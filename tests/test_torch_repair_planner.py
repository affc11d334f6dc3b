"""The port's repair planner and health ledger
(seaweedfs_tpu_torch/maintenance/repair.py) held to the reference's on
the CPU, and the maintenance plane on the port's master.

Unit cases feed both packages the same seeded input and compare with
``==``: `TokenBucket` under a still clock, `build_ledger` over scripted
topologies (RS, LRC and MSR volumes, scrub reports, under-replicated
volumes; each package's own `Topology` fed the same beats),
`_plan_survivors` for RS, lrc_10_2_2 and msr_9_16 on phase 9's and
10's topologies of chip_smoke.py (the plans that return None too),
`tick()`'s ordering, node caps and cross-rack deferral, and whole repairs
(`_run_one`) against a recording stand-in of the volume servers' admin
routes: the reduced path, its naive fallback and forced debit, the naive
path, the purge of corrupt shards, unresolved corruption and
re-replication, with the calls made, the history, the decisions and the
repair-byte counters compared.  Then twins of tests/test_maintenance.py's
planner cases, the knobs (each malformed one raising where the
reference falls back, the repair interval read at construction), and
the master: /maintenance/status of a mixed cluster against the
reference master's, the reference's shell (`maintenance.status`,
`volume.fsck -json`) against the port's master healing a port node, and
a planner tick and an autopilot tick in a fresh interpreter that loads
neither jax nor torch.
"""

import asyncio
import copy
import io
import json
import shutil
import subprocess
import sys
import time
import types

import numpy as np
import pytest

from seaweedfs_tpu.maintenance import repair as ref_repair
from seaweedfs_tpu.server import master as ref_master
from seaweedfs_tpu.stats import metrics as ref_metrics
from seaweedfs_tpu.topology import topology as ref_topology

from seaweedfs_tpu_torch.maintenance import repair
from seaweedfs_tpu_torch.server import master as mastermod
from seaweedfs_tpu_torch.stats import metrics
from seaweedfs_tpu_torch.topology import topology

from tests.test_torch_master_cluster import REPO, free_port

PKGS = {"ref": (ref_repair, ref_topology, ref_metrics),
        "port": (repair, topology, metrics)}


@pytest.fixture()
def frozen(monkeypatch):
    """One still clock for both packages' planners and buckets."""
    clock = types.SimpleNamespace(monotonic=lambda: 5000.0,
                                  time=lambda: 1.7e9)
    for mod in (repair, ref_repair):
        monkeypatch.setattr(mod, "time", clock)


# ---- token bucket -----------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_token_bucket_equals_reference(seed, monkeypatch):
    """A seeded sequence of acquires (some over the burst), retunes,
    credits and forced debits on a patched clock: every answer and the
    tokens after each step are the reference's."""
    rng = np.random.default_rng(seed)
    now = [100.0]
    clock = types.SimpleNamespace(monotonic=lambda: now[0])
    for mod in (repair, ref_repair):
        monkeypatch.setattr(mod, "time", clock)
    rate, burst = float(rng.uniform(0, 5)), float(rng.uniform(1, 8))
    buckets = {name: mods[0].TokenBucket(rate, burst)
               for name, mods in PKGS.items()}
    for _ in range(200):
        now[0] += float(rng.exponential(0.3))
        op = int(rng.integers(4))
        arg = float(rng.uniform(0, 2 * burst))
        got = {}
        for name, b in buckets.items():
            if op == 0:
                got[name] = b.try_acquire(arg)
            elif op == 1:
                got[name] = b.set_rate(arg - burst / 2)
            elif op == 2:
                got[name] = b.credit(arg)
            else:
                got[name] = b.force_debit(arg)
            got[name] = (got[name], b.tokens, b.rate, b.burst)
        assert got["port"] == got["ref"]


def test_token_bucket_oversized_request_admits_at_full():
    """Twin of tests/test_maintenance.py's."""
    b = repair.TokenBucket(rate=0.0, burst=1024.0)
    assert b.try_acquire(4096.0)
    assert b.tokens == -3072.0
    assert not b.try_acquire(1.0)
    b.tokens = 1023.0
    assert not b.try_acquire(4096.0)


# ---- the health ledger ------------------------------------------------------------

CODECS = ("rs_10_4", "lrc_10_2_2", "msr_9_16", None)
N_SHARDS = {"rs_10_4": 14, "lrc_10_2_2": 14, "msr_9_16": 18, None: 14}


def _scripted(seed):
    """(beats, scrub reports) of a seeded cluster: nodes in two DCs and
    three racks, normal volumes under replica placements, EC volumes of
    every code spread over the nodes with shards missing, and scrub
    reports naming corrupt shards, unlocalised ranges, quarantines and
    CRC mismatches."""
    rng = np.random.default_rng(seed)
    nodes = [(f"10.0.0.{i}:80", f"dc{i % 2}", f"r{i % 3}")
             for i in range(int(rng.integers(3, 6)))]
    beats = {url: {"max_volume_count": int(rng.integers(4, 12)),
                   "volumes": [], "ec_shards": []} for url, _, _ in nodes}
    for vid in range(1, int(rng.integers(4, 9))):
        rp = str(rng.choice(["000", "001", "010", "100", "002"]))
        for url, _, _ in nodes:
            if rng.random() < 0.4:
                beats[url]["volumes"].append(
                    {"id": vid, "collection": "c" * int(rng.integers(2)),
                     "size": int(rng.integers(1, 1 << 20)),
                     "replica_placement": rp})
    for vid in range(50, 50 + int(rng.integers(3, 8))):
        codec = CODECS[int(rng.integers(len(CODECS)))]
        n = N_SHARDS[codec]
        keep = [s for s in range(n) if rng.random() < 0.85]
        size = int(rng.integers(0, 3)) * 4096
        for s in keep:
            for url, _, _ in nodes:
                if rng.random() < 0.5 or url == nodes[s % len(nodes)][0]:
                    ent = next((e for e in beats[url]["ec_shards"]
                                if e["id"] == vid), None)
                    if ent is None:
                        ent = {"id": vid, "collection": "",
                               "shard_ids": []}
                        if size:
                            ent["shard_size"] = size
                        if codec:
                            ent["codec"] = codec
                        beats[url]["ec_shards"].append(ent)
                    ent["shard_ids"].append(s)
                    break
    reports = {}
    for vid in list(range(1, 10)) + list(range(50, 58)):
        for url, _, _ in nodes:
            if rng.random() < 0.25:
                rep = {"last_scrub": float(rng.integers(1, 1000)),
                       "corrupt": [], "crc_mismatches":
                       int(rng.integers(0, 2))}
                for _ in range(int(rng.integers(0, 3))):
                    rep["corrupt"].append(
                        {"shard": int(rng.integers(-1, 14)),
                         "offset": int(rng.integers(0, 1 << 20)),
                         "size": 4096, "columns": 1})
                if rng.random() < 0.5:
                    rep["quarantined"] = {"3": [[0, 4096]]}
                reports.setdefault(url, {})[str(vid)] = rep
    return nodes, beats, reports


def _cluster(pkg, nodes, beats, reports=None):
    """`pkg`'s Topology fed the beats, and a planner over it with the
    scrub reports recorded."""
    rmod, tmod, _ = PKGS[pkg]
    topo = tmod.Topology()
    for url, dc, rack in nodes:
        topo.register_heartbeat(node_id=url, url=url, public_url="",
                                dc=dc, rack=rack,
                                beat=copy.deepcopy(beats[url]))
    planner = rmod.RepairPlanner(types.SimpleNamespace(topo=topo,
                                                       _session=None))
    for url, vols in (reports or {}).items():
        planner.record_scrub(url, {"volumes": copy.deepcopy(vols)})
    return planner


@pytest.mark.parametrize("seed", range(6))
def test_build_ledger_equals_reference(seed):
    """The same beats and scrub reports: the ledgers, the
    weedtpu_volume_health gauge and `status()` are the reference's."""
    nodes, beats, reports = _scripted(seed)
    led = {}
    for pkg, (_, _, met) in PKGS.items():
        planner = _cluster(pkg, nodes, beats, reports)
        led[pkg] = (planner.ledger(),
                    {s: met.VOLUME_HEALTH.labels(s).value
                     for s in repair.HEALTH_STATES},
                    planner.status())
    assert led["port"] == led["ref"]
    states = {i["state"] for i in led["port"][0].values()}
    assert states & {"degraded", "corrupt", "critical", "under_replicated"}


def test_ledger_urgency_orders_by_shards_lost():
    """Twin of tests/test_maintenance.py's."""
    topo = topology.Topology()
    beat = {"max_volume_count": 50, "volumes": [], "ec_shards": [
        {"id": 1, "collection": "", "shard_ids": list(range(13))},
        {"id": 2, "collection": "", "shard_ids": list(range(11))},
    ]}
    topo.register_heartbeat(node_id="n1", url="n1", public_url="",
                            dc="", rack="", beat=beat)
    led = repair.build_ledger(topo, {})
    assert led[1]["state"] == led[2]["state"] == "degraded"
    assert led[2]["urgency"] > led[1]["urgency"]
    topo2 = _degraded_topology(1, missing=6)
    assert repair.build_ledger(topo2, {})[1]["state"] == "critical"


# ---- survivor plans -----------------------------------------------------------

# chip_smoke.py's topologies: phase 9's (the repairing node R, "a:1" in
# its rack, "b:2" in another DC) and phase 17's four nodes for phase 10's
# msr_9_16 set ("c:3" in R's DC, another rack)
PHASE9 = {"R": ("dc1", "r1", range(0, 6)), "a:1": ("dc1", "r1", range(6, 9)),
          "b:2": ("dc2", "r1", range(9, 14))}
PHASE10_MSR = {"R": ("dc1", "r1", range(0, 6)),
               "a:1": ("dc1", "r1", range(6, 12)),
               "c:3": ("dc1", "r2", (12,)),
               "b:2": ("dc2", "r1", range(13, 18))}
PHASE10_LRC = {"R": ("dc1", "r1", range(0, 5)),
               "a:1": ("dc1", "r1", range(5, 10)),
               "c:3": ("dc1", "r2", (10, 11)),
               "b:2": ("dc2", "r1", (12, 13))}


def _placed(layout_, codec, lost, size=16 * 4096):
    nodes = [(url, dc, rack) for url, (dc, rack, _) in layout_.items()]
    beats = {}
    for url, (_, _, span) in layout_.items():
        ent = {"id": 9, "collection": "", "shard_size": size,
               "shard_ids": [s for s in span if s not in lost]}
        if codec:
            ent["codec"] = codec
        beats[url] = {"max_volume_count": 8, "volumes": [],
                      "ec_shards": [ent]}
    return nodes, beats


def _plans(layout_, codec, patterns):
    out = {}
    for pkg in PKGS:
        got = []
        for lost in patterns:
            planner = _cluster(pkg, *_placed(layout_, codec, lost))
            info = planner.ledger()[9]
            got.append(planner._plan_survivors(info))
        out[pkg] = got
    assert out["port"] == out["ref"]
    return out["port"]


def _patterns(n, seed, extra=()):
    rng = np.random.default_rng(seed)
    pats = [list(p) for p in extra]
    for _ in range(40):
        k = int(rng.integers(1, 6))
        pats.append(sorted(int(s) for s in rng.choice(n, k, replace=False)))
    return pats


@pytest.mark.parametrize("layout_,codec,n", [
    (PHASE9, "rs_10_4", 14), (PHASE9, None, 14),
    (PHASE10_LRC, "lrc_10_2_2", 14), (PHASE10_MSR, "msr_9_16", 18)],
    ids=["rs_phase9", "untagged_phase9", "lrc_phase10", "msr_phase10"])
def test_plan_survivors_equals_reference(layout_, codec, n):
    """Every plan over phase 9's and 10's topologies, for phase 9's and
    10's losses and seeded others, is the reference's: the rebuilder,
    the helper groups and their locality, every byte estimate, and the
    patterns that return None (below k, an LRC group with no basis,
    fewer than d MSR helpers)."""
    plans = _plans(layout_, codec, _patterns(
        n, n, extra=([3], [1, 12], [0], [0, 13], [2], [12], [2, 3],
                     [0, 1, 2, 3, 4])))
    assert any(p is None for p in plans)
    assert any(p and len({g["locality"] for g in p["groups"]}) > 1
               for p in plans)


def test_plan_survivors_without_a_shard_size_is_none():
    nodes, beats = _placed(PHASE9, "rs_10_4", [3], size=0)
    for b in beats.values():
        b["ec_shards"][0].pop("shard_size")
    for pkg in PKGS:
        planner = _cluster(pkg, nodes, beats)
        assert planner._plan_survivors(planner.ledger()[9]) is None


def _rack_topology(nodes, vids, shard_size=4096):
    topo = topology.Topology()
    for url, dc, rack in nodes:
        beat = {"max_volume_count": 50, "volumes": [],
                "ec_shards": [{"id": vid, "collection": "",
                               "shard_ids": per[url],
                               "shard_size": shard_size}
                              for vid, per in vids.items()
                              if per.get(url)]}
        topo.register_heartbeat(node_id=url, url=url, public_url="",
                                dc=dc, rack=rack, beat=beat)
    return topo


def _degraded_topology(n_vols, missing=2):
    topo = topology.Topology()
    beat = {"max_volume_count": 50, "volumes": [],
            "ec_shards": [{"id": vid, "collection": "",
                           "shard_ids": list(range(14 - missing))}
                          for vid in range(1, n_vols + 1)]}
    topo.register_heartbeat(node_id="127.0.0.1:1", url="127.0.0.1:1",
                            public_url="", dc="", rack="", beat=beat)
    return topo


def test_plan_survivors_prefers_same_rack_minimal_groups():
    """Twin of tests/test_maintenance.py's."""
    topo = _rack_topology(
        [("a", "dc1", "r0"), ("b", "dc1", "r0"), ("c", "dc1", "r1")],
        {1: {"a": list(range(0, 6)), "b": list(range(6, 10)),
             "c": [10, 11]}})
    info = repair.build_ledger(topo, {})[1]
    assert info["shards_missing"] == [12, 13]
    assert info["shard_size"] == 4096
    planner = repair.RepairPlanner(
        types.SimpleNamespace(topo=topo, _session=None))
    plan = planner._plan_survivors(info)
    assert plan["rebuilder"] == "a"
    assert [g["node"] for g in plan["groups"]] == ["b"]
    assert plan["groups"][0]["locality"] == 1
    assert plan["est_xrack_bytes"] == 0
    assert plan["est_remote_bytes"] == 2 * 4096
    assert plan["naive_remote_bytes"] == 6 * 4096


def test_locality_class_ranking():
    """Twin of tests/test_maintenance.py's."""
    lc = topology.locality_class
    assert lc("dc1", "r0", "dc1", "r0", same_node=True) == 0
    assert lc("dc1", "r0", "dc1", "r0") == 1
    assert lc("dc1", "r0", "dc1", "r1") == 2
    assert lc("dc1", "r0", "dc2", "r0") == 3
    assert lc("", "", "", "") == 1


# ---- ticks and whole repairs against a recording stand-in ----------------------

class Admin:
    """A stand-in of the volume servers' admin routes: records every
    (node, path, body) and answers as `reply(path, body)` says."""

    def __init__(self, reply=None):
        self.calls = []
        self.reply = reply or (lambda node, path, body: {})

    async def __call__(self, url, path, body):
        self.calls.append((url, path, copy.deepcopy(body)))
        out = self.reply(url, path, body)
        if isinstance(out, Exception):
            raise out
        return out


def _view(planner):
    st = planner.status()
    st["history"] = [{k: v for k, v in h.items() if k != "seconds"}
                     for h in st["history"]]
    st["decisions"] = [{k: v for k, v in d.items() if k != "ts"}
                       for d in st["decisions"]]
    st["backoffs"] = {v: b["failures"] for v, b in st["backoffs"].items()}
    return st


def _drive(pkg, nodes, beats, reports, reply, ticks=1, **kw):
    planner = _cluster(pkg, nodes, beats, reports)
    for k, v in kw.items():
        setattr(planner, k, v)
    admin = Admin(reply)
    planner._post = admin
    _, _, met = PKGS[pkg]
    before = {loc: met.REPAIR_BYTES.labels(loc).value
              for loc in topology.LOCALITY_NAMES}
    acts = {k: met.REPAIR_ACTIONS.labels(*k).value
            for k in (("ec", "ok"), ("ec", "error"), ("normal", "ok"),
                      ("normal", "error"))}

    async def run():
        out = []
        for _ in range(ticks):
            out.append(await planner.tick())
            await planner.wait_idle()
        return out

    actions = asyncio.run(run())
    booked = {loc: met.REPAIR_BYTES.labels(loc).value - before[loc]
              for loc in before}
    acted = {k: met.REPAIR_ACTIONS.labels(*k).value - v
             for k, v in acts.items()}
    return actions, admin.calls, _view(planner), booked, acted


def _both_drive(nodes, beats, reports, reply, **kw):
    got = {pkg: _drive(pkg, nodes, beats, reports, reply, **kw)
           for pkg in PKGS}
    assert got["port"] == got["ref"]
    return got["port"]


def _reduced_ok(node, path, body):
    if path == "/admin/ec/rebuild" and "reduced" in body:
        size = body["reduced"]["shard_size"]
        lost = len(body["reduced"]["lost"])
        per = {g["node"]: size * lost for g in body["reduced"]["groups"]}
        by_loc = {}
        for g in body["reduced"]["groups"]:
            name = topology.locality_name(g["locality"])
            by_loc[name] = by_loc.get(name, 0) + size * lost
        return {"rebuilt": body["reduced"]["lost"], "helper_bytes": per,
                "by_locality": by_loc, "replans": 0}
    return {}


def _reduced_fails(node, path, body):
    if path == "/admin/ec/rebuild" and "reduced" in body:
        return RuntimeError("helpers exhausted")
    return {}


@pytest.mark.parametrize("reply", [_reduced_ok, _reduced_fails],
                         ids=["reduced", "naive_fallback"])
@pytest.mark.parametrize("reduced", ["1", "0"])
def test_phase9_repairs_equal_reference(reply, reduced, frozen,
                                        monkeypatch):
    """Phase 9's [1, 12] through a whole tick: the reduced rebuild (and
    its mount), or its failure, the survivor copies, the naive rebuild,
    the borrowed shards' delete and the mount; the decision records,
    the forced cross-rack debit, the repair-byte counters and the
    action counters are the reference's."""
    monkeypatch.setenv("WEEDTPU_REPAIR_REDUCED", reduced)
    nodes, beats = _placed(PHASE9, "rs_10_4", [1, 12])
    actions, calls, view, booked, acted = _both_drive(
        nodes, beats, {}, reply)
    paths = [p for _, p, _ in calls]
    if reduced == "1" and reply is _reduced_ok:
        assert paths == ["/admin/ec/rebuild", "/admin/ec/mount"]
        assert view["decisions"][0]["mode"] == "reduced"
        assert view["decisions"][0]["actual_bytes"] == \
            view["decisions"][0]["est_remote_bytes"]
        assert sum(booked.values()) == 0  # metered at the rebuilder
    else:
        assert paths.count("/admin/ec/copy") == 7
        assert sum(booked.values()) == 7 * 16 * 4096
    assert acted[("ec", "ok")] == 1
    assert [a["vid"] for a in actions[0]] == [9]


def _corrupt_reports(url, shard):
    return {url: {"9": {"corrupt": [{"shard": shard, "offset": 0,
                                     "size": 4096, "columns": 1}],
                        "quarantined": {str(shard): [[0, 4096]]},
                        "last_scrub": 5.0}}}


@pytest.mark.parametrize("case", ["purge", "unlocalized", "too_few",
                                  "remote_verdict"])
def test_corruption_repairs_equal_reference(case, frozen):
    """Corrupt shards: purged on their owner and rebuilt (the verdict
    resolved), an unlocalised range or a purge below k refused with a
    backoff, a verdict reported by another node purged on the owner."""
    if case == "too_few":
        layout_ = {"R": ("dc1", "r1", range(0, 10))}
        nodes, beats = _placed(layout_, "rs_10_4", [])
        reports = _corrupt_reports("R", 4)
    else:
        nodes, beats = _placed(PHASE9, "rs_10_4", [12])
        shard = -1 if case == "unlocalized" else 7
        reports = _corrupt_reports("b:2" if case == "remote_verdict"
                                   else "a:1", shard)
    actions, calls, view, booked, acted = _both_drive(
        nodes, beats, reports, _reduced_ok, ticks=2)
    if case in ("purge", "remote_verdict"):
        assert calls[0] == ("a:1", "/admin/ec/delete_shards",
                            {"volume": 9, "shards": [7]})
        assert view["history"][0]["outcome"] == "ok"
    else:
        assert calls == []
        assert view["history"][0]["outcome"].startswith("error")
        assert view["backoffs"] == {"9": 1}


def test_replication_and_tick_caps_equal_reference(frozen):
    """Under-replicated normal volumes, a corrupt-but-replicated one,
    and many degraded EC volumes over four nodes with a per-node cap
    of two and a bucket of nine: the launch order (urgency, then
    fewest survivors), the /admin/volume/copy targets and what waits
    are the reference's."""
    nodes = [("n1:80", "dc1", "r1"), ("n2:80", "dc1", "r2"),
             ("n3:80", "dc2", "r1"), ("n4:80", "dc2", "r2")]
    beats = {u: {"max_volume_count": 6 + 4 * i, "volumes": [],
                 "ec_shards": []} for i, (u, _, _) in enumerate(nodes)}
    beats["n1:80"]["volumes"] = [
        {"id": 1, "collection": "", "replica_placement": "001"},
        {"id": 2, "collection": "x", "replica_placement": "010"},
        {"id": 3, "collection": "", "replica_placement": "000"}]
    for vid, (holder, keep) in enumerate(
            [("n2:80", 13), ("n2:80", 11), ("n3:80", 12), ("n3:80", 10),
             ("n1:80", 12)], start=20):
        beats[holder]["ec_shards"].append(
            {"id": vid, "collection": "", "shard_ids": list(range(keep)),
             "shard_size": 4096})
    reports = {"n1:80": {"3": {"crc_mismatches": 2, "last_scrub": 1.0}}}
    got = {}
    for pkg, (rmod, _, _) in PKGS.items():
        got[pkg] = _drive(pkg, nodes, beats, reports, _reduced_ok, ticks=3,
                          node_concurrency=2,
                          bucket=rmod.TokenBucket(0.0, 9.0))
    assert got["port"] == got["ref"]
    actions, calls = got["port"][0], got["port"][1]
    got_vids = [[a["vid"] for a in t] for t in actions]
    assert got_vids[0] == [23, 21, 24, 22, 1, 2, 20], got_vids
    assert sum(map(len, got_vids)) == 9  # the bucket's nine
    assert ("n4:80", "/admin/volume/copy",
            {"volume": 2, "source": "n1:80", "collection": "x"}) in calls


def test_xrack_budget_defers_lower_urgency_repairs():
    """Twin of tests/test_maintenance.py's."""
    size = 4096
    topo = _rack_topology(
        [("a", "dc1", "r0"), ("c", "dc1", "r1")],
        {1: {"a": list(range(0, 6)), "c": list(range(6, 12))},
         2: {"a": list(range(0, 6)), "c": list(range(6, 13))}},
        shard_size=size)
    master = types.SimpleNamespace(topo=topo, _session=None)
    planner = repair.RepairPlanner(master, rate=0.0, burst=10.0,
                                   node_concurrency=100,
                                   xrack_rate=0.0, xrack_burst=2.5 * size)
    launched = []

    async def fake_run_one(info, node):
        launched.append(info["vid"])
        planner._active_vids.discard(info["vid"])

    planner._run_one = fake_run_one
    planner.bucket.tokens = 10.0
    actions = asyncio.run(planner.tick())
    assert [a["vid"] for a in actions] == [1]
    assert planner.waiting_xrack == [2]
    assert planner.status()["xrack"]["waiting"] == [2]
    planner.xrack_bucket.tokens = planner.xrack_bucket.burst = 10 * size
    actions = asyncio.run(planner.tick())
    assert 2 in {a["vid"] for a in actions}
    assert planner.waiting_xrack == []


def test_naive_fallback_debits_xrack_shortfall():
    """Twin of tests/test_maintenance.py's."""
    size = 4096
    topo = _rack_topology(
        [("a", "dc1", "r0"), ("c", "dc1", "r1")],
        {1: {"a": list(range(0, 6)), "c": list(range(6, 12))}},
        shard_size=size)
    planner = repair.RepairPlanner(
        types.SimpleNamespace(topo=topo, _session=None),
        rate=0.0, burst=10.0, node_concurrency=100,
        xrack_rate=0.0, xrack_burst=100.0 * size)
    info = repair.build_ledger(topo, {})[1]
    plan = planner._plan_survivors(info)
    assert plan["est_xrack_bytes"] < plan["naive_xrack_bytes"]

    async def fake_post(url, path, body):
        if path == "/admin/ec/rebuild" and "reduced" in body:
            raise RuntimeError("helpers exhausted")
        return {}

    planner._post = fake_post
    before = planner.xrack_bucket.tokens
    asyncio.run(planner._repair_ec(1, info))
    assert before - planner.xrack_bucket.tokens == \
        plan["naive_xrack_bytes"] - plan["est_xrack_bytes"]


def test_token_bucket_caps_concurrent_rebuilds():
    """Twin of tests/test_maintenance.py's."""
    bucket = repair.TokenBucket(rate=0.0, burst=2.0)
    assert bucket.try_acquire() and bucket.try_acquire()
    assert not bucket.try_acquire()
    master = types.SimpleNamespace(topo=_degraded_topology(6),
                                   _session=None)
    planner = repair.RepairPlanner(master, rate=0.0, burst=2.0,
                                   node_concurrency=100)
    calls = []

    async def fake_post(url, path, body):
        calls.append((url, path, body))
        return {}

    planner._post = fake_post

    async def drive():
        actions = await planner.tick()
        await planner.wait_idle()
        return actions

    assert len(asyncio.run(drive())) == 2
    assert {c[1] for c in calls} >= {"/admin/ec/rebuild", "/admin/ec/mount"}
    planner.bucket.burst = planner.bucket.tokens = 10.0
    assert len(asyncio.run(drive())) == 6


def test_capacity_boost_equals_reference(frozen):
    """A forecaster naming a filling node raises the urgency of the
    repairs whose survivors sit there, in both packages."""
    nodes, beats = _placed(PHASE9, "rs_10_4", [3])
    beats["a:1"]["ec_shards"].append({"id": 10, "collection": "",
                                      "shard_ids": list(range(12)),
                                      "shard_size": 4096})
    out = {}
    for pkg in PKGS:
        planner = _cluster(pkg, nodes, beats)
        planner.master.forecaster = types.SimpleNamespace(
            filling_nodes=lambda horizon: {"a:1"}
            if horizon == 21600.0 else set())
        infos = [i for i in planner.ledger().values()]
        planner._capacity_boost(infos)
        out[pkg] = infos
    assert out["port"] == out["ref"]
    assert all(i.get("capacity_urgent") for i in out["port"])


# ---- the knobs -------------------------------------------------------------------

KNOBS = [("WEEDTPU_REPAIR_INTERVAL", "soon"),
         ("WEEDTPU_REPAIR_REDUCED", "yes"), ("WEEDTPU_AUTOPILOT", "bogus"),
         ("WEEDTPU_AUTOPILOT_COLD_S", "x"),
         ("WEEDTPU_AUTOPILOT_HOT_RPS", "fast"),
         ("WEEDTPU_AUTOPILOT_HOT_S", "1m"),
         ("WEEDTPU_AUTOPILOT_CODEC_RATE", "half")]


@pytest.mark.parametrize("knob,value", KNOBS,
                         ids=[f"{k}={v}" for k, v in KNOBS])
def test_malformed_maintenance_knob_raises_unlike_the_reference(
        knob, value, monkeypatch):
    """The reference's master falls back on each of these (or reads the
    interval only when its loop starts); the port's raises at
    construction, before its socket binds."""
    monkeypatch.setenv(knob, value)
    ref_master.MasterServer("127.0.0.1", 1)
    with pytest.raises(ValueError, match=knob):
        mastermod.MasterServer("127.0.0.1", 1)


def test_repair_interval_read_at_construction_unlike_the_reference(
        monkeypatch):
    """The port's master reads WEEDTPU_REPAIR_INTERVAL when it is built,
    so a value scoped around the constructor holds for its loop; the
    reference reads it when the loop starts."""
    from tests.test_torch_master import Loop
    monkeypatch.setenv("WEEDTPU_REPAIR_INTERVAL", "0")
    mine = mastermod.MasterServer("127.0.0.1", free_port())
    ref = ref_master.MasterServer("127.0.0.1", free_port())
    monkeypatch.setenv("WEEDTPU_REPAIR_INTERVAL", "3600")
    lp = Loop()
    try:
        for m in (mine, ref):
            lp.run(m.start())
        lp.run(asyncio.sleep(0.1))
        assert mine.repair_interval == 0.0
        assert mine._repair_task.done()  # the loop returned at once
        assert not ref._repair_task.done()  # the reference's waits 3600 s
    finally:
        for m in (mine, ref):
            lp.run(m.stop())
        lp.close()


def test_constant_knobs_are_the_references_defaults(monkeypatch):
    for knob in ("WEEDTPU_REPAIR_CONCURRENCY", "WEEDTPU_REPAIR_RATE",
                 "WEEDTPU_REPAIR_BURST", "WEEDTPU_REPAIR_XRACK_BUDGET",
                 "WEEDTPU_REPAIR_XRACK_BURST"):
        monkeypatch.delenv(knob, raising=False)
    mine = repair.RepairPlanner(types.SimpleNamespace())
    ref = ref_repair.RepairPlanner(types.SimpleNamespace())
    for b in ("bucket", "xrack_bucket"):
        assert (getattr(mine, b).rate, getattr(mine, b).burst) == \
            (getattr(ref, b).rate, getattr(ref, b).burst)
    assert mine.node_concurrency == ref.node_concurrency
    assert (mine.backoff_base, mine.backoff_max) == \
        (ref.backoff_base, ref.backoff_max)
    assert repair.HEALTH_STATES == ref_repair.HEALTH_STATES
    for name in ("REPAIR_ACTIONS", "REPAIR_BYTES", "VOLUME_HEALTH"):
        m, r = getattr(metrics, name), getattr(ref_metrics, name)
        assert (m.name, m.help, m.label_names, m.kind) == \
            (r.name, r.help, r.label_names, r.kind)


# ---- the master ------------------------------------------------------------------

def _make_shards(d, vid, n=24, seed=3):
    """An EC shard set of `n` needles written and encoded by the port on
    the CPU in directory `d`, the .dat and .idx removed."""
    import os
    from seaweedfs_tpu_torch.storage import needle as ndl
    from seaweedfs_tpu_torch.storage.ec import ec_files
    from seaweedfs_tpu_torch.storage.volume import Volume
    v = Volume(str(d), "", vid)
    rng = np.random.default_rng(seed)
    for nid in range(1, n + 1):
        v.append_needle(ndl.Needle(cookie=0x77, id=nid, data=rng.bytes(
            int(rng.integers(1000, 9000)))))
    v.close()
    base = str(d / str(vid))
    ec_files.write_ec_files(base, device="cpu")
    ec_files.write_sorted_ecx(base + ".idx")
    for ext in (".dat", ".idx"):
        os.remove(base + ext)
    return base


def test_mixed_cluster_status_equals_reference_master(tmp_path,
                                                      monkeypatch):
    """The port's master over one reference and one port volume server,
    and the reference's master over two more holding copies of the same
    files: /maintenance/status lists the same volumes (node addresses
    read as roles), states, shards and urgency."""
    import os
    from seaweedfs_tpu.server.volume_server import VolumeServer as RefVS
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    from tests.test_torch_master import Loop, call
    from seaweedfs_tpu_torch.storage.ec import layout
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "0")
    monkeypatch.setenv("WEEDTPU_AGG_INTERVAL", "0")
    monkeypatch.setenv("WEEDTPU_REPAIR_INTERVAL", "0")
    src = tmp_path / "src"
    src.mkdir()
    base = _make_shards(src, 31)
    lp = Loop()
    started = []
    views = {}
    try:
        for kind, mcls in (("port", mastermod.MasterServer),
                           ("ref", ref_master.MasterServer)):
            m = mcls("127.0.0.1", free_port())
            lp.run(m.start())
            started.append(m)
            roles = {}
            for role, vcls, span in (("refvs", RefVS, range(0, 7)),
                                     ("portvs", VolumeServer,
                                      range(7, 13))):
                d = tmp_path / f"{kind}_{role}"
                d.mkdir()
                for s in span:
                    shutil.copyfile(base + layout.to_ext(s),
                                    str(d / "31") + layout.to_ext(s))
                for ext in (".ecx", ".vif"):
                    shutil.copyfile(base + ext, str(d / "31") + ext)
                kw = {"device": "cpu"} if vcls is VolumeServer else {}
                vs = vcls([str(d)], m.url, "127.0.0.1", free_port(),
                          heartbeat_interval=0.2, **kw)
                lp.run(vs.start())
                started.append(vs)
                roles[vs.url] = role
            deadline = time.time() + 10
            while time.time() < deadline:
                st = call(m.url, "/maintenance/status")[1]
                if st["volumes"].get("31", {}).get("shards_present") == \
                        list(range(13)):
                    break
                time.sleep(0.1)
            text = json.dumps(st["volumes"])
            for url, role in roles.items():
                text = text.replace(url, role)
            views[kind] = (json.loads(text), st["states"])
        assert views["port"] == views["ref"]
        vol = views["port"][0]["31"]
        assert (vol["state"], vol["shards_missing"], vol["urgency"]) == \
            ("degraded", [13], 1)
        assert set(vol["node_locality"]) == {"refvs", "portvs"}
        assert os.path.getsize(base + ".ec00") == vol["shard_size"]
    finally:
        for obj in reversed(started):
            lp.run(obj.stop())
        lp.close()


def test_reference_shell_fsck_and_status_against_the_port_master(
        tmp_path, monkeypatch):
    """The reference's shell against the port's master over a port node
    (the flight-recorder drive): `volume.fsck -json` reads ok; a bit
    flipped by /admin/faults and found by /admin/scrub makes it fail
    with the corrupt shard, `maintenance.status` lists the volume
    corrupt; one /maintenance/tick purges and rebuilds, a fresh scrub is
    clean and fsck reads ok again; /maintenance/status carries the
    planner, conversion, resilience, SLO, alert, interference,
    autopilot and loops blocks, and no geo block."""
    from seaweedfs_tpu.client import WeedClient
    from seaweedfs_tpu.shell.commands import CommandEnv, run_command
    from tests.test_torch_master import call
    from tests.test_torch_master_cluster import Cluster
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "1000")
    monkeypatch.setenv("WEEDTPU_SCRUB_INTERVAL", "3600")
    monkeypatch.setenv("WEEDTPU_AGG_INTERVAL", "0")
    monkeypatch.setenv("WEEDTPU_REPAIR_INTERVAL", "0")
    c = Cluster(tmp_path, n_volume_servers=1).start()
    try:
        c.wait_heartbeats()
        client = WeedClient(c.master.url)
        rng = np.random.default_rng(11)
        blobs = {client.upload(rng.bytes(12_000), name=f"k{i}"): None
                 for i in range(16)}
        vid = int(next(iter(blobs)).partition(",")[0])
        time.sleep(0.5)
        env = CommandEnv(c.master.url)
        out = io.StringIO()
        run_command(env, "lock", out)
        run_command(env, f"ec.encode -volumeId {vid}", out)
        run_command(env, "unlock", out)
        time.sleep(0.5)
        vs = c.volume_servers[0]
        # fsck lists the filer's tree first: the port has no filer yet
        # (ROADMAP 1.20), so a member that lists an empty root stands in
        from aiohttp import web
        filer = web.AppRunner(_empty_filer())
        c.submit(filer.setup())
        fport = free_port()
        c.submit(web.TCPSite(filer, "127.0.0.1", fport).start())
        call(c.master.url, "/cluster/register",
             body={"type": "filer", "address": f"127.0.0.1:{fport}"})

        def fsck():
            buf = io.StringIO()
            run_command(env, "lock", buf)
            rc = run_command(env, "volume.fsck -json", buf)
            run_command(env, "unlock", io.StringIO())
            text = buf.getvalue()
            return rc, json.loads(text[text.index("{"):
                                       text.rindex("}") + 1])

        rc, rep = fsck()
        assert rc == 0 and rep["ok"] is True, rep
        call(vs.url, "/admin/faults", body={"faults": [
            {"action": "flip_bit", "volume": vid, "shard": 2,
             "offset": 777}]})
        sc = call(vs.url, "/admin/scrub", body={})[1]
        assert sc["volumes"][str(vid)]["corrupt"][0]["shard"] == 2
        rc, rep = fsck()
        assert rc == 1 and rep["ok"] is False, rep
        assert rep["volumes"][str(vid)]["health"]["state"] == "corrupt"
        buf = io.StringIO()
        run_command(env, "maintenance.status", buf)
        assert "corrupt" in buf.getvalue()
        st = call(c.master.url, "/maintenance/status")[1]
        assert st["volumes"][str(vid)]["state"] == "corrupt"
        r = call(c.master.url, "/maintenance/tick", body={"wait": True})
        assert r[0] == 200 and r[1]["actions"][0]["vid"] == vid
        deadline = time.time() + 10
        while time.time() < deadline:
            st = call(c.master.url, "/maintenance/status")[1]
            if st["volumes"][str(vid)]["state"] == "healthy":
                break
            time.sleep(0.1)
        assert st["volumes"][str(vid)]["state"] == "healthy", st
        sc = call(vs.url, "/admin/scrub", body={})[1]
        assert sc["volumes"][str(vid)]["corrupt"] == []
        rc, rep = fsck()
        assert rc == 0 and rep["ok"] is True, rep
        assert {"volumes", "states", "planner", "convert", "resilience",
                "slo", "alerts", "capacity", "history", "interference",
                "autopilot", "loops"} <= set(st)
        assert "geo" not in st
        assert st["planner"]["history"][-1]["outcome"] == "ok"
        client.close()
        c.submit(filer.cleanup())
    finally:
        c.stop()


def _empty_filer():
    from aiohttp import web

    async def listing(req):
        return web.json_response({"Entries": []})
    app = web.Application()
    app.add_routes([web.get("/{path:.*}", listing)])
    return app


def test_maintenance_ticks_leave_jax_and_torch_unloaded(tmp_path):
    """A port master alone in a fresh interpreter, with a node's beat of
    a degraded EC volume: /maintenance/status, a /maintenance/tick whose
    repair fails (the node is not there) and backs off, a conversion
    tick and an autopilot tick; neither jax, torch nor the reference
    package is imported."""
    code = f"""
import asyncio, json, os, sys, threading, urllib.request
os.environ.update(WEEDTPU_AGG_INTERVAL="0", WEEDTPU_CANARY_INTERVAL="0",
                  WEEDTPU_REPAIR_INTERVAL="0")
from seaweedfs_tpu_torch.server.master import MasterServer
loop = asyncio.new_event_loop()
threading.Thread(target=loop.run_forever, daemon=True).start()
run = lambda c: asyncio.run_coroutine_threadsafe(c, loop).result(60)
m = MasterServer("127.0.0.1", {free_port()})
run(m.start())
def post(path, body):
    req = urllib.request.Request(f"http://{{m.url}}{{path}}",
        data=json.dumps(body).encode(),
        headers={{"Content-Type": "application/json"}})
    with urllib.request.urlopen(req) as r:
        return json.loads(r.read())
node = "127.0.0.1:{free_port()}"
post("/heartbeat", {{"id": node, "url": node, "volumes": [],
     "ec_shards": [{{"id": 5, "collection": "", "codec": "lrc_10_2_2",
                    "shard_ids": list(range(12)), "shard_size": 4096}}]}})
st = json.loads(urllib.request.urlopen(
    f"http://{{m.url}}/maintenance/status").read())
assert st["volumes"]["5"]["state"] == "degraded", st
got = post("/maintenance/tick", {{"wait": True}})
assert [a["vid"] for a in got["actions"]] == [5], got
assert m.maintenance.history[-1]["outcome"].startswith("error")
assert post("/maintenance/convert", {{"volumes": [5], "tick": True}})
ap = post("/cluster/autopilot", {{"tick": True}})
assert ap["status"]["ticks"] == 1 and ap["status"]["actuator_calls"] == 0
run(m.stop())
bad = [k for k in sys.modules if k.split(".")[0] in ("jax", "torch",
                                                     "seaweedfs_tpu")]
assert not bad, bad
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_heal_books_repair_class_bytes(tmp_path, monkeypatch):
    """Twin of tests/test_flight_recorder.py's on two port nodes under
    the port's master: a planner-driven heal books its survivor traffic
    as class repair, at least one shard's worth."""
    from seaweedfs_tpu.client import WeedClient
    from seaweedfs_tpu.shell.commands import CommandEnv, run_command
    from seaweedfs_tpu_torch.stats import netflow
    from tests.test_torch_master import call
    from tests.test_torch_master_cluster import Cluster
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "0")
    monkeypatch.setenv("WEEDTPU_AGG_INTERVAL", "0")
    monkeypatch.setenv("WEEDTPU_REPAIR_INTERVAL", "0")
    c = Cluster(tmp_path, n_volume_servers=2).start()
    try:
        c.wait_heartbeats()
        client = WeedClient(c.master.url)
        rng = np.random.default_rng(9)
        fids = [client.upload(rng.integers(0, 256, 50_000,
                                           dtype=np.uint8).tobytes(),
                              name=f"hb{i}.bin") for i in range(12)]
        vid = int(fids[0].partition(",")[0])
        time.sleep(0.7)
        env = CommandEnv(c.master.url)
        out = io.StringIO()
        run_command(env, "lock", out)
        run_command(env, f"ec.encode -volumeId {vid}", out)
        run_command(env, "unlock", out)
        time.sleep(0.7)
        client.close()
        shard_size = next(
            loc.ec_volumes[vid].shard_size
            for vs in c.volume_servers for loc in vs.store.locations
            if vid in loc.ec_volumes)
        dropped = 0
        for vs in c.volume_servers:
            held = sorted(s for loc in vs.store.locations
                          if vid in loc.ec_volumes
                          for s in loc.ec_volumes[vid].shard_ids())
            if held and dropped < 2:
                call(vs.url, "/admin/ec/delete_shards",
                     body={"volume": vid, "shards": [held[0]]})
                dropped += 1
        assert dropped == 2
        deadline = time.time() + 10
        while time.time() < deadline:
            st = call(c.master.url, "/maintenance/status")[1]
            if len(st["volumes"].get(str(vid), {})
                   .get("shards_missing", [])) == 2:
                break
            time.sleep(0.1)
        b0 = netflow.class_total("recv", "repair")
        assert call(c.master.url, "/maintenance/tick",
                    body={"wait": True})[0] == 200
        deadline = time.time() + 20
        while time.time() < deadline:
            v = call(c.master.url, "/maintenance/status")[1][
                "volumes"].get(str(vid), {})
            if v.get("state") == "healthy" and \
                    len(v.get("shards_present", [])) == 14:
                break
            time.sleep(0.1)
        assert v.get("state") == "healthy", v
        moved = netflow.class_total("recv", "repair") - b0
        assert moved >= shard_size, (moved, shard_size)
    finally:
        c.stop()


def test_maintenance_round_ticks_the_three_loops(monkeypatch):
    """One round of the background loop, driven by hand with the repair
    interval off: the planner's, the scheduler's and the autopilot's
    ticks run through the loop monitor (/cluster/loops lists repair,
    convert and autopilot, no error), in the reference's order."""
    from tests.test_torch_master import Loop, call
    monkeypatch.setenv("WEEDTPU_REPAIR_INTERVAL", "0")
    monkeypatch.setenv("WEEDTPU_AGG_INTERVAL", "0")
    lp = Loop()
    m = mastermod.MasterServer("127.0.0.1", free_port())
    lp.run(m.start())
    try:
        assert lp.run(asyncio.sleep(0, m._repair_task.done()))
        tasks = lp.run(m.maintenance_round())
        assert tasks == [m._convert_task, m._autopilot_task]
        lp.run(asyncio.wait(tasks))
        loops = call(m.url, "/cluster/loops")[1]["loops"]
        assert {"repair", "convert", "autopilot"} <= set(loops)
        assert all(loops[n]["ticks"] == 1 and not loops[n]["errors"]
                   for n in ("repair", "convert", "autopilot")), loops
        assert m.autopilot.ticks == 1
    finally:
        lp.run(m.stop())
        lp.close()
