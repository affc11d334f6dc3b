"""The port's fleet-conversion scheduler
(seaweedfs_tpu_torch/maintenance/convert.py) held to the reference's on
the CPU.

Each unit case drives both packages' `ConvertScheduler` over the same
stub master (tests/test_fleet_convert.py's stubs: a placement, firing
alerts, the repair planner's active nodes and a recording HTTP session)
through the same ticks, and compares the actions, the session's calls
and `status()` with ``==``; only the backoff's jittered retry times are
left out.  Then twins of tests/test_fleet_convert.py's scheduler tests,
of tests/test_interference.py's pause cases, of tests/test_autopilot.py's
seal-retry and re-queue cases, and a cluster case: the port's master
converting and sealing volumes on a port volume server (`device="cpu"`).
"""

import asyncio
import os
import types

import numpy as np
import pytest

from seaweedfs_tpu.maintenance import convert as ref_convert
from seaweedfs_tpu.maintenance import repair as ref_repair
from seaweedfs_tpu.stats import interference as ref_itf
from seaweedfs_tpu.stats import metrics as ref_metrics

from seaweedfs_tpu_torch.maintenance import convert, repair
from seaweedfs_tpu_torch.stats import interference as itf
from seaweedfs_tpu_torch.stats import metrics, netflow
from tests.test_fleet_convert import (_StubMaster, _StubResp,
                                      _shard_bytes)

PKGS = {"ref": ref_convert, "port": convert}


@pytest.fixture(autouse=True)
def _switches(monkeypatch):
    for var in ("WEEDTPU_CONVERT_PAUSE_ALERTS", "WEEDTPU_GOVERNOR",
                "WEEDTPU_INTERFERENCE"):
        monkeypatch.delenv(var, raising=False)
    for mod in (itf, ref_itf):
        monkeypatch.setattr(mod, "_enabled_cache", (0.0, True))


@pytest.fixture()
def frozen(monkeypatch):
    """One still clock for both packages' schedulers and buckets, so
    their token refills match."""
    clock = types.SimpleNamespace(monotonic=lambda: 5000.0,
                                  time=lambda: 1.7e9)
    for mod in (convert, repair, ref_convert, ref_repair):
        monkeypatch.setattr(mod, "time", clock)


def _tick(sched):
    return asyncio.run(sched.tick())


def _status(sched) -> dict:
    st = sched.status()
    st["backoffs"] = {v: b["failures"] for v, b in st["backoffs"].items()}
    st["history"] = _actions(st["history"])
    return st


def _actions(actions) -> list:
    return [{k: v for k, v in a.items() if k != "seconds"}
            for a in actions]


def _both(make_master, script, **kw):
    """Run `script(sched, master)` (a list of steps, each returning
    something comparable) on both packages over fresh stub masters."""
    out = {}
    for name, mod in PKGS.items():
        master = make_master()
        sched = mod.ConvertScheduler(master, **kw)
        out[name] = (script(sched, master), _status(sched),
                     master._session.calls)
    assert out["port"] == out["ref"]
    return out["port"]


# ---- equality over scripted ticks ----------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_grouping_and_pacing_equal_reference(seed, frozen):
    """A seeded placement, queue and bucket: the node batches, the
    volumes each tick launches and the queue left behind are the
    reference's, tick by tick."""
    rng = np.random.default_rng(seed)
    placement = {f"n{i}:80": sorted(int(v) for v in rng.choice(
        np.arange(1 + 20 * i, 20 * (i + 1)), int(rng.integers(1, 8)),
        replace=False)) for i in range(int(rng.integers(2, 5)))}
    vids = [v for vs in placement.values() for v in vs]
    queue = [int(v) for v in rng.permutation(vids + [999, 998])]
    batch = int(rng.integers(1, 4))
    burst = float(rng.integers(2, 9))
    active = {url: 1 for url in placement if rng.random() < 0.3}

    def script(sched, master):
        steps = [sched.enqueue(queue[: len(queue) // 2]),
                 sched.enqueue(queue[len(queue) // 2:] + ["x", None])]
        for i in range(4):
            if i == 2:
                master.maintenance._active_nodes = {}
            steps.append((_actions(_tick(sched)), list(sched.queued),
                          sched.converted))
        return steps

    _both(lambda: _StubMaster(placement, active_nodes=active), script,
          rate=0.0, burst=burst, node_batch=batch)


def test_requeue_backoff_and_recovery_equal_reference(frozen):
    def script(sched, master):
        sched.enqueue([5, 6])
        steps = [_actions(_tick(sched)), _actions(_tick(sched))]
        master._session.fail = False
        sched._backoff = {v: (f, 0.0) for v, (f, _) in
                          sched._backoff.items()}
        steps.append(_actions(_tick(sched)))
        return steps

    got, st, _ = _both(lambda: _StubMaster({"n1:80": [5, 6]}, fail=True),
                       script, rate=100.0, burst=100.0)
    assert got[0][0]["outcome"].startswith("error") and got[1] == []
    assert got[2][0]["outcome"] == "ok" and st["converted"] == 2
    assert st["requeued"] == {"total": 2, "by_reason": {"node_error": 2},
                              "parked": []}


def test_skipped_volumes_requeue_equal_reference(frozen):
    """A node that answers but converts only part of the batch: the
    rest re-queue under reason `skipped`."""
    class Partial:
        def __init__(self):
            self.calls = []

        def post(self, url, json=None, timeout=None):
            self.calls.append((url, json))
            return _StubResp(payload={"converted": json["volumes"][:1],
                                      "bytes": 1, "wall_s": 0.1})

    def master():
        m = _StubMaster({"n1:80": [3, 4]})
        m._session = Partial()
        return m

    got, st, _ = _both(master, lambda s, m: (s.enqueue([3, 4]),
                                             _actions(_tick(s))),
                       rate=100.0, burst=100.0)
    assert st["requeued"]["by_reason"] == {"skipped": 1}
    assert st["queued"] == [4] and st["converted"] == 1


@pytest.mark.parametrize("firing,governed,switch", [
    (("interference_high",), False, "1"),
    (("interference_high",), True, "1"),
    (("interference_high",), True, "0"),
    (("interference_high", "disk_full_soon"), True, "1"),
    (("no_interference_baseline",), False, "1"),
    ((), True, "1"),
])
def test_pause_by_alert_equal_reference(firing, governed, switch,
                                        monkeypatch, frozen):
    monkeypatch.setenv("WEEDTPU_GOVERNOR", switch)

    def master():
        m = _StubMaster({"n1:80": [4]}, firing=firing)
        if governed:
            m.governor = types.SimpleNamespace(
                INTERFERENCE_ALERT="interference_high")
        return m

    got, st, calls = _both(master, lambda s, m: (s.enqueue([4]),
                                                 _actions(_tick(s))),
                           rate=100.0, burst=100.0)
    assert (st["paused"] is None) == bool(got[1])


def test_pause_alert_list_knob_equal_reference(monkeypatch, frozen):
    monkeypatch.setenv("WEEDTPU_CONVERT_PAUSE_ALERTS", " a , b,,")
    st = _both(lambda: _StubMaster({"n1:80": [4]}, firing=("b",)),
               lambda s, m: (s.enqueue([4]), _actions(_tick(s))))[1]
    assert st["pause_alerts"] == ["a", "b"] and st["paused"] == "b"


class _SealSession:
    """fleet_convert converts everything; the first `fail_deletes`
    /admin/volume/delete hops die."""

    def __init__(self, fail_deletes=1, fail_mounts=0):
        self.fail_deletes = fail_deletes
        self.fail_mounts = fail_mounts
        self.calls = []

    def post(self, url, json=None, timeout=None):
        self.calls.append((url, json))
        if "fleet_convert" in url:
            return _StubResp(payload={"converted": json["volumes"],
                                      "bytes": 1, "wall_s": 0.1})
        if "volume/delete" in url and self.fail_deletes:
            self.fail_deletes -= 1
            raise OSError("delete hop died")
        if "ec/mount" in url and self.fail_mounts:
            self.fail_mounts -= 1
            return _StubResp(status=500, payload={"error": "no"})
        return _StubResp(payload={})


@pytest.mark.parametrize("fail_deletes,fail_mounts", [(0, 0), (1, 0),
                                                      (2, 0), (0, 1)])
def test_seal_and_seal_retry_equal_reference(fail_deletes, fail_mounts,
                                             frozen):
    """Sealed conversions mount and delete; a failed hop parks the vid
    on `seal_stuck` and later ticks retry it until the .dat is gone."""
    def master():
        m = _StubMaster({"n1:80": [7, 8]})
        m._session = _SealSession(fail_deletes, fail_mounts)
        return m

    def script(sched, m):
        steps = [sched.enqueue([7], seal=True), sched.enqueue([8])]
        for _ in range(3):
            steps.append((_actions(_tick(sched)), _status(sched)))
        return steps

    got, st, calls = _both(master, script, rate=100.0, burst=100.0)
    assert st["seal_stuck"] == [] and st["sealing"] == []
    assert [c[0] for c in calls].count(
        "http://n1:80/admin/volume/delete") == 1 + fail_deletes


def test_constants_are_the_references_defaults():
    mine = convert.ConvertScheduler(types.SimpleNamespace())
    ref = ref_convert.ConvertScheduler(types.SimpleNamespace())
    assert (mine.bucket.rate, mine.bucket.burst, mine.node_batch,
            mine.pause_alerts) == (ref.bucket.rate, ref.bucket.burst,
                                   ref.node_batch, ref.pause_alerts)
    assert (convert.RATE, convert.BURST, convert.NODE_BATCH) == (
        2.0, 8.0, 4)
    ref_m, m = ref_metrics.CONVERT_REQUEUED, metrics.CONVERT_REQUEUED
    assert (m.name, m.help, m.label_names, m.kind) == \
        (ref_m.name, ref_m.help, ref_m.label_names, ref_m.kind)


# ---- twins of the reference's scheduler tests -----------------------------------

def test_scheduler_groups_paces_and_converts():
    """Twin of tests/test_fleet_convert.py's."""
    master = _StubMaster({"n1:80": [1, 2, 3], "n2:80": [7]})
    sched = convert.ConvertScheduler(master, rate=100.0, burst=100.0,
                                     node_batch=2)
    assert sched.enqueue([1, 2, 3, 7, 7, "x"]) == [1, 2, 3, 7]
    actions = _tick(sched)
    by_node = {a["node"]: a for a in actions}
    assert sorted(by_node) == ["n1:80", "n2:80"]
    assert by_node["n1:80"]["volumes"] == [1, 2]
    assert by_node["n1:80"]["outcome"] == "ok"
    assert sched.queued == [3] and sched.converted == 3
    assert _tick(sched)[0]["volumes"] == [3]
    assert not sched.queued and not sched.active


def test_scheduler_yields_to_active_repair_and_drops_unplaceable():
    master = _StubMaster({"n1:80": [8]}, active_nodes={"n1:80": 1})
    sched = convert.ConvertScheduler(master, rate=100.0, burst=100.0)
    sched.enqueue([8, 99])
    assert _tick(sched) == []
    assert sched.queued == [8]
    assert any(h.get("outcome") == "unplaceable" and h["vid"] == 99
               for h in sched.history)
    master.maintenance._active_nodes = {}
    assert _tick(sched)[0]["outcome"] == "ok"


def _pause_sched(firing, governor=False):
    class Alerts:
        def status(self):
            return {"rules": [{"name": n, "state": "firing"}
                              for n in firing]}
    m = types.SimpleNamespace(alerts=Alerts())
    if governor:
        m.governor = types.SimpleNamespace(
            INTERFERENCE_ALERT="interference_high")
    return convert.ConvertScheduler(m)


def test_pause_alert_exact_name_not_substring():
    """Twin of tests/test_interference.py's."""
    assert _pause_sched(["no_interference_baseline"])._paused_by_alert() \
        is None
    assert _pause_sched(["interference_high"])._paused_by_alert() == \
        "interference_high"
    assert _pause_sched(["disk_full_soon"])._paused_by_alert() == \
        "disk_full_soon"


def test_governor_supersedes_interference_pause(monkeypatch):
    """Twin of tests/test_interference.py's."""
    s = _pause_sched(["interference_high"], governor=True)
    assert s._paused_by_alert() is None
    s = _pause_sched(["interference_high", "disk_full_soon"], governor=True)
    assert s._paused_by_alert() == "disk_full_soon"
    monkeypatch.setenv("WEEDTPU_GOVERNOR", "0")
    s = _pause_sched(["interference_high"], governor=True)
    assert s._paused_by_alert() == "interference_high"


def test_seal_stuck_retries_until_dat_deleted():
    """Twin of tests/test_autopilot.py's."""
    master = _StubMaster({"n1:80": [7]})
    master._session = _SealSession()
    sched = convert.ConvertScheduler(master, rate=100.0, burst=100.0)
    sched.enqueue([7], seal=True)
    rec = _tick(sched)[0]
    assert rec["outcome"] == "ok" and "sealed" not in rec
    assert sched.status()["seal_stuck"] == [7]
    _tick(sched)
    assert sched.status()["seal_stuck"] == []
    assert sched.status()["sealing"] == []
    assert [c[0] for c in master._session.calls].count(
        "http://n1:80/admin/volume/delete") == 2


def test_convert_requeue_surface():
    """Twin of tests/test_autopilot.py's."""
    def requeued_total():
        return sum(child.value for _, child in
                   metrics.CONVERT_REQUEUED._pairs())

    before = requeued_total()
    master = _StubMaster({"n1:80": [1, 2]}, fail=True)
    sched = convert.ConvertScheduler(master, rate=100.0, burst=100.0)
    sched.enqueue([1, 2])
    assert _tick(sched)[0]["outcome"].startswith("error")
    st = sched.status()
    assert st["requeued"]["total"] == 2
    assert st["requeued"]["by_reason"] == {"node_error": 2}
    assert sorted(st["requeued"]["parked"]) == [1, 2]
    assert sorted(st["queued"]) == [1, 2]
    assert requeued_total() - before == 2.0


# ---- the port's master over a port node -------------------------------------------

def test_master_converts_and_seals_on_a_port_node(tmp_path, monkeypatch):
    """/maintenance/convert on the port's master: queued volumes go to
    their port node in one /admin/ec/fleet_convert batch (booked as
    class convert), each sealed (the shard set mounted and serving, the
    .dat gone), and every blob reads back through the EC path."""
    from seaweedfs_tpu.client import WeedClient
    from tests.test_torch_master import call
    from tests.test_torch_master_cluster import Cluster
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "0")
    monkeypatch.setenv("WEEDTPU_AGG_INTERVAL", "0")
    monkeypatch.setenv("WEEDTPU_REPAIR_INTERVAL", "0")
    c = Cluster(tmp_path, n_volume_servers=1).start()
    try:
        c.wait_heartbeats()
        client = WeedClient(c.master.url)
        rng = np.random.default_rng(0xC0)
        blobs = {}
        for i in range(10):
            data = rng.integers(0, 256, int(rng.integers(5_000, 30_000)),
                                dtype=np.uint8).tobytes()
            blobs[client.upload(data, name=f"c{i}.bin")] = data
        vs = c.volume_servers[0]
        vids = sorted({int(f.partition(",")[0]) for f in blobs})
        for v in vids:
            vs.store.get_volume(v).nm.flush()
        recv0 = netflow.class_total("recv", "convert")
        st, got = call(c.master.url, "/maintenance/convert",
                       body={"volumes": vids, "seal": True, "tick": True})
        assert st == 200, got
        assert got["accepted"] == vids
        assert [a["outcome"] for a in got["actions"]] == ["ok"]
        assert got["actions"][0]["sealed"] == vids
        status = got["status"]
        assert status["converted"] == len(vids) and not status["queued"]
        assert status["sealing"] == [] and status["seal_stuck"] == []
        assert netflow.class_total("recv", "convert") > recv0
        for v in vids:
            assert vs.store.get_volume(v) is None
            ev = vs.store.get_ec_volume(v)
            assert ev is not None
            assert sorted(_shard_bytes(ev.base)) == list(range(14))
            assert not os.path.exists(ev.base + ".dat")
        assert call(c.master.url, "/maintenance/convert")[1] == status
        client._vid_cache.clear()
        import time
        time.sleep(0.7)
        for fid, data in blobs.items():
            assert client.download(fid) == data
        client.close()
    finally:
        c.stop()
