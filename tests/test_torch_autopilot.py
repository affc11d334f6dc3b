"""The port's autopilot (seaweedfs_tpu_torch/maintenance/autopilot.py) held
to the reference's on the CPU.

Each case is a twin of a test of tests/test_autopilot.py (whole) or of
tests/test_codecs.py's codec_select cases, run on both packages from
one stub master (that file's `_StubMaster`: a scripted ledger, heat
view, forecast and topology) with one patched clock (`time` in each
package's autopilot and repair modules): the plans each tick creates,
serialized, and `status()` are compared with ``==``, leaving out each
plan's trace id (a fresh random root).  Chunk promotion runs against a
stub filer member and a stub `/__hot__/seed`, `RendezvousRing.home`
against the reference's ring.  Then the cluster cases on port nodes
(`device="cpu"`) under the port's master: the tiering round trip, the
volume move, the autopilot's headline and the heat headline in
/maintenance/status.
"""

import asyncio
import glob
import io
import json
import os
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from seaweedfs_tpu.maintenance import autopilot as ref_autopilot
from seaweedfs_tpu.maintenance import repair as ref_repair
from seaweedfs_tpu.stats import metrics as ref_metrics
from seaweedfs_tpu.utils import hashring as ref_hashring

from seaweedfs_tpu_torch.maintenance import autopilot, repair
from seaweedfs_tpu_torch.stats import metrics
from seaweedfs_tpu_torch.utils import hashring
from tests.test_autopilot import (_StubMaster, _StubNode, _StubVol,
                                  _heat_view)

PKGS = {"ref": ref_autopilot, "port": autopilot}


class Clock:
    """One clock for both packages: wall time and monotonic time move
    together, by hand."""

    def __init__(self, now=1_700_000_000.0):
        self.now = now

    def time(self):
        return self.now

    def monotonic(self):
        return self.now - 1_699_000_000.0


@pytest.fixture()
def clock(monkeypatch):
    c = Clock()
    fake = types.SimpleNamespace(time=c.time, monotonic=c.monotonic)
    for mod in (autopilot, repair, ref_autopilot, ref_repair):
        monkeypatch.setattr(mod, "time", fake)
    return c


def _tick(ap):
    async def run():
        plans = await ap.tick()
        await ap.wait_idle()
        return plans
    return asyncio.run(run())


def _plans(plans):
    return [{k: v for k, v in p.items() if k != "trace_id"} for p in plans]


def _status(ap):
    st = ap.status()
    st["plans"] = _plans(st["plans"])
    return st


def _both(scenario, **kw):
    """Run `scenario(mod, ap, master)` on both packages, each over its
    own stub master from `make()`; the results, serialized, must be
    equal."""
    out = {}
    for name, mod in PKGS.items():
        out[name] = scenario(mod)
    assert out["port"] == out["ref"]
    return out["port"]


# ---- mode and state machine --------------------------------------------------

def test_mode_parsing(monkeypatch):
    """Twin of tests/test_autopilot.py's, but a value the reference
    reads as `plan` raises in the port."""
    for raw, want in (("plan", "plan"), ("execute", "execute"),
                      ("0", "0"), ("off", "0"), ("", "plan"),
                      ("EXECUTE", "execute"), ("No", "0")):
        monkeypatch.setenv("WEEDTPU_AUTOPILOT", raw)
        assert autopilot.autopilot_mode() == want == \
            ref_autopilot.autopilot_mode()
    monkeypatch.delenv("WEEDTPU_AUTOPILOT")
    assert autopilot.autopilot_mode() == "plan"


def test_unknown_mode_raises_unlike_the_reference(monkeypatch):
    monkeypatch.setenv("WEEDTPU_AUTOPILOT", "bogus")
    assert ref_autopilot.autopilot_mode() == "plan"
    with pytest.raises(ValueError, match="WEEDTPU_AUTOPILOT"):
        autopilot.autopilot_mode()


def test_plan_state_machine(monkeypatch, clock):
    monkeypatch.setenv("WEEDTPU_AUTOPILOT", "plan")

    def scenario(mod):
        m = _StubMaster()
        ap = mod.Autopilot(m, cold_s=0.0, cooldown_s=0.0)
        seen = []

        async def run():
            plan = ap._new_plan("tiering_demote", 7, reason={"rps": 0})
            pid = plan["id"]
            assert plan["state"] == "planned" and plan["trace_id"]
            assert ap.abort(pid)["state"] == "aborted"
            for fn in (ap.abort, ap.approve):
                with pytest.raises(ValueError):
                    fn(pid)
            with pytest.raises(KeyError):
                ap.approve("nope")
            p2 = ap._new_plan("tiering_demote", 8, reason={})
            ap.approve(p2["id"])
            await ap.wait_idle()
            assert p2["state"] == "done"
            with pytest.raises(ValueError):
                ap.abort(p2["id"])
            seen.append(ap.serialize_plan(p2))

        asyncio.run(run())
        assert m.convert.enqueued == [([8], True)]
        assert ap.actuator_calls == 1
        return _plans(seen), _status(ap)

    _both(scenario)


def test_abort_after_approve_prevents_execution(monkeypatch, clock):
    monkeypatch.setenv("WEEDTPU_AUTOPILOT", "plan")

    def scenario(mod):
        m = _StubMaster()
        ap = mod.Autopilot(m, cooldown_s=0.0)

        async def run():
            plan = ap._new_plan("tiering_demote", 5, reason={})
            ap.approve(plan["id"])
            ap.abort(plan["id"])
            await ap.wait_idle()
            assert plan["state"] == "aborted"

        asyncio.run(run())
        assert ap.actuator_calls == 0 and m.convert.enqueued == []
        return _status(ap)

    _both(scenario)


def test_plan_only_mode_provably_executes_nothing(monkeypatch, clock):
    monkeypatch.setenv("WEEDTPU_AUTOPILOT", "plan")

    def scenario(mod):
        ledger = {1: {"vid": 1, "kind": "normal", "state": "healthy",
                      "collection": ""}}
        m = _StubMaster(ledger=ledger, heat=_heat_view([]),
                        disks=[{"vs": "n1:80", "dir": "/d",
                                "predicted_full_seconds": 60.0}],
                        nodes=[_StubNode("n1:80", {1: _StubVol(),
                                                   2: _StubVol()}),
                               _StubNode("n2:80", {})])
        ap = mod.Autopilot(m, cold_rps=10.0, cold_s=0.0, cooldown_s=0.0,
                           horizon_s=3600.0)
        plans = _tick(ap)
        assert {p["policy"] for p in plans} == \
            {"tiering_demote", "balance_move"}
        assert ap.actuator_calls == 0 and m.convert.enqueued == []
        again = _tick(ap)
        assert again == [] and ap.actuator_calls == 0
        return _plans(plans), _status(ap)

    _both(scenario)


def test_off_mode_plans_nothing(monkeypatch, clock):
    monkeypatch.setenv("WEEDTPU_AUTOPILOT", "0")

    def scenario(mod):
        m = _StubMaster(ledger={1: {"vid": 1, "kind": "normal",
                                    "state": "healthy"}})
        ap = mod.Autopilot(m, cold_s=0.0)
        assert _tick(ap) == []
        assert not ap.plans and ap.actuator_calls == 0
        return _status(ap)

    _both(scenario)


# ---- hysteresis ---------------------------------------------------------------

def test_cold_clock_resets_on_warm_sighting(monkeypatch, clock):
    monkeypatch.setenv("WEEDTPU_AUTOPILOT", "plan")
    t0 = clock.now

    def scenario(mod):
        clock.now = t0
        ledger = {3: {"vid": 3, "kind": "normal", "state": "healthy",
                      "collection": ""}}
        m = _StubMaster(ledger=ledger, heat=_heat_view([]))
        ap = mod.Autopilot(m, cold_rps=0.5, cold_s=30.0, cooldown_s=0.0)
        steps = [_tick(ap)]
        assert 3 in ap._cold_since
        m._heat = _heat_view([{"key": "3", "rps": 2.0, "sustained_s": 5}])
        clock.now += 10
        steps.append(_tick(ap))
        assert 3 not in ap._cold_since
        m._heat = _heat_view([])
        clock.now += 10
        steps.append(_tick(ap))
        clock.now += 31
        plans = _tick(ap)
        assert [p["policy"] for p in plans] == ["tiering_demote"]
        assert plans[0]["reason"]["cold_for_s"] >= 30.0
        return steps, _plans(plans), _status(ap)

    _both(scenario)


def test_promote_requires_sustained_heat_and_cooldown(monkeypatch, clock):
    monkeypatch.setenv("WEEDTPU_AUTOPILOT", "plan")

    def scenario(mod):
        shard_locs = {str(s): ["n1:80"] for s in range(14)}
        ledger = {9: {"vid": 9, "kind": "ec", "state": "healthy",
                      "collection": "", "shard_locations": shard_locs}}
        m = _StubMaster(ledger=ledger, heat=_heat_view(
            [{"key": "9", "rps": 50.0, "sustained_s": 3.0}]))
        ap = mod.Autopilot(m, hot_rps=5.0, hot_s=60.0, cooldown_s=100.0)
        assert _tick(ap) == []
        m._heat = _heat_view([{"key": "9", "rps": 50.0,
                               "sustained_s": 120.0}])
        plans = _tick(ap)
        assert [p["policy"] for p in plans] == ["tiering_promote"]
        assert plans[0]["node"] == "n1:80"
        ap.plans.clear()
        ap._last_action[9] = (clock.time(), "tiering_promote")
        assert _tick(ap) == []
        return _plans(plans), _status(ap)

    _both(scenario)


def test_promote_needs_k_shards_on_one_node(monkeypatch, clock):
    monkeypatch.setenv("WEEDTPU_AUTOPILOT", "plan")

    def scenario(mod):
        spread = {str(s): [f"n{s % 3}:80"] for s in range(14)}
        ledger = {4: {"vid": 4, "kind": "ec", "state": "healthy",
                      "shard_locations": spread}}
        m = _StubMaster(ledger=ledger, heat=_heat_view(
            [{"key": "4", "rps": 50.0, "sustained_s": 999.0}]))
        ap = mod.Autopilot(m, hot_rps=1.0, hot_s=0.0, cooldown_s=0.0)
        assert _tick(ap) == []
        assert ap.promote_blocked_spread == 1
        return _status(ap)

    _both(scenario)


def test_demote_skips_convert_backlog(monkeypatch, clock):
    monkeypatch.setenv("WEEDTPU_AUTOPILOT", "plan")

    def scenario(mod):
        ledger = {5: {"vid": 5, "kind": "normal", "state": "healthy"},
                  6: {"vid": 6, "kind": "normal", "state": "healthy"}}
        m = _StubMaster(ledger=ledger, heat=_heat_view([]))
        m.convert._backoff = {5: (2, 0.0)}
        ap = mod.Autopilot(m, cold_rps=1.0, cold_s=0.0, cooldown_s=0.0)
        plans = _tick(ap)
        assert [p["vid"] for p in plans] == [6]
        return _plans(plans)

    _both(scenario)


# ---- balancing -----------------------------------------------------------------

def test_balancing_moves_coldest_single_copy_volume(monkeypatch, clock):
    monkeypatch.setenv("WEEDTPU_AUTOPILOT", "plan")

    def scenario(mod):
        vols = {1: _StubVol(size=100), 2: _StubVol(size=10_000),
                3: _StubVol(size=500, replica_placement="001")}
        m = _StubMaster(
            ledger={}, heat=_heat_view(
                [{"key": "1", "rps": 40.0, "sustained_s": 5.0}]),
            disks=[{"vs": "full:80", "dir": "/d1",
                    "predicted_full_seconds": 120.0}],
            nodes=[_StubNode("full:80", vols),
                   _StubNode("roomy:80", {}, free_slots=8),
                   _StubNode("alsofull:80", {}, free_slots=2)])
        m.forecaster._disks.append({"vs": "alsofull:80", "dir": "/d",
                                    "predicted_full_seconds": 200.0})
        ap = mod.Autopilot(m, cold_rps=0.0, horizon_s=3600.0,
                           cooldown_s=0.0)
        moves = [p for p in _tick(ap) if p["policy"] == "balance_move"]
        assert [(p["vid"], p["source"], p["target"]) for p in moves] == \
            [(2, "full:80", "roomy:80")]
        assert moves[0]["reason"]["predicted_full_seconds"] == 120.0
        return _plans(moves)

    _both(scenario)


# ---- codec selection (twins of tests/test_codecs.py's) ----------------------

def _codec_ledger(codec="rs_10_4", state="healthy", n=14):
    locs = {str(s): ["n1:80"] for s in range(n)}
    return {"kind": "ec", "state": state, "codec": codec,
            "collection": "", "shard_locations": locs}


def test_codec_select_bands(monkeypatch, clock):
    monkeypatch.setenv("WEEDTPU_AUTOPILOT", "plan")

    def scenario(mod):
        ledger = {1: dict(_codec_ledger(), vid=1),
                  2: dict(_codec_ledger(), vid=2),
                  3: dict(_codec_ledger(), vid=3),
                  4: dict(_codec_ledger(state="degraded"), vid=4),
                  5: dict(_codec_ledger(codec="lrc_10_2_2"), vid=5)}
        ap = mod.Autopilot(_StubMaster(ledger=ledger), hot_rps=5.0,
                           hot_s=120.0, cold_rps=0.2, cold_s=0.0,
                           cooldown_s=0.0)
        heat = {1: {"rps": 50.0, "sustained_s": 500.0},
                3: {"rps": 1.0, "sustained_s": 0.0},
                5: {"rps": 50.0, "sustained_s": 500.0}}
        plans = {p["vid"]: p for p in
                 ap._plan_codec_select(clock.time(), heat, ledger)}
        assert (plans[1]["from_codec"], plans[1]["to_codec"],
                plans[1]["reason"]["band"]) == ("rs_10_4", "lrc_10_2_2",
                                                "hot")
        assert (plans[2]["to_codec"], plans[2]["reason"]["band"]) == \
            ("msr_9_16", "cold")
        assert set(plans) == {1, 2}
        return _plans(ap.serialize_plan(p) for p in plans.values())

    _both(scenario)


def test_codec_select_cold_clock_resets_on_warm_sighting(monkeypatch,
                                                         clock):
    monkeypatch.setenv("WEEDTPU_AUTOPILOT", "plan")

    def scenario(mod):
        ledger = {7: dict(_codec_ledger(), vid=7)}
        ap = mod.Autopilot(_StubMaster(ledger=ledger), cold_rps=0.5,
                           cold_s=30.0, cooldown_s=0.0)
        now = clock.time()
        assert ap._plan_codec_select(now, {}, ledger) == []
        assert 7 in ap._codec_cold_since
        warm = {7: {"rps": 2.0, "sustained_s": 5.0}}
        assert ap._plan_codec_select(now, warm, ledger) == []
        assert 7 not in ap._codec_cold_since
        assert ap._plan_codec_select(now, {}, ledger) == []
        ap._codec_cold_since[7] -= 31.0
        plans = ap._plan_codec_select(now, {}, ledger)
        assert [p["to_codec"] for p in plans] == ["msr_9_16"]
        return _plans(ap.serialize_plan(p) for p in plans)

    _both(scenario)


def test_codec_select_plan_only_executes_nothing(monkeypatch, clock):
    monkeypatch.setenv("WEEDTPU_AUTOPILOT", "plan")

    def scenario(mod):
        ledger = {2: dict(_codec_ledger(), vid=2)}
        m = _StubMaster(ledger=ledger, heat={})
        ap = mod.Autopilot(m, cold_rps=0.2, cold_s=0.0, cooldown_s=0.0)
        sel = [p for p in _tick(ap) if p["policy"] == "codec_select"]
        assert [(p["from_codec"], p["to_codec"], p["node"]) for p in sel] \
            == [("rs_10_4", "msr_9_16", "n1:80")]
        assert ap.actuator_calls == 0 and m.convert.enqueued == []
        assert [p for p in _tick(ap) if p["policy"] == "codec_select"] \
            == []
        return _plans(sel), _status(ap)

    _both(scenario)


def test_codec_select_spread_volume_is_counted_not_silent(monkeypatch,
                                                          clock):
    monkeypatch.setenv("WEEDTPU_AUTOPILOT", "plan")

    def scenario(mod):
        spread = dict(_codec_ledger(), vid=9)
        spread["shard_locations"] = {str(s): [f"n{s}:80"]
                                     for s in range(14)}
        ledger = {9: spread}
        ap = mod.Autopilot(_StubMaster(ledger=ledger), cold_rps=0.2,
                           cold_s=0.0, cooldown_s=0.0)
        assert ap._plan_codec_select(clock.time(), {}, ledger) == []
        assert ap.status()["recode_blocked_spread"] == 1
        return _status(ap)

    _both(scenario)


def test_codec_rate_knob_turns_codec_select_off(monkeypatch, clock):
    """WEEDTPU_AUTOPILOT_CODEC_RATE=0 (chip_smoke's phase 22 sets it):
    no codec_select plan, as in the reference."""
    monkeypatch.setenv("WEEDTPU_AUTOPILOT", "plan")
    monkeypatch.setenv("WEEDTPU_AUTOPILOT_CODEC_RATE", "0")

    def scenario(mod):
        ledger = {2: dict(_codec_ledger(), vid=2)}
        ap = mod.Autopilot(_StubMaster(ledger=ledger, heat={}),
                           cold_s=0.0)
        return _plans(_tick(ap)), ap.buckets["codec"].rate

    assert _both(scenario) == ([], 0.0)


# ---- executions, seeded --------------------------------------------------------

class _Session:
    """Answers the actuators' POSTs (post_json's shape) and records
    them; `fail` names paths that answer 500."""

    def __init__(self, fail=()):
        self.calls = []
        self.fail = tuple(fail)

    def post(self, url, json=None, timeout=None):
        from tests.test_fleet_convert import _StubResp
        self.calls.append((url, json))
        if any(url.endswith(p) for p in self.fail):
            return _StubResp(status=500, payload={"error": "nope"})
        if url.endswith("/admin/volume/unconvert"):
            return _StubResp(payload={"decoded": True, "thawed": True})
        if url.endswith("/admin/volume/move"):
            return _StubResp(payload={"crc": 7, "target": json["target"]})
        if url.endswith("/admin/ec/recode"):
            return _StubResp(payload={"codec": json["codec"],
                                      "from": "rs_10_4",
                                      "shards": list(range(14))})
        if url.endswith("/__hot__/seed"):
            return _StubResp(payload={"seeded": len(json["fids"]),
                                      "skipped": 0})
        return _StubResp(payload={})


@pytest.mark.parametrize("fail", [(), ("/admin/ec/delete_shards",),
                                  ("/admin/volume/unconvert",
                                   "/admin/volume/move",
                                   "/admin/ec/recode", "/__hot__/seed")])
def test_every_policy_planned_and_executed_equal_reference(
        fail, monkeypatch, clock):
    """One master whose telemetry wakes every policy: a cold normal
    volume, a hot EC volume with remnant shards elsewhere, a cold EC
    volume (recode to MSR), a filling disk, and hot chunks homed on two
    live filers (the rendezvous ring of each package).  In execute mode
    every plan is approved and run against a stub session; the plans,
    their outcomes (aborted where the actuator fails), the actuator
    calls, the cooldowns and the metric deltas are the reference's."""
    monkeypatch.setenv("WEEDTPU_AUTOPILOT", "execute")
    t0 = clock.now

    def scenario(mod):
        clock.now = t0
        met = metrics if mod is autopilot else ref_metrics
        locs = {str(s): ["n1:80"] for s in range(11)}
        locs.update({str(s): ["n2:80"] for s in range(11, 14)})
        cold_locs = {str(s): ["n2:80"] for s in range(14)}
        ledger = {
            1: {"vid": 1, "kind": "normal", "state": "healthy",
                "collection": "c1"},
            2: {"vid": 2, "kind": "ec", "state": "healthy",
                "codec": "rs_10_4", "collection": "",
                "shard_locations": locs},
            3: {"vid": 3, "kind": "ec", "state": "healthy",
                "codec": "rs_10_4", "collection": "",
                "shard_locations": cold_locs}}
        heat = _heat_view([{"key": "2", "rps": 9.0, "sustained_s": 500.0,
                            "degraded_fraction": 0.5}])
        heat["chunks"] = {"top": [
            {"key": f"{v},{k:x}01020304", "rps": 3.0 + k,
             "sustained_s": 100.0} for v in (2, 5) for k in range(5)]
            + [{"key": "nofid", "rps": 99.0, "sustained_s": 999.0}]}
        m = _StubMaster(ledger=ledger, heat=heat,
                        disks=[{"vs": "n3:80", "dir": "/d",
                                "predicted_full_seconds": 10.0}],
                        nodes=[_StubNode("n3:80", {7: _StubVol(size=9)}),
                               _StubNode("n4:80", {}, free_slots=9)])
        m.cluster_members = {"filer": {"f1:8888": clock.time(),
                                       "f2:8888": clock.time(),
                                       "old:8888": clock.time() - 99}}
        m._session = _Session(fail)
        before = {p: {o: met.AUTOPILOT_ACTIONS.labels(p, o).value
                      for o in ("done", "aborted")} for p in mod.POLICIES}
        plans0 = {p: met.AUTOPILOT_PLANS.labels(p).value
                  for p in mod.POLICIES}
        ap = mod.Autopilot(m, cold_s=0.0, hot_s=60.0, hot_rps=5.0,
                           cooldown_s=50.0)
        plans = _tick(ap)
        acted = {p: {o: met.AUTOPILOT_ACTIONS.labels(p, o).value
                     - before[p][o] for o in ("done", "aborted")}
                 for p in mod.POLICIES}
        made = {p: met.AUTOPILOT_PLANS.labels(p).value - plans0[p]
                for p in mod.POLICIES}
        assert {p["policy"] for p in plans} == set(mod.POLICIES)
        clock.now += 10
        again = _tick(ap)  # cooldowns hold every volume and fid
        return (_plans(plans), _status(ap), m._session.calls,
                m.convert.enqueued, acted, made, _plans(again))

    out = _both(scenario)
    status, calls = out[1], out[2]
    assert status["actuator_calls"] == len(calls) + 1  # + the enqueue
    assert out[6] == []


def test_rendezvous_ring_equals_reference():
    rng = np.random.default_rng(5)
    members = [f"10.0.{i}.{j}:8888" for i in range(3) for j in range(4)]
    mine, ref = hashring.RendezvousRing(), ref_hashring.RendezvousRing()
    for step in range(20):
        pick = [m for m in members if rng.random() < 0.6]
        assert mine.update(pick) == ref.update(pick)
        assert (mine.members, mine.version, len(mine)) == \
            (ref.members, ref.version, len(ref))
        for k in range(30):
            key = f"{int(rng.integers(1, 50))},{int(rng.integers(1 << 30)):x}"
            assert mine.home(key) == ref.home(key)
            assert mine.ranked(key) == ref.ranked(key)
    assert hashring.RendezvousRing().home("x") is None


def test_chunk_promote_against_a_stub_filer(tmp_path, monkeypatch, clock):
    """A live filer member with a stub `/__hot__/seed`: the hot chunks'
    plan (one per home filer) executes through the port's post_json and
    the filer answers what it seeded; without live filers no plan, as
    the reference (maintenance/autopilot.py:495-497)."""
    from aiohttp import web
    from tests.test_torch_master import Loop
    from tests.test_torch_master_cluster import free_port
    monkeypatch.setenv("WEEDTPU_AUTOPILOT", "plan")
    seeded = []

    async def seed(req):
        body = await req.json()
        seeded.append(body["fids"])
        return web.json_response({"seeded": len(body["fids"]),
                                   "skipped": 0})

    app = web.Application()
    app.add_routes([web.post("/__hot__/seed", seed)])
    lp = Loop()
    runner = web.AppRunner(app)
    lp.run(runner.setup())
    port = free_port()
    lp.run(web.TCPSite(runner, "127.0.0.1", port).start())
    try:
        heat = {"chunks": {"top": [
            {"key": f"3,{k:x}0a0b0c0d", "rps": 5.0, "sustained_s": 60.0}
            for k in range(3)]}}
        m = _StubMaster(ledger={}, heat=heat)
        m.cluster_members = {}
        ap = autopilot.Autopilot(m)
        assert _tick(ap) == []  # no live filer
        m.cluster_members = {"filer": {f"127.0.0.1:{port}": clock.time()}}

        async def run():
            import aiohttp
            m._session = aiohttp.ClientSession()
            try:
                plans = await ap.tick()
                ap.approve(plans[0]["id"])
                await ap.wait_idle()
                return plans
            finally:
                await m._session.close()

        plans = lp.run(run())
        assert [p["policy"] for p in plans] == ["chunk_promote"]
        plan = ap.plans[plans[0]["id"]]
        assert plan["state"] == "done", plan
        assert plan["outcome"] == {"seeded": 3, "skipped": 0}
        assert seeded == [plan["fids"]] and plan["node"] == \
            f"127.0.0.1:{port}"
    finally:
        lp.run(runner.cleanup())
        lp.close()


def test_constants_are_the_references_defaults(monkeypatch):
    for var in [k for k in os.environ if k.startswith("WEEDTPU_AUTOPILOT")]:
        monkeypatch.delenv(var)
    mine = autopilot.Autopilot(types.SimpleNamespace())
    ref = ref_autopilot.Autopilot(types.SimpleNamespace())
    assert mine.status()["knobs"] == ref.status()["knobs"]
    assert {n: (b.rate, b.burst) for n, b in mine.buckets.items()} == \
        {n: (b.rate, b.burst) for n, b in ref.buckets.items()}
    assert (autopilot.PLAN_STATES, autopilot.POLICIES,
            autopilot.Autopilot.KEEP_PLANS) == \
        (ref_autopilot.PLAN_STATES, ref_autopilot.POLICIES,
         ref_autopilot.Autopilot.KEEP_PLANS)
    for name in ("AUTOPILOT_PLANS", "AUTOPILOT_ACTIONS"):
        m, r = getattr(metrics, name), getattr(ref_metrics, name)
        assert (m.name, m.help, m.label_names, m.kind) == \
            (r.name, r.help, r.label_names, r.kind)


# ---- cluster layer: port nodes under the port's master ------------------------

def _post_json(url, body, timeout=120.0):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.load(r)


def _get_json(url, timeout=30.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.load(r)


def test_autopilot_tiering_round_trip_end_to_end(tmp_path, monkeypatch):
    """Twin of tests/test_autopilot.py's on the port's master and a port
    volume server: cold volumes demote (sealed conversion, the .dat
    retired), read back through the EC path, then, read hot, promote
    back (decode and thaw) writable with the shard set retired; every
    plan carries a trace id, and the reference's shell renders the
    ledger."""
    from seaweedfs_tpu.client import WeedClient
    from tests.test_torch_master_cluster import Cluster
    monkeypatch.setenv("WEEDTPU_AUTOPILOT", "execute")
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "0")
    monkeypatch.setenv("WEEDTPU_AGG_INTERVAL", "0")
    monkeypatch.setenv("WEEDTPU_REPAIR_INTERVAL", "0")
    c = Cluster(tmp_path, n_volume_servers=1).start()
    try:
        c.wait_heartbeats()
        master = c.master
        ap = master.autopilot
        ap.cold_rps = 1e9
        ap.cold_s = 0.0
        ap.hot_rps = 0.01
        ap.hot_s = 0.0
        ap.cooldown_s = 0.0
        client = WeedClient(master.url)
        rng = np.random.default_rng(0xA171)
        blobs = {}
        for i in range(10):
            data = rng.integers(0, 256, int(rng.integers(8_000, 30_000)),
                                dtype=np.uint8).tobytes()
            blobs[client.upload(data, name=f"t{i}.bin")] = data
        vs = c.volume_servers[0]
        vids = sorted({vid for loc in vs.store.locations
                       for vid in loc.volumes})
        for v in vids:
            vs.store.get_volume(v).nm.flush()
        time.sleep(0.7)
        master.collect_heat()
        out = _post_json(f"http://{master.url}/cluster/autopilot",
                         {"tick": True, "wait": True})
        demotes = [p for p in out["plans"]
                   if p["policy"] == "tiering_demote"]
        assert {p["vid"] for p in demotes} == set(vids)
        c.submit(master.convert.tick())
        st = master.convert.status()
        assert st["converted"] == len(vids), st
        for vid in vids:
            assert vs.store.get_volume(vid) is None
            ev = vs.store.get_ec_volume(vid)
            assert ev is not None and not os.path.exists(ev.base + ".dat")
        time.sleep(0.7)
        for fid, data in blobs.items():
            assert client.download(fid) == data
        ap_st = _get_json(f"http://{master.url}/cluster/autopilot")
        assert all(p["state"] == "done" for p in ap_st["plans"]
                   if p["policy"] == "tiering_demote")
        for _ in range(3):
            for fid, data in blobs.items():
                assert client.download(fid) == data
        master.collect_heat()
        out = _post_json(f"http://{master.url}/cluster/autopilot",
                         {"tick": True, "wait": True})
        promotes = [p for p in out["plans"]
                    if p["policy"] == "tiering_promote"]
        assert {p["vid"] for p in promotes} == set(vids), out["plans"]
        for vid in vids:
            v = vs.store.get_volume(vid)
            assert v is not None and not v.read_only
            assert vs.store.get_ec_volume(vid) is None
            assert os.path.exists(v._base + ".dat")
            assert not glob.glob(v._base + ".ec*")
        for fid, data in blobs.items():
            assert client.download(fid) == data
        ap_st = _get_json(f"http://{master.url}/cluster/autopilot")
        assert all(len(p["trace_id"]) == 32 for p in ap_st["plans"])
        from seaweedfs_tpu.shell.commands import CommandEnv, run_command
        buf = io.StringIO()
        run_command(CommandEnv(master.url), "cluster.autopilot", buf)
        text = buf.getvalue()
        assert "mode=execute" in text
        assert "tiering_promote" in text and "tiering_demote" in text
        st = _get_json(f"http://{master.url}/maintenance/status")
        assert st["autopilot"]["mode"] == "execute"
        assert st["autopilot"]["states"]["done"] == 2 * len(vids)
        assert "heat" in st and st["heat"]["volumes"], st.get("heat")
        client.close()
    finally:
        c.stop()


def test_autopilot_route_refusals(tmp_path, monkeypatch):
    """/cluster/autopilot: a remote caller is refused, an unknown plan
    is a 404, a terminal one a 409, a PUT a 405 (as the reference's)."""
    from tests.test_torch_master import Loop, call
    from tests.test_torch_master_cluster import free_port
    from seaweedfs_tpu_torch.server.master import MasterServer
    monkeypatch.setenv("WEEDTPU_REPAIR_INTERVAL", "0")
    lp = Loop()
    m = MasterServer("127.0.0.1", free_port())
    lp.run(m.start())
    try:
        assert call(m.url, "/cluster/autopilot",
                    body={"approve": "ap9"})[0] == 404
        plan = m.autopilot._new_plan("tiering_demote", 4, reason={})
        m.autopilot.abort(plan["id"])
        st, body = call(m.url, "/cluster/autopilot",
                        body={"approve": plan["id"]})
        assert st == 409 and "aborted" in body["error"]
        assert call(m.url, "/cluster/autopilot", method="PUT",
                    data=b"{}")[0] == 405
        got = call(m.url, "/cluster/autopilot")[1]
        assert got["plans"][0]["state"] == "aborted"
    finally:
        lp.run(m.stop())
        lp.close()


def test_volume_move_end_to_end_and_dead_target_abort(tmp_path,
                                                      monkeypatch):
    """Twin of tests/test_autopilot.py's on port nodes under the port's
    master: a move at a dead target aborts clean, a real one lands the
    volume byte-identical and retires the source."""
    from seaweedfs_tpu.client import WeedClient
    from tests.test_torch_master_cluster import Cluster, free_port
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "0")
    c = Cluster(tmp_path, n_volume_servers=2).start()
    try:
        c.wait_heartbeats()
        client = WeedClient(c.master.url)
        rng = np.random.default_rng(0xB0B)
        blobs = {}
        for i in range(8):
            data = rng.integers(0, 256, 20_000, dtype=np.uint8).tobytes()
            blobs[client.upload(data, name=f"m{i}.bin")] = data
        vid = int(next(iter(blobs)).partition(",")[0])
        src = next(vs for vs in c.volume_servers
                   if vs.store.get_volume(vid) is not None)
        dst = next(vs for vs in c.volume_servers if vs is not src)
        dead = f"127.0.0.1:{free_port()}"
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post_json(f"http://{src.url}/admin/volume/move",
                       {"volume": vid, "target": dead})
        assert ei.value.code == 500
        v = src.store.get_volume(vid)
        assert v is not None and not v.read_only
        for fid, data in blobs.items():
            assert client.download(fid) == data
        out = _post_json(f"http://{src.url}/admin/volume/move",
                         {"volume": vid, "target": dst.url})
        assert out["moved"] == vid and out["target"] == dst.url
        assert src.store.get_volume(vid) is None
        moved = dst.store.get_volume(vid)
        assert moved is not None and not moved.read_only
        time.sleep(0.8)
        client._vid_cache.clear()
        for fid, data in blobs.items():
            assert client.download(fid) == data
        client.close()
    finally:
        c.stop()
