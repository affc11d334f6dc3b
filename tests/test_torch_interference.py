"""The port's interference observatory and governor
(seaweedfs_tpu_torch/stats/interference.py) held to the reference's on
the CPU.

Both are ported whole: each case feeds both packages the same scripted
ticks (parsed from each package's own registry) and compares their
state, snapshots and decisions with ``==``.  The governors run on stub
masters that carry each package's own repair, conversion and autopilot
buckets.  Then twins of tests/test_interference.py but its xrack,
convert-pause and bench trajectory cases (those are in
tests/test_torch_repair_planner.py and
tests/test_torch_convert_scheduler.py), and its 3-node case on port
nodes.
"""

import copy
import logging
import threading
import time
import types

import pytest

from seaweedfs_tpu.maintenance import repair as ref_repair
from seaweedfs_tpu.stats import aggregate as ref_ag
from seaweedfs_tpu.stats import interference as ref_itf
from seaweedfs_tpu.stats import metrics as ref_metrics

from seaweedfs_tpu_torch.maintenance import repair, scrub
from seaweedfs_tpu_torch.stats import aggregate as ag
from seaweedfs_tpu_torch.stats import interference as itf
from seaweedfs_tpu_torch.stats import metrics, netflow, trace
from seaweedfs_tpu_torch.utils import weedlog
from tests.test_cluster_obs import _read_all, _upload_and_encode_all
from tests.test_maintenance import _get, _post
from tests.test_torch_master_cluster import Cluster

PKGS = {"ref": (ref_itf, ref_ag, ref_metrics), "port": (itf, ag, metrics)}


@pytest.fixture(autouse=True)
def _retire_gauges(monkeypatch):
    """The observatory's per-node gauges live on each package's global
    registry: retire them after each case, and start each with the
    switches on."""
    for var in ("WEEDTPU_INTERFERENCE", "WEEDTPU_GOVERNOR"):
        monkeypatch.delenv(var, raising=False)
    for mod in (itf, ref_itf):
        monkeypatch.setattr(mod, "_enabled_cache", (0.0, True))
    yield
    for met in (metrics, ref_metrics):
        met.INTERFERENCE_INDEX.remove_matching()
        met.GOVERNOR_RATE.remove_matching()


class FakeNode:
    """One synthetic node of package `mods`: a private registry of
    foreground read latencies and background byte counters, rendered and
    parsed by that package."""

    def __init__(self, mods):
        _, self.ag, met = mods
        self.reg = met.Registry()
        self.hist = self.reg.histogram("weedtpu_volume_request_seconds",
                                       "t", ("type",))
        self.net = self.reg.counter("weedtpu_net_bytes_total", "t",
                                    ("direction", "class", "peer_role"))

    def read(self, latencies):
        for v in latencies:
            self.hist.labels("read").observe(v)

    def bg(self, cls, nbytes, direction="recv"):
        self.net.labels(direction, cls, "volume").inc(nbytes)

    def fams(self):
        return self.ag.parse_exposition(self.reg.render())


def _obs(mod, **kw):
    kw.setdefault("quiet_bps", 1000.0)
    kw.setdefault("min_samples", 4)
    kw.setdefault("alpha", 0.5)
    return mod.InterferenceObservatory(**kw)


def _state(obs):
    return copy.deepcopy(
        {n: {k: getattr(st, k) for k in st.__slots__ if k != "prev_ts"}
         for n, st in obs._nodes.items()})


def both(scenario, *args):
    got = {k: scenario(*mods, *args) for k, mods in PKGS.items()}
    assert got["port"] == got["ref"]
    return got["port"]


# ---- the observatory -----------------------------------------------------------

def _baseline_scenario(mod, a, m):
    mods = (mod, a, m)
    obs = _obs(mod)
    node = FakeNode(mods)
    out = []
    t0 = 1000.0
    node.read([0.01] * 8)
    obs.observe(t0, {"n1": node.fams()})
    node.read([0.01] * 8)
    obs.observe(t0 + 10, {"n1": node.fams()})
    out.append(_state(obs))
    node.read([0.1] * 8)
    node.bg("repair", 50 * 1024 * 1024)
    obs.observe(t0 + 20, {"n1": node.fams()})
    out.append((_state(obs), obs.fleet_index()))
    for i in range(1, 6):
        node.read([0.01] * 8)
        obs.observe(t0 + 20 + 10 * i, {"n1": node.fams()})
    out.append(obs.snapshot())
    gauge = m.INTERFERENCE_INDEX.labels("n1", "repair").value
    obs.close()
    return out, gauge


def test_quiet_baseline_busy_attribution_and_decay():
    (quiet, (busy, fleet), snap), _ = both(_baseline_scenario)
    assert quiet["n1"]["quiet_p99"] == pytest.approx(0.01, rel=0.2)
    assert busy["n1"]["index"]["repair"] > 0.5
    assert fleet["repair"]["node"] == "n1"
    assert snap["nodes"]["n1"]["index"]["repair"] < \
        busy["n1"]["index"]["repair"] * 0.2
    assert (snap["nodes"]["n1"]["quiet_ticks"],
            snap["nodes"]["n1"]["busy_ticks"]) == (6, 1)


def _share_scenario(mod, a, m):
    mods = (mod, a, m)
    obs = _obs(mod)
    node = FakeNode(mods)
    for t, lat in ((0.0, 0.01), (10.0, 0.01)):
        node.read([lat] * 8)
        obs.observe(t, {"n1": node.fams()})
    node.read([0.05] * 8)
    node.bg("repair", 10 * 1024 * 1024)
    node.bg("scrub", 30 * 1024 * 1024)
    obs.observe(20.0, {"n1": node.fams()})
    out = _state(obs)
    obs.close()
    return out


def test_impact_attributed_by_byte_share():
    st = both(_share_scenario)["n1"]
    assert st["index"]["scrub"] == pytest.approx(3 * st["index"]["repair"],
                                                 rel=0.05)


def _thin_scenario(mod, a, m):
    mods = (mod, a, m)
    obs = _obs(mod, min_samples=8)
    node = FakeNode(mods)
    for t in (0.0, 10.0):
        node.read([0.01] * 10)
        obs.observe(t, {"n1": node.fams()})
    base = obs._nodes["n1"].quiet_p99
    node.read([0.5] * 2)
    node.bg("repair", 50 * 1024 * 1024)
    obs.observe(20.0, {"n1": node.fams()})
    out = (base, _state(obs))
    obs.close()
    return out


def test_too_few_samples_moves_nothing():
    base, st = both(_thin_scenario)
    assert st["n1"]["quiet_p99"] == base
    assert st["n1"]["index"].get("repair", 0.0) == 0.0


def _absent_scenario(mod, a, m):
    mods = (mod, a, m)
    obs = _obs(mod)
    node = FakeNode(mods)
    for t, lat in ((0.0, 0.01), (10.0, 0.01)):
        node.read([lat] * 8)
        obs.observe(t, {"nd": node.fams()})
    node.read([0.1] * 8)
    node.bg("repair", 50 * 1024 * 1024)
    obs.observe(20.0, {"nd": node.fams()})
    idx = obs._nodes["nd"].index["repair"]
    for i in range(1, 6):
        obs.observe(20.0 + 10 * i, {})
    out = (idx, _state(obs), obs.fleet_index())
    obs.close()
    return out


def test_absent_node_index_decays_instead_of_freezing():
    idx, st, fleet = both(_absent_scenario)
    assert idx > 0.5 and st["nd"]["index"]["repair"] < idx * 0.2
    assert fleet["repair"]["index"] < idx * 0.2


def _seeded_scenario(mod, a, m, seed):
    """Four nodes over 30 ticks: seeded read latencies, each background
    class bursting at random, one node absent for a stretch."""
    import numpy as np
    rng = np.random.default_rng(seed)
    mods = (mod, a, m)
    obs = _obs(mod, quiet_bps=64 * 1024, min_samples=6, alpha=0.3)
    nodes = {f"n{i}": FakeNode(mods) for i in range(4)}
    snaps = []
    for t in range(30):
        per = {}
        for name, node in nodes.items():
            busy = rng.random() < 0.4
            node.read(list(rng.exponential(0.02 * (3 if busy else 1),
                                           int(rng.integers(2, 14)))))
            if busy:
                cls = mod.BG_CLASSES[int(rng.integers(len(mod.BG_CLASSES)))]
                node.bg(cls, int(rng.integers(1, 64)) * 1024 * 1024)
            if name == "n3" and 10 <= t < 16:
                continue
            per[name] = node.fams()
        per["__aggregator__"] = {}
        obs.observe(100.0 + 5 * t, per)
        snaps.append(obs.snapshot())
    gauges = sorted((k, round(c.value, 6)) for k, c in
                    m.INTERFERENCE_INDEX._children.items()
                    if k[0].startswith("n"))
    obs.close()
    return snaps, gauges


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_observatory_over_scripted_ticks_equals_reference(seed):
    snaps, _ = both(_seeded_scenario, seed)
    assert snaps[-1]["ticks"] == 30
    assert any(n["busy_ticks"] for n in snaps[-1]["nodes"].values())


def test_disabled_observatory_is_a_noop(monkeypatch):
    monkeypatch.setenv("WEEDTPU_INTERFERENCE", "0")
    obs = _obs(itf)
    node = FakeNode(PKGS["port"])
    node.read([0.01] * 8)
    obs.observe(0.0, {"n1": node.fams()})
    assert obs.ticks == 0 and not obs._nodes
    assert not itf.governor_enabled()


def test_disable_observatory_retires_index_series(monkeypatch):
    obs = _obs(itf)
    node = FakeNode(PKGS["port"])
    for t, lat in ((0.0, 0.01), (10.0, 0.01)):
        node.read([lat] * 8)
        obs.observe(t, {"nfreeze": node.fams()})
    node.read([0.1] * 8)
    node.bg("repair", 50 * 1024 * 1024)
    obs.observe(20.0, {"nfreeze": node.fams()})
    assert obs._nodes["nfreeze"].index.get("repair", 0.0) > 0
    assert 'node="nfreeze"' in metrics.REGISTRY.render()
    monkeypatch.setenv("WEEDTPU_INTERFERENCE", "0")
    monkeypatch.setattr(itf, "_enabled_cache", (0.0, True))
    obs.observe(30.0, {"nfreeze": node.fams()})
    assert not obs._nodes
    assert 'node="nfreeze"' not in metrics.REGISTRY.render()


@pytest.mark.parametrize("knob", ["WEEDTPU_INTERFERENCE", "WEEDTPU_GOVERNOR"])
def test_switch_knob_raises_unlike_the_reference(knob, monkeypatch):
    monkeypatch.setenv(knob, "off")
    ref_itf._enabled_cache = (0.0, True)
    ref_itf.governor_enabled()  # the reference reads anything but "0" as on
    with pytest.raises(ValueError, match=knob):
        itf.governor_enabled()


# ---- the governor --------------------------------------------------------------

class _FakeTopo:
    def __init__(self, nodes=None):
        self.nodes = dict(nodes or {})
        self._lock = threading.Lock()


def _fake_master(nodes=None, mod=repair):
    """A stub master with `mod`'s buckets, the ones each governor reads
    at construction: the repair planner's, the conversion scheduler's
    and the autopilot's."""
    m = types.SimpleNamespace()
    m.topo = _FakeTopo(nodes)
    m.aggregator = types.SimpleNamespace(pool=None)
    m.maintenance = types.SimpleNamespace(
        xrack_bucket=mod.TokenBucket(1000.0, 4000.0))
    m.convert = types.SimpleNamespace(bucket=mod.TokenBucket(2.0, 8.0))
    m.autopilot = types.SimpleNamespace(buckets={
        "tiering": mod.TokenBucket(0.5, 4.0),
        "balance": mod.TokenBucket(0.1, 2.0),
        "chunk": mod.TokenBucket(1.0, 8.0),
        "codec": mod.TokenBucket(0.1, 2.0)})
    return m


def _ref_master(nodes=None):
    return _fake_master(nodes, ref_repair)


def _governors(monkeypatch, mbps="8", nodes=None):
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", mbps)
    out = {}
    for name, mod, master in (("ref", ref_itf, _ref_master(nodes)),
                              ("port", itf, _fake_master(nodes))):
        obs = _obs(mod)
        gov = mod.Governor(master, obs)
        pushes = []
        monkeypatch.setattr(gov, "_push_scrub_rate", pushes.append)
        out[name] = (mod, gov, obs, pushes)
    return out


def _set_index(mod, obs, index):
    st = obs._nodes.get("n1")
    if st is None:
        st = obs._nodes["n1"] = mod._NodeState()
    st.index = dict(index)
    st.last_seen = time.time()


def _scrub_view(decisions, targets=("scrub",)):
    return [{k: v for k, v in d.items() if k != "trace_id"}
            for d in decisions if d["target"] in targets]


ALL = ("scrub", "repair_xrack", "convert", "autopilot_tier",
       "autopilot_balance", "autopilot_chunk")


def test_governor_targets_equal_reference(monkeypatch):
    """Both governors govern the same targets (the repair planner's
    cross-rack budget, the conversion scheduler's bucket, the
    autopilot's three plan buckets and the scrub rate) with the same
    ceilings, floors and classes, and `INTERFERENCE_ALERT` is the
    reference's."""
    g = _governors(monkeypatch)
    port, ref = g["port"][1].status(), g["ref"][1].status()
    assert sorted(port["targets"]) == [
        "autopilot_balance", "autopilot_chunk", "autopilot_tier",
        "convert", "repair_xrack", "scrub"]
    assert port == ref
    assert g["port"][1].ceilings == g["ref"][1].ceilings
    assert g["port"][1].classes == g["ref"][1].classes
    assert itf.Governor.INTERFERENCE_ALERT == \
        ref_itf.Governor.INTERFERENCE_ALERT == "interference_high"


SCRIPT = [  # (ts, scrub index, repair index): backoff, floor, recovery
    (100.0, 2.0, 1.0), (101.0, 2.0, 0.0), (102.0, 0.6, 0.0),
    (103.0, 0.3, 0.0), (110.0, 0.26, 0.0), (111.0, 0.0, 0.0),
    (112.0, 0.0, 0.0), (113.0, 0.0, 0.0), (114.0, 0.24, 0.0),
    (140.0, 0.0, 3.0), (141.0, 5.0, 0.0)] + \
    [(150.0 + i, 0.0, 0.0) for i in range(12)] + \
    [(200.0, 0.9, 0.0), (240.0, 0.9, 0.0), (241.0, 0.1, 0.0)]


def test_governor_scrub_decisions_equal_reference(monkeypatch):
    """The same observatory state tick by tick: every target's rate,
    every decision (target, direction, from, to, index, node) and every
    scrub push equal the reference governor's."""
    g = _governors(monkeypatch, nodes={"n1:80": object()})
    for ts, s_idx, r_idx in SCRIPT:
        made = {}
        for name, (mod, gov, obs, _) in g.items():
            _set_index(mod, obs, {"scrub": s_idx, "repair": r_idx})
            made[name] = _scrub_view(gov.tick(ts), ALL)
        assert made["port"] == made["ref"], ts
        assert g["port"][1]._scrub_rate == g["ref"][1]._scrub_rate
        for name in g["port"][1].ceilings:
            assert g["port"][1]._current_rate(name) == \
                g["ref"][1]._current_rate(name), (ts, name)
    assert g["port"][3] == g["ref"][3] and len(g["port"][3]) > 3
    assert _scrub_view(g["port"][1].decisions, ALL) == \
        _scrub_view(g["ref"][1].decisions, ALL)
    rates = [d["to"] for d in g["port"][1].decisions]
    assert min(rates) == pytest.approx(0.8)  # the floor, 0.1 x 8
    assert g["port"][1]._scrub_rate == 8.0 or rates[-1] < 8.0


def test_governor_backoff_floor_recovery_and_audit(monkeypatch):
    g = _governors(monkeypatch)
    mod, gov, obs, _ = g["port"]
    _set_index(mod, obs, {"scrub": 2.0})
    made = gov.tick(1000.0)
    assert [d["target"] for d in made] == ["scrub"]
    assert gov._scrub_rate == pytest.approx(1.0)  # 8 x 0.25 / 2.0
    assert made[0]["direction"] == "down"
    recs = trace.traces(tid=made[0]["trace_id"])
    assert recs and any(s["name"] == "governor.retune"
                        for r in recs for s in r["spans"])
    assert made[0]["trace_id"] in trace.pinned_ids()
    for i in range(6):
        gov.tick(1001.0 + i)
    assert gov._scrub_rate == pytest.approx(0.8)
    _set_index(mod, obs, {})
    for i in range(20):
        gov.tick(1100.0 + i)
    assert gov._scrub_rate == pytest.approx(8.0)
    assert any(d["direction"] == "up" for d in gov.decisions)
    st = gov.status()
    assert st["targets"]["scrub"]["ceiling"] == 8.0
    assert st["retunes"] == gov.retunes
    assert metrics.GOVERNOR_RATE.labels("scrub").value == 8.0
    assert metrics.GOVERNOR_RETUNES.labels("scrub", "down").value >= 1


def test_governor_disabled_restores_ceiling_once(monkeypatch):
    g = _governors(monkeypatch)
    mod, gov, obs, pushes = g["port"]
    _set_index(mod, obs, {"scrub": 5.0})
    gov.tick(1.0)
    assert gov._scrub_rate < 8.0
    monkeypatch.setenv("WEEDTPU_GOVERNOR", "0")
    restored = gov.tick(2.0)
    assert [d["reason"] for d in restored] == ["disabled"]
    assert gov._scrub_rate == 8.0 and pushes[-1] == 8.0
    n = len(gov.decisions)
    assert gov.tick(3.0) == [] and len(gov.decisions) == n


def test_governor_deadband_never_strands_rate_below_ceiling(monkeypatch):
    g = _governors(monkeypatch)
    _, gov, _, _ = g["port"]
    gov._scrub_rate = 7.82  # 97.7% of the ceiling
    gov.tick(1.0)
    assert gov._scrub_rate == pytest.approx(8.0)
    n = len(gov.decisions)
    gov.tick(2.0)
    assert len(gov.decisions) == n


def test_governor_repushes_scrub_rate_for_late_joiners(monkeypatch):
    g = _governors(monkeypatch)
    mod, gov, obs, pushes = g["port"]
    _set_index(mod, obs, {"scrub": 2.0})
    gov.tick(100.0)
    assert pushes == [pytest.approx(1.0)]
    gov.tick(101.0)
    assert pushes[-1] == pytest.approx(0.8)
    n = len(pushes)
    gov.tick(102.0)
    gov.tick(110.0)
    assert len(pushes) == n
    gov.tick(101.0 + gov.REPUSH_S + 1)
    assert len(pushes) == n + 1 and pushes[-1] == pytest.approx(0.8)
    monkeypatch.setenv("WEEDTPU_GOVERNOR", "0")
    t0 = 101.0 + gov.REPUSH_S + 1
    gov.tick(t0 + 1)
    assert pushes[-1] == pytest.approx(8.0)
    n = len(pushes)
    gov.tick(t0 + 2)
    assert len(pushes) == n
    gov.tick(t0 + 1 + gov.REPUSH_S + 1)
    assert len(pushes) == n + 1 and pushes[-1] == pytest.approx(8.0)
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "0")
    gov2 = itf.Governor(_fake_master(), _obs(itf))
    assert "scrub" not in gov2.status()["targets"]


def test_governor_converges_fleet_scrub_on_first_tick(monkeypatch):
    g = _governors(monkeypatch, nodes={"n1:80": object()})
    _, gov, _, pushes = g["port"]
    gov.tick(1.0)
    assert pushes == [pytest.approx(8.0)]
    gov.tick(2.0)
    assert len(pushes) == 1


def test_governor_push_is_a_scale_to_every_node(monkeypatch):
    """The push itself: a POST of {"scale": rate / ceiling} to each
    node's /admin/scrub_rate over the aggregator's pool."""
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "8")
    sent = []

    class _Pool:
        def request(self, url, method="GET", body=None, headers=None,
                    timeout=None):
            sent.append((url, method, body))
            return 200, {}, b"{}"

    master = _fake_master({"a": types.SimpleNamespace(url="h1:1"),
                           "b": types.SimpleNamespace(url="h2:2")})
    master.aggregator = types.SimpleNamespace(pool=_Pool())
    gov = itf.Governor(master, _obs(itf))
    gov._push_scrub_rate(2.0)
    assert sorted(sent) == [
        ("http://h1:1/admin/scrub_rate", "POST", b'{"scale": 0.25}'),
        ("http://h2:2/admin/scrub_rate", "POST", b'{"scale": 0.25}')]


# ---- the scrubber's side ---------------------------------------------------------

class _Store:
    locations = ()


def test_scrub_set_mbps_zero_pauses_never_unthrottles():
    s = scrub.Scrubber(_Store(), mbps=8)
    s._limiter = scrub.RateLimiter(8e6)
    assert s.set_mbps(0) == 0.0 and s.operator_paused
    assert s._limiter.rate == 8e6
    assert s.scrub_once().get("paused") is True
    assert s.set_mbps(6, governed=True) == 0.0
    assert s.mbps == 0.0 and s.operator_paused
    assert s.set_mbps(4) == 4.0 and not s.operator_paused
    assert s._limiter.rate == 4e6
    assert "paused" not in s.scrub_once()
    assert s.set_mbps(2, governed=True) == 2.0


def test_governed_scale_respects_per_node_config():
    s = scrub.Scrubber(_Store(), mbps=2)
    assert s.apply_governed_scale(1.0) == 2.0
    assert s.apply_governed_scale(0.5) == 1.0
    assert s.apply_governed_scale(2.0) == 2.0
    s.set_mbps(0)
    assert s.apply_governed_scale(1.0) == 0.0
    s.set_mbps(4)
    assert s.configured_mbps == 4.0
    assert s.apply_governed_scale(0.25) == 1.0


def test_weedlog_exc_info_carries_traceback(caplog):
    with caplog.at_level(logging.WARNING, logger="itf_test"):
        try:
            raise RuntimeError("deep cause")
        except RuntimeError as e:
            weedlog.warning("observer failed: %s", e, name="itf_test",
                            exc_info=True)
    rec = caplog.records[-1]
    assert rec.exc_info and rec.exc_info[0] is RuntimeError
    assert "deep cause" in caplog.text and "Traceback" in caplog.text


# ---- the 3-node case on port nodes, scrub half ---------------------------------

@pytest.fixture()
def itf_cluster(tmp_path, monkeypatch):
    """The port's master and three port volume servers on the CPU,
    scrubbers at 8 MB/s that pass only on request, ticks on demand, a
    fast observatory and an interference_high rule without
    hysteresis."""
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "8")
    monkeypatch.setenv("WEEDTPU_SCRUB_INTERVAL", "3600")
    monkeypatch.setenv("WEEDTPU_REPAIR_INTERVAL", "0")
    monkeypatch.setenv("WEEDTPU_AGG_INTERVAL", "0")
    monkeypatch.setenv("WEEDTPU_HEDGE_PCT", "0")
    monkeypatch.setenv("WEEDTPU_INTERF_MIN_SAMPLES", "4")
    monkeypatch.setenv("WEEDTPU_INTERF_ALPHA", "0.5")
    monkeypatch.setenv(
        "WEEDTPU_ALERT_RULES",
        "interference_high=threshold,series=weedtpu_interference_index,"
        "agg=last,window=60,op=gt,value=0.5,for=0,clear_for=0")
    c = Cluster(tmp_path, n_volume_servers=3).start()
    c.wait_heartbeats()
    yield c
    c.stop()


def _interference(master_url):
    return _get(master_url, "/cluster/interference?refresh=1", timeout=60)


def test_cluster_interference_rises_governs_scrub_and_recovers(itf_cluster):
    """Twin of tests/test_interference.py's 3-node case on port nodes
    under the port's master: slow reads with repair- and scrub-class
    bytes booked raise both indexes; the governor backs the repair
    planner's cross-rack budget and the fleet scrub rate off (seen in
    /maintenance/status too), the alert fires, and both recover."""
    c = itf_cluster
    master = c.master
    client, payloads = _upload_and_encode_all(c)
    xrack_ceiling = master.maintenance.xrack_bucket.rate
    scrub_ceiling = c.volume_servers[0].scrubber.mbps
    assert scrub_ceiling == 8.0
    _interference(master.url)
    for _ in range(2):
        _read_all(client, payloads)
        st = _interference(master.url)
    assert any(rec.get("quiet_p99_ms")
               for rec in st["interference"]["nodes"].values()), st
    try:
        for vs in c.volume_servers:
            _post(vs.url, "/admin/faults", {"faults": [
                {"action": "delay_shard_read", "ms": 250}]})
        # repair- and scrub-class bytes, booked (not read) as the
        # reference's case books them
        netflow.account("recv", "repair", "volume", 64 * 1024 * 1024)
        netflow.account("recv", "scrub", "volume", 64 * 1024 * 1024)
        _read_all(client, payloads)
        st = _interference(master.url)
        for cls in ("scrub", "repair"):
            assert st["interference"]["classes"].get(cls, {}).get(
                "index", 0.0) > 0.25, st
        gov = st["governor"]
        assert sorted(gov["targets"]) == [
            "autopilot_balance", "autopilot_chunk", "autopilot_tier",
            "convert", "repair_xrack", "scrub"]
        assert gov["targets"]["scrub"]["rate"] < scrub_ceiling
        assert gov["targets"]["repair_xrack"]["rate"] < xrack_ceiling
        assert master.maintenance.xrack_bucket.rate == pytest.approx(
            gov["targets"]["repair_xrack"]["rate"], abs=1e-3)
        assert [d for d in gov["decisions"] if d["target"] ==
                "repair_xrack" and d["direction"] == "down"], gov
        mst = _get(master.url, "/maintenance/status")
        assert mst["planner"]["xrack"]["budget_bytes_per_s"] < \
            xrack_ceiling
        assert mst["interference"]["governor"]["targets"][
            "repair_xrack"]["rate"] < xrack_ceiling
        down = [d for d in gov["decisions"] if d["target"] == "scrub"
                and d["direction"] == "down"]
        assert down, gov
        governed = [vs.scrubber.mbps for vs in c.volume_servers]
        assert all(m < scrub_ceiling for m in governed), governed
        assert governed[0] == pytest.approx(gov["targets"]["scrub"]["rate"],
                                            abs=1e-3)
        wf = _get(master.url, f"/cluster/trace/{down[-1]['trace_id']}",
                  timeout=60)
        assert any(s["name"] == "governor.retune" for s in wf["spans"])
        alerts = _get(master.url, "/cluster/alerts?refresh=1", timeout=60)
        rule = next(r for r in alerts["rules"]
                    if r["name"] == "interference_high")
        assert rule["state"] == "firing", alerts
        for series in ("weedtpu_governor_rate",
                       "weedtpu_interference_index"):
            h = _get(master.url, f"/cluster/history?series={series}"
                                 "&range=600")
            assert h["vectors"], h
    finally:
        for vs in c.volume_servers:
            _post(vs.url, "/admin/faults", {"faults": [
                {"action": "delay_shard_read", "ms": 0}]})
    floor = gov["targets"]["scrub"]["floor"]
    xfloor = gov["targets"]["repair_xrack"]["floor"]
    deadline = time.time() + 30
    recovered = None
    while time.time() < deadline:
        _read_all(client, payloads)
        st = _interference(master.url)
        classes = st["interference"]["classes"]
        targets = st["governor"]["targets"]
        if max(classes.get(k, {}).get("index", 0.0)
               for k in ("scrub", "repair")) < 0.25 and \
                targets["scrub"]["rate"] > floor and \
                targets["repair_xrack"]["rate"] > xfloor:
            recovered = st
            break
    assert recovered is not None, st
    deadline = time.time() + 20
    while time.time() < deadline:
        alerts = _get(master.url, "/cluster/alerts?refresh=1", timeout=60)
        rule = next(r for r in alerts["rules"]
                    if r["name"] == "interference_high")
        if rule["state"] != "firing":
            break
        time.sleep(0.2)
    assert rule["state"] != "firing", alerts
    assert any(d["direction"] == "up"
               for d in recovered["governor"]["decisions"])
    assert c.volume_servers[0].scrubber.mbps > min(governed)
    import io
    from seaweedfs_tpu.shell.commands import CommandEnv, run_command
    out = io.StringIO()
    run_command(CommandEnv(master.url), "cluster.interference", out)
    assert "governor" in out.getvalue() and "scrub" in out.getvalue()
    client.close()
