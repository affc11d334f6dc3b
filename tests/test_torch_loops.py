"""The port's loop monitor (seaweedfs_tpu_torch/stats/loops.py), fan-out
sizing and backoff, held to the reference's on the CPU.

Twins of tests/test_loops.py, its fleet simulator case on a port master
with the port's `FleetSim` included: the tick math, overruns,
errors, the EMA, `close` retiring the metric children, the cardinality
providers, the fan-out knob (which raises on a malformed value, where
the reference falls back), the bounds under 500-node churn, and
/cluster/loops on a port master driven by the reference's shell.  Where
a result does not depend on wall time, both packages get the same input
and their answers compare with ``==``.  The port's fleet simulator
(maintenance/fleetsim.py): each vnode's heartbeat, exposition and heat
sketch on a frozen clock equal the reference's, and a port master
aggregates either package's fleet alike.
"""

import io
import json
import random
import time

import pytest

from seaweedfs_tpu.maintenance import fleetsim as ref_fleetsim
from seaweedfs_tpu.shell.commands import CommandEnv, run_command
from seaweedfs_tpu.stats import history as ref_history
from seaweedfs_tpu.stats import interference as ref_itf
from seaweedfs_tpu.stats import loops as ref_loops
from seaweedfs_tpu.stats import metrics as ref_metrics
from seaweedfs_tpu.utils import fanout as ref_fanout
from seaweedfs_tpu.utils import resilience as ref_res

from seaweedfs_tpu_torch.maintenance import fleetsim
from seaweedfs_tpu_torch.stats import history, interference, loops, metrics
from seaweedfs_tpu_torch.utils import fanout, resilience
from tests.test_maintenance import _get
from tests.test_torch_master_cluster import Cluster

PKGS = {"ref": (ref_loops, ref_history, ref_itf, ref_metrics),
        "port": (loops, history, interference, metrics)}


def _no_ts(st):
    st = json.loads(json.dumps(st))
    st.pop("ts", None)
    for rec in st.get("loops", {}).values():
        rec.pop("last_ts", None)
        if rec.get("last_error"):
            rec["last_error"].pop("ts", None)
    return st


# ---- LoopMonitor -------------------------------------------------------------

def test_tick_records_wall_items_backlog_and_status():
    mon = loops.LoopMonitor()
    try:
        with mon.tick("aggregator", interval=10.0) as t:
            time.sleep(0.01)
            t.items = 5
            t.backlog = 2
        st = mon.status()["loops"]["aggregator"]
        assert (st["ticks"], st["items_total"], st["backlog"],
                st["overruns"], st["interval"]) == (1, 5, 2, 0, 10.0)
        assert st["wall_last"] >= 0.01
        assert 0.0 < st["overrun_ratio"] < 1.0
        assert st["wall_avg"] == pytest.approx(st["wall_total"])
    finally:
        mon.close()


def test_overrun_detected_and_counted():
    mon = loops.LoopMonitor()
    try:
        with mon.tick("repair", interval=0.001):
            time.sleep(0.01)
        st = mon.status()["loops"]["repair"]
        assert st["overruns"] == 1 and st["overrun_ratio"] > 1.0
        assert "OVERRUN:repair" in mon.headline()
        assert metrics.LOOP_OVERRUNS.labels("repair").value >= 1
    finally:
        mon.close()


def test_no_interval_never_overruns():
    mon = loops.LoopMonitor()
    try:
        with mon.tick("convert"):
            time.sleep(0.005)
        st = mon.status()["loops"]["convert"]
        assert (st["overruns"], st["interval"], st["overrun_ratio"]) == \
            (0, None, 0.0)
    finally:
        mon.close()


def test_error_captured_and_reraised():
    mon = loops.LoopMonitor()
    try:
        with pytest.raises(ValueError):
            with mon.tick("autopilot", interval=30.0):
                raise ValueError("boom")
        st = mon.status()["loops"]["autopilot"]
        assert st["ticks"] == 1 and st["errors"] == 1
        assert st["last_error"]["error"] == "ValueError: boom"
        with mon.tick("autopilot", interval=30.0):
            pass
        st = mon.status()["loops"]["autopilot"]
        assert st["ticks"] == 2 and st["errors"] == 1
        assert st["last_error"] is not None
    finally:
        mon.close()


def _record_scenario(lp, _h, _i, _m):
    """Scripted `_record` calls (wall, cpu, items, backlog, interval,
    error): status, headline and accounting, without a clock."""
    mon = lp.LoopMonitor()
    try:
        for args in (("governor", 1.0, 0.5, 10, 0, None, None),
                     ("governor", 3.0, 0.5, 10, 0, None, None),
                     ("aggregator", 0.2, 0.1, 3, 1, 10.0, None),
                     ("aggregator", 12.0, 0.3, 3, 4, 10.0, None),
                     ("canary", 0.4, 0.0, 2, 0, 30.0, "Boom: x" * 100),
                     ("canary", 0.1, 0.0, 0, 0, 0.0, None)):
            mon._record(*args)
        mon.add_cardinality("unit_rec_sub", lambda: 4)
        return _no_ts(mon.status()), mon.headline()
    finally:
        mon.close()


def test_ema_max_avg_and_status_equal_reference():
    got = {k: _record_scenario(*mods) for k, mods in PKGS.items()}
    assert got["port"] == got["ref"]
    st, headline = got["port"]
    gov = st["loops"]["governor"]
    assert gov["wall_ema"] == pytest.approx(0.8 * 1.0 + 0.2 * 3.0)
    assert (gov["wall_max"], gov["items_total"]) == (3.0, 20)
    assert headline == "slowest=aggregator ema=2560.0ms OVERRUN:aggregator"
    assert len(st["loops"]["canary"]["last_error"]["error"]) == 500


def test_headline_before_any_tick():
    mon = loops.LoopMonitor()
    assert mon.headline() == ref_loops.LoopMonitor().headline() == \
        "no ticks yet"
    mon.close()


def test_close_retires_metric_children():
    mon = loops.LoopMonitor()
    with mon.tick("unit_close_test", interval=1.0):
        pass
    mon.add_cardinality("unit_close_sub", lambda: 7)
    mon.refresh_accounting()
    text = metrics.REGISTRY.render()
    assert 'loop="unit_close_test"' in text
    assert 'subsystem="unit_close_sub"' in text
    mon.close()
    text = metrics.REGISTRY.render()
    assert 'loop="unit_close_test"' not in text
    assert 'subsystem="unit_close_sub"' not in text
    mon.close()  # idempotent


def test_cardinality_providers_and_broken_provider():
    mon = loops.LoopMonitor()
    try:
        mon.add_cardinality("unit_prov_ok", lambda: 3)

        def _broken():
            raise RuntimeError("nope")

        mon.add_cardinality("unit_prov_bad", _broken)
        acct = mon.refresh_accounting()
        assert acct == {"unit_prov_ok": 3}
        assert mon.status()["subsystems"]["unit_prov_ok"] == 3
        assert metrics.SUBSYSTEM_ENTRIES.labels("unit_prov_ok").value == 3
    finally:
        mon.close()


@pytest.mark.parametrize("name", [
    "LOOP_TICK_SECONDS", "LOOP_CPU_SECONDS", "LOOP_ITEMS", "LOOP_OVERRUNS",
    "LOOP_ERRORS", "LOOP_BACKLOG", "LOOP_OVERRUN_RATIO", "SUBSYSTEM_ENTRIES",
    "METRIC_SERIES", "CANARY_PROBES", "CANARY_PROBE_SECONDS",
    "CANARY_LATENCY", "ALERTS_FIRING", "HISTORY_SERIES", "HISTORY_EVICTED",
    "PREDICTED_FULL", "VOLUME_PREDICTED_FULL", "INTERFERENCE_INDEX",
    "GOVERNOR_RATE", "GOVERNOR_RETUNES"])
def test_plane_metric_families_are_the_references(name):
    ref, mine = getattr(ref_metrics, name), getattr(metrics, name)
    assert (mine.name, mine.help, mine.label_names, mine.kind) == \
        (ref.name, ref.help, ref.label_names, ref.kind)
    assert metrics.REGISTRY._metrics[mine.name] is mine
    if mine.kind == "histogram":
        assert mine._buckets == ref._buckets


def test_registry_counts_its_own_series():
    for met in (metrics, ref_metrics):
        reg = met.Registry()
        c = reg.counter("t_total", "", ("k",))
        for i in range(5):
            c.labels(str(i)).inc()
        reg.gauge("t_g", "").labels().set(1)
        assert reg.series_count() == 6
    before = metrics.REGISTRY.series_count()
    text = metrics.REGISTRY.render()
    assert f"weedtpu_metric_series {float(before)}" in text or \
        f"weedtpu_metric_series {before}" in text


# ---- fan-out sizing and backoff ------------------------------------------------

def test_fanout_workers_scale_with_nodes_and_knob(monkeypatch):
    monkeypatch.delenv("WEEDTPU_FANOUT_POOL", raising=False)
    for mod in (fanout, ref_fanout):
        assert (mod.workers(2), mod.workers(500), mod.workers(0)) == \
            (2, 64, 1)
    monkeypatch.setenv("WEEDTPU_FANOUT_POOL", "4")
    assert fanout.workers(100) == ref_fanout.workers(100) == 4
    monkeypatch.setenv("WEEDTPU_FANOUT_POOL", "0")
    assert fanout.workers(100) == ref_fanout.workers(100) == 1


@pytest.mark.parametrize("value", ["junk", "4.5", "x4"])
def test_fanout_knob_raises_unlike_the_reference(monkeypatch, value):
    monkeypatch.setenv("WEEDTPU_FANOUT_POOL", value)
    assert ref_fanout.workers(100) == 64  # the reference falls back
    with pytest.raises(ValueError, match="WEEDTPU_FANOUT_POOL"):
        fanout.workers(100)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_backoff_equals_reference(seed):
    """`Backoff` and `backoff_delay` draw the same delays from the same
    seeded generator."""
    got = {}
    for name, mod in (("ref", ref_res), ("port", resilience)):
        rng = random.Random(seed)
        bo = mod.Backoff(base=0.5, cap=20.0, rng=rng)
        seq = [bo.next() for _ in range(12)]
        bo.reset()
        seq.append(bo.next())
        seq += [mod.backoff_delay(a, base=0.25, cap=9.0, rng=rng)
                for a in range(0, 8)]
        got[name] = seq
    assert got["port"] == got["ref"]
    assert max(got["port"][:12]) <= 20.0


# ---- bounds under churn: synthetic 500-node fleets -----------------------------

def _gauge_node(url, used=10.0):
    return {"weedtpu_disk_bytes": {"type": "gauge", "samples": [
        ("weedtpu_disk_bytes", {"vs": url, "dir": "/d", "kind": "used"},
         used),
        ("weedtpu_disk_bytes", {"vs": url, "dir": "/d", "kind": "total"},
         100.0)]}}


def _age_node(url, age=100.0):
    return {"weedtpu_agg_scrape_age_seconds": {
        "type": "gauge", "samples": [
            ("weedtpu_agg_scrape_age_seconds", {"node": url}, age)]}}


def _churn_history(_lp, h, _i, _m):
    store = h.HistoryStore(resolutions=[(0, 8), (60, 8)], max_series=64)
    t0 = 1_700_000_000.0
    for wave in range(25):
        store.record(t0 + wave * 30.0, {
            f"http://churn-h-{wave}-{i}:80":
                _gauge_node(f"http://churn-h-{wave}-{i}:80")
            for i in range(20)})
    return store.series_count(), store.evicted, sorted(store._series)


def test_history_series_bounded_under_500_node_churn():
    got = {k: _churn_history(*mods) for k, mods in PKGS.items()}
    assert got["port"] == got["ref"]
    n, evicted, _ = got["port"]
    assert n <= 64 and evicted > 0


def test_history_counter_baselines_age_out_after_departure():
    store = history.HistoryStore(resolutions=[(0, 8)], max_series=64)
    t0 = 1_700_000_000.0

    def _counter_node(v):
        return {"weedtpu_net_bytes_total": {"type": "counter", "samples": [
            ("weedtpu_net_bytes_total", {"class": "scrub"}, v)]}}

    store.record(t0, {"http://churn-b-gone:80": _counter_node(5.0),
                      "http://churn-b-live:80": _counter_node(5.0)})
    store.record(t0 + 30.0, {"http://churn-b-live:80": _counter_node(9.0)})
    assert "http://churn-b-gone:80" in store._prev
    store.record(t0 + history.HistoryStore.EVICT_IDLE_S + 31.0,
                 {"http://churn-b-live:80": _counter_node(12.0)})
    assert set(store._prev) == {"http://churn-b-live:80"}


def _churn_alerts(_lp, h, _i, _m):
    store = h.HistoryStore(resolutions=[(0, 8)], max_series=512)
    eng = h.AlertEngine(store, rules=h.parse_alert_rules(
        "stale=threshold,series=weedtpu_agg_scrape_age_seconds,"
        "agg=max,window=60,op=gt,value=45,for=0,clear_for=0"))
    t0 = 1_700_000_000.0
    store.record(t0, {f"http://churn-a-{i}:80":
                      _age_node(f"http://churn-a-{i}:80")
                      for i in range(300)})
    eng.evaluate(t0 + 1.0)
    first = len(eng._state["stale"])
    t1 = t0 + 700.0
    store.record(t1, {f"http://churn-a-{i}:80":
                      _age_node(f"http://churn-a-{i}:80")
                      for i in range(10)})
    eng.evaluate(t1 + 1.0)
    eng.evaluate(t1 + 2.0)
    return first, sorted(eng._state["stale"]), eng.status()


def test_alert_groups_bounded_and_pruned_under_churn():
    got = {k: _churn_alerts(*mods) for k, mods in PKGS.items()}
    assert got["port"] == got["ref"]
    first, groups, _ = got["port"]
    assert 0 < first <= history.AlertEngine.MAX_GROUPS
    assert groups == sorted((("node", f"http://churn-a-{i}:80"),)
                            for i in range(10))


def _interf_node():
    return {"weedtpu_volume_request_seconds": {
        "type": "histogram", "samples": [
            ("weedtpu_volume_request_seconds_bucket",
             {"type": "read", "le": "0.005"}, 10.0),
            ("weedtpu_volume_request_seconds_bucket",
             {"type": "read", "le": "+Inf"}, 12.0),
            ("weedtpu_volume_request_seconds_count", {"type": "read"},
             12.0)]}}


def test_interference_index_series_retired_after_eviction_window():
    obs = interference.InterferenceObservatory(min_samples=1)
    t0 = 1_700_000_000.0
    try:
        obs.observe(t0, {"http://churn-i-gone:80": _interf_node(),
                         "http://churn-i-live:80": _interf_node()})
        obs.observe(t0 + 30.0, {"http://churn-i-live:80": _interf_node()})
        assert "http://churn-i-gone:80" in obs._nodes
        obs.observe(t0 + obs.EVICT_IDLE_S + 31.0,
                    {"http://churn-i-live:80": _interf_node()})
        assert "http://churn-i-gone:80" not in obs._nodes
        assert 'node="http://churn-i-gone:80"' not in \
            metrics.REGISTRY.render()
    finally:
        obs.close()


def test_forecaster_retires_gauges_for_departed_nodes():
    store = history.HistoryStore(resolutions=[(0, 16)], max_series=64)
    t0 = 1_700_000_000.0
    url = "http://churn-f-a:80"
    for k, used in enumerate((10.0, 40.0, 70.0)):
        per_node = {url: _gauge_node(url, used=used)}
        per_node[url]["weedtpu_volume_size_bytes"] = {
            "type": "gauge", "samples": [
                ("weedtpu_volume_size_bytes",
                 {"vid": "churnf7", "vs": url}, 1e6 * (k + 1))]}
        store.record(t0 + k * 30.0, per_node)
    f = history.CapacityForecaster(store, window=600.0)
    f.update(now=t0 + 61.0, volume_size_limit=10_000_000)
    assert (url, "/d") in f.disks and "churnf7" in f.volumes
    text = metrics.REGISTRY.render()
    assert f'vs="{url}"' in text and 'vid="churnf7"' in text
    f.update(now=t0 + 10_000.0, volume_size_limit=10_000_000)
    assert not f.disks and not f.volumes
    text = metrics.REGISTRY.render()
    assert f'vs="{url}"' not in text and 'vid="churnf7"' not in text


# ---- /cluster/loops on a port master ---------------------------------------------

@pytest.fixture()
def loops_cluster(tmp_path, monkeypatch):
    """One port volume server under the port's master; ticks on demand;
    a 2 s node timeout, so the expire loop ticks every second."""
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "0")
    monkeypatch.setenv("WEEDTPU_AGG_INTERVAL", "0")
    c = Cluster(tmp_path, n_volume_servers=1)
    c.start()
    c.wait_heartbeats()
    yield c
    c.stop()


def test_cluster_loops_endpoint_and_shell(loops_cluster):
    c = loops_cluster
    st = _get(c.master.url, "/cluster/loops?refresh=1")
    for name in ("aggregator", "history_record", "forecast", "alerts",
                 "interference", "governor"):
        assert name in st["loops"], sorted(st["loops"])
    agg = st["loops"]["aggregator"]
    assert agg["ticks"] >= 1 and agg["items_total"] >= 2
    assert agg["wall_last"] > 0.0
    assert st["headline"].startswith("slowest=")
    subs = st["subsystems"]
    assert set(subs) == {"registry_series", "history_series",
                         "history_node_baselines", "alert_groups",
                         "interference_nodes", "heat_entries",
                         "pinned_traces"}
    assert subs["registry_series"] > 0 and subs["history_series"] > 0
    env = CommandEnv(c.master.url)
    out = io.StringIO()
    run_command(env, "cluster.loops -refresh", out)
    assert "aggregator" in out.getvalue() and "entries:" in out.getvalue()
    out = io.StringIO()
    run_command(env, "cluster.loops -json", out)
    assert "aggregator" in json.loads(out.getvalue())["loops"]
    out = io.StringIO()
    run_command(env, "maintenance.status", out)
    assert "loops:" in out.getvalue()


def test_expire_loop_ticks_through_the_monitor(tmp_path, monkeypatch):
    """The master's expire loop reports each tick as loop "expire" with
    its interval (min(5, node_timeout / 2)) and the nodes it expired."""
    from seaweedfs_tpu_torch.server.master import MasterServer
    monkeypatch.setenv("WEEDTPU_AGG_INTERVAL", "0")
    c = Cluster(tmp_path, n_volume_servers=0).start()
    try:
        c.submit(c.master.stop())
        m = MasterServer("127.0.0.1", c.master.port, node_timeout=0.4)
        c.master = m
        c.submit(m.start())
        beat = {"id": "127.0.0.1:1", "url": "127.0.0.1:1", "volumes": [],
                "ec_shards": [], "max_volume_count": 1}
        m.topo.register_heartbeat(node_id=beat["id"], url=beat["url"],
                                  public_url="", dc="", rack="", beat=beat)
        deadline = time.time() + 10
        st = {}
        while time.time() < deadline:
            st = m.loops.status()["loops"].get("expire", {})
            if st.get("items_total", 0) >= 1:
                break
            time.sleep(0.05)
        assert st["interval"] == 0.2 and st["items_total"] == 1, st
        assert st["errors"] == 0
        assert "127.0.0.1:1" not in m.topo.nodes
    finally:
        c.stop()


# ---- the fleet simulator ------------------------------------------------------

def test_fleetsim_drives_master_loops(tmp_path, monkeypatch):
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "0")
    monkeypatch.setenv("WEEDTPU_REPAIR_INTERVAL", "3600")
    monkeypatch.setenv("WEEDTPU_AGG_INTERVAL", "0")
    c = Cluster(tmp_path, n_volume_servers=1).start()
    c.wait_heartbeats()
    # heartbeat_s is huge: beat_all() below is the only heartbeat source,
    # so registration is deterministic and the test never sleeps
    sim = fleetsim.FleetSim(c.master.url, nodes=20, racks=4,
                            volumes_per_node=2, heartbeat_s=3600.0,
                            base_rps=50.0, seed=7)
    sim.start()
    try:
        assert sim.beat_all() == 20
        st = _get(c.master.url, "/cluster/loops?refresh=1")
        agg = st["loops"]["aggregator"]
        assert agg["items_total"] >= 21  # 20 vnodes + the real fleet
        assert agg["backlog"] == 0      # every scrape answered
        # the synthesized expositions are real enough for the whole
        # observer chain: per-node interference state for every vnode
        assert st["subsystems"]["interference_nodes"] >= 20

        # correlated rack failure -> scrape errors surface as backlog
        failed = sim.fail_rack("rack0")
        assert len(failed) == 5  # 20 nodes round-robined over 4 racks
        st = _get(c.master.url, "/cluster/loops?refresh=1")
        assert st["loops"]["aggregator"]["backlog"] >= len(failed)
        sim.recover_rack("rack0")
        st = _get(c.master.url, "/cluster/loops?refresh=1")
        assert st["loops"]["aggregator"]["backlog"] == 0

        # leave churn shrinks the fleet
        gone = sim.stop_nodes(5)
        assert len(gone) == 5 and len(sim) == 15
    finally:
        sim.stop()
        c.stop()


class _FrozenTime:
    """A `time` module whose clock moves only when the test moves it."""

    def __init__(self, t: float):
        self.t = t

    def time(self) -> float:
        return self.t


@pytest.mark.parametrize("seed", [7, 42])
def test_fleetsim_surfaces_equal_reference(monkeypatch, seed):
    """On a frozen clock and one seed, each vnode's heartbeat, metrics
    exposition and heat sketch, the Zipf weights and a flash crowd's
    pick are the reference's, calm and busy."""
    clock = _FrozenTime(1_700_000_000.0)
    monkeypatch.setattr(fleetsim, "time", clock)
    monkeypatch.setattr(ref_fleetsim, "time", clock)
    sims = {name: mod.FleetSim("127.0.0.1:1", nodes=6, racks=3,
                               volumes_per_node=5, base_rps=80.0, seed=seed)
            for name, mod in (("port", fleetsim), ("ref", ref_fleetsim))}
    for n in (1, 5, 8, 500):
        assert sims["port"].zipf_weights(n) == \
            sims["ref"].zipf_weights(n)
    nodes = {}
    for name, mod in (("port", fleetsim), ("ref", ref_fleetsim)):
        nodes[name] = []
        for idx in range(6):
            vn = mod._VNode(sims[name], idx, f"rack{idx % 3}",
                            list(range(1 + 5 * idx, 6 + 5 * idx)))
            vn.url = f"127.0.0.1:{20000 + idx}"
            vn.tracker_id = f"t{idx}"
            sims[name].nodes[idx] = vn
            nodes[name].append(vn)

    def surfaces(vn):
        return (vn.heartbeat_body(), vn.render_metrics(), vn.render_heat())

    for step in (37.5, 120.25):
        clock.t += step
        for a, b in zip(nodes["port"], nodes["ref"]):
            assert surfaces(a) == surfaces(b)
    assert sims["port"].flash_crowd(0.34, 60.0) == \
        sims["ref"].flash_crowd(0.34, 60.0)
    clock.t += 12.0
    for a, b in zip(nodes["port"], nodes["ref"]):
        assert surfaces(a) == surfaces(b)


def test_port_master_aggregates_both_fleetsims_alike(tmp_path, monkeypatch):
    """A reference and a port FleetSim against one port master: every
    vnode of either is scraped, its families carry the same labels, a
    rack failure in each shows as backlog and clears on recovery."""
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "0")
    monkeypatch.setenv("WEEDTPU_REPAIR_INTERVAL", "3600")
    monkeypatch.setenv("WEEDTPU_AGG_INTERVAL", "0")
    c = Cluster(tmp_path, n_volume_servers=1).start()
    c.wait_heartbeats()
    sims = [mod.FleetSim(c.master.url, nodes=6, racks=2,
                         volumes_per_node=2, heartbeat_s=3600.0, seed=3)
            for mod in (fleetsim, ref_fleetsim)]
    try:
        for sim in sims:
            sim.start()
            assert sim.beat_all() == 6
        st = _get(c.master.url, "/cluster/loops?refresh=1")
        agg = st["loops"]["aggregator"]
        assert agg["items_total"] >= 13 and agg["backlog"] == 0
        per_node = c.master.aggregator.per_node
        shapes = []
        for sim in sims:
            urls = sim.urls()
            assert set(urls) <= set(per_node)
            for u in urls:
                fams = per_node[u]
                shapes.append({f: sorted({(name, tuple(sorted(labels)))
                                          for name, labels, _ in
                                          fam["samples"]})
                               for f, fam in fams.items()})
        assert all(s == shapes[0] for s in shapes)
        for sim in sims:
            failed = sim.fail_rack("rack1")
            assert len(failed) == 3
        st = _get(c.master.url, "/cluster/loops?refresh=1")
        assert st["loops"]["aggregator"]["backlog"] >= 6
        for sim in sims:
            sim.recover_rack("rack1")
        st = _get(c.master.url, "/cluster/loops?refresh=1")
        assert st["loops"]["aggregator"]["backlog"] == 0
    finally:
        for sim in sims:
            sim.stop()
        c.stop()
