"""The port's history plane (seaweedfs_tpu_torch/stats/history.py) held to
the reference's on the CPU.

Every unit case runs one scripted input through both packages'
`HistoryStore`, `AlertEngine` and `CapacityForecaster` (parsed
expositions from each package's own registry, the same seeded values)
and compares the answers with ``==``, floats included: both are the
same pure-Python arithmetic.  Then the twins of tests/test_history.py's
3-node cases on a cluster that is all the port's (its master and
`device="cpu"` volume servers), driven by the reference's client and
shell, `/maintenance/status` and `maintenance.status` included.
"""

import io
import math
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from seaweedfs_tpu.stats import aggregate as ref_ag
from seaweedfs_tpu.stats import history as ref_history
from seaweedfs_tpu.stats import metrics as ref_metrics

from seaweedfs_tpu_torch.stats import aggregate as ag
from seaweedfs_tpu_torch.stats import history, metrics
from tests.test_cluster_obs import _read_all, _upload_and_encode_all
from tests.test_maintenance import _get, _post
from tests.test_torch_master_cluster import Cluster

PKGS = {"ref": (ref_history, ref_ag, ref_metrics),
        "port": (history, ag, metrics)}


def both(scenario, *args):
    """Run `scenario(history, aggregate, metrics, *args)` on each
    package; assert the answers are equal and return the port's."""
    got = {k: scenario(*mods, *args) for k, mods in PKGS.items()}
    assert got["port"] == got["ref"]
    return got["port"]


def _node(mods, counter=None, gauge=None, hist=None):
    """One node's parsed exposition from a fresh registry of `mods`'
    package, parsed by that package."""
    _, agm, met = mods
    reg = met.Registry()
    if counter is not None:
        reg.counter("weedtpu_h_total", "c", ("op",)).labels(
            "read").inc(counter)
    if gauge is not None:
        reg.gauge("weedtpu_h_gauge", "g", ("who",)).labels(
            "x").set(gauge)
    if hist is not None:
        h = reg.histogram("weedtpu_h_seconds", "h")
        for v in hist:
            h.labels().observe(v, trace_id="e" * 32)
    return agm.parse_exposition(reg.render(openmetrics=True))


def _store(hist_mod, res=((0, 8), (10, 8), (60, 8)), max_series=64):
    return hist_mod.HistoryStore(resolutions=list(res),
                                 max_series=max_series)


@pytest.fixture(autouse=True)
def _history_on(monkeypatch):
    monkeypatch.delenv("WEEDTPU_HISTORY", raising=False)
    for mod in (history, ref_history):
        monkeypatch.setattr(mod, "_enabled_cache", (0.0, True))


# ---- rings ---------------------------------------------------------------

def _ring_scenario(h, _ag, _m, res, cap, points):
    r = h._Ring(res, cap)
    for ts, v in points:
        r.append(ts, v)
    return list(r.slots()), r.n, len(r.ts), r.oldest_ts(), r.latest_ts()


@pytest.mark.parametrize("res,cap,points", [
    (10, 4, [(1003.0, 5.0), (1007.0, 1.0), (1012.0, 9.0)]),
    (0, 4, [(100.0 + i, float(i)) for i in range(10)]),
    (0, 8, [(100.0, 1.0), (110.0, 2.0), (105.0, 7.0)]),
], ids=["rollup", "capacity", "out_of_order"])
def test_ring_equals_reference(res, cap, points):
    slots, n, width, _, _ = both(_ring_scenario, res, cap, points)
    assert width == cap and n <= cap and slots


def test_ring_rollup_seeded_equals_reference():
    rng = np.random.default_rng(11)
    pts = sorted((1000.0 + float(rng.integers(0, 400)),
                  float(rng.normal())) for _ in range(300))
    pts += [(1100.0, 3.0), (900.0, -2.0)]  # out of order: merge
    for res, cap in ((0, 64), (10, 16), (60, 4)):
        both(_ring_scenario, res, cap, pts)


# ---- the store -----------------------------------------------------------

def _deltas_scenario(h, a, m):
    mods = (h, a, m)
    store = _store(h)
    t0 = 1000.0
    store.record(t0, {"a": _node(mods, counter=100),
                      "b": _node(mods, counter=50)})
    store.record(t0 + 10, {"a": _node(mods, counter=160),
                           "b": _node(mods, counter=20)})
    return [store.query("weedtpu_h_total", {"op": "read"}, range_s=40,
                        step=10, agg=agg, now=t0 + 10)
            for agg in ("sum", "rate", None, "min", "max", "last",
                        "avg", "increase")]


def test_counter_deltas_per_node_and_across_restart():
    res = both(_deltas_scenario)
    pts = dict(map(tuple, res[0]["vectors"][0]["points"]))
    assert pts[1000.0] is None and pts[1010.0] == 80.0
    assert dict(map(tuple, res[1]["vectors"][0]["points"]))[1010.0] == 8.0


def _gauge_scenario(h, a, m):
    mods = (h, a, m)
    store = _store(h, res=((0, 4), (10, 8), (60, 8)))
    t0 = 2000.0
    for dt, x, y in [(0, 3.0, 5.0), (2, 1.0, 1.0), (4, 9.0, 2.0),
                     (6, 4.0, 4.0), (11, 8.0, 8.0)]:
        store.record(t0 + dt, {"a": _node(mods, gauge=x),
                               "b": _node(mods, gauge=y)})
    out = [store.query("weedtpu_h_gauge", labels, range_s=30, step=10,
                       agg=agg, now=t0 + 12)
           for labels in ({"who": "x"}, None)
           for agg in ("max", "min", "last", "avg", "sum", "rate", None)]
    out.append(store.window_groups("weedtpu_h_gauge", {}, 60,
                                   now=t0 + 12))
    out.append(store.series_points("weedtpu_h_gauge", {}, 60,
                                   now=t0 + 12))
    return out


def test_gauges_sum_across_nodes_and_rollup_aggs():
    res = both(_gauge_scenario)
    assert res[0]["resolution_s"] == 10.0
    by_ts = dict(map(tuple, res[0]["vectors"][0]["points"]))
    assert by_ts[2000.0] == 11.0 and by_ts[2010.0] == 16.0


def _quantile_scenario(h, a, m, qs):
    mods = (h, a, m)
    store = _store(h, res=((0, 16),))
    t0 = 3000.0
    store.record(t0, {"a": _node(mods, hist=[0.004])})
    store.record(t0 + 10, {"a": _node(mods, hist=[0.004] * 21 +
                                      [2.0] * 2)})
    return [store.query("weedtpu_h_seconds", None, range_s=20, step=20,
                        agg=q, now=t0 + 10) for q in qs]


def test_histogram_quantile_over_time_every_pnn():
    res = both(_quantile_scenario, ["p50", "p90", "p99", "p99.9", "p1"])
    p99 = [v for _, v in res[2]["vectors"][0]["points"] if v is not None]
    assert p99 and 1.0 <= p99[-1] <= 2.5


def _seeded_store_scenario(h, a, m, seed):
    """Three nodes, twelve ticks of seeded counters, gauges and
    histogram observations, one node restarting and one missing a tick;
    every agg of every family over two ranges."""
    rng = np.random.default_rng(seed)
    _, agm, met = h, a, m
    regs = {n: met.Registry() for n in ("a", "b", "c")}
    fams = {}
    for n, reg in regs.items():
        fams[n] = (reg.counter("weedtpu_s_total", "c", ("op",)),
                   reg.gauge("weedtpu_s_gauge", "g", ("dir",)),
                   reg.histogram("weedtpu_s_seconds", "h", ("type",)))
    store = _store(h, res=((0, 16), (10, 8), (60, 4)))
    t0 = 5000.0
    for i in range(12):
        per = {}
        for n, (c, g, hh) in fams.items():
            c.labels(("read", "write")[i % 2]).inc(float(rng.integers(1, 50)))
            g.labels("/d%d" % (i % 3)).set(float(rng.normal() * 10))
            for v in rng.exponential(0.05, int(rng.integers(1, 6))):
                hh.labels("read").observe(float(v), trace_id="f" * 32)
            if n == "b" and i == 5:
                # b restarts: a fresh registry counts from zero
                regs[n] = met.Registry()
                fams[n] = (regs[n].counter("weedtpu_s_total", "c", ("op",)),
                           regs[n].gauge("weedtpu_s_gauge", "g", ("dir",)),
                           regs[n].histogram("weedtpu_s_seconds", "h",
                                             ("type",)))
            if n == "c" and i == 7:
                continue  # c's scrape failed this tick
            per[n] = agm.parse_exposition(regs[n].render(openmetrics=True))
        store.record(t0 + 7 * i, per)
    now = t0 + 7 * 11
    out = [store.status()]
    for name, labels in (("weedtpu_s_total", {"op": "read"}),
                         ("weedtpu_s_total", None),
                         ("weedtpu_s_gauge", None),
                         ("weedtpu_s_seconds_count", {"type": "read"})):
        for agg in ("min", "max", "last", "sum", "avg", "rate", None):
            for rng_s, step in ((90, 7), (600, 60)):
                out.append(store.query(name, labels, rng_s, step, agg,
                                       now=now))
    for q in ("p50", "p95", "p99"):
        out.append(store.query("weedtpu_s_seconds", {"type": "read"}, 90,
                               10, q, now=now))
    out.append(store.window_groups("weedtpu_s_seconds_sum", {}, 60, now))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_record_and_query_seeded_equal_reference(seed):
    res = both(_seeded_store_scenario, seed)
    assert res[0]["ticks"] == 12 and res[0]["series"] > 0


def _cardinality_scenario(h, a, m):
    store = _store(h, max_series=5)
    reg = m.Registry()
    g = reg.gauge("weedtpu_card", "g", ("i",))
    for i in range(12):
        g.labels(str(i)).set(float(i))
    store.record(5000.0, {"a": a.parse_exposition(reg.render())})
    first = (store.series_count(), store.evicted, store.slot_capacity())
    store.record(5010.0, {"a": a.parse_exposition(reg.render())})
    return first, store.series_count(), store.evicted, \
        sorted(store._series)


def test_cardinality_eviction_and_memory_bound():
    (n, evicted, cap), n2, _, _ = both(_cardinality_scenario)
    assert (n, evicted, n2) == (5, 7, 5) and cap == 5 * 24


def _gap_scenario(h, a, m):
    mods = (h, a, m)
    store = _store(h)
    t0 = 5500.0
    store.record(t0, {"a": _node(mods, counter=100),
                      "b": _node(mods, counter=100)})
    store.record(t0 + 10, {"a": _node(mods, counter=110)})
    store.record(t0 + 20, {"a": _node(mods, counter=120),
                           "b": _node(mods, counter=160)})
    return store.query("weedtpu_h_total", {"op": "read"}, range_s=40,
                       step=10, agg="sum", now=t0 + 20)


def test_transient_scrape_gap_keeps_counter_baseline():
    res = both(_gap_scenario)
    assert dict(map(tuple, res["vectors"][0]["points"]))[5520.0] == 70.0


def _reenable_scenario(h, a, m, monkeypatch):
    mods = (h, a, m)
    store = _store(h)
    t0 = 6000.0
    monkeypatch.setenv("WEEDTPU_HISTORY", "1")
    h._enabled_cache = (0.0, True)
    store.record(t0, {"a": _node(mods, counter=100)})
    store.record(t0 + 10, {"a": _node(mods, counter=150)})
    monkeypatch.setenv("WEEDTPU_HISTORY", "0")
    h._enabled_cache = (0.0, False)
    store.record(t0 + 20, {"a": _node(mods, counter=3_600_200)})
    monkeypatch.setenv("WEEDTPU_HISTORY", "1")
    h._enabled_cache = (0.0, True)
    store.record(t0 + 30, {"a": _node(mods, counter=3_600_250)})
    store.record(t0 + 40, {"a": _node(mods, counter=3_600_300)})
    return store.query("weedtpu_h_total", {"op": "read"}, range_s=50,
                       step=10, agg="sum", now=t0 + 40)


def test_disabled_window_does_not_spike_counters_on_reenable(monkeypatch):
    res = both(_reenable_scenario, monkeypatch)
    pts = dict(map(tuple, res["vectors"][0]["points"]))
    assert pts[6010.0] == 50.0 and pts[6040.0] == 50.0
    assert pts[6030.0] in (None, 0.0)


def _churn_scenario(h, a, m):
    store = _store(h, max_series=2)
    t0 = 7000.0
    names = []

    def tick(ts, who, v):
        reg = m.Registry()
        reg.gauge("weedtpu_churn", "g", ("who",)).labels(who).set(v)
        store.record(ts, {"a": a.parse_exposition(reg.render())})
        names.append(sorted(dict(k[1]).get("who") for k in store._series))

    tick(t0, "old1", 1.0)
    tick(t0, "old2", 1.0)
    tick(t0 + 10, "fresh", 1.0)
    tick(t0 + store.EVICT_IDLE_S + 20, "newcomer", 1.0)
    return names, store.evicted


def test_dead_series_evicted_for_live_newcomer():
    names, evicted = both(_churn_scenario)
    assert names[2] == ["old1", "old2"] and "newcomer" in names[3]
    assert evicted >= 2


def _gauge_rate_scenario(h, a, m):
    mods = (h, a, m)
    store = _store(h, res=((10, 8),))
    t0 = 8000.0
    for dt, v in ((0, 5.0), (3, 1.0), (6, 5.0)):
        store.record(t0 + dt, {"a": _node(mods, gauge=v)})
    return store.window_groups("weedtpu_h_gauge", {}, 60, now=t0 + 6), \
        store.query("weedtpu_h_gauge", None, 20, 10, "rate", now=t0 + 6)


def test_gauge_rate_uses_slot_first_not_min():
    recs, _ = both(_gauge_rate_scenario)
    assert (recs[0]["first"], recs[0]["last"], recs[0]["min"]) == \
        (5.0, 5.0, 1.0)


# ---- alert rules ---------------------------------------------------------

GOOD_RULES = (
    "hot=threshold,series=weedtpu_x,agg=max,window=30,op=gt,value=5,"
    "for=10;gone=absence,series=weedtpu_y,window=45;"
    "roc=rate,series=weedtpu_z_total,window=20,op=gt,value=0.5,"
    "for=2,clear_for=7;lab=threshold,series=weedtpu_q,label.k=v,op=lt")


def test_alert_rule_parsing_equals_reference():
    assert history.parse_alert_rules(GOOD_RULES) == \
        ref_history.parse_alert_rules(GOOD_RULES)
    assert history.parse_alert_rules(None) == \
        ref_history.parse_alert_rules(None)
    names = {r["name"] for r in history.parse_alert_rules(None)}
    # the default replication rules stay: they see no series until the
    # replication pumps come (ROADMAP 1.22)
    assert {"node_scrape_stale", "scrape_age_absent", "disk_full_soon",
            "replication_stalled", "replication_lag_high"} <= names


@pytest.mark.parametrize("junk", [
    "junk", "noseries=threshold,op=gt", "bad=threshold,series=x,op=ge",
    "w=threshold,series=x,window=soon", "k=gauge,series=x"])
def test_bad_alert_rule_raises_unlike_the_reference(junk, monkeypatch):
    """The reference drops a malformed rule; the port raises, and a
    master with one in WEEDTPU_ALERT_RULES refuses to construct."""
    spec = GOOD_RULES + ";" + junk
    assert [r["name"] for r in ref_history.parse_alert_rules(spec)] == \
        ["hot", "gone", "roc", "lab"]
    with pytest.raises(ValueError):
        history.parse_alert_rules(spec)
    from seaweedfs_tpu_torch.server.master import MasterServer
    monkeypatch.setenv("WEEDTPU_ALERT_RULES", spec)
    with pytest.raises(ValueError):
        MasterServer("127.0.0.1", 1)


def _alert_setup(h, rule_spec, **store_kw):
    store = _store(h, **store_kw)
    pinned = []
    eng = h.AlertEngine(store, rules=h.parse_alert_rules(rule_spec),
                        pin_fn=pinned.append)
    return store, eng, pinned


def _flap_scenario(h, a, m):
    mods = (h, a, m)
    store, eng, pinned = _alert_setup(
        h, "hot=threshold,series=weedtpu_h_gauge,agg=last,window=30,"
        "op=gt,value=10,for=15,clear_for=15")
    t0 = 10000.0
    out = []
    for dt, v in ((0, 1.0), (10, 99.0), (20, 1.0), (30, 99.0), (40, 99.0),
                  (46, 99.0), (56, 1.0), (66, 1.0), (72, 1.0)):
        store.record(t0 + dt, {"a": _node(mods, gauge=v)})
        eng.evaluate(t0 + dt)
        out.append(eng.status())
    return out, pinned


def test_alert_flap_sustain_and_clear_equal_reference():
    out, pinned = both(_flap_scenario)
    assert [s["rules"][0]["state"] for s in out] == [
        "ok", "pending", "ok", "pending", "pending", "firing", "firing",
        "firing", "ok"]
    assert pinned == []


def _exemplar_scenario(h, a, m):
    mods = (h, a, m)
    store, eng, pinned = _alert_setup(
        h, "slow=threshold,series=weedtpu_h_seconds_count,agg=sum,"
        "window=30,op=gt,value=5,for=0")
    t0 = 20000.0
    store.record(t0, {"a": _node(mods, hist=[0.004])})
    store.record(t0 + 10, {"a": _node(mods, hist=[0.004] * 20)})
    eng.evaluate(t0 + 10)
    return eng.status(), pinned


def test_alert_fire_pins_exemplar_equals_reference():
    st, pinned = both(_exemplar_scenario)
    assert st["rules"][0]["state"] == "firing" and pinned == ["e" * 32]


def _rate_absence_scenario(h, a, m):
    mods = (h, a, m)
    store, eng, _ = _alert_setup(
        h, "roc=rate,series=weedtpu_h_total,label.op=read,window=20,op=gt,"
        "value=2,for=0;dark=absence,series=weedtpu_h_gauge,window=25,for=0")
    t0 = 30000.0
    out = []
    for dt, kw in ((0, {"counter": 0, "gauge": 1.0}),
                   (10, {"counter": 10, "gauge": 1.0}),
                   (20, {"counter": 100, "gauge": 1.0}),
                   (60, {"counter": 100})):
        store.record(t0 + dt, {"a": _node(mods, **kw)})
        eng.evaluate(t0 + dt)
        out.append(eng.status())
    return out


def test_alert_rate_rule_on_counter_and_absence():
    out = both(_rate_absence_scenario)
    by = [{r["name"]: r["state"] for r in s["rules"]} for s in out]
    assert by[1] == {"roc": "ok", "dark": "ok"}
    assert by[2]["roc"] == "firing" and by[3]["dark"] == "firing"


def _seeded_alert_scenario(h, a, m, seed):
    """A gauge random-walking around its threshold for 40 ticks under
    a rule with hysteresis on both edges, plus a per-label rule."""
    rng = np.random.default_rng(seed)
    store, eng, pinned = _alert_setup(
        h, "walk=threshold,series=weedtpu_w,agg=avg,window=20,op=gt,"
        "value=0,for=8,clear_for=12;"
        "low=threshold,series=weedtpu_w,label.who=b,agg=min,window=10,"
        "op=lt,value=-1,for=0")
    reg = m.Registry()
    g = reg.gauge("weedtpu_w", "g", ("who",))
    t0 = 40000.0
    x = {"a": 0.0, "b": 0.0}
    out = []
    for i in range(40):
        for who in x:
            x[who] += float(rng.normal())
            g.labels(who).set(x[who])
        store.record(t0 + 3 * i, {"n": a.parse_exposition(reg.render())})
        eng.evaluate(t0 + 3 * i)
        out.append(eng.status())
    return out


@pytest.mark.parametrize("seed", [3, 4])
def test_alert_states_seeded_equal_reference(seed):
    out = both(_seeded_alert_scenario, seed)
    assert len(out) == 40


# ---- capacity forecasting --------------------------------------------------

def _forecast_scenario(h, a, m, flat):
    store = _store(h, res=((0, 64),), max_series=64)
    reg = m.Registry()
    disk = reg.gauge("weedtpu_disk_bytes", "d", ("vs", "dir", "kind"))
    vol = reg.gauge("weedtpu_volume_size_bytes", "v", ("vid", "vs"))
    t0 = 40000.0
    for i in range(12):
        used = 5e8 if flat else 1e8 + 2e6 * 10 * i
        disk.labels("n1:8080", "/data", "used").set(used)
        disk.labels("n1:8080", "/data", "total").set(1e9)
        vol.labels("7", "n1:8080").set(1e6 * 10 * i)
        vol.labels("7", "n2:8080").set(2e6 * 10 * i)
        store.record(t0 + 10 * i,
                     {"n1:8080": a.parse_exposition(reg.render())})
    fc = h.CapacityForecaster(store, window=300)
    fc.update(now=t0 + 110, volume_size_limit=256 * 1024 * 1024)
    snap = fc.snapshot()
    gauges = sorted((k, c.value) for k, c in
                    m.PREDICTED_FULL._children.items()
                    if k == ("n1:8080", "/data"))
    return snap, fc.filling_nodes(1e5), fc.filling_nodes(1.0), gauges


@pytest.mark.parametrize("flat", [False, True], ids=["filling", "flat"])
def test_forecast_on_synthetic_fill_curve_equals_reference(flat):
    snap, filling, soon, _ = both(_forecast_scenario, flat)
    d = snap["disks"][0]
    if flat:
        assert d["predicted_full_seconds"] == history.FORECAST_CAP_S
        assert filling == set()
    else:
        assert d["fill_bps"] == pytest.approx(2e6, rel=0.01)
        assert filling == {"n1:8080"} and soon == set()
        # the soonest-full replica is the volume's forecast
        assert snap["volumes"][0]["fill_bps"] == pytest.approx(2e6,
                                                                rel=0.01)


def test_forecast_window_is_the_references_default():
    store = history.HistoryStore()
    assert history.CapacityForecaster(store).window == \
        ref_history.CapacityForecaster(ref_history.HistoryStore()).window
    assert store.resolutions == ref_history.history_resolutions()
    assert store.max_series == ref_history.history_max_series()


# ---- the dashboard's pieces ------------------------------------------------

@pytest.mark.parametrize("fn,args", [
    ("_svg_sparkline", ([[0, 1.0], [1, None], [2, 3.0], [3, 2.0]],)),
    ("_svg_sparkline", ([[0, None]],)),
    ("_fmt_val", (12345678.9,)), ("_fmt_val", (None,)),
    ("_fmt_secs", (3.2e8,)), ("_fmt_secs", (4000.0,)),
    ("_h", ('<a href="x">&</a>',)),
])
def test_dashboard_helpers_equal_reference(fn, args):
    assert getattr(history, fn)(*args) == getattr(ref_history, fn)(*args)


# ---- scrape age: a never-scraped node is +Inf ------------------------------

def _never_scraped_scenario(h, a, m):
    reg = m.Registry()
    reg.counter("weedtpu_x_total", "c").labels().inc()
    agg = a.ClusterAggregator(lambda: {"127.0.0.1:1": "127.0.0.1:1"},
                              local=("m:1", reg), interval=0)
    seen = []
    agg.observers.append(lambda ts, pn: seen.append(pn))
    try:
        agg.scrape_once()
        out = agg.render()
        fams = seen[-1]["__aggregator__"]
        ages = {lab["node"]: v for _, lab, v in
                fams["weedtpu_agg_scrape_age_seconds"]["samples"]}
        store = _store(h)
        eng = h.AlertEngine(store, rules=h.parse_alert_rules(
            "stale=threshold,series=weedtpu_agg_scrape_age_seconds,"
            "agg=max,window=60,op=gt,value=45,for=0"))
        now = time.time()
        store.record(now, seen[-1])
        eng.evaluate(now)
        rule = eng.status()["rules"][0]
        firing = [(g["labels"], g.get("stale")) for g in rule["groups"]
                  if g["state"] == "firing"]
        return ('weedtpu_agg_scrape_age_seconds{node="127.0.0.1:1"} +Inf'
                in out, ages["127.0.0.1:1"], ages["m:1"] < 5.0,
                rule["state"], firing)
    finally:
        agg.stop()


def test_never_scraped_node_reports_inf_not_fresh():
    inf_line, age, fresh, state, firing = both(_never_scraped_scenario)
    assert inf_line and age == math.inf and fresh
    assert state == "firing" and firing == [({"node": "127.0.0.1:1"}, True)]


# ---- twins of the 3-node cases, on port nodes ------------------------------

@pytest.fixture()
def hist_cluster(tmp_path, monkeypatch):
    """The port's master and three port volume servers on the CPU, no
    background aggregation (ticks driven by ?refresh=1), the reference
    case's rules."""
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "0")
    monkeypatch.setenv("WEEDTPU_AGG_INTERVAL", "0")
    monkeypatch.setenv("WEEDTPU_HEDGE_PCT", "0")
    monkeypatch.setenv(
        "WEEDTPU_ALERT_RULES",
        "read_time_burn=rate,series=weedtpu_volume_request_seconds_sum,"
        "label.type=read,window=8,op=gt,value=0.8,for=0,clear_for=0.3;"
        "node_scrape_stale=threshold,"
        "series=weedtpu_agg_scrape_age_seconds,agg=max,window=60,"
        "op=gt,value=45,for=0")
    c = Cluster(tmp_path, n_volume_servers=3).start()
    c.wait_heartbeats()
    yield c
    c.stop()


def _alerts(master_url, refresh=True):
    qs = "?refresh=1" if refresh else ""
    return _get(master_url, f"/cluster/alerts{qs}", timeout=60)


def _alert_rule(st, name):
    return next(r for r in st["rules"] if r["name"] == name)


def test_cluster_alerts_fire_on_delay_fault_and_clear(hist_cluster):
    c = hist_cluster
    client, payloads = _upload_and_encode_all(c)
    _alerts(c.master.url)
    _read_all(client, payloads)
    st = _alerts(c.master.url)
    assert _alert_rule(st, "read_time_burn")["state"] == "ok", st
    assert _alert_rule(st, "node_scrape_stale")["state"] == "ok"
    try:
        for vs in c.volume_servers:
            _post(vs.url, "/admin/faults", {"faults": [
                {"action": "delay_shard_read", "ms": 100}]})
        _read_all(client, payloads)
        st = _alerts(c.master.url)
        if _alert_rule(st, "read_time_burn")["state"] != "firing":
            st = _alerts(c.master.url)
        rule = _alert_rule(st, "read_time_burn")
        assert rule["state"] == "firing", rule
        group = next(g for g in rule["groups"] if g["state"] == "firing")
        assert group["labels"].get("type") == "read"
        assert group["value"] > 0.8
        # the reference's shell renders the port master's alerts
        from seaweedfs_tpu.shell.commands import CommandEnv, run_command
        out = io.StringIO()
        run_command(CommandEnv(c.master.url), "cluster.alerts", out)
        assert "read_time_burn" in out.getvalue() and \
            "FIRING" in out.getvalue(), out.getvalue()
        # the firing alert surfaces in maintenance.status and its shell
        # command
        mst = _get(c.master.url, "/maintenance/status")
        assert next(r for r in mst["alerts"]["rules"]
                    if r["name"] == "read_time_burn")["state"] == "firing"
        out = io.StringIO()
        run_command(CommandEnv(c.master.url), "maintenance.status", out)
        assert "alerts:" in out.getvalue(), out.getvalue()
    finally:
        for vs in c.volume_servers:
            _post(vs.url, "/admin/faults", {"faults": [
                {"action": "delay_shard_read", "ms": 0}]})
    deadline = time.time() + 30
    state = "firing"
    while time.time() < deadline:
        time.sleep(0.4)
        state = _alert_rule(_alerts(c.master.url),
                            "read_time_burn")["state"]
        if state == "ok":
            break
    assert state == "ok", state


def test_cluster_history_endpoint_and_dashboard(hist_cluster):
    c = hist_cluster
    client, payloads = _upload_and_encode_all(c, n=8)
    for _ in range(3):
        _read_all(client, payloads)
        c.master.aggregator.scrape_once()
        time.sleep(0.25)
    h = _get(c.master.url,
             "/cluster/history?series=weedtpu_volume_request_total"
             "&labels=type=read&agg=sum&range=60&step=5", timeout=60)
    assert h["vectors"], h
    vals = [v for _, v in h["vectors"][0]["points"] if v is not None]
    assert vals and sum(vals) > 0
    q = _get(c.master.url,
             "/cluster/history?series=weedtpu_volume_request_seconds"
             "&labels=type=read&agg=p99&range=60&step=60", timeout=60)
    assert q["vectors"]
    assert len(c.master.history.resolutions) >= 3 and "resolution_s" in h
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"http://{c.master.url}/cluster/history",
                               timeout=10)
    assert e.value.code == 400
    with urllib.request.urlopen(
            f"http://{c.master.url}/cluster/metrics?refresh=1",
            timeout=60) as r:
        fed = r.read().decode()
    for vs in c.volume_servers:
        assert any(f'vs="{vs.url}"' in line for line in fed.splitlines()
                   if line.startswith("weedtpu_predicted_full_seconds{")), \
            vs.url
    assert "weedtpu_metric_series" in fed
    with urllib.request.urlopen(
            f"http://{c.master.url}/cluster/dashboard", timeout=60) as r:
        dash = r.read().decode()
    assert "<svg" in dash and "Capacity forecasts" in dash
    assert "src=" not in dash and "http://" not in dash.replace(
        f"http://{c.master.url}", "")
    from seaweedfs_tpu.shell.commands import CommandEnv, run_command
    out = io.StringIO()
    run_command(CommandEnv(c.master.url),
                "cluster.history -series weedtpu_volume_request_total"
                " -labels type=read -agg sum -range 60 -step 5", out)
    assert "weedtpu_volume_request_total" in out.getvalue()


def test_history_store_memory_is_bounded_in_live_master(hist_cluster):
    c = hist_cluster
    store = c.master.history
    for _ in range(3):
        c.master.aggregator.scrape_once()
    assert 0 < store.series_count() <= store.max_series
    assert store.status()["slot_capacity"] == store.max_series * sum(
        cap for _, cap in store.resolutions)
    with store._lock:
        s = next(iter(store._series.values()))
    assert [len(r.ts) for r in s.rings] == \
        [cap for _, cap in store.resolutions]
