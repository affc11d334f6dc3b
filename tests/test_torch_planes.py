"""The port's master planes on the CPU, held to the reference's.

Unit cases feed both packages the same seeded input and compare with
``==``: `parse_exposition` on both packages' rendered registries, the
counter and histogram merges, `histogram_quantile`, the SLO engine over
one scripted history, the heat fleet merge, `aggregate_fleet` and
`roofline_offenders`.  Then the master: its route table against the
reference's, each malformed knob raising where the reference falls
back, /cluster/slo over the repair planner's health ledger, twins of
tests/test_cluster_obs.py and of tests/test_flight_recorder.py's canary
and scrape-age cases on clusters that are all the port's (its master,
`device="cpu"` volume servers, the reference's client and shell), a
mixed cluster whose port master federates a reference and a port
volume server, and the planes in a fresh interpreter without jax.
"""

import io
import json
import math
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

from seaweedfs_tpu.client import WeedClient
from seaweedfs_tpu.server import master as ref_master
from seaweedfs_tpu.shell.commands import CommandEnv, run_command
from seaweedfs_tpu.stats import aggregate as ref_ag
from seaweedfs_tpu.stats import heat as ref_heat
from seaweedfs_tpu.stats import metrics as ref_metrics
from seaweedfs_tpu.stats import pipeline as ref_pipeline

from seaweedfs_tpu_torch.server import master as mastermod
from seaweedfs_tpu_torch.stats import aggregate as ag
from seaweedfs_tpu_torch.stats import heat, metrics, pipeline
from seaweedfs_tpu_torch.utils import fanout
from tests.test_cluster_obs import _read_all, _upload_and_encode_all
from tests.test_maintenance import _get, _post
from tests.test_torch_master_cluster import REPO, Cluster
from tests.test_torch_stats import _Clock, _drive_heat


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---- parse_exposition and the merges ---------------------------------------

def _seeded_registry(met, seed):
    """Every metric kind, labels needing escapes, exemplars on the
    histogram, from the seed."""
    rng = np.random.default_rng(seed)
    reg = met.Registry()
    c = reg.counter("weedtpu_p_requests_total", "reqs", ("op", "class"))
    g = reg.gauge("weedtpu_p_gauge", 'a "quoted" help', ("dir",))
    h = reg.histogram("weedtpu_p_seconds", "lat", ("type",),
                      buckets=(0.001, 0.01, 0.1, 1.0))
    u = reg.counter("weedtpu_p_plain_total", "no labels")
    for _ in range(200):
        c.labels(("read", "write")[rng.integers(2)],
                 ("2xx", "5xx")[int(rng.random() < 0.1)]).inc()
        g.labels(f'/d{rng.integers(3)}"x\\y').set(float(rng.normal()))
        h.labels(("read", "write")[rng.integers(2)]).observe(
            float(rng.exponential(0.05)), trace_id=f"{seed:032x}")
    u.labels().inc(7)
    return reg


@pytest.mark.parametrize("openmetrics", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_parse_exposition_on_both_registries(seed, openmetrics,
                                            monkeypatch):
    """Each package's parser reads each package's rendering alike,
    OpenMetrics exemplars and the `_total` folding included (exemplars
    carry their wall time: the clock is pinned)."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    texts = [_seeded_registry(met, seed).render(openmetrics=openmetrics)
             for met in (metrics, ref_metrics)]
    assert texts[0] == texts[1]
    for text in texts:
        mine, ref = ag.parse_exposition(text), ref_ag.parse_exposition(text)
        assert mine == ref
        assert mine["weedtpu_p_requests_total"]["type"] == "counter"
        if openmetrics:
            assert mine["weedtpu_p_seconds"]["exemplars"]


def test_parse_exposition_edge_lines_equal_reference():
    text = "\n".join([
        "# HELP weedtpu_om counts", "# TYPE weedtpu_om counter",
        'weedtpu_om_total{a="1"} 3 # {trace_id="ab\\"c"} 1.0',
        "# TYPE weedtpu_h histogram",
        'weedtpu_h_bucket{le="0.1"} 1', 'weedtpu_h_bucket{le="+Inf"} 2',
        "weedtpu_h_sum 0.3", "weedtpu_h_count 2",
        "garbage line here", "weedtpu_nan NaN", "weedtpu_inf +Inf",
        "weedtpu_neg -1e-3", "# a comment", "# EOF", ""])
    # repr: NaN equals nothing, itself included
    assert repr(ag.parse_exposition(text)) == \
        repr(ref_ag.parse_exposition(text))


def _per_node(seed, n=3):
    """{node: parsed families} from seeded registries of the port."""
    return {f"n{i}": ag.parse_exposition(
        _seeded_registry(metrics, seed * 10 + i).render(openmetrics=True))
        for i in range(n)}


@pytest.mark.parametrize("seed", [2, 3])
def test_merges_and_quantiles_equal_reference(seed):
    per = _per_node(seed)
    assert ag.merge_counters(per) == ref_ag.merge_counters(per)
    mh = ag.merge_histograms(per)
    assert mh == ref_ag.merge_histograms(per)
    for rec in mh.values():
        for q in (0.0, 0.5, 0.9, 0.99, 1.0):
            assert ag.histogram_quantile(rec["buckets"], q) == \
                ref_ag.histogram_quantile(rec["buckets"], q)
    rng = np.random.default_rng(seed)
    for _ in range(50):
        les = sorted(set(rng.choice([0.001, 0.01, 0.1, 1.0, 2.5, math.inf],
                                    size=int(rng.integers(1, 6)))))
        cum = np.cumsum(rng.integers(0, 5, len(les))).astype(float)
        b = dict(zip(les, cum))
        q = float(rng.random())
        assert ag.histogram_quantile(b, q) == ref_ag.histogram_quantile(b, q)
    assert ag.histogram_quantile({}, 0.5) is None


SLO_RULES = (
    "read_availability=availability,op=read,target=0.999;"
    "lat=latency,family=weedtpu_p_seconds,label.type=read,ms=20,"
    "target=0.9;"
    "lat_unaligned=latency,family=weedtpu_p_seconds,ms=40,target=0.5;"
    "canary=availability,family=weedtpu_p_requests_total,target=0.95;"
    "backlog=backlog,family=weedtpu_p_gauge,label.dir!=/d0")


def _history(seed, ticks=8):
    """A scripted aggregator history: per-node counters and histograms
    over `ticks` scrapes of seeded, growing registries; node n1 restarts
    half way (a fresh registry)."""
    rng = np.random.default_rng(seed)
    mets = {}
    out = []
    for t in range(ticks):
        per = {}
        for i in range(3):
            if (i, t) == (1, ticks // 2) or i not in mets:
                mets[i] = _seeded_registry(metrics, 100 + i)
            reg = mets[i]
            c = reg.counter("weedtpu_http_requests_total", "", (
                "server", "op", "class"))
            for _ in range(int(rng.integers(5, 40))):
                c.labels("volume", ("read", "write")[rng.integers(2)],
                         ("2xx", "5xx")[int(rng.random() < 0.05)]).inc()
            reg.histogram("weedtpu_p_seconds", "lat", ("type",),
                          buckets=(0.001, 0.01, 0.1, 1.0)).labels(
                "read").observe(float(rng.exponential(0.03)))
            per[f"n{i}"] = ag.parse_exposition(reg.render())
        out.append((1000.0 + 10 * t,
                    {n: ag.merge_counters({n: f}) for n, f in per.items()},
                    {n: ag.merge_histograms({n: f}) for n, f in per.items()}))
    return out


@pytest.mark.parametrize("seed", [4, 5])
@pytest.mark.parametrize("windows", [[15.0, 45.0], [300.0, 3600.0],
                                     [5.0]])
def test_slo_engine_over_a_scripted_history(seed, windows):
    hist = _history(seed)
    rules = ag.parse_rules(SLO_RULES)
    assert rules == ref_ag.parse_rules(SLO_RULES)
    for upto in (1, 2, len(hist) // 2 + 1, len(hist)):
        mine = ag.SLOEngine(rules, windows).evaluate(hist[:upto])
        ref = ref_ag.SLOEngine(rules, windows).evaluate(hist[:upto])
        assert mine == ref
    assert ag.SLOEngine(rules, windows).evaluate([]) == \
        ref_ag.SLOEngine(rules, windows).evaluate([])


def test_default_slo_rules_and_windows_are_the_references(monkeypatch):
    for var in ("WEEDTPU_SLO_RULES", "WEEDTPU_SLO_WINDOWS",
                "WEEDTPU_AGG_INTERVAL"):
        monkeypatch.delenv(var, raising=False)
    assert ag.parse_rules() == ref_ag.parse_rules()
    assert ag.slo_windows() == ref_ag.slo_windows()
    assert ag.agg_interval() == ref_ag.agg_interval()
    monkeypatch.setenv("WEEDTPU_SLO_WINDOWS", "60,5,600")
    assert ag.slo_windows() == ref_ag.slo_windows() == [5.0, 60.0, 600.0]


# ---- the heat fleet merge ----------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_heat_fleet_merge_equals_reference(seed):
    """`SpaceSaving.merge`, `CountMin.merge`, `_entry_view`,
    `merge_serialized` and `merged_estimate` over three seeded node
    trackers on a shared clock."""
    out = {}
    for name, mod in (("ref", ref_heat), ("port", heat)):
        clock = _Clock()
        snaps = [_drive_heat(mod, seed + 20 * i, clock).serialize()
                 for i in range(3)]
        for s in snaps:
            s.pop("id")
        now = clock.t + 5.0
        res = [mod.merge_serialized(snaps, now=now),
               mod.merge_serialized(snaps, k=4, halflife=60.0, now=now),
               mod.SpaceSaving.merge([s["dims"]["chunk"] for s in snaps],
                                     8, 30.0, now),
               mod.CountMin.merge([s["cms"]["volume"] for s in snaps],
                                  30.0, now).rows,
               [mod.merged_estimate(snaps, d, f"key{i}", now=now)
                for d in mod.DIMS for i in range(6)],
               [mod._entry_view(e, 30.0, now) for e in
                mod.SpaceSaving.merge([s["dims"]["tenant"] for s in snaps],
                                      8, 30.0, now)["entries"]]]
        out[name] = res
    assert out["port"] == out["ref"]
    # a mismatched Count-Min layout is skipped, not merged
    bad = {"width": 3, "depth": heat.CMS_DEPTH, "rows": [[1.0] * 3] * 4}
    assert heat.CountMin.merge([bad], 30.0, 0.0).rows == \
        ref_heat.CountMin.merge([bad], 30.0, 0.0).rows


# ---- the perf fleet view -------------------------------------------------------

def _perf_payloads(seed):
    rng = np.random.default_rng(seed)
    out = []
    for n in range(4):
        jobs = []
        for j in range(int(rng.integers(1, 4))):
            stages = {s: {"busy_s": float(rng.random()),
                          "bytes": float(rng.integers(0, 1 << 20)),
                          "busy_frac": float(rng.random())}
                      for s in ("read", "encode", "write_data")}
            jobs.append({"kind": ("ec_encode", "ec_rebuild")[j % 2],
                         "stages": stages,
                         "state": ("running", "done")[int(rng.random() < .5)],
                         "bottleneck": {"stage": "read",
                                        "busy_frac": float(rng.random())}})
        rows = [{"kernel": f"k{i}", "resource": "hbm",
                 "busy_s": float(rng.random()),
                 "ceiling_frac": float(rng.random()) if i % 3 else None}
                for i in range(6)]
        out.append((f"n{n}", {"id": f"t{n % 3}", "jobs": jobs,
                              "tile": {"verdict": "ok"} if n == 2 else None,
                              "roofline": {"rows": rows}}))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_aggregate_fleet_and_offenders_equal_reference(seed):
    per = _perf_payloads(seed)
    mine = pipeline.aggregate_fleet(per)
    assert mine == ref_pipeline.aggregate_fleet(per)
    assert mine["nodes"] == ["n0", "n1", "n2"]  # n3 shares n0's tracker
    for _, p in per:
        for limit in (2, 5):
            assert pipeline.roofline_offenders(p["roofline"], limit) == \
                ref_pipeline.roofline_offenders(p["roofline"], limit)


# ---- the master: route table, knobs ------------------------------------------

def test_master_serves_every_reference_route_but_six():
    """Every route of the reference's master (the name is the pin's from
    when six, then one, were left out; the geo view came last, with
    replication)."""
    assert not hasattr(mastermod, "LEFT_OUT")
    mine = mastermod.MasterServer("127.0.0.1", 1)
    ref = ref_master.MasterServer("127.0.0.1", 1)
    table = {(r.method, r.resource.canonical)
             for r in mine.app.router.routes()}
    want = {(r.method, r.resource.canonical)
            for r in ref.app.router.routes()}
    assert table == want
    for path in ("/cluster/geo", "/cluster/metrics", "/cluster/slo",
                 "/cluster/heat",
                 "/cluster/perf", "/cluster/trace/{tid}", "/cluster/traces",
                 "/cluster/canary", "/cluster/history",
                 "/cluster/interference", "/cluster/alerts",
                 "/cluster/loops", "/cluster/dashboard",
                 "/maintenance/status"):
        assert ("GET", path) in table, path
    for path in ("/maintenance/scrub_report", "/maintenance/tick"):
        assert ("POST", path) in table, path
    for path in ("/maintenance/convert", "/cluster/autopilot"):
        assert ("*", path) in table, path


KNOBS = [("WEEDTPU_AGG_INTERVAL", "soon"), ("WEEDTPU_SLO_RULES", "junk"),
         ("WEEDTPU_SLO_RULES", "x=latency,ms=fast"),
         ("WEEDTPU_SLO_WINDOWS", "300,x"), ("WEEDTPU_SLO_WINDOWS", "-5"),
         ("WEEDTPU_HISTORY", "yes"), ("WEEDTPU_ALERT_RULES", "r=gauge"),
         ("WEEDTPU_INTERF_MIN_SAMPLES", "many"),
         ("WEEDTPU_INTERF_ALPHA", "x"), ("WEEDTPU_INTERFERENCE", "on"),
         ("WEEDTPU_GOVERNOR", "off"), ("WEEDTPU_SCRUB_MBPS", "fast"),
         ("WEEDTPU_CANARY_INTERVAL", "30s"), ("WEEDTPU_FANOUT_POOL", "4.5")]


@pytest.mark.parametrize("knob,value", KNOBS,
                         ids=[f"{k}={v}" for k, v in KNOBS])
def test_malformed_plane_knob_raises_unlike_the_reference(knob, value,
                                                          monkeypatch):
    """The reference's master falls back on each of these; the port's
    raises at construction, before its socket binds."""
    monkeypatch.setenv(knob, value)
    ref_master.MasterServer("127.0.0.1", 1)
    with pytest.raises(ValueError, match=knob if "RULES" not in knob
                       else "rule"):
        mastermod.MasterServer("127.0.0.1", 1)


def test_constant_knobs_are_the_references_defaults():
    from seaweedfs_tpu.stats import canary as ref_canary
    from seaweedfs_tpu.stats import interference as ref_itf
    from seaweedfs_tpu.utils import fanout as ref_fanout
    from seaweedfs_tpu_torch.stats import canary, interference
    m = mastermod.MasterServer("127.0.0.1", 1)
    r = ref_master.MasterServer("127.0.0.1", 1)
    assert canary.ALL_PATHS == ref_canary.canary_paths()
    assert (m.governor.target, m.governor.floor_frac, m.governor.step) == \
        (r.governor.target, r.governor.floor_frac, r.governor.step)
    assert m.interference.quiet_bps == r.interference.quiet_bps
    assert interference.QUIET_BPS == ref_itf.InterferenceObservatory(
        ).quiet_bps
    assert fanout.pool_cap() == ref_fanout.pool_cap()
    assert [fanout.workers(n) for n in (0, 1, 64, 500)] == \
        [ref_fanout.workers(n) for n in (0, 1, 64, 500)]
    assert m.aggregator.interval == r.aggregator.interval


# ---- clusters of port nodes --------------------------------------------------

@pytest.fixture()
def obs_cluster(tmp_path, monkeypatch):
    """The twin of tests/test_cluster_obs.py's: three port volume servers
    under the port's master, ticks on demand, 1 s / 3 s windows, a 50 ms
    read-latency rule."""
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "0")
    monkeypatch.setenv("WEEDTPU_AGG_INTERVAL", "0")
    monkeypatch.setenv("WEEDTPU_SLO_WINDOWS", "1,3")
    monkeypatch.setenv(
        "WEEDTPU_SLO_RULES",
        "read_availability=availability,op=read,target=0.999;"
        "read_latency=latency,family=weedtpu_volume_request_seconds,"
        "label.type=read,ms=50,target=0.8;"
        "repair_backlog=backlog,family=weedtpu_volume_health,"
        "label.state!=healthy")
    c = Cluster(tmp_path, n_volume_servers=3).start()
    c.wait_heartbeats()
    yield c
    c.stop()


def _slo(master_url, refresh=True):
    return _get(master_url, "/cluster/slo" + ("?refresh=1" if refresh
                                              else ""), timeout=60)


def _rule(slo, name):
    return next(r for r in slo["rules"] if r["name"] == name)


def test_cluster_slo_flips_under_delay_faults(obs_cluster, monkeypatch):
    monkeypatch.setenv("WEEDTPU_HEDGE_PCT", "0")
    c = obs_cluster
    client, payloads = _upload_and_encode_all(c)
    _slo(c.master.url)
    _read_all(client, payloads)
    time.sleep(0.1)
    slo = _slo(c.master.url)
    assert set(c.master.aggregator.per_node) >= \
        {vs.url for vs in c.volume_servers}
    assert _rule(slo, "read_latency")["state"] == "ok", slo
    assert _rule(slo, "read_availability")["state"] == "ok"
    assert _rule(slo, "repair_backlog")["state"] == "ok"
    try:
        for vs in c.volume_servers:
            _post(vs.url, "/admin/faults", {"faults": [
                {"action": "delay_shard_read", "ms": 100}]})
        _read_all(client, payloads)
        slo = _slo(c.master.url)
        r = _rule(slo, "read_latency")
        assert r["state"] == "violated", r
        assert all(w["burn_rate"] > 1 for w in r["windows"].values()), r
        assert max(w.get("p99_ms") or 0 for w in r["windows"].values()) \
            >= 50, r
        assert _rule(slo, "read_availability")["state"] == "ok"
        assert slo["state"] == "violated"
        env = CommandEnv(c.master.url)
        out = io.StringIO()
        run_command(env, "cluster.slo -json", out)
        assert _rule(json.loads(out.getvalue()),
                     "read_latency")["state"] == "violated"
        out = io.StringIO()
        run_command(env, "cluster.slo", out)
        assert "violated" in out.getvalue()
        out = io.StringIO()
        run_command(env, "maintenance.status", out)
        assert "slo:" in out.getvalue() and \
            "read_latency" in out.getvalue(), out.getvalue()
    finally:
        for vs in c.volume_servers:
            _post(vs.url, "/admin/faults", {"faults": [
                {"action": "delay_shard_read", "ms": 0}]})
    deadline = time.time() + 15
    while time.time() < deadline:
        _read_all(client, payloads)
        r = _rule(_slo(c.master.url), "read_latency")
        if r["state"] == "ok":
            break
        time.sleep(0.5)
    assert r["state"] == "ok", r


def test_cluster_metrics_federation_and_pprof_under_load(obs_cluster):
    c = obs_cluster
    client, payloads = _upload_and_encode_all(c, n=16)
    _read_all(client, payloads)
    with urllib.request.urlopen(
            f"http://{c.master.url}/cluster/metrics?refresh=1",
            timeout=60) as resp:
        text = resp.read().decode()
    for vs in c.volume_servers:
        assert f'node="{vs.url}"' in text, vs.url
        assert f'weedtpu_cluster_node_up{{node="{vs.url}"}} 1' in text
    assert f'node="{c.master.url}"' in text
    assert "weedtpu_http_requests_total" in text
    assert "# TYPE weedtpu_volume_request_seconds histogram" in text
    # the federation parses back by either package's parser alike
    assert ag.parse_exposition(text) == ref_ag.parse_exposition(text)
    stop = threading.Event()

    def hammer():
        fids = list(payloads)
        i = 0
        while not stop.is_set():
            try:
                client.download(fids[i % len(fids)])
            except Exception:
                pass
            i += 1

    threads = [threading.Thread(target=hammer, daemon=True)
               for _ in range(4)]
    for t in threads:
        t.start()
    try:
        with urllib.request.urlopen(
                f"http://{c.volume_servers[0].url}/debug/pprof"
                "?seconds=1.5&hz=147", timeout=30) as resp:
            prof = resp.read().decode()
    finally:
        stop.set()
        for t in threads:
            t.join(5)
    lines = [ln for ln in prof.splitlines() if ln.strip()]
    assert lines and any("ec_volume." in ln or "dispatch." in ln
                         for ln in lines), prof[:2000]
    for ln in lines[:10]:
        stack, _, count = ln.rpartition(" ")
        assert count.isdigit() and stack, ln


def test_canary_probe_ok_then_failure_flips_slo(tmp_path, monkeypatch):
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "0")
    monkeypatch.setenv("WEEDTPU_AGG_INTERVAL", "0")
    c = Cluster(tmp_path, n_volume_servers=1).start()
    try:
        c.wait_heartbeats()
        st = c.submit(c.master.canary.run_once(paths=("blob",)))
        blob = st["paths"]["blob"]
        assert blob["outcome"] == "ok", blob
        assert blob["ms"] > 0 and len(blob["trace_id"]) == 32
        wf = _get(c.master.url, f"/cluster/trace/{blob['trace_id']}")
        assert any(s["name"] == "canary.blob" for s in wf["spans"])
        assert "volume" in wf["servers"]
        canary_rule = _rule(_slo(c.master.url), "canary_availability")
        assert canary_rule["state"] == "ok"
        vs = c.volume_servers[0]
        c.submit(vs.stop())
        c.volume_servers.remove(vs)
        st = c.submit(c.master.canary.run_once(paths=("blob",)))
        blob = st["paths"]["blob"]
        assert blob["outcome"] == "fail" and blob.get("error"), blob
        assert blob.get("waterfall", {}).get("spans")
        slo = _slo(c.master.url)
        assert _rule(slo, "canary_availability")["state"] == "violated"
        assert slo["state"] == "violated"
        # /cluster/canary answers the same state, and ?probe=1 probes
        got = _get(c.master.url, "/cluster/canary")
        assert got["paths"]["blob"]["outcome"] == "fail"
        assert got["enabled_paths"] == ["blob", "s3", "filer", "degraded"]
    finally:
        c.stop()


def test_canary_degraded_probe_reconstructs(tmp_path, monkeypatch):
    """The degraded path drives /admin/ec/probe_read on a port node; the
    s3 and filer paths skip (no such members) and book no SLO event."""
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "0")
    monkeypatch.setenv("WEEDTPU_AGG_INTERVAL", "0")
    c = Cluster(tmp_path, n_volume_servers=2).start()
    try:
        c.wait_heartbeats()
        client = WeedClient(c.master.url)
        rng = np.random.default_rng(3)
        fids = [client.upload(rng.integers(0, 256, 40_000,
                                           dtype=np.uint8).tobytes(),
                              name=f"deg{i}.bin") for i in range(12)]
        vid = int(fids[0].partition(",")[0])
        time.sleep(0.7)
        env = CommandEnv(c.master.url)
        out = io.StringIO()
        run_command(env, "lock", out)
        run_command(env, f"ec.encode -volumeId {vid}", out)
        run_command(env, "unlock", out)
        time.sleep(0.7)
        client.close()
        probes = metrics.CANARY_PROBES
        before = {p: probes.labels(p, "2xx").value
                  for p in ("degraded", "s3", "filer")}
        st = c.submit(c.master.canary.run_once(
            paths=("degraded", "s3", "filer")))
        assert st["paths"]["degraded"]["outcome"] == "ok", st
        assert st["paths"]["s3"]["outcome"] == "skip"
        assert st["paths"]["filer"]["outcome"] == "skip"
        grew = {p: probes.labels(p, "2xx").value - before[p]
                for p in before}
        assert grew == {"degraded": 1, "s3": 0, "filer": 0}
        holder = next(vs for vs in c.volume_servers
                      if any(vid in loc.ec_volumes
                             for loc in vs.store.locations))
        probe = _get(holder.url, f"/admin/ec/probe_read?volume={vid}")
        assert probe["bytes"] > 0 and "skipped_shard" in probe
        # the degraded probe's waterfall holds the server's probe span
        wf = _get(c.master.url, "/cluster/trace/"
                  + st["paths"]["degraded"]["trace_id"])
        names = {s["name"] for s in wf["spans"]}
        assert {"canary.degraded", "volume.probe_read",
                "codec.reconstruct"} <= names, names
    finally:
        c.stop()


def test_agg_scrape_age_and_dead_node_gap(tmp_path, monkeypatch):
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "0")
    monkeypatch.setenv("WEEDTPU_AGG_INTERVAL", "0")
    c = Cluster(tmp_path, n_volume_servers=1).start()
    try:
        c.wait_heartbeats()
        with urllib.request.urlopen(
                f"http://{c.master.url}/cluster/metrics?refresh=1",
                timeout=30) as r:
            text = r.read().decode()
        vs = c.volume_servers[0]
        for node in (vs.url, c.master.url):
            assert f'weedtpu_agg_scrape_age_seconds{{node="{node}"}}' \
                in text
        dead = f"127.0.0.1:{free_port()}"
        agg = ag.ClusterAggregator(lambda: {vs.url: vs.url, dead: dead},
                                   interval=0)
        agg.scrape_once()
        out = agg.render()
        assert f'weedtpu_cluster_node_up{{node="{dead}"}} 0' in out
        assert f'weedtpu_agg_scrape_age_seconds{{node="{dead}"}} +Inf' \
            in out
        assert f'weedtpu_agg_scrape_age_seconds{{node="{vs.url}"}}' in out
        agg.stop()
    finally:
        c.stop()


def test_fleet_views_traces_heat_perf(tmp_path, monkeypatch):
    """/cluster/traces lists the fleet's traces, /cluster/heat merges
    the trackers of servers sharing one process once, /cluster/perf the
    pipeline payloads once, with the codec mix from the beats."""
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "0")
    monkeypatch.setenv("WEEDTPU_AGG_INTERVAL", "0")
    c = Cluster(tmp_path, n_volume_servers=2).start()
    try:
        c.wait_heartbeats()
        client, payloads = _upload_and_encode_all(c, n=6, size=64 * 1024)
        _read_all(client, payloads)
        heat_view = _get(c.master.url, "/cluster/heat?refresh=1")
        assert heat_view["nodes"] == sorted(
            [c.master.url] + [vs.url for vs in c.volume_servers])
        assert heat_view["volumes"]["top"]
        # one tracker in the process, merged once, not once per node
        # (the estimates decay between the two reads: within 1%)
        alone = heat.merge_serialized([heat.serialize()])["volumes"]["top"]
        assert [e["key"] for e in heat_view["volumes"]["top"]] == \
            [e["key"] for e in alone]
        for got, one in zip(heat_view["volumes"]["top"], alone):
            assert got["est"] == pytest.approx(one["est"], rel=0.01)
        perf = _get(c.master.url, "/cluster/perf")
        assert perf["nodes"] == [c.master.url]  # one pipeline tracker
        vids = sorted({fid.partition(",")[0] for fid in payloads})
        assert perf["codecs"] == {"volumes": {v: "rs_10_4" for v in vids},
                                  "mix": {"rs_10_4": len(vids)}}
        assert "ec_encode" in perf["occupancy"]
        listing = _get(c.master.url, "/cluster/traces?min_ms=0&limit=50")
        assert listing["node_errors"] == {} and listing["traces"]
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(
                f"http://{c.master.url}/cluster/trace/{'ab' * 16}",
                timeout=30)
        assert e.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(
                f"http://{c.master.url}/cluster/trace/nothex", timeout=30)
        assert e.value.code == 400
    finally:
        c.stop()


# ---- /cluster/slo reads the health ledger -------------------------------------

def _degraded_beat(m, node, vid=91):
    """A JSON beat from a node that holds 12 of an EC volume's 14
    shards: the volume is degraded in the master's health ledger."""
    req = urllib.request.Request(
        f"http://{m.url}/heartbeat", data=json.dumps({
            "id": node, "url": node, "max_volume_count": 8, "volumes": [],
            "ec_shards": [{"id": vid, "collection": "",
                           "shard_ids": list(range(12)),
                           "shard_size": 4096}]}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        assert r.status == 200


def test_cluster_slo_reads_the_ledger_as_reference(tmp_path, monkeypatch):
    """Both masters' /cluster/slo rebuild the repair planner's health
    ledger first: on a cluster with one degraded volume both answer the
    same rules and states, and `repair_backlog` sees the
    weedtpu_volume_health gauge and is violated.  Its value sums the
    gauge over every node that exposes it: the port's master and its
    volume server render one registry (two), the reference's master
    its own, and the port's volume server under it the port's (two)."""
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "0")
    monkeypatch.setenv("WEEDTPU_AGG_INTERVAL", "0")
    monkeypatch.setenv("WEEDTPU_REPAIR_INTERVAL", "3600")
    c = Cluster(tmp_path, n_volume_servers=0).start()
    ref = ref_master.MasterServer("127.0.0.1", free_port())
    c.submit(ref.start())
    servers = []
    gone = f"127.0.0.1:{free_port()}"  # the degraded volume's holder
    try:
        for i, m in enumerate((c.master, ref)):
            d = tmp_path / f"v{i}"
            d.mkdir()
            vs = VolumeServer([str(d)], m.url, "127.0.0.1", free_port(),
                              heartbeat_interval=0.3, device="cpu")
            c.submit(vs.start())
            servers.append(vs)
        for m in (c.master, ref):
            deadline = time.time() + 10
            while time.time() < deadline and len(m.topo.nodes) < 1:
                time.sleep(0.05)
            client = WeedClient(m.url)
            for j in range(4):
                client.upload(b"x" * (1000 + j), name=f"s{j}")
            client.close()
            _degraded_beat(m, gone)
        time.sleep(0.7)
        got = [_slo(m.url) for m in (c.master, ref)]
        got = [_slo(m.url) for m in (c.master, ref)]  # a second tick

        def shape(s):
            return (s["state"], s["windows_s"], s["interval_s"],
                    s["scrape_errors"], len(s["nodes"]),
                    [(r["name"], r["kind"], r["state"],
                      sorted(r["windows"])) for r in s["rules"]])
        assert shape(got[0]) == shape(got[1])
        assert _rule(got[0], "repair_backlog") == \
            _rule(got[1], "repair_backlog") == {
                "name": "repair_backlog", "kind": "backlog",
                "windows": {}, "value": 2.0, "state": "violated"}
        assert metrics.VOLUME_HEALTH.labels("degraded").value == 1
        assert ref_metrics.VOLUME_HEALTH.labels("degraded").value == 1
    finally:
        for vs in servers:
            c.submit(vs.stop())
        c.submit(ref.stop())
        c.stop()


# ---- a mixed cluster -----------------------------------------------------------

def test_mixed_cluster_federation_crosses_registries(tmp_path, monkeypatch):
    """The port's master federates one port and one reference volume
    server: two registries, each parsed by both packages' parsers
    alike, under their node labels; a canary round probes either
    node's blob path."""
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "0")
    monkeypatch.setenv("WEEDTPU_AGG_INTERVAL", "0")
    c = Cluster(tmp_path, n_volume_servers=1, n_ref=1).start()
    try:
        c.wait_heartbeats()
        client = WeedClient(c.master.url)
        for j in range(8):
            client.upload(b"y" * (500 + j), name=f"m{j}")
        client.close()
        c.master.aggregator.scrape_once()
        per = c.master.aggregator.per_node
        port_vs, ref_vs = c.volume_servers
        assert {port_vs.url, ref_vs.url, c.master.url} <= set(per)
        for node in (port_vs.url, ref_vs.url):
            st, _, body = c.master.aggregator.pool.request(
                f"http://{node}/metrics",
                headers={"Accept": "application/openmetrics-text"})
            text = body.decode()
            assert ag.parse_exposition(text) == \
                ref_ag.parse_exposition(text)
            disk = per[node]["weedtpu_disk_bytes"]
            assert disk["type"] == "gauge"
            assert node in {lab["vs"] for _, lab, _ in disk["samples"]}
        fed = c.master.aggregator.render()
        for node in (port_vs.url, ref_vs.url):
            assert f'weedtpu_cluster_node_up{{node="{node}"}} 1' in fed
        st = c.submit(c.master.canary.run_once(paths=("blob",)))
        assert st["paths"]["blob"]["outcome"] == "ok"
    finally:
        c.stop()


# ---- the planes without jax --------------------------------------------------

def test_planes_leave_jax_unloaded(tmp_path):
    """A port master with its planes and a port volume server on the CPU
    in a fresh interpreter: a canary round, a federated scrape, every
    plane's view, a planner tick and an autopilot tick; neither jax nor
    the reference package is imported (torch is: the volume server is
    in the process; tests/test_torch_repair_planner.py holds the master
    alone to neither)."""
    code = f"""
import asyncio, json, os, sys, threading, urllib.request
os.environ.update(WEEDTPU_AGG_INTERVAL="0", WEEDTPU_CANARY_INTERVAL="0",
                  WEEDTPU_SCRUB_MBPS="0")
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
loop = asyncio.new_event_loop()
threading.Thread(target=loop.run_forever, daemon=True).start()
run = lambda c: asyncio.run_coroutine_threadsafe(c, loop).result(60)
m = MasterServer("127.0.0.1", {free_port()})
run(m.start())
vs = VolumeServer([{str(tmp_path)!r}], m.url, "127.0.0.1", {free_port()},
                  heartbeat_interval=0.3, device="cpu")
run(vs.start())
import time
while not m.topo.nodes:
    time.sleep(0.05)
st = run(m.canary.run_once(("blob",)))
assert st["paths"]["blob"]["outcome"] == "ok", st
for path in ("/cluster/metrics?refresh=1", "/cluster/slo",
             "/cluster/history?series=weedtpu_canary_probes_total",
             "/cluster/alerts", "/cluster/interference", "/cluster/loops",
             "/cluster/heat", "/cluster/perf", "/cluster/traces",
             "/cluster/canary", "/cluster/dashboard", "/maintenance/status",
             "/maintenance/convert", "/cluster/autopilot"):
    with urllib.request.urlopen(f"http://{{m.url}}{{path}}") as r:
        assert r.status == 200, path
for path in ("/maintenance/tick", "/cluster/autopilot"):
    req = urllib.request.Request(f"http://{{m.url}}{{path}}",
        data=b'{{"tick": true, "wait": true}}',
        headers={{"Content-Type": "application/json"}})
    with urllib.request.urlopen(req) as r:
        assert r.status == 200, path
run(vs.stop())
run(m.stop())
bad = [k for k in sys.modules if k == "jax" or k.startswith("jax.")
       or k == "seaweedfs_tpu" or k.startswith("seaweedfs_tpu.")]
assert not bad, bad
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
