"""The port's telemetry modules (stats/, utils/grace.py, maintenance/
faults.py) held against the JAX package's on the same calls.

Each case makes the same calls on both packages and compares what they
report, timing fields excluded and everything else equal.  The process-
wide singletons a case reads (the kernel profile, the heat tracker, the
ceilings, the job registry) are swapped for fresh ones with monkeypatch
in both packages, and restored after, so no other test sees them.
"""

import errno
import math

import numpy as np
import pytest

from seaweedfs_tpu.maintenance import faults as ref_faults
from seaweedfs_tpu.stats import heat as ref_heat
from seaweedfs_tpu.stats import metrics as ref_metrics
from seaweedfs_tpu.stats import netflow as ref_netflow
from seaweedfs_tpu.stats import pipeline as ref_pipeline
from seaweedfs_tpu.stats import profile as ref_profile
from seaweedfs_tpu.stats import trace as ref_trace

from seaweedfs_tpu_torch.maintenance import faults
from seaweedfs_tpu_torch.stats import (heat, metrics, netflow, pipeline,
                                       profile, trace)

# ---- metrics ---------------------------------------------------------------

@pytest.mark.parametrize("name", [
    "NET_BYTES", "WAN_BYTES", "SCRUB_BYTES", "SCRUB_CORRUPTIONS",
    "PIPELINE_STAGE_SECONDS", "PIPELINE_STAGE_BYTES", "ROOFLINE_FRAC"])
def test_metric_families_are_the_references(name):
    ref, mine = getattr(ref_metrics, name), getattr(metrics, name)
    assert (mine.name, mine.help, mine.label_names, mine.kind) == \
        (ref.name, ref.help, ref.label_names, ref.kind)
    assert metrics.REGISTRY._metrics[mine.name] is mine


def _drive_registry(mod):
    reg = mod.Registry()
    c = reg.counter("t_bytes_total", "bytes", ("kind", "stage"))
    g = reg.gauge("t_frac", "a fraction", ("resource",))
    h = reg.histogram("t_seconds", "latency", ("op",),
                      buckets=(0.001, 0.01, 0.1, 1.0))
    u = reg.counter("t_plain_total", "no labels")
    g2 = reg.gauge("t_esc", 'quote " and \\ slash', ("path",))
    rng = np.random.default_rng(5)
    for _ in range(200):
        c.labels(f"k{rng.integers(3)}", f"s{rng.integers(4)}").inc(
            float(rng.integers(1, 1 << 20)))
        g.labels(("disk", "h2d", "device")[rng.integers(3)]).set(
            float(rng.random()))
        h.labels(("read", "write")[rng.integers(2)]).observe(
            float(rng.random() * 2))
    u.labels().inc(3)
    g2.labels('a"b\\c\nd').dec(2.5)
    assert reg.counter("t_bytes_total") is c  # registered once
    return reg


@pytest.mark.parametrize("openmetrics", [False, True])
def test_exposition_text_equals_reference(openmetrics):
    """The same increments give the same exposition text, Prometheus 0.0.4
    and OpenMetrics."""
    want = _drive_registry(ref_metrics).render(openmetrics=openmetrics)
    got = _drive_registry(metrics).render(openmetrics=openmetrics)
    assert got == want
    assert "t_bytes_total" in got


def test_label_cardinality_cap_equals_reference(monkeypatch):
    for mod in (ref_metrics, metrics):
        monkeypatch.setattr(mod._Metric, "MAX_CHILDREN", 3)
    texts = []
    for mod in (ref_metrics, metrics):
        c = mod.Registry().counter("t_total", "", ("key",))
        for i in range(6):
            c.labels(str(i)).inc(i)
        texts.append("\n".join(c.render()))
    assert texts[0] == texts[1] and "__other__" in texts[1]


# ---- heat ------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 1_700_000_000.0

    def __call__(self):
        return self.t


def _drive_heat(mod, seed, clock):
    tr = mod.HeatTracker(k=8, halflife=30.0, now_fn=clock)
    rng = np.random.default_rng(seed)
    for _ in range(400):
        clock.t += float(rng.random() * 0.5)
        dim = mod.DIMS[rng.integers(len(mod.DIMS))]
        key = f"key{int(rng.zipf(1.5)) % 40}"
        op = ("read", "write", "degraded", "bogus")[rng.integers(4)]
        weight = 0.0 if op == "degraded" else 1.0
        tr.record(dim, key, int(rng.integers(0, 5000)), op, weight)
    return tr


def _no_id(snap):
    return {k: v for k, v in snap.items() if k != "id"}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_heat_serialize_and_merge_equal_reference(seed):
    """The same seeded records on a shared clock serialize alike, and give
    the same Count-Min estimates.  (The fleet merge stays with the
    reference until the master needs it; its input, the serialisation,
    is what is held equal here.)"""
    out = {}
    for name, mod in (("ref", ref_heat), ("port", heat)):
        clock = _Clock()
        a = _drive_heat(mod, seed, clock)
        b = _drive_heat(mod, seed + 10, clock)
        out[name] = (_no_id(a.serialize()), _no_id(b.serialize()),
                     [a.estimate(d, f"key{i}") for d in mod.DIMS
                      for i in range(4)])
    assert out["port"] == out["ref"]


def test_heat_defaults_are_the_references(monkeypatch):
    """The port's constant top-K size and half-life are the reference's
    defaults: default trackers on a shared clock serialize alike, and
    past K keys the top-K holds K entries."""
    for var in ("WEEDTPU_HEAT", "WEEDTPU_HEAT_K", "WEEDTPU_HEAT_HALFLIFE"):
        monkeypatch.delenv(var, raising=False)
    snaps = []
    for mod in (ref_heat, heat):
        clock = _Clock()
        tr = mod.HeatTracker(now_fn=clock)
        for i in range(heat.HEAT_K + 10):
            clock.t += 0.25
            tr.record("chunk", f"c{i % (heat.HEAT_K + 5)}", 10 * i)
        snaps.append(_no_id(tr.serialize()))
    assert snaps[0] == snaps[1]
    assert (snaps[1]["k"], snaps[1]["halflife"]) == (64, 300.0)
    assert len(snaps[1]["dims"]["chunk"]["entries"]) == heat.HEAT_K


def test_heat_module_record_and_ambient_class(monkeypatch):
    """The module-level record goes to the process tracker; scrub or
    repair traffic is not foreground data, in both packages."""
    got = []
    for mod, nf in ((ref_heat, ref_netflow), (heat, netflow)):
        clock = _Clock()
        monkeypatch.setattr(mod, "TRACKER",
                            mod.HeatTracker(k=8, now_fn=clock))
        seen = [mod.ambient_is_data()]
        with nf.flow("scrub"):
            seen.append(mod.ambient_is_data())
        with nf.flow("readahead"):
            seen += [mod.ambient_is_data(),
                     mod.ambient_is_data(include_readahead=True)]
        mod.record("volume", "7", 0, "degraded", weight=0.0)
        mod.record("volume", "7", 100, "read")
        got.append((seen, _no_id(mod.serialize())))
    assert got[0] == got[1]
    assert got[1][0] == [True, False, False, True]


# ---- netflow ---------------------------------------------------------------

PATHS = ["/metrics", "/metrics/x", "/metricsx", "/status", "/status-reports/a",
         "/heat", "/heat/obj", "/perf", "/admin/ec/shard_read", "/3,01ab",
         "/bucket/key", "/cluster", "/debug/pprof", "", "/__ui__/x"]


@pytest.mark.parametrize("path", PATHS)
def test_classify_equals_reference(path):
    assert netflow.classify(path) == ref_netflow.classify(path)
    assert netflow.is_internal(path) == ref_netflow.is_internal(path)


def _book(nf):
    before = {(d, c): nf.class_total(d, c)
              for d in ("sent", "recv") for c in sorted(nf.CLASSES)}
    wan_before = {(d, r): nf.wan_total(d, r) for d in ("sent", "recv")
                  for r in (None, "eu")}
    rng = np.random.default_rng(11)
    for _ in range(50):
        cls = (sorted(nf.CLASSES) + ["bogus", None])[rng.integers(10)]
        nbytes = int(rng.integers(-5, 1 << 16))
        direction = ("sent", "recv")[rng.integers(2)]
        if rng.random() < 0.3:
            with nf.wan("eu"):
                nf.account(direction, cls, "volume", nbytes)
        else:
            nf.account(direction, cls, ("", "filer")[rng.integers(2)], nbytes)
    with nf.flow("repair"):
        cls = nf.current_class()
    return ({k: nf.class_total(*k) - v for k, v in before.items()},
            {k: nf.wan_total(*k) - v for k, v in wan_before.items()},
            cls, nf.current_class(), nf.flow("bogus").cls)


def test_netflow_ledger_equals_reference():
    """The same bytes booked under the same classes give the same per-class
    and WAN deltas, and the same ambient classes."""
    want, got = _book(ref_netflow), _book(netflow)
    assert got == want
    assert sum(got[0].values()) > 0 and sum(got[1].values()) > 0


# ---- trace -----------------------------------------------------------------

def _span_records():
    """A two-node trace with a client hop, an orphan and a duplicate."""
    tid = "ab" * 16
    recs = [
        {"name": "filer.request", "trace": tid, "span": "1" * 16,
         "parent": None, "start": 100.0, "ms": 50.0,
         "attrs": {"server": "filer"}},
        {"name": "http.send", "trace": tid, "span": "2" * 16,
         "parent": "1" * 16, "start": 100.01, "ms": 30.0},
        {"name": "volume.request", "trace": tid, "span": "3" * 16,
         "parent": "2" * 16, "start": 100.012, "ms": 20.0,
         "attrs": {"server": "volume", "region": "eu"}, "node": "v1"},
        {"name": "ec.plan", "trace": tid, "span": "4" * 16,
         "parent": "3" * 16, "start": 100.013, "ms": 1.0},
        {"name": "ec.local_pread", "trace": tid, "span": "5" * 16,
         "parent": "3" * 16, "start": 100.014, "ms": 5.0, "error": True},
        {"name": "late.orphan", "trace": tid, "span": "6" * 16,
         "parent": "9" * 16, "start": 100.2, "ms": 2.0},
    ]
    return recs + [dict(recs[1])]


def test_assemble_equals_reference():
    assert trace.assemble(_span_records()) == \
        ref_trace.assemble(_span_records())
    assert trace.assemble([]) == ref_trace.assemble([])


@pytest.mark.parametrize("value", [None, "16", "1", "0", "7"])
def test_sample_rate_equals_reference(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("WEEDTPU_TRACE_SAMPLE", raising=False)
    else:
        monkeypatch.setenv("WEEDTPU_TRACE_SAMPLE", value)
    assert trace.sample_rate() == ref_trace.sample_rate()


def test_malformed_sample_rate_raises(monkeypatch):
    """Like the port's other knobs, and unlike the reference (which falls
    back to 16), a sample rate that is not an integer raises."""
    monkeypatch.setenv("WEEDTPU_TRACE_SAMPLE", "often")
    with pytest.raises(ValueError, match="WEEDTPU_TRACE_SAMPLE"):
        trace.sample_rate()


def test_ring_keeps_the_references_default(monkeypatch):
    """The ring holds TRACE_BUF spans, the reference's default size, and
    overwrites the oldest past it."""
    monkeypatch.delenv("WEEDTPU_TRACE_BUF", raising=False)
    assert trace.TRACE_BUF == 4096 == ref_trace._ring_capacity()
    trace.reset_ring()
    try:
        root = trace.new_root()
        for i in range(trace.TRACE_BUF + 5):
            trace.record_span(f"s{i}", root.trace_id, f"{i:016x}",
                              root.span_id, 1.0 + i, 0.5)
        names = {r["name"] for r in trace.ring_snapshot()}
    finally:
        trace.reset_ring()
    assert len(names) == trace.TRACE_BUF
    assert "s4" not in names and "s5" in names


def _traced(mod):
    """Spans recorded under a sampled root, then under an unsampled one;
    the same shapes in both packages, ids aside."""
    mod.reset_ring()
    root = mod.new_root()
    with mod.span("outer", parent=root, k=1) as sp:
        with mod.span("inner", bytes=10):
            assert mod.current_exemplar() == root.trace_id
        sp.set(done=True)
        try:
            with mod.span("failing"):
                raise KeyError("x")
        except KeyError:
            pass
    with mod.span("dropped", parent=mod.new_root(sampled=False)):
        pass
    assert mod.span("no-parent") is mod._NOOP
    got = mod.traces(tid=root.trace_id)[0]
    by_id = {r["span"]: r for r in got["spans"]}
    shape = sorted((r["name"], by_id[r["parent"]]["name"]
                    if r["parent"] in by_id else None, r.get("attrs"),
                    r.get("error", False)) for r in got["spans"])
    return (shape, [t["trace_id"] for t in mod.traces()] ==
            [root.trace_id], len(mod.traces(min_ms=1e9)))


def test_spans_equal_reference():
    try:
        assert _traced(trace) == _traced(ref_trace)
    finally:
        trace.reset_ring()
        ref_trace.reset_ring()


# ---- profile: the kernel rows and the roofline ------------------------------

def _fresh_profile(monkeypatch, mod, ceilings):
    monkeypatch.setattr(mod, "KERNELS", mod.KernelProfile())
    monkeypatch.setattr(mod, "_ceilings_set", {})
    monkeypatch.setattr(mod, "_ceilings_cache", None)
    for resource, gbps in ceilings.items():
        mod.set_ceiling(resource, gbps)


def _record_kernels(mod):
    K = mod.KERNELS
    rng = np.random.default_rng(3)
    for _ in range(20):
        n = float(rng.integers(1, 1 << 24))
        K.record("encode_parity", "device", wall_s=1e-4, h2d_s=n / 20e9,
                 h2d_bytes=n, nbytes=n)
        K.record("encode_parity", "device", calls=0, device_s=n / 900e9,
                 d2h_s=n / 50e9, d2h_bytes=0.4 * n)
        K.record("reconstruct", "host", wall_s=n / 3e9, nbytes=n)
    K.record("shard_write", "host", calls=0, wall_s=0.5, nbytes=1e9)
    K.record("fleet_encode", "device", wall_s=1e-6, nbytes=10.0)  # < 1 ms
    with K.timed("repair_partial", nbytes=64.0):
        pass
    return K


@pytest.mark.parametrize("ceilings", [
    {}, {"device": 900.0, "h2d": 20.0, "d2h": 25.0, "disk": 3.2,
         "host": 2.0}])
def test_roofline_snapshot_equals_reference(monkeypatch, ceilings):
    """The same kernel rows and ceilings give the same roofline rows and
    fractions, but for one pinned difference: a `[device]` row gives no
    `device` (compute) share in the port, whose `device_s` is a wait and
    not a kernel's time.  The tables list the same rows (ordered by
    time, so compared as sets)."""
    monkeypatch.delenv("WEEDTPU_CEILINGS", raising=False)
    views = []
    for mod in (ref_profile, profile):
        _fresh_profile(monkeypatch, mod, ceilings)
        K = _record_kernels(mod)
        # a wait long enough for the reference to read it as compute
        K.record("encode_parity", "device", calls=0, device_s=0.01)
        snap = K.snapshot()
        for row in snap.values():
            row.pop("wall_s")  # the timed() row's wall is a clock reading
        rows = mod.roofline_snapshot()
        views.append((snap, rows, sorted(ln.split()[-1] for ln in
                                         K.table().splitlines())))
    ref_rows = views[0][1]["rows"]
    views[0][1]["rows"] = [r for r in ref_rows
                           if (r["backend"], r["resource"]) !=
                           ("device", "device")]
    assert len(views[0][1]["rows"]) < len(ref_rows)
    assert views[1] == views[0]
    assert views[1][1]["rows"]
    assert {r["resource"] for r in views[1][1]["rows"]
            if r["backend"] == "device"} == {"h2d", "d2h"}


def test_ceilings_from_the_environment(monkeypatch):
    monkeypatch.setenv("WEEDTPU_CEILINGS", "disk=3.5, h2d=x,d2h=-1,net=1e1")
    views = []
    for mod in (ref_profile, profile):
        _fresh_profile(monkeypatch, mod, {"device": 100.0})
        mod.set_ceiling("disk", 4.0)
        views.append(mod.ceilings())
    assert views[0] == views[1] == {"disk": 4.0, "net": 10.0,
                                    "device": 100.0}


def test_export_roofline_sets_the_gauge(monkeypatch):
    _fresh_profile(monkeypatch, profile, {"disk": 1.0})
    monkeypatch.setattr(pipeline, "_enabled_cache", (0.0, True))
    profile.KERNELS.record("shard_write", "host", calls=0, wall_s=1.0,
                           nbytes=5e8)
    profile.export_roofline()
    assert metrics.ROOFLINE_FRAC.labels("disk", "shard_write").value == 0.5


def test_sampling_profiler_sees_other_threads():
    import threading
    import time
    stop = threading.Event()

    def busy_worker():
        while not stop.is_set():
            time.sleep(0.001)
    th = threading.Thread(target=busy_worker, name="busy")
    th.start()
    prof = profile.SamplingProfiler(hz=500).start()
    try:
        deadline = time.monotonic() + 10
        while prof.samples < 20 and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        prof.stop()
        stop.set()
        th.join(timeout=10)
    assert not th.is_alive() and not prof.running
    assert prof.samples >= 20
    assert "test_torch_stats.busy_worker" in prof.collapsed()
    assert "test_torch_stats.busy_worker" in prof.table()


# ---- pipeline: jobs and bottleneck verdicts ---------------------------------

STATS = [
    {"read_s": 0.44, "encode_s": 0.002, "d2h_s": 0.05, "write_data_s": 1.1,
     "write_data_workers": 6.4, "write_parity_s": 0.3,
     "write_parity_workers": 1.6, "stall_s": 0.2, "submit_s": 0.2,
     "submit_workers": 8.0, "wall_s": 0.55, "bytes": 1 << 30},
    {"reconstruct_s": 0.3, "write_s": 0.9, "write_workers": 4.0,
     "wall_s": 0.4, "mode": "staged"},
    {"encode_s": 2.0, "wall_s": 1.0, "stall_s": 0.1},
    {"wall_s": 0.5},
]


def _jobs(mod):
    mod.reset()
    out = []
    for i, stats in enumerate(STATS):
        job = mod.track(f"kind{i}", dict(stats), 1000 * i,
                        meta={"i": i} if i % 2 else None)
        job.add_bytes("read", 1 << 30)
        job.add_bytes("write_data", 1 << 30, items=3)
        job.add_bytes("write", 123456)
        job.queue("q_read", 2, 3)
        job.queue("q_read", 3)
        job.queue("q_disp", 1)
        job.finish("disk full" if i == 3 else None)
    flow = mod.flow("ec_read")
    assert mod.flow("ec_read") is flow
    flow.add_bytes("local_pread", 4096, items=1)
    # newest first, with ties at the millisecond in insertion order: kept
    # apart from the clock by sorting on the kind
    snaps = sorted(mod.jobs_snapshot(), key=lambda s: s["kind"])
    for s in snaps:
        for key in ("id", "started"):
            s.pop(key)
        if s["state"] == "flow":
            s.pop("wall_s")
            for row in s["stages"].values():
                row.pop("busy_frac")
    return snaps, [mod.bottleneck(s) for s in snaps]


@pytest.mark.parametrize("ceilings", [{}, {"disk": 3.2, "d2h": 25.0}])
def test_jobs_and_bottlenecks_equal_reference(monkeypatch, ceilings):
    """Jobs over the same stats dicts, bytes and queue samples snapshot
    alike, with the same bottleneck verdicts."""
    monkeypatch.delenv("WEEDTPU_CEILINGS", raising=False)
    views = []
    try:
        for mod, prof in ((ref_pipeline, ref_profile),
                          (pipeline, profile)):
            monkeypatch.setattr(mod, "_enabled_cache", (0.0, True))
            _fresh_profile(monkeypatch, prof, ceilings)
            prof.set_ceiling("device", 900.0)
            views.append(_jobs(mod))
    finally:
        ref_pipeline.reset()
        pipeline.reset()
    assert views[1] == views[0]
    snaps, verdicts = views[1]
    assert [s["kind"] for s in snaps] == ["ec_read", "kind0", "kind1",
                                          "kind2", "kind3"]
    # kind1: reconstruct 0.3 of 0.4 s against write 0.9 s over 4 workers
    assert verdicts[2]["stage"] == "reconstruct"
    assert verdicts[4] is None and snaps[4]["error"] == "disk full"
    if ceilings:
        assert verdicts[1]["resource"] == "disk"


def test_finished_jobs_kept_are_the_references(monkeypatch):
    """Past PERF_OBS_JOBS finished jobs (the reference's default), the
    oldest drop out of the snapshot in both packages."""
    monkeypatch.delenv("WEEDTPU_PERF_OBS_JOBS", raising=False)
    kept = []
    try:
        for mod in (ref_pipeline, pipeline):
            monkeypatch.setattr(mod, "_enabled_cache", (0.0, True))
            mod.reset()
            for i in range(pipeline.PERF_OBS_JOBS + 8):
                with mod.track(f"job{i}", {"wall_s": 0.1}):
                    pass
            kept.append(sorted(int(s["kind"][3:])
                               for s in mod.jobs_snapshot()))
    finally:
        ref_pipeline.reset()
        pipeline.reset()
    assert kept[0] == kept[1] == list(range(8, pipeline.PERF_OBS_JOBS + 8))


def test_finished_job_exports_occupancy_seconds(monkeypatch):
    """finish() books each stage's busy seconds over its workers and its
    bytes into the stage counters."""
    monkeypatch.setattr(pipeline, "_enabled_cache", (0.0, True))
    secs = metrics.PIPELINE_STAGE_SECONDS.labels("t_export", "write")
    nbytes = metrics.PIPELINE_STAGE_BYTES.labels("t_export", "write")
    s0, b0 = secs.value, nbytes.value
    try:
        with pipeline.track("t_export", {"write_s": 3.0, "write_workers": 4,
                                         "wall_s": 1.0}) as job:
            job.add_bytes("write", 500)
    finally:
        pipeline.reset()
    assert math.isclose(secs.value - s0, 0.75)
    assert nbytes.value - b0 == 500


def test_local_snapshot_carries_jobs_and_roofline(monkeypatch):
    monkeypatch.setattr(pipeline, "_enabled_cache", (0.0, True))
    _fresh_profile(monkeypatch, profile, {})
    try:
        with pipeline.track("ec_encode", {"encode_s": 1.0, "wall_s": 1.0}):
            pass
        snap = pipeline.local_snapshot()
    finally:
        pipeline.reset()
    assert set(snap) == {"id", "enabled", "jobs", "roofline"}
    assert snap["jobs"][0]["kind"] == "ec_encode"
    assert snap["jobs"][0]["bottleneck"]["stage"] == "encode"


# ---- faults ----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["EIO", "ENOSPC"])
def test_check_shard_write_raises_as_reference(kind):
    try:
        got = []
        for mod in (ref_faults, faults):
            mod.set_shard_write_error(kind)
            with pytest.raises(OSError) as exc:
                mod.check_shard_write("/v/1")
            got.append((exc.value.errno, str(exc.value)))
    finally:
        ref_faults.set_shard_write_error(None)
        faults.set_shard_write_error(None)
    assert got[0] == got[1]
    assert got[1][0] == getattr(errno, kind)


def test_unarmed_and_cleared_faults_pass():
    for arm in (None, "off", "EIO"):
        faults.set_shard_write_error(arm)
        if arm == "EIO":
            faults.set_shard_write_error(None)
        assert faults._disk_shard_write is None
        faults.check_shard_write("/v/1")
