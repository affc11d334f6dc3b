"""The telemetry of the port's data-plane paths held against the JAX
package's: the same calls on the same seeded volume, on the CPU, book the
same kernel rows, pipeline jobs, `ec_read` flow stages, heat records and
spans, and fail alike under an armed shard-write fault.

The port runs its plain version (`device="cpu"`, rows `[device]`) or its
native host codec (`WEEDTPU_EC_CODEC=native`, rows `[host]`); the
reference runs as its own tests run it: its XLA codec
(`WEEDTPU_EC_CODEC=jax`) or its native codec, set only around its calls.
Both packages' profiles are process-wide, so each case reads what its own
calls added: kernel rows as deltas, jobs by id, spans by trace id.  Times
differ and are left out; everything else must be equal, but for one
difference that stays: the port's fleet launches a ragged last batch's
units only, the reference its whole slot, so the port's `fleet_encode`
bytes are short of the reference's by the empty slots' (pinned below).

Geometry: tests/test_ec.py's 10 000 B large and 100 B small blocks.
"""

import errno
import os
import shutil
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest
import torch

from seaweedfs_tpu.maintenance import faults as ref_faults
from seaweedfs_tpu.maintenance import scrub as ref_scrub
from seaweedfs_tpu.ops import dispatch as ref_dispatch
from seaweedfs_tpu.ops import fleet_convert as ref_fleet
from seaweedfs_tpu.ops import gfmat_jax
from seaweedfs_tpu.stats import heat as ref_heat
from seaweedfs_tpu.stats import pipeline as ref_pipeline
from seaweedfs_tpu.stats import profile as ref_profile
from seaweedfs_tpu.stats import trace as ref_trace
from seaweedfs_tpu.storage.ec import ec_files as ref_ec
from seaweedfs_tpu.storage.ec import ec_volume as ref_ecv

from seaweedfs_tpu_torch.maintenance import faults, scrub
from seaweedfs_tpu_torch.ops import dispatch, fleet_convert, gf_cuda, regen
from seaweedfs_tpu_torch.stats import heat, pipeline, profile, trace
from seaweedfs_tpu_torch.storage import needle
from seaweedfs_tpu_torch.storage.ec import ec_files, ec_volume, layout
from seaweedfs_tpu_torch.storage.volume import Volume
from seaweedfs_tpu_torch.utils import grace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LARGE, SMALL, BATCH = 10_000, 100, 2000
LOST = [1, 12]
READS = 12  # needles read degraded
SHARDS = [layout.to_ext(i) for i in range(14)]

PKGS = {
    "ref": dict(ec=ref_ec, ecv=ref_ecv, profile=ref_profile,
                pipeline=ref_pipeline, trace=ref_trace, heat=ref_heat,
                faults=ref_faults),
    "port": dict(ec=ec_files, ecv=ec_volume, profile=profile,
                 pipeline=pipeline, trace=trace, heat=heat, faults=faults),
}
# the backend each package runs as, set only around its own calls
KINDS = {"device": {"ref": "jax", "port": None},
         "host": {"ref": "native", "port": "native"}}


def _needles():
    g = np.random.default_rng(2024)
    return [dict(cookie=int(g.integers(0, 2**32)), id=i + 1,
                 data=g.bytes(int(g.integers(1, 7000))),
                 append_at_ns=1_600_000_000_000_000_000 + i)
            for i in range(70)]


NEEDLES = _needles()


@pytest.fixture(scope="module")
def volume(tmp_path_factory):
    """One volume (.dat, .idx) of seeded needles, spanning two large rows
    and small rows, and its shard set, .ecx and .vif."""
    d = tmp_path_factory.mktemp("telemetry_vol")
    v = Volume(str(d), "", 1)
    for kw in NEEDLES:
        v.append_needle(needle.Needle(**kw))
    v.close()
    base = os.path.join(str(d), "1")
    ec_files.write_ec_files(base, large_block=LARGE, small_block=SMALL,
                            batch_size=BATCH, device="cpu")
    ec_files.write_sorted_ecx(base + ".idx")
    assert layout.n_large_rows(os.path.getsize(base + ".dat"), LARGE,
                               SMALL) == 2
    return base


def _copy(base, dst, exts):
    os.makedirs(dst, exist_ok=True)
    for ext in exts:
        shutil.copy(base + ext, os.path.join(dst, "1" + ext))
    return os.path.join(dst, "1")


def _clock():
    return 1_700_000_000.0


class _Observed:
    """What one package's calls add to its process-wide telemetry: kernel
    rows as deltas, the jobs they registered, the `ec_read` flow's stage
    deltas, a fresh heat tracker on a fixed clock, and the spans of one
    sampled root trace."""

    def __init__(self, pkg, monkeypatch):
        self.m = PKGS[pkg]
        self.k0 = self.m["profile"].KERNELS.snapshot()
        self.jobs0 = {j["id"] for j in self.m["pipeline"].jobs_snapshot()
                      if j["state"] != "flow"}
        self.flow0 = self._flow()
        monkeypatch.setattr(self.m["heat"], "TRACKER",
                            self.m["heat"].HeatTracker(now_fn=_clock))
        self.root = self.m["trace"].new_root()

    def _flow(self):
        for j in self.m["pipeline"].jobs_snapshot():
            if j["state"] == "flow" and j["kind"] == "ec_read":
                return {s: (r["bytes"], r["items"])
                        for s, r in j["stages"].items()}
        return {}

    def span(self):
        return self.m["trace"].span("test.root", parent=self.root)

    def view(self):
        rows = {}
        for key, r in self.m["profile"].KERNELS.snapshot().items():
            r0 = self.k0.get(key, {})
            rows[key] = {f: r[f] - r0.get(f, 0.0)
                         for f in ("calls", "bytes", "h2d_bytes",
                                   "d2h_bytes")}
        rows = {k: v for k, v in rows.items() if any(v.values())
                or k not in self.k0}
        jobs = sorted(
            (j["kind"], j["state"], j.get("meta"), sorted(j["queues"]),
             {s: r["bytes"] for s, r in j["stages"].items()},
             j.get("bottleneck", {}).get("stage") is not None)
            for j in self.m["pipeline"].jobs_snapshot()
            if j["state"] != "flow" and j["id"] not in self.jobs0)
        # the stages these calls booked (an earlier test in the process
        # may have booked others, remote_fetch among them)
        flow = {s: (b - self.flow0.get(s, (0, 0))[0],
                    i - self.flow0.get(s, (0, 0))[1])
                for s, (b, i) in self._flow().items()}
        flow = {s: v for s, v in flow.items() if v != (0, 0)}
        snap = self.m["heat"].serialize()["dims"]["volume"]
        heat_view = [e[:4] for e in snap["entries"]]
        spans = self.m["trace"].traces(tid=self.root.trace_id)
        spans = spans[0]["spans"] if spans else []
        names = {r["span"]: r["name"] for r in spans}
        shape = Counter((r["name"], names.get(r["parent"]),
                         tuple(sorted((r.get("attrs") or {}).items())))
                        for r in spans)
        return {"kernels": rows, "jobs": jobs, "ec_read": flow,
                "heat": heat_view, "spans": shape}


# ---- the paths -------------------------------------------------------------

def _fetcher(pkg, codec, held):
    """A helper node's partial through the package's own dispatch seam."""
    apply = ref_dispatch.apply_matrix if pkg == "ref" \
        else dispatch.apply_matrix

    def fetch(group, sids, coeff, off, n):
        rows = np.stack([held[s][off:off + n] for s in sids])
        return apply(codec, coeff, rows).tobytes()
    return fetch


def _run(path, pkg, base, monkeypatch):
    """Drive one path of one package on its copy of the volume."""
    ec, ecv = PKGS[pkg]["ec"], PKGS[pkg]["ecv"]
    cpu = {} if pkg == "ref" else {"device": "cpu"}
    if path == "encode":
        ec.write_ec_files(base, large_block=LARGE, small_block=SMALL,
                          batch_size=BATCH, **cpu)
    elif path == "rebuild":
        ec.rebuild_ec_files(base, batch_size=BATCH, **cpu)
    elif path == "degraded":
        ev = ecv.EcVolume(base, LARGE, SMALL, **cpu)
        try:
            for kw in NEEDLES[:READS]:
                assert ev.read_needle(kw["id"]).data == kw["data"]
        finally:
            ev.close()
    elif path == "scrub":
        ev = ecv.EcVolume(base, LARGE, SMALL, **cpu)
        try:
            if pkg == "ref":
                assert ref_scrub.syndrome_scan(ev, window=4096) == []
            else:
                monkeypatch.setattr(scrub, "DEFAULT_WINDOW", 4096)
                assert scrub.syndrome_scan(ev) == []
        finally:
            ev.close()
    elif path == "repair":
        shards = {s: np.fromfile(base + layout.to_ext(s), np.uint8)
                  for s in range(14)}
        held = {s: shards[s] for s in range(8, 14)}
        for s in [3] + sorted(held):
            os.remove(base + layout.to_ext(s))
        groups = [{"node": "h", "shards": sorted(held), "locality": 1}]
        if pkg == "ref":
            res = ref_ec.rebuild_ec_reduced(
                base, [3], groups,
                _fetcher(pkg, gfmat_jax.get_codec(10, 4), held),
                batch_size=4096, align=512)
        else:
            monkeypatch.setattr(ec_files, "DEFAULT_BATCH", 4096)
            monkeypatch.setattr(regen, "DEFAULT_SEG_ALIGN", 512)
            res = ec_files.rebuild_ec_reduced(
                base, [3], groups,
                _fetcher(pkg, gf_cuda.get_codec(10, 4, device="cpu"), held),
                device="cpu")
        assert res["rebuilt"] == [3]
        assert np.array_equal(np.fromfile(base + ".ec03", np.uint8),
                              shards[3])


def _prepare(path, volume, d):
    if path == "encode":
        return _copy(volume, d, [".dat", ".idx"])
    base = _copy(volume, d, SHARDS + [".ecx", ".vif"])
    if path in ("rebuild", "degraded"):
        for i in LOST:
            os.remove(base + layout.to_ext(i))
    return base


CASES = [("encode", "device"), ("encode", "host"), ("rebuild", "device"),
         ("rebuild", "host"), ("degraded", "device"), ("scrub", "device"),
         ("repair", "device")]


@pytest.mark.parametrize("path,kind", CASES)
def test_path_telemetry_equals_reference(volume, tmp_path, monkeypatch,
                                         path, kind):
    """Kernel rows (calls, bytes, h2d_bytes, d2h_bytes), pipeline jobs
    (kind, meta, queues, stages and their booked bytes), the `ec_read`
    flow's stages, the heat records and the spans (names, parents,
    attributes) equal the reference's."""
    views = {}
    files = {}
    for pkg in ("ref", "port"):
        base = _prepare(path, volume, str(tmp_path / pkg))
        with monkeypatch.context() as mp:
            if KINDS[kind][pkg]:
                mp.setenv("WEEDTPU_EC_CODEC", KINDS[kind][pkg])
            obs = _Observed(pkg, mp)
            with obs.span():
                _run(path, pkg, base, mp)
            views[pkg] = obs.view()
        files[pkg] = {ext: open(base + ext, "rb").read() for ext in SHARDS
                      if os.path.exists(base + ext)}
    assert files["port"] == files["ref"]
    got, want = views["port"], views["ref"]
    assert got == want
    assert got["spans"] and got["kernels"]
    if path in ("encode", "rebuild"):
        assert got["jobs"] and got["kernels"]["shard_write[host]"]["bytes"]
        assert all(f"{k}[{kind}]" in got["kernels"] for k in
                   (("encode_parity",) if path == "encode"
                    else ("reconstruct",)))
    if path == "degraded":
        assert set(got["ec_read"]) == {"local_pread", "gather_survivors",
                                       "reconstruct"}
        assert got["heat"] and got["heat"][0][3]["degraded"] > 0


FLEET = (200_000, 137_777, 95_001)
FLEET_GEOM = dict(large_block=LARGE, small_block=SMALL, batch_size=1000)


def _nonempty_units():
    """Units carrying data, by the reference's own unit iterator."""
    n = 0
    for size in FLEET:
        for row_start, block, col, step, _ in ref_ec._iter_units(
                size, **FLEET_GEOM):
            n += ref_ec._unit_coverage(size, row_start, block, col,
                                       step)[0] > 0
    return n


def _fleet(pkg, d, monkeypatch, units):
    rng = np.random.default_rng(7)
    bases = []
    for i, size in enumerate(FLEET):
        base = os.path.join(d, str(i + 1))
        os.makedirs(d, exist_ok=True)
        with open(base + ".dat", "wb") as f:
            f.write(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
        bases.append(base)
    obs = _Observed(pkg, monkeypatch)
    with obs.span():
        if pkg == "ref":
            monkeypatch.setenv("WEEDTPU_CONVERT_UNITS", str(units))
            ref_fleet.convert_volumes(bases, codec=gfmat_jax.get_codec(10, 4),
                                      **FLEET_GEOM)
        else:
            monkeypatch.setattr(fleet_convert, "UNIT_BATCH", units)
            fleet_convert.convert_volumes(bases, device="cpu", **FLEET_GEOM)
    return obs.view(), [open(b + ext, "rb").read() for b in bases
                        for ext in SHARDS + [".vif"]]


@pytest.mark.parametrize("units", [3, 4])
def test_fleet_telemetry_equals_reference(tmp_path, monkeypatch, units):
    """The fleet's job, spans and kernel rows equal the reference's, but
    for the ragged last batch: the port launches its nu units, the
    reference all U of its slot, so the port's fleet_encode bytes and
    h2d_bytes are short by (U - nu) * k * W and its d2h_bytes by
    (U - nu) * m * W, and so is the last batch's dispatch span's
    `bytes`."""
    ref_view, ref_files = _fleet("ref", str(tmp_path / "ref"), monkeypatch,
                                 units)
    view, files = _fleet("port", str(tmp_path / "port"), monkeypatch, units)
    assert files == ref_files
    k, m, W = 10, 4, 1000
    nonempty = _nonempty_units()
    batches = -(-nonempty // units)
    short = batches * units - nonempty
    assert short > 0
    row, ref_row = view["kernels"].pop("fleet_encode[device]"), \
        ref_view["kernels"].pop("fleet_encode[device]")
    assert row == {"calls": ref_row["calls"],
                   "bytes": ref_row["bytes"] - short * k * W,
                   "h2d_bytes": ref_row["h2d_bytes"] - short * k * W,
                   "d2h_bytes": ref_row["d2h_bytes"] - short * m * W}
    assert row["calls"] == batches
    # the dispatch spans (the drain's D2H runs on a thread without the
    # trace, in both packages): the last batch's bytes differ
    full = ("codec.dispatch_parity_batch", "test.root",
            (("backend", "device"), ("bytes", units * k * W)))
    ragged = full[:2] + ((("backend", "device"),
                          ("bytes", (units - short) * k * W)),)
    want = ref_view.pop("spans")
    assert want[full] == batches and not want[ragged]
    want[full] -= 1
    want[ragged] += 1
    assert view.pop("spans") == want
    assert view == ref_view
    assert view["jobs"][0][0] == "fleet_convert"


# ---- shard-write faults -----------------------------------------------------

FAULT_PATHS = ["write_ec_files", "rebuild_ec_files", "rebuild_ec_reduced",
               "convert_volumes"]


def _fault_call(entry, pkg, base, monkeypatch):
    ec = PKGS[pkg]["ec"]
    cpu = {} if pkg == "ref" else {"device": "cpu"}
    if entry == "write_ec_files":
        ec.write_ec_files(base, large_block=LARGE, small_block=SMALL,
                          batch_size=BATCH, **cpu)
    elif entry == "rebuild_ec_files":
        ec.rebuild_ec_files(base, batch_size=BATCH, **cpu)
    elif entry == "rebuild_ec_reduced":
        held = {s: np.zeros(1, np.uint8) for s in (12, 13)}
        codec = gfmat_jax.get_codec(10, 4) if pkg == "ref" else \
            gf_cuda.get_codec(10, 4, device="cpu")
        ec.rebuild_ec_reduced(base, [1], [{"node": "h", "shards": [12, 13],
                                           "locality": 1}],
                              _fetcher(pkg, codec, held), **cpu)
    elif pkg == "ref":
        ref_fleet.convert_volumes([base], codec=gfmat_jax.get_codec(10, 4),
                                  large_block=LARGE, small_block=SMALL)
    else:
        fleet_convert.convert_volumes([base], large_block=LARGE,
                                      small_block=SMALL, device="cpu")


@pytest.mark.parametrize("kind", ["EIO", "ENOSPC"])
@pytest.mark.parametrize("entry", FAULT_PATHS)
def test_shard_write_fault_raises_as_reference(volume, tmp_path,
                                               monkeypatch, entry, kind):
    """An armed shard_write_error makes each writer raise what the
    reference raises, before any .tmp exists: the previous shard set (or
    the lost shard's absence) is left byte for byte."""
    got = {}
    for pkg in ("ref", "port"):
        d = str(tmp_path / pkg)
        base = _copy(volume, d, [".dat", ".idx", ".ecx", ".vif"] + SHARDS)
        if entry.startswith("rebuild"):
            os.remove(base + layout.to_ext(1))
        before = {p: open(os.path.join(d, p), "rb").read()
                  for p in sorted(os.listdir(d))}
        mod = PKGS[pkg]["faults"]
        with monkeypatch.context() as mp:
            if pkg == "ref":
                mp.setenv("WEEDTPU_EC_CODEC", "jax")
            mod.set_shard_write_error(kind)
            try:
                with pytest.raises(OSError) as exc:
                    _fault_call(entry, pkg, base, mp)
            finally:
                mod.set_shard_write_error(None)
        after = {p: open(os.path.join(d, p), "rb").read()
                 for p in sorted(os.listdir(d))}
        assert after == before, pkg
        got[pkg] = (exc.value.errno, str(exc.value).replace(d, "<dir>"))
    assert got["port"] == got["ref"]
    assert got["port"][0] == getattr(errno, kind)


# ---- the observatory switch, the profiler, the import rule ------------------

def test_perf_obs_off_registers_no_job(volume, tmp_path, monkeypatch):
    monkeypatch.setenv("WEEDTPU_PERF_OBS", "0")
    monkeypatch.setattr(pipeline, "_enabled_cache", (0.0, True))
    base = _copy(volume, str(tmp_path), [".dat", ".idx"])
    def jobs():  # the flow accounts' snapshots move with the clock
        return [j["id"] for j in pipeline.jobs_snapshot()
                if j["state"] != "flow"]
    before = jobs()
    stats = {}
    ec_files.write_ec_files(base, large_block=LARGE, small_block=SMALL,
                            batch_size=BATCH, device="cpu", stats=stats)
    assert jobs() == before
    assert stats["encode_s"] > 0 and stats["wall_s"] > 0
    monkeypatch.setattr(pipeline, "_enabled_cache", (0.0, True))


def test_torch_profile_writes_a_cpu_trace(tmp_path):
    codec = gf_cuda.get_codec(10, 4, device="cpu")
    data = np.random.default_rng(1).integers(0, 256, (10, 4096), np.uint8)
    with grace.torch_profile(str(tmp_path / "tr"), device="cpu") as prof:
        with torch.profiler.record_function("encode"):
            dispatch.materialize(dispatch.dispatch_parity(codec, data))
    files = os.listdir(tmp_path / "tr")
    assert len(files) == 1 and files[0].endswith(".json")
    text = open(tmp_path / "tr" / files[0]).read()
    assert '"encode"' in text
    assert any(e.name == "encode" for e in prof.events())
    with grace.torch_profile(None) as none:
        assert none is None
    with grace.torch_profile("") as none:
        assert none is None


@pytest.mark.parametrize("kernel", ["encode_parity", "fleet_encode"])
def test_materialize_books_the_dispatching_kernel(kernel):
    """A dispatch's result carries its kernel row: `materialize` books the
    D2H in the row of the kernel that dispatched it and in no other."""
    codec = gf_cuda.get_codec(10, 4, device="cpu")
    rng = np.random.default_rng(7)
    before = profile.KERNELS.snapshot()
    if kernel == "fleet_encode":
        batch = rng.integers(0, 256, (3, 10, 1000), dtype=np.uint8)
        got = dispatch.materialize(dispatch.dispatch_parity_batch(codec,
                                                                  batch))
    else:
        batch = rng.integers(0, 256, (10, 1000), dtype=np.uint8)
        got = dispatch.materialize(dispatch.dispatch_parity(codec, batch))
    after = profile.KERNELS.snapshot()

    def moved(key, field):
        return after.get(key, {}).get(field, 0.0) - \
            before.get(key, {}).get(field, 0.0)
    other = ({"encode_parity", "fleet_encode"} - {kernel}).pop()
    assert moved(f"{kernel}[device]", "calls") == 1
    assert moved(f"{kernel}[device]", "d2h_bytes") == got.nbytes
    assert moved(f"{kernel}[device]", "bytes") == batch.nbytes
    assert moved(f"{other}[device]", "d2h_bytes") == 0
    assert moved(f"{other}[device]", "calls") == 0


def test_traced_paths_leave_jax_unloaded(tmp_path):
    """Encode, rebuild, read degraded, scrub and convert under a sampled
    root trace and torch_profile, in a fresh interpreter: spans, kernel
    rows and jobs are recorded, and neither jax nor the reference package
    gets imported."""
    code = (
        "import os, sys, numpy as np\n"
        "os.environ.pop('WEEDTPU_EC_CODEC', None)\n"
        "from seaweedfs_tpu_torch.storage.ec import ec_files, ec_volume\n"
        "from seaweedfs_tpu_torch.ops import fleet_convert\n"
        "from seaweedfs_tpu_torch.maintenance import scrub\n"
        "from seaweedfs_tpu_torch.stats import pipeline, profile, trace\n"
        "from seaweedfs_tpu_torch.utils import grace\n"
        "d = sys.argv[1]\n"
        "b = os.path.join(d, '1')\n"
        "open(b + '.dat', 'wb').write(os.urandom(30_000))\n"
        "root = trace.new_root()\n"
        "with grace.torch_profile(os.path.join(d, 'tr'), device='cpu'), \\\n"
        "        trace.span('smoke', parent=root):\n"
        "    ec_files.write_ec_files(b, large_block=1000, small_block=100, "
        "device='cpu')\n"
        "    os.remove(b + '.ec02')\n"
        "    ec_files.rebuild_ec_files(b, device='cpu')\n"
        "    open(b + '.ecx', 'wb').close()\n"
        "    ev = ec_volume.EcVolume(b, 1000, 100, device='cpu')\n"
        "    scrub.DEFAULT_WINDOW = 512\n"
        "    assert scrub.syndrome_scan(ev) == []\n"
        "    ev.close()\n"
        "    c = os.path.join(d, '2')\n"
        "    open(c + '.dat', 'wb').write(os.urandom(5_000))\n"
        "    fleet_convert.convert_volumes([c], large_block=1000, "
        "small_block=100, device='cpu')\n"
        "names = {s['name'] for s in trace.traces(tid=root.trace_id)[0]"
        "['spans']}\n"
        "assert {'codec.dispatch_parity', 'codec.reconstruct', "
        "'scrub.syndrome', 'codec.dispatch_parity_batch'} <= names, names\n"
        "kinds = {j['kind'] for j in pipeline.jobs_snapshot()}\n"
        "assert {'ec_encode', 'ec_rebuild', 'fleet_convert'} <= kinds\n"
        "assert 'encode_parity[device]' in profile.KERNELS.snapshot()\n"
        "assert os.listdir(os.path.join(d, 'tr'))\n"
        "assert not any(m == 'jax' or m.startswith('jax.') "
        "or m.startswith('seaweedfs_tpu.') for m in sys.modules), "
        "sorted(m for m in sys.modules if 'jax' in m)\n")
    subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=REPO,
                   check=True, timeout=120)
