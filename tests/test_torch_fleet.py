"""Fleet conversion and the batched dispatch seam of the PyTorch/CUDA port
held against the JAX package, byte for byte.

The port runs on the CPU, where the batched apply takes its plain version.
The reference's `convert_volumes` runs its Pallas kernels in interpret
mode (`PallasRSCodec(..., interpret=True)` passed as `codec=`), as
tests/test_pallas.py runs them.  The geometry is
tests/test_fleet_convert.py's: 10 000 B large blocks, 100 B small blocks,
1000 B column batches, so a volume over 100 000 B has large rows.
"""

import math
import os
import sys

import numpy as np
import pytest
import torch

from seaweedfs_tpu.models import rs as ref_rs
from seaweedfs_tpu.ops import dispatch as ref_dispatch
from seaweedfs_tpu.ops import fleet_convert as ref_fleet
from seaweedfs_tpu.ops import pallas_gf
from seaweedfs_tpu.storage.ec import ec_files as ref_ec

from seaweedfs_tpu_torch.ops import dispatch, fleet_convert, gf_cuda
from seaweedfs_tpu_torch.stats.profile import KERNELS
from seaweedfs_tpu_torch.storage.ec import ec_files, layout

GEOM = dict(large_block=10_000, small_block=100, batch_size=1000)
FLEETS = {
    "three": [200_000, 137_777, 95_001],
    "mixed": [250_000, 5_000, 100_001],
    "empty_and_tiny": [0, 400, 123_456],
}


def _make_volumes(dirname, sizes, seed=7, names=None):
    rng = np.random.default_rng(seed)
    bases = []
    for i, sz in enumerate(sizes):
        base = os.path.join(str(dirname), (names or {}).get(i, str(i + 1)))
        with open(base + ".dat", "wb") as f:
            f.write(rng.integers(0, 256, sz, dtype=np.uint8).tobytes())
        bases.append(base)
    return bases


def _files(base):
    """Every shard and .vif file of a volume, by extension."""
    out = {}
    for ext in [layout.to_ext(i) for i in range(14)] + [".vif"]:
        if os.path.exists(base + ext):
            with open(base + ext, "rb") as f:
                out[ext] = f.read()
    return out


def _no_tmp(dirname):
    return not [p for p in os.listdir(dirname) if p.endswith(".tmp")]


@pytest.fixture(scope="module")
def ref_codec():
    return pallas_gf.PallasRSCodec(ref_rs.get_code(10, 4), tile=256,
                                   interpret=True)


@pytest.fixture(scope="module")
def reference(tmp_path_factory, ref_codec):
    """Each fleet converted once by the JAX package."""
    out = {}
    for name, sizes in FLEETS.items():
        d = tmp_path_factory.mktemp(f"ref_{name}")
        bases = _make_volumes(d, sizes)
        stats = {}
        rep = ref_fleet.convert_volumes(bases, codec=ref_codec, stats=stats,
                                        **GEOM)
        out[name] = {"files": [_files(b) for b in bases], "report": rep,
                     "stats": stats}
    return out


def _nonempty_units(sizes):
    """Units carrying data, by the reference's own unit iterator."""
    n = 0
    for size in sizes:
        for row_start, block, col, step, _ in ref_ec._iter_units(
                size, GEOM["large_block"], GEOM["small_block"],
                GEOM["batch_size"]):
            n += ref_ec._unit_coverage(size, row_start, block, col,
                                       step)[0] > 0
    return n


@pytest.mark.parametrize("units", [1, 3, 4])
@pytest.mark.parametrize("fleet", sorted(FLEETS))
def test_convert_volumes_equals_reference(tmp_path, monkeypatch, reference,
                                          fleet, units):
    """Every shard file and .vif equals the reference fleet's, whatever
    the unit batch; one dispatch per batch of `units` units."""
    monkeypatch.setattr(fleet_convert, "UNIT_BATCH", units)
    sizes = FLEETS[fleet]
    bases = _make_volumes(tmp_path, sizes)
    KERNELS.reset()
    launches = dict(gf_cuda.LAUNCHES)
    stats = {}
    rep = fleet_convert.convert_volumes(bases, device="cpu", stats=stats,
                                        **GEOM)
    ref = reference[fleet]
    for base, want in zip(bases, ref["files"]):
        assert sorted(want) == sorted(_files(base))
        assert _files(base) == want, base
    assert _no_tmp(tmp_path)
    ref_rep = ref["report"]
    assert rep["bytes"] == ref_rep["bytes"] == sum(sizes)
    assert rep["units"] == ref_rep["units"]
    assert list(rep["volumes"].values()) == list(ref_rep["volumes"].values())
    assert stats["mode"] == "fleet" and stats["unit_batch"] == units
    assert sorted(stats["committed_bases"]) == sorted(bases)
    assert stats["volumes"] == len(bases)
    assert KERNELS.snapshot()["fleet_encode[device]"]["calls"] == \
        math.ceil(_nonempty_units(sizes) / units)
    assert gf_cuda.LAUNCHES == launches  # the CPU runs no kernel


def test_fleet_equals_write_ec_files_under_thread_churn(tmp_path,
                                                       monkeypatch):
    """Twelve volumes, some empty, with 50 B column batches so that rows
    end in units wholly past the .dat (skipped by the reader while the
    drain finalizes volumes), at U = 3 and a 1 us switch interval: every
    volume commits once, and its shards equal one write_ec_files per
    volume."""
    geom = dict(large_block=10_000, small_block=100, batch_size=50)
    sizes = [0, 1, 49, 51, 130, 999, 1_001, 20_030, 100_001, 100_049,
             0, 64_321]
    monkeypatch.setattr(fleet_convert, "UNIT_BATCH", 3)
    (tmp_path / "fleet").mkdir()
    bases = _make_volumes(tmp_path / "fleet", sizes, seed=11)
    stats = {}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        fleet_convert.convert_volumes(bases, device="cpu", stats=stats,
                                      **geom)
    finally:
        sys.setswitchinterval(interval)
    assert sorted(stats["committed_bases"]) == sorted(bases)
    assert len(stats["committed_bases"]) == len(bases)
    (tmp_path / "serial").mkdir()
    serial = _make_volumes(tmp_path / "serial", sizes, seed=11)
    for base in serial:
        ec_files.write_ec_files(base, device="cpu", **geom)
    for a, b in zip(bases, serial):
        fa, fb = _files(a), _files(b)
        assert fa.pop(".vif") != fb.pop(".vif")  # the fleet's has no codec
        assert fa == fb, a
    assert _no_tmp(tmp_path / "fleet")


def test_fleet_vif_has_no_codec_key(tmp_path):
    """The fleet's .vif carries no codec tag, as the reference fleet
    writes it (write_ec_files' carries one); a reader takes RS."""
    bases = _make_volumes(tmp_path, [1234, 0])
    fleet_convert.convert_volumes(bases, device="cpu", **GEOM)
    for base, size in zip(bases, (1234, 0)):
        assert _files(base)[".vif"] == \
            b'{"version": 3, "dat_file_size": %d}' % size
        assert ec_files.read_vif(base) == {"version": 3,
                                           "dat_file_size": size}


@pytest.mark.parametrize("units, n", [(1, 1), (3, 4097), (8, 1000)])
def test_dispatch_parity_batch_equals_reference(ref_codec, units, n):
    """One dispatch per batch; its parity equals the reference's batch
    and, unit by unit, the numpy encode."""
    codec = gf_cuda.get_codec(10, 4, device="cpu")
    batch = np.random.default_rng(units).integers(0, 256, (units, 10, n),
                                                  dtype=np.uint8)
    KERNELS.reset()
    parity = dispatch.dispatch_parity_batch(codec, batch)
    assert KERNELS.snapshot()["fleet_encode[device]"]["calls"] == 1
    got = dispatch.materialize(parity)
    want = np.concatenate([
        np.asarray(b) for _, _, b in ref_dispatch.unit_parity_shards(
            ref_dispatch.dispatch_parity_batch(ref_codec, batch))])
    assert got.shape == (units, 4, n) and np.array_equal(got, want)
    for u in range(units):
        assert np.array_equal(got[u], ref_rs.get_code(
            10, 4).encode_numpy(batch[u])[10:])


class _Injected(OSError):
    pass


def _failing_copy(real, victim):
    """A _copy_range that fails every copy into the victim volume's
    shard files, as a dying disk would."""
    def copy(src_fd, dst_fd, *args, **kw):
        if os.path.basename(os.readlink(f"/proc/self/fd/{dst_fd}")
                            ).startswith(victim + ".ec"):
            raise _Injected("injected shard write error")
        return real(src_fd, dst_fd, *args, **kw)
    return copy


def _fail_volume_c(d, sizes, pkg, ref_codec, monkeypatch):
    """Convert volumes a, b, c with every copy into c's shards failing;
    -> (committed volume names, every volume's files).  c's previous
    shard set must stay untouched and no .tmp be left."""
    mod, module = (ref_fleet, ref_ec) if pkg == "ref" else \
        (fleet_convert, ec_files)
    d.mkdir()
    bases = _make_volumes(d, sizes, names={0: "a", 1: "b", 2: "c"})
    ec_files.write_ec_files(bases[2], device="cpu", large_block=1000,
                            small_block=100)
    before = _files(bases[2])
    stats = {}
    monkeypatch.setattr(module, "_copy_range",
                        _failing_copy(module._copy_range, "c"))
    kw = {"codec": ref_codec} if pkg == "ref" else {"device": "cpu"}
    with pytest.raises(_Injected):
        mod.convert_volumes(bases, stats=stats, **GEOM, **kw)
    monkeypatch.undo()
    files = {os.path.basename(b): _files(b) for b in bases}
    assert _no_tmp(d)
    assert files["c"] == before
    return [os.path.basename(b)
            for b in stats.get("committed_bases", [])], files


def test_writer_error_keeps_committed_volumes(tmp_path, monkeypatch,
                                             ref_codec):
    """A writer error in a later volume fails the run: the volumes
    committed before it stay committed (stats["committed_bases"]) and the
    rest roll back, in the port as in the reference: no .tmp is left, and
    the failing volume's previous shard set stays untouched.  Volumes "a"
    and "c" each end before the last unit of a batch, so both packages see
    their ends in time: the reference learns that a volume has ended only
    when its reader visits it again, and for a volume whose last unit
    fills a batch that visit races the drain (at c = 60 000 B it sometimes
    commits "b" before "c" fails; the port's case is the test below)."""
    sizes = [29_000, 200_000, 59_000]  # a, b, c; c fails
    got = {pkg: _fail_volume_c(tmp_path / pkg, sizes, pkg, ref_codec,
                               monkeypatch)
           for pkg in ("ref", "port")}
    assert got["port"][0] == got["ref"][0] == ["a"]
    assert got["port"][1] == got["ref"][1]
    assert len(got["port"][1]["a"]) == 15
    assert got["port"][1]["b"] == {}


def test_writer_error_when_the_failing_volume_fills_a_batch(
        tmp_path, monkeypatch, ref_codec):
    """The port alone at c = 60 000 B, where c's last unit fills a K2
    batch.  The port knows a unit is its volume's last when it reads it
    (one unit of lookahead), so its drain finalizes c, and meets c's
    error, as c's last unit lands, which is before b's last unit: only
    "a" is committed, every time, and "b" rolls back (the reference's
    later notice of c's end races its drain there)."""
    committed, files = _fail_volume_c(tmp_path / "port",
                                      [29_000, 200_000, 60_000], "port",
                                      ref_codec, monkeypatch)
    assert committed == ["a"]
    assert len(files["a"]) == 15 and files["b"] == {}


def test_fleet_needs_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bases = _make_volumes(tmp_path, [1000])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet_convert.convert_volumes(bases, **GEOM)
    assert sorted(os.listdir(tmp_path)) == ["1.dat"]


@pytest.mark.parametrize("size", [1, 999, 100_000, 100_001, 250_000,
                                  1_000_001])
def test_max_step_equals_reference(size):
    """The staging width the fleet sizes its slots by is the widest step
    the reference cuts for the volume, and the narrowest (which picks
    direct or batched submission) is the reference's too."""
    assert ec_files._unit_steps(size, **GEOM) == \
        ref_ec._unit_steps(size, **GEOM)
