"""The whole slice, both directions, between the PyTorch/CUDA port (on the
CPU) and the JAX package: the same needles give the same .dat/.idx, the
same .ec00-.ec13/.ecx/.vif, each package rebuilds lost shards of a volume
the other encoded, and each serves degraded reads from the other's shards.

Block sizes are the small ones tests/test_ec.py uses; the volume spans
two large-block rows and a tail of small-block rows.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from seaweedfs_tpu.storage import needle as ref_needle
from seaweedfs_tpu.storage.ec import ec_files as ref_ec
from seaweedfs_tpu.storage.ec import ec_volume as ref_ecv
from seaweedfs_tpu.storage.volume import Volume as RefVolume

from seaweedfs_tpu_torch.ops import gf_cuda
from seaweedfs_tpu_torch.stats.profile import KERNELS
from seaweedfs_tpu_torch.storage import needle, types
from seaweedfs_tpu_torch.storage.ec import ec_files, ec_volume, layout
from seaweedfs_tpu_torch.storage.volume import Volume

LARGE, SMALL = 10000, 100  # tests/test_ec.py's block sizes
EXTS = [layout.to_ext(i) for i in range(14)] + [".ecx", ".vif"]


def _needles():
    g = np.random.default_rng(2024)
    out = []
    for i in range(70):
        out.append(dict(cookie=int(g.integers(0, 2**32)), id=i + 1,
                        data=g.bytes(int(g.integers(1, 7000))),
                        append_at_ns=1_600_000_000_000_000_000 + i))
    return out


NEEDLES = _needles()


def _write_volume(dirname, volume_cls, needle_mod):
    v = volume_cls(dirname, "", 1)
    for kw in NEEDLES:
        v.append_needle(needle_mod.Needle(**kw))
    v.close()
    return os.path.join(dirname, "1")


@pytest.fixture(scope="module")
def encoded(tmp_path_factory):
    """One volume written and EC-encoded by each package."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WEEDTPU_EC_CODEC", "jax")
        root = tmp_path_factory.mktemp("torch_ec")
        ref_dir, port_dir = root / "ref", root / "port"
        ref_dir.mkdir()
        port_dir.mkdir()
        ref_base = _write_volume(str(ref_dir), RefVolume, ref_needle)
        port_base = _write_volume(str(port_dir), Volume, needle)
        ref_ec.write_ec_files(ref_base, large_block=LARGE, small_block=SMALL)
        ref_ec.write_sorted_ecx(ref_base + ".idx")
        mp.delenv("WEEDTPU_EC_CODEC")  # the port takes no reference kind
        ec_files.write_ec_files(port_base, large_block=LARGE,
                                small_block=SMALL, batch_size=2000,
                                device="cpu")
        ec_files.write_sorted_ecx(port_base + ".idx")
        yield {"ref": ref_base, "port": port_base}


def _copy(base, dst):
    os.makedirs(dst, exist_ok=True)
    for name in os.listdir(os.path.dirname(base)):
        shutil.copy(os.path.join(os.path.dirname(base), name), dst)
    return os.path.join(dst, "1")


def test_volume_spans_large_and_small_rows(encoded):
    size = os.path.getsize(encoded["port"] + ".dat")
    assert layout.n_large_rows(size, LARGE, SMALL) == 2
    assert layout.n_small_rows(size, LARGE, SMALL) > 1


@pytest.mark.parametrize("ext", [".dat", ".idx"])
def test_volume_files_identical(encoded, ext):
    with open(encoded["ref"] + ext, "rb") as a, \
            open(encoded["port"] + ext, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("ext", EXTS)
def test_ec_files_identical(encoded, ext):
    with open(encoded["ref"] + ext, "rb") as a, \
            open(encoded["port"] + ext, "rb") as b:
        assert a.read() == b.read(), ext


def test_encode_streams_through_dispatch(tmp_path):
    """Pooled [:, :step] staging, ragged final unit, counters booked."""
    base = _write_volume(str(tmp_path), Volume, needle)
    KERNELS.reset()
    launches = dict(gf_cuda.LAUNCHES)
    stats = {}
    done = []
    ec_files.write_ec_files(base, large_block=LARGE, small_block=SMALL,
                            batch_size=5000, stats=stats, device="cpu",
                            progress=done.append)
    assert KERNELS.snapshot()["encode_parity[device]"]["calls"] > 10
    assert done[-1] == os.path.getsize(base + ".dat")
    for key in ("read_s", "encode_s", "d2h_s", "write_parity_s", "wall_s"):
        assert key in stats, key
    assert not any(p.endswith(".tmp") for p in os.listdir(tmp_path))
    assert gf_cuda.LAUNCHES == launches  # the CPU runs no kernel


def test_encode_cancel_keeps_no_partial_shards(tmp_path):
    base = _write_volume(str(tmp_path), Volume, needle)
    with pytest.raises(ec_files.EncodeCancelled):
        ec_files.write_ec_files(base, large_block=LARGE, small_block=SMALL,
                                batch_size=1000, device="cpu",
                                cancel=lambda: True)
    assert sorted(os.listdir(tmp_path)) == ["1.dat", "1.idx"]


def test_entry_points_need_the_card(encoded, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base = _copy(encoded["port"], str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ec_files.write_ec_files(base, large_block=LARGE, small_block=SMALL)
    assert not any(p.endswith(".tmp") for p in os.listdir(tmp_path))
    os.remove(base + layout.to_ext(2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ec_files.rebuild_ec_files(base)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ec_volume.EcVolume(base, LARGE, SMALL)


LOST = [[5], [0, 13], [2, 7, 11], [0, 3, 10, 12]]


@pytest.mark.parametrize("lost", LOST, ids=lambda v: "-".join(map(str, v)))
@pytest.mark.parametrize("direction", ["port_rebuilds_ref",
                                       "ref_rebuilds_port"])
def test_rebuild_across_packages(encoded, tmp_path, monkeypatch, lost,
                                 direction):
    src = encoded["ref"] if direction == "port_rebuilds_ref" \
        else encoded["port"]
    base = _copy(src, str(tmp_path))
    want = {}
    for i in lost:
        with open(base + layout.to_ext(i), "rb") as f:
            want[i] = f.read()
        os.remove(base + layout.to_ext(i))
    if direction == "port_rebuilds_ref":
        got = ec_files.rebuild_ec_files(base, batch_size=3000, device="cpu")
    else:
        monkeypatch.setenv("WEEDTPU_EC_CODEC", "jax")
        got = ref_ec.rebuild_ec_files(base, batch_size=3000)
    assert sorted(got) == lost
    for i in lost:
        with open(base + layout.to_ext(i), "rb") as f:
            assert f.read() == want[i], i


@pytest.mark.parametrize("direction", ["port_reads_ref", "ref_reads_port"])
def test_degraded_reads_across_packages(encoded, tmp_path, monkeypatch,
                                        direction):
    src = encoded["ref"] if direction == "port_reads_ref" \
        else encoded["port"]
    base = _copy(src, str(tmp_path))
    for i in (0, 3, 10, 12):
        os.remove(base + layout.to_ext(i))
    if direction == "port_reads_ref":
        vol = ec_volume.EcVolume(base, LARGE, SMALL, device="cpu")
    else:
        monkeypatch.setenv("WEEDTPU_EC_CODEC", "jax")
        vol = ref_ecv.EcVolume(base, LARGE, SMALL)
    try:
        for kw in NEEDLES:
            n = vol.read_needle(kw["id"])
            assert (n.cookie, n.data) == (kw["cookie"], kw["data"]), kw["id"]
        if direction == "port_reads_ref":
            assert vol.read_stats["reconstruct_batches"] > 0
    finally:
        vol.close()


def test_degraded_read_one_dispatch_per_needle(encoded, tmp_path):
    """Every missing range of one read rebuilds in a single dispatch."""
    base = _copy(encoded["port"], str(tmp_path))
    for i in (1, 2):
        os.remove(base + layout.to_ext(i))
    vol = ec_volume.EcVolume(base, LARGE, SMALL, device="cpu")
    try:
        for kw in NEEDLES:
            off, size = vol.find_needle(kw["id"])
            ivs = layout.locate_data(LARGE, SMALL, vol.dat_size, off,
                                     types.actual_size(size))
            touched = {iv.to_shard_id_and_offset(LARGE, SMALL)[0]
                       for iv in ivs}
            before = vol.read_stats["reconstruct_batches"]
            assert vol.read_needle(kw["id"]).data == kw["data"]
            assert vol.read_stats["reconstruct_batches"] - before == \
                (1 if touched & {1, 2} else 0)
    finally:
        vol.close()


def test_delete_and_ecj_replay(encoded, tmp_path):
    base = _copy(encoded["port"], str(tmp_path))
    vol = ec_volume.EcVolume(base, LARGE, SMALL, device="cpu")
    vol.delete_needle(4)
    with pytest.raises(KeyError):
        vol.read_needle(4)
    vol.close()
    assert ec_files.read_ecj(base + ".ecj") == [4]
    ref = ref_ecv.EcVolume(base, LARGE, SMALL)  # replays the port's journal
    with pytest.raises(KeyError):
        ref.find_needle(4)
    ref.close()
    assert not os.path.exists(base + ".ecj")
    assert ec_files.find_dat_file_size(base) == \
        os.path.getsize(base + ".dat")
