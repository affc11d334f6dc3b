"""Syndrome scrub of the PyTorch/CUDA port held against the JAX package.

Both packages scan the same shard files.  The port runs on the CPU, where
`dispatch.parity_mismatch` takes the plain version; the reference's scan
is handed `PallasRSCodec(..., interpret=True)`, as tests/test_pallas.py
runs the Pallas kernel.  The volume is a random 200 000 B `.dat` at
10 000 B large blocks and 100 B small blocks, so its shards are 20 000 B:
three 8192 B windows, the last one ragged.
"""

import os

import numpy as np
import pytest

from seaweedfs_tpu.maintenance import scrub as ref_scrub
from seaweedfs_tpu.models import rs as ref_rs
from seaweedfs_tpu.ops import pallas_gf
from seaweedfs_tpu.storage.ec import ec_volume as ref_ec_volume

from seaweedfs_tpu_torch.maintenance import scrub
from seaweedfs_tpu_torch.models import rs
from seaweedfs_tpu_torch.storage.ec import ec_files, ec_volume, layout

LARGE, SMALL = 10_000, 100
DAT_SIZE = 200_000
WINDOW = 8192
SHARD_SIZE = 20_000


@pytest.fixture(scope="module")
def ref_codec():
    return pallas_gf.PallasRSCodec(ref_rs.get_code(10, 4), tile=256,
                                   interpret=True)


@pytest.fixture
def base(tmp_path):
    """A shard set written by the port (its files equal the reference's:
    tests/test_torch_ec.py), with an empty .ecx: the scan reads shards
    only."""
    base = str(tmp_path / "5")
    rng = np.random.default_rng(21)
    with open(base + ".dat", "wb") as f:
        f.write(rng.integers(0, 256, DAT_SIZE, dtype=np.uint8).tobytes())
    ec_files.write_ec_files(base, large_block=LARGE, small_block=SMALL,
                            device="cpu")
    open(base + ".ecx", "wb").close()
    assert os.path.getsize(base + layout.to_ext(0)) == SHARD_SIZE
    return base


def _flip(path, offset, mask=0x10):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ mask]))


@pytest.fixture(autouse=True)
def _window(monkeypatch):
    monkeypatch.setattr(scrub, "DEFAULT_WINDOW", WINDOW)


def _scan_both(base, ref_codec):
    """(port ranges, port stats), (reference ranges, reference stats) of
    one pass over the files as they are."""
    out = []
    for pkg in ("port", "ref"):
        stats = {}
        if pkg == "port":
            ev = ec_volume.EcVolume(base, LARGE, SMALL, device="cpu")
            got = scrub.syndrome_scan(ev, stats=stats)
        else:
            ev = ref_ec_volume.EcVolume(base, LARGE, SMALL)
            got = ref_scrub.syndrome_scan(ev, codec=ref_codec, window=WINDOW,
                                          stats=stats)
        ev.close()
        out.append((got, stats))
    return out


@pytest.mark.parametrize("sid", range(14))
def test_flip_in_any_shard_is_localised_as_reference(base, ref_codec, sid):
    """One flipped byte in any of the 14 shards: one range, localised to
    that shard, the same list as the reference's; restored, clean."""
    path = base + layout.to_ext(sid)
    off = (5000 + 997 * sid) % SHARD_SIZE
    _flip(path, off)
    (got, st), (want, ref_st) = _scan_both(base, ref_codec)
    assert got == want
    assert st == ref_st
    w0 = off - off % WINDOW
    assert got == [{"shard": sid, "offset": w0,
                    "size": min(WINDOW, SHARD_SIZE - w0), "columns": 1}]
    _flip(path, off)
    assert _scan_both(base, ref_codec)[0][0] == []


# (shard, offset) flips per case, and the shard each range localises to
FLIPS = {
    "clean": ([], []),
    "two_windows": ([(5, 100), (11, 9000)], [5, 11]),
    "ragged_last_window": ([(13, SHARD_SIZE - 1)], [13]),
    "two_in_one_window": ([(2, 50), (7, 60)], [-1]),
}


@pytest.mark.parametrize("case", sorted(FLIPS))
def test_scan_equals_reference(base, ref_codec, case):
    flips, shards = FLIPS[case]
    for sid, off in flips:
        _flip(base + layout.to_ext(sid), off)
    (got, st), (want, ref_st) = _scan_both(base, ref_codec)
    assert got == want
    assert st == ref_st == {"bytes": 14 * SHARD_SIZE, "windows": 3}
    assert [r["shard"] for r in got] == shards


@pytest.mark.parametrize("missing, windows, skipped, ranges", [
    (12, 3, 0, [{"shard": -1, "offset": 0, "size": WINDOW, "columns": 1}]),
    (3, 0, 3, [])])
def test_missing_shard_equals_reference(base, ref_codec, missing, windows,
                                        skipped, ranges):
    """With a parity shard gone, a data flip is still found but cannot be
    localised (localising needs all 14 rows): shard -1.  With a data shard
    gone, every window is skipped."""
    os.rename(base + layout.to_ext(missing), base + ".aside")
    _flip(base + layout.to_ext(5), 4000)
    (got, st), (want, ref_st) = _scan_both(base, ref_codec)
    assert got == want == ranges
    assert st == ref_st
    assert st.get("windows", 0) == windows
    assert st.get("windows_skipped", 0) == skipped
    assert st["bytes"] == 13 * SHARD_SIZE


def test_localize_corrupt_shard_equals_reference():
    """Random codewords with zero, one or two corrupt rows, localised by
    both packages' code."""
    code, ref_code = rs.get_code(10, 4), ref_rs.get_code(10, 4)
    g = np.random.default_rng(4)
    data = g.integers(0, 256, (10, 64), dtype=np.uint8)
    cols = ref_code.encode_numpy(data)
    for bad in ([], [0], [9], [10], [13], [1, 12]):
        c = cols.copy()
        for i in bad:
            c[i] ^= g.integers(1, 256, 64, dtype=np.uint8)
        got = scrub.localize_corrupt_shard(c, code)
        assert got == ref_scrub.localize_corrupt_shard(c, ref_code)
        assert got == (bad[0] if len(bad) == 1 else None)


def test_reconstruct_numpy_equals_reference():
    code, ref_code = rs.get_code(10, 4), ref_rs.get_code(10, 4)
    g = np.random.default_rng(5)
    full = ref_code.encode_numpy(g.integers(0, 256, (10, 333),
                                            dtype=np.uint8))
    for lost in ([0], [3, 12], [0, 1, 10, 13]):
        shards = {i: full[i] for i in range(14) if i not in lost}
        got = code.reconstruct_numpy(shards, lost)
        want = ref_code.reconstruct_numpy(shards)
        assert sorted(got) == sorted(want) == lost
        for i in lost:
            assert np.array_equal(got[i], want[i])
            assert np.array_equal(got[i], full[i])


def test_shard_size_equals_reference(base):
    os.remove(base + layout.to_ext(0))
    ev = ec_volume.EcVolume(base, LARGE, SMALL, device="cpu")
    ref = ref_ec_volume.EcVolume(base, LARGE, SMALL)
    assert ev.shard_size == ref.shard_size == SHARD_SIZE
    ev.close()
    ref.close()
