"""The port's native host codec (csrc/gf_native.cc, native.py,
ops/native_codec.py) and its zero-copy host paths held against the JAX
package's native codec, byte for byte.

The native codec runs here as it runs on the card's host: g++ builds it
at first use and the CPU's own AVX2 (and GFNI, where CPUID finds it)
kernels compute.  The reference runs its own native library
(`WEEDTPU_EC_CODEC=cpp`, or a `NativeRSCodec` passed in), and the port's
numpy GF product and plain codec are the second oracle.  GF(2^8) is exact,
so every comparison is equality.  Every environment variable is set with
monkeypatch, for the reference's calls only where it takes a kind the port
refuses.
"""

import mmap
import os
import shutil

import numpy as np
import pytest
import torch

from seaweedfs_tpu import native as ref_native
from seaweedfs_tpu.maintenance import scrub as ref_scrub
from seaweedfs_tpu.models import rs as ref_rs
from seaweedfs_tpu.ops import fleet_convert as ref_fleet
from seaweedfs_tpu.ops import gf as ref_gf
from seaweedfs_tpu.ops import lrc as ref_lrc
from seaweedfs_tpu.ops import msr as ref_msr
from seaweedfs_tpu.ops import native_codec as ref_native_codec
from seaweedfs_tpu.storage.ec import ec_files as ref_ec
from seaweedfs_tpu.storage.ec import ec_volume as ref_ecv

from seaweedfs_tpu_torch import _build, native
from seaweedfs_tpu_torch.maintenance import scrub
from seaweedfs_tpu_torch.ops import (codecs, dispatch, fleet_convert, gf,
                                     gf_cuda, msr, native_codec, regen)
from seaweedfs_tpu_torch.storage import needle
from seaweedfs_tpu_torch.storage.ec import ec_files, ec_volume, layout
from seaweedfs_tpu_torch.storage.volume import Volume

TAGS = ["rs_10_4", "lrc_10_2_2", "msr_9_16"]
# large block, small block, column batch; MSR's are alpha (8) multiples
GEOM = {"rs_10_4": (10_000, 100, 1000), "lrc_10_2_2": (10_000, 100, 1000),
        "msr_9_16": (8000, 400, 4000)}
LOSSES = {"rs_10_4": [[0], [13], [0, 3, 10, 12], [1, 2, 11, 13]],
          "lrc_10_2_2": [[2], [12], [2, 5, 11], [0, 6, 13]],
          "msr_9_16": [[0], [0, 13], [3, 7, 17], list(range(9))]}
IMPLS = {"scalar": native.GF_IMPL_SCALAR, "avx2": native.GF_IMPL_AVX2,
         "gfni": native.GF_IMPL_GFNI}


@pytest.fixture(params=sorted(IMPLS))
def impl(request):
    """Each GF kernel the library has, forced for one test; GFNI skips on
    a CPU without it (under auto the library picks GFNI where it can)."""
    native.set_gf_impl(native.GF_IMPL_AUTO)
    if request.param == "gfni" and native.gf_impl() != native.GF_IMPL_GFNI:
        pytest.skip("this CPU has no GFNI with AVX-512BW")
    native.set_gf_impl(IMPLS[request.param])
    assert native.gf_impl() == IMPLS[request.param]
    yield request.param
    native.set_gf_impl(native.GF_IMPL_AUTO)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


# ---- the GF product ---------------------------------------------------------

def _numpy_product(mat, data):
    """The port's numpy GF product: whole for narrow data, else on the
    first and last 4 KiB of columns (the tail past the vector width)."""
    n = data.shape[1]
    if n <= 4097:
        return [(slice(None), gf.gf_matmul(mat, data))]
    return [(cols, gf.gf_matmul(mat, data[:, cols]))
            for cols in (slice(0, 4096), slice(n - 4109, n))]


@pytest.mark.parametrize("n", [1, 17, 4097, (1 << 20) + 13])
@pytest.mark.parametrize("k", [1, 5, 10, 33, 72])
@pytest.mark.parametrize("m", [1, 4, 16, 17, 72])
def test_gf_matmul_equals_reference(impl, m, k, n):
    g = np.random.default_rng(m * 1000 + k * 10 + n % 7)
    mat = g.integers(0, 256, (m, k), dtype=np.uint8)
    data = g.integers(0, 256, (k, n), dtype=np.uint8)
    got = np.full((m, n), 0x5A, dtype=np.uint8)
    native.gf_matmul_ptrs(mat, list(data), list(got), n)
    assert np.array_equal(got, ref_native.gf_matmul(mat, data))
    for cols, want in _numpy_product(mat, data):
        assert np.array_equal(got[:, cols], want)
    # the same product by row address, CPU tensors in, numpy rows out
    out = np.full((m, n), 0xA5, dtype=np.uint8)
    native.gf_matmul_ptrs(mat, torch.from_numpy(data).unbind(0), list(out),
                          n)
    assert np.array_equal(out, got)


def test_gf_matmul_ptrs_scattered_unaligned_rows(impl, tmp_path):
    """Input rows at odd offsets of a read-only mmap, output rows at odd
    offsets of a wider buffer, rows of a padded tensor: read and written
    where they lie, nothing past n touched."""
    g = np.random.default_rng(4)
    n, k, m = 5003, 10, 4
    path = tmp_path / "blob"
    path.write_bytes(g.integers(0, 256, 80_000, dtype=np.uint8).tobytes())
    mat = ref_rs.get_code(10, 4).parity_matrix
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, prot=mmap.PROT_READ)
        view = np.frombuffer(mm, dtype=np.uint8)
        offs = [1 + 7919 * j for j in range(k)]
        rows = [view[o:o + n] for o in offs]
        want = gf.gf_matmul(mat, np.stack(rows))
        wide = np.zeros((m, n + 64), dtype=np.uint8)
        outs = [wide[r, 3:3 + n] for r in range(m)]
        native.gf_matmul_ptrs(mat, rows, outs, n)
        assert np.array_equal(np.stack(outs), want)
        assert not wide[:, :3].any() and not wide[:, 3 + n:].any()
        padded = dispatch.device_empty((k, n), torch.device("cpu"))
        padded.copy_(torch.from_numpy(np.stack(rows)))
        assert np.array_equal(
            native_codec.NativeGFMatrix(mat)(padded).numpy(), want)
        del rows, view
        mm.close()


@pytest.mark.parametrize("c", [0, 1, 2, 0x8E, 0xF0, 255])
def test_gf_matmul_ptrs_sparse_coefficients(impl, c):
    """Rows of one coefficient among zeros, and a row of zeros only: the
    kernels skip zero coefficients and still write every output byte (an
    all-zero row comes out zero over whatever the buffer held)."""
    g = np.random.default_rng(c)
    n = 4098
    data = g.integers(0, 256, (3, n + 1), dtype=np.uint8)[:, 1:]  # off grid
    mat = np.array([[c, 0, 0], [0, 0, c], [c, 0, c], [0, 0, 0]], np.uint8)
    out = g.integers(0, 256, (4, n), dtype=np.uint8)
    native.gf_matmul_ptrs(mat, list(data), list(out), n)
    table = gf.GF_MUL_TABLE[c]
    assert np.array_equal(out, ref_native.gf_matmul(mat, data))
    assert np.array_equal(out[0], table[data[0]])
    assert np.array_equal(out[1], table[data[2]])
    assert np.array_equal(out[2], table[data[0]] ^ table[data[2]])
    assert not out[3].any()


def test_bad_rows_and_impls_raise():
    mat = np.ones((2, 3), np.uint8)
    rows = [np.zeros(16, np.uint8)] * 3
    with pytest.raises(ValueError, match="input"):
        native.gf_matmul_ptrs(mat, rows[:2], [np.zeros(16, np.uint8)] * 2, 8)
    with pytest.raises(ValueError, match="need 32"):
        native.gf_matmul_ptrs(mat, rows, [np.zeros(16, np.uint8)] * 2, 32)
    with pytest.raises(ValueError, match="unit stride"):
        native.gf_matmul_ptrs(mat, [np.zeros(32, np.uint8)[::2]] * 3,
                              [np.zeros(16, np.uint8)] * 2, 16)
    ro = np.zeros(16, np.uint8)
    ro.setflags(write=False)
    with pytest.raises(ValueError, match="read-only"):
        native.gf_matmul_ptrs(mat, rows, [ro, np.zeros(16, np.uint8)], 16)
    with pytest.raises(ValueError, match="uint8"):
        native.gf_matmul_ptrs(mat, [torch.zeros(16)] * 3,
                              [np.zeros(16, np.uint8)] * 2, 16)
    with pytest.raises(ValueError, match="unknown GF impl"):
        native.set_gf_impl(9)


class _NoGfniLib:
    """The library as a CPU without GFNI shows it: a GFNI force runs the
    auto choice (AVX2), as the reference's C code does."""

    def __init__(self):
        self.force = 0

    def wn_gf_set_impl(self, impl):
        self.force = impl

    def wn_gf_impl(self):
        return native.GF_IMPL_SCALAR if self.force == 2 else \
            native.GF_IMPL_AVX2


def test_forced_gfni_without_gfni_raises(monkeypatch):
    """The reference runs another kernel when GFNI is forced on a CPU
    without it; the port raises and leaves the choice at auto."""
    lib = _NoGfniLib()
    monkeypatch.setattr(native, "_lib", lambda: lib)
    with pytest.raises(ValueError, match="without GFNI"):
        native.set_gf_impl(native.GF_IMPL_GFNI)
    assert lib.force == native.GF_IMPL_AUTO
    native.set_gf_impl(native.GF_IMPL_SCALAR)
    assert native.gf_impl() == native.GF_IMPL_SCALAR


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_command", lambda name, out: [
        "sh", "-c", "echo gf_native.cc:1: error: no compiler; exit 1"])
    with pytest.raises(RuntimeError, match="no compiler"):
        native.gf_impl()
    assert not list(tmp_path.glob("*.so"))


def test_build_flags_are_host_independent():
    """The library is keyed by its command line, so that line names no
    host-specific ISA: AVX2 and SSSE3 at most, GFNI by CPUID at run time."""
    cmd = _build._command("gf_native", "OUT")
    assert not [a for a in cmd if a.startswith(("-march", "-mtune"))]
    assert not [a for a in cmd if "gfni" in a or "avx512" in a]


# ---- the codec --------------------------------------------------------------

def _ref_native_codec(tag):
    if tag == "rs_10_4":
        return ref_native_codec.NativeRSCodec(ref_rs.get_code(10, 4))
    if tag == "lrc_10_2_2":
        return ref_native_codec.NativeRSCodec(ref_lrc.get_code(10, 2, 2))
    return ref_msr.MSRFileCodec(
        ref_native_codec.NativeRSCodec(ref_msr.get_code(9, 16)))


@pytest.mark.parametrize("tag", TAGS)
def test_native_codec_equals_reference(tag):
    """Encode and reconstruct equal the reference's NativeRSCodec for
    every loss pattern, and so do the decode matrices each builds."""
    mine = codecs.make_codec(tag, kind="native")
    ref = _ref_native_codec(tag)
    inner = mine.inner if tag.startswith("msr") else mine
    assert isinstance(inner, native_codec.NativeRSCodec)
    assert mine.device.type == "cpu"
    assert mine._factory is native_codec.NativeGFMatrix
    g = np.random.default_rng(9)
    L = 8 * 517
    data = g.integers(0, 256, (mine.k, L), dtype=np.uint8)
    shards = mine.encode(torch.from_numpy(data)).numpy()
    assert np.array_equal(shards, np.asarray(ref.encode(data)))
    for lost in LOSSES[tag]:
        have = {i: shards[i] for i in range(mine.n) if i not in lost}
        got = mine.reconstruct({i: torch.from_numpy(v)
                                for i, v in have.items()})
        want = ref.reconstruct(dict(have), list(lost))
        for i in lost:
            assert np.array_equal(got[i].numpy(), shards[i]), (lost, i)
            assert np.array_equal(got[i].numpy(), np.asarray(want[i]))
    ref_inner = ref.inner if tag.startswith("msr") else ref
    assert len(inner._decode_cache) == len(ref_inner._decode_cache)
    for (basis, wanted), mat in ref_inner._decode_cache.items():
        assert np.array_equal(inner._decode_cache[(basis, wanted)].C, mat)


def test_codec_kinds():
    rs_codec = codecs.make_codec("rs_10_4", kind="native")
    assert rs_codec is native_codec.get_codec(10, 4)
    assert codecs.make_codec("msr_9_16", kind="native", device="cpu") is \
        codecs.make_codec("msr_9_16", kind="native")
    assert isinstance(codecs.make_codec("lrc_10_2_2", device="cpu"),
                      gf_cuda.CudaRSCodec)
    with pytest.raises(ValueError, match="runs on the CPU"):
        codecs.make_codec("rs_10_4", device="cuda", kind="native")
    for kind in ("auto", "tpu", "jax", "numpy", "cpp", "NATIVE"):
        with pytest.raises(ValueError, match="cuda, native \\(unset"):
            codecs.make_codec("rs_10_4", device="cpu", kind=kind)


# ---- volumes on disk --------------------------------------------------------

def _blobs(count, seed):
    g = np.random.default_rng(seed)
    return {i + 1: g.bytes(int(g.integers(1, 7000))) for i in range(count)}


@pytest.fixture(scope="module")
def volumes(tmp_path_factory):
    """Two needle volumes: "tail", small rows only with a partial last
    row; "large", large rows too (at every tag's large block)."""
    root = tmp_path_factory.mktemp("native_volumes")
    out = {}
    for name, count in (("tail", 13), ("large", 70)):
        d = root / name
        d.mkdir()
        v = Volume(str(d), "", 3)
        blobs = _blobs(count, count)
        for nid, data in blobs.items():
            v.append_needle(needle.Needle(cookie=7, id=nid, data=data))
        v.close()
        out[name] = {"base": str(d / "3"), "blobs": blobs}
    return out


def _copy_volume(base, d):
    os.makedirs(d, exist_ok=True)
    for ext in (".dat", ".idx"):
        shutil.copy(base + ext, os.path.join(d, "3" + ext))
    return os.path.join(d, "3")


def _files(base, n):
    exts = [layout.to_ext(i) for i in range(n)] + [".ecx", ".vif"]
    with_ = {}
    for ext in exts:
        with open(base + ext, "rb") as f:
            with_[ext] = f.read()
    return with_


def _port_encode(base, tag, mp, plain=False, stats=None):
    """Encode with the port: the native codec, or the plain version."""
    large, small, batch = GEOM[tag]
    if plain:
        mp.delenv("WEEDTPU_EC_CODEC", raising=False)
        ec_files.write_ec_files(base, large_block=large, small_block=small,
                                batch_size=batch, codec_tag=tag,
                                device="cpu", stats=stats)
    else:
        mp.setenv("WEEDTPU_EC_CODEC", "native")
        ec_files.write_ec_files(base, large_block=large, small_block=small,
                                batch_size=batch, codec_tag=tag,
                                stats=stats)
    ec_files.write_sorted_ecx(base + ".idx")


def _ref_encode(base, tag, mp):
    """Encode with the reference's native codec, pipelined."""
    large, small, batch = GEOM[tag]
    mp.setenv("WEEDTPU_EC_CODEC", "cpp")
    mp.setenv("WEEDTPU_EC_PIPELINE", "pipelined")
    ref_ec.write_ec_files(base, large_block=large, small_block=small,
                          batch_size=batch, codec_tag=tag)
    ref_ec.write_sorted_ecx(base + ".idx")


@pytest.mark.parametrize("vol", ["tail", "large"])
@pytest.mark.parametrize("tag", TAGS)
def test_write_ec_files_equals_reference(volumes, tmp_path, tag, vol):
    """Shards, .ecx and .vif of the native encode equal the reference
    native codec's and the port's plain codec's."""
    src = volumes[vol]["base"]
    n = codecs.parse_tag(tag).n
    got = {}
    with pytest.MonkeyPatch.context() as mp:
        base = _copy_volume(src, str(tmp_path / "ref"))
        _ref_encode(base, tag, mp)
        got["ref"] = _files(base, n)
    with pytest.MonkeyPatch.context() as mp:
        base = _copy_volume(src, str(tmp_path / "native"))
        st: dict = {}
        _port_encode(base, tag, mp, stats=st)
        got["native"] = _files(base, n)
        assert st["mode"] == "pipelined"
        assert st["bytes"] == os.path.getsize(src + ".dat")
        assert st["encode_s"] > 0
        if tag != "msr_9_16":  # the host path stages nothing
            assert "read_s" not in st
    with pytest.MonkeyPatch.context() as mp:
        base = _copy_volume(src, str(tmp_path / "plain"))
        _port_encode(base, tag, mp, plain=True)
        got["plain"] = _files(base, n)
    assert got["native"] == got["ref"]
    assert got["native"] == got["plain"]
    assert not [p for p in os.listdir(tmp_path / "native")
                if p.endswith(".tmp")]


@pytest.fixture(scope="module")
def encoded(volumes, tmp_path_factory):
    """The "large" volume encoded under each tag by the port's native
    codec (pipelined) and by the reference's."""
    out = {}
    for tag in TAGS:
        root = tmp_path_factory.mktemp(f"native_{tag}")
        with pytest.MonkeyPatch.context() as mp:
            port = _copy_volume(volumes["large"]["base"], str(root / "port"))
            _port_encode(port, tag, mp)
        with pytest.MonkeyPatch.context() as mp:
            ref = _copy_volume(volumes["large"]["base"], str(root / "ref"))
            _ref_encode(ref, tag, mp)
        out[tag] = {"port": port, "ref": ref}
    return out


def _copy_set(base, d):
    os.makedirs(d, exist_ok=True)
    src = os.path.dirname(base)
    for name in os.listdir(src):
        shutil.copy(os.path.join(src, name), os.path.join(d, name))
    return os.path.join(d, os.path.basename(base))


def _shard_bytes(base, n):
    return {i: open(base + layout.to_ext(i), "rb").read() for i in range(n)}


@pytest.mark.parametrize("tag,lost", [(t, lost) for t in TAGS
                                      for lost in LOSSES[t][1:3]])
def test_rebuild_ec_files_native(encoded, tmp_path, monkeypatch, tag, lost):
    """RS and LRC rebuild in host-serial mode, MSR staged (its codec is
    a file codec over the native one, as in the reference)."""
    base = _copy_set(encoded[tag]["port"], str(tmp_path))
    n = codecs.parse_tag(tag).n
    want = _shard_bytes(base, n)
    for i in lost:
        os.remove(base + layout.to_ext(i))
    monkeypatch.setenv("WEEDTPU_EC_CODEC", "native")
    st: dict = {}
    assert ec_files.rebuild_ec_files(base, batch_size=800, stats=st) == lost
    assert _shard_bytes(base, n) == want
    assert st["mode"] == ("staged" if tag == "msr_9_16" else "host-serial")
    assert st["codec"] == tag and st["reconstruct_s"] > 0
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]


def test_rebuild_ec_files_plain_is_staged(encoded, tmp_path):
    base = _copy_set(encoded["rs_10_4"]["port"], str(tmp_path))
    want = _shard_bytes(base, 14)
    for i in (0, 13):
        os.remove(base + layout.to_ext(i))
    st: dict = {}
    ec_files.rebuild_ec_files(base, batch_size=800, stats=st, device="cpu")
    assert st["mode"] == "staged" and _shard_bytes(base, 14) == want


@pytest.mark.parametrize("direction", ["port_reads_ref", "ref_reads_port"])
@pytest.mark.parametrize("tag", TAGS)
def test_native_volume_crosses_packages(volumes, encoded, tmp_path,
                                        monkeypatch, tag, direction):
    """A shard set one package's native codec wrote, with shards lost:
    the other package reads every needle degraded and rebuilds the
    shards byte for byte."""
    writer = "ref" if direction == "port_reads_ref" else "port"
    base = _copy_set(encoded[tag][writer], str(tmp_path))
    n = codecs.parse_tag(tag).n
    want = _shard_bytes(base, n)
    lost = LOSSES[tag][2]
    for i in lost:
        os.remove(base + layout.to_ext(i))
    large, small, _ = GEOM[tag]
    if direction == "port_reads_ref":
        monkeypatch.setenv("WEEDTPU_EC_CODEC", "native")
        ev = ec_volume.EcVolume(base, large, small)
        assert ev.device.type == "cpu"
        assert ev.codec._factory is native_codec.NativeGFMatrix
    else:
        monkeypatch.setenv("WEEDTPU_EC_CODEC", "cpp")
        ev = ref_ecv.EcVolume(base, large, small)
    try:
        for nid, data in volumes["large"]["blobs"].items():
            assert ev.read_needle(nid).data == data, nid
        if direction == "port_reads_ref":
            assert ev.read_stats["reconstruct_batches"] > 0
    finally:
        ev.close()
    if direction == "port_reads_ref":
        ec_files.rebuild_ec_files(base)
    else:
        ref_ec.rebuild_ec_files(base)
    assert _shard_bytes(base, n) == want


@pytest.mark.parametrize("tag", TAGS)
def test_native_scrub_equals_reference(encoded, tmp_path, monkeypatch, tag):
    """syndrome_scan on the native codec: clean, then one flipped byte,
    found where the reference's scan finds it (localised for RS and LRC,
    shard -1 for MSR)."""
    monkeypatch.setattr(scrub, "DEFAULT_WINDOW", 1000)
    base = _copy_set(encoded[tag]["port"], str(tmp_path))
    large, small, _ = GEOM[tag]
    flipped = {"rs_10_4": 11, "lrc_10_2_2": 1, "msr_9_16": 6}[tag]
    results = []
    for flip in (False, True):
        if flip:
            with open(base + layout.to_ext(flipped), "r+b") as f:
                b = os.pread(f.fileno(), 1, 1234)
                os.pwrite(f.fileno(), bytes([b[0] ^ 0x10]), 1234)
        with monkeypatch.context() as mp:
            mp.setenv("WEEDTPU_EC_CODEC", "native")
            ev = ec_volume.EcVolume(base, large, small)
            got = scrub.syndrome_scan(ev)
            ev.close()
        with monkeypatch.context() as mp:
            mp.setenv("WEEDTPU_EC_CODEC", "cpp")
            rev = ref_ecv.EcVolume(base, large, small)
            assert got == ref_scrub.syndrome_scan(rev, window=1000)
            rev.close()
        results.append(got)
    assert results[0] == []
    assert len(results[1]) == 1
    assert results[1][0]["shard"] == (-1 if tag == "msr_9_16" else flipped)


# ---- reduced-read repair and the fleet --------------------------------------

REPAIRS = {
    # tag, lost, local shards, remote (node, shards, locality)
    "rs [1, 12]": ("rs_10_4", [1, 12], [0, 2, 3, 4, 5, 6],
                   [("a:1", [7, 8, 9, 10], 1), ("b:2", [11, 13], 3)]),
    "lrc [2]": ("lrc_10_2_2", [2], range(6),
                [("a:1", range(6, 9), 1), ("b:2", range(9, 14), 3)]),
    "msr [0]": ("msr_9_16", [0], range(6),
                [("a:1", range(6, 12), 1), ("c:3", [12], 2),
                 ("b:2", range(13, 18), 3)]),
}


def _fetcher(port: bool, codec, files, alpha):
    """A helper node's partial over its shards (MSR: sub-row `v % alpha`
    of file `v // alpha`): the port's through `dispatch.apply_matrix`,
    the reference's through its GF product."""
    def fetch(group, sids, coeff, off, n):
        rows = np.stack([
            files[s][off:off + n] if alpha == 1 else
            files[s // alpha][off * alpha:(off + n) * alpha]
            .reshape(n, alpha)[:, s % alpha] for s in sids])
        if port:
            return dispatch.apply_matrix(codec, coeff, rows).tobytes()
        return ref_gf.gf_matmul(np.asarray(coeff, np.uint8), rows).tobytes()
    return fetch


@pytest.mark.parametrize("case", sorted(REPAIRS))
def test_rebuild_ec_reduced_native_equals_reference(tmp_path, monkeypatch,
                                                    case):
    """rebuild_ec_reduced on the native codec: the rebuilt shards, the
    plans' predictions and the measured byte ledger equal the reference's
    on its native codec."""
    tag, lost, local, remote = REPAIRS[case]
    spec = codecs.parse_tag(tag)
    L = 8 * 2500
    g = np.random.default_rng(17)
    codec = codecs.make_codec(tag, kind="native")
    data = torch.from_numpy(g.integers(0, 256, (spec.k, L), dtype=np.uint8))
    files = codec.encode(data).numpy()
    groups = [{"node": n, "shards": [int(s) for s in span], "locality": loc}
              for n, span, loc in remote]
    monkeypatch.setattr(ec_files, "DEFAULT_BATCH", 4096)
    monkeypatch.setattr(regen, "DEFAULT_SEG_ALIGN", 1024)
    out = {}
    for who in ("port", "ref"):
        d = tmp_path / who
        d.mkdir()
        base = str(d / "5")
        for sid in local:
            if sid not in lost:
                (d / ("5" + layout.to_ext(sid))).write_bytes(
                    files[sid].tobytes())
        ec_files.write_vif(base, spec.k * L, codec=tag)
        fetch = _fetcher(who == "port", codec, files, spec.alpha)
        with monkeypatch.context() as mp:
            if who == "port":
                mp.setenv("WEEDTPU_EC_CODEC", "native")
                out[who] = ec_files.rebuild_ec_reduced(base, lost, groups,
                                                       fetch)
            else:
                mp.setenv("WEEDTPU_EC_CODEC", "cpp")
                out[who] = ref_ec.rebuild_ec_reduced(
                    base, lost, groups, fetch, batch_size=4096, align=1024)
        for sid in lost:
            assert (d / ("5" + layout.to_ext(sid))).read_bytes() == \
                files[sid].tobytes(), (who, sid)
    assert out["port"] == out["ref"]
    assert out["port"]["helper_bytes"] == out["port"]["predicted"]["per_node"]


def test_native_fleet_equals_reference(tmp_path, monkeypatch):
    """convert_volumes on the native codec (a per-unit loop over each
    batch, no device buffer) writes the reference fleet's shards."""
    sizes = [200_000, 5_000, 123_456, 0]
    out = {}
    for who in ("port", "ref"):
        d = tmp_path / who
        d.mkdir()
        g = np.random.default_rng(23)
        bases = []
        for i, sz in enumerate(sizes):
            base = str(d / str(i + 1))
            with open(base + ".dat", "wb") as f:
                f.write(g.integers(0, 256, sz, dtype=np.uint8).tobytes())
            bases.append(base)
        geom = dict(large_block=10_000, small_block=100, batch_size=1000)
        if who == "port":
            with monkeypatch.context() as mp:
                mp.setenv("WEEDTPU_EC_CODEC", "native")
                st: dict = {}
                fleet_convert.convert_volumes(bases, stats=st, **geom)
                assert st["mode"] == "fleet" and "d2h_s" in st
        else:
            ref_fleet.convert_volumes(
                bases, codec=ref_native_codec.get_codec(10, 4), **geom)
        out[who] = [{ext: open(b + ext, "rb").read()
                     for ext in [layout.to_ext(i) for i in range(14)]
                     + [".vif"]} for b in bases]
    assert out["port"] == out["ref"]


# ---- knobs, the card, and the dispatch seam ---------------------------------

@pytest.mark.parametrize("value", ["auto", "tpu", "jax", "numpy", "cpp",
                                   "bogus"])
def test_codec_knob_takes_only_the_ports_values(monkeypatch, value):
    monkeypatch.setenv("WEEDTPU_EC_CODEC", value)
    with pytest.raises(ValueError, match="cuda, native \\(unset"):
        ec_files._get_codec(device="cpu")


def test_unset_knob_needs_the_card(volumes, encoded, tmp_path, monkeypatch,
                                   no_card):
    """With the knob unset every entry point still runs on the card and
    raises without one; with it at native they need none."""
    base = _copy_set(encoded["rs_10_4"]["port"], str(tmp_path / "v"))
    os.remove(base + layout.to_ext(0))
    monkeypatch.delenv("WEEDTPU_EC_CODEC", raising=False)
    for call in (lambda: ec_files._get_codec(),
                 lambda: ec_volume.EcVolume(base, 10_000, 100),
                 lambda: fleet_convert.convert_volumes([base])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    monkeypatch.setenv("WEEDTPU_EC_CODEC", "native")
    assert isinstance(ec_files._get_codec(), native_codec.NativeRSCodec)
    ev = ec_volume.EcVolume(base, 10_000, 100)
    try:
        for nid, data in volumes["large"]["blobs"].items():
            assert ev.read_needle(nid).data == data, nid
        assert ev.read_stats["reconstruct_batches"] > 0
    finally:
        ev.close()
    dat = str(tmp_path / "1")
    with open(dat + ".dat", "wb") as f:
        f.write(os.urandom(3000))
    fleet_convert.convert_volumes([dat], large_block=1000, small_block=100,
                                  batch_size=100)
    assert os.path.exists(dat + ".ec13")


def test_apply_cache_keeps_native_and_plain_apart(monkeypatch):
    """One process, one matrix, a plain and a native codec: each apply
    is its own codec's (the cache is keyed by factory and matrix)."""
    monkeypatch.setattr(dispatch, "_APPLY_CACHE", {})
    plain = gf_cuda.get_codec(10, 4, device="cpu")
    host = native_codec.get_codec(10, 4)
    C = np.array([[3, 7, 11]], np.uint8)
    stack = np.random.default_rng(2).integers(0, 256, (3, 999), np.uint8)
    want = gf.gf_matmul(C, stack)
    for codec in (plain, host, plain, host):
        assert np.array_equal(dispatch.apply_matrix(codec, C, stack), want)
    kinds = sorted(type(v).__name__ for v in dispatch._APPLY_CACHE.values())
    assert kinds == ["CudaGFMatrix", "NativeGFMatrix"]
    m = codecs.make_codec("msr_9_16", kind="native")
    assert isinstance(m, msr.MSRFileCodec) and m._factory is \
        native_codec.NativeGFMatrix
