"""The GF(2^8) kernel on the card, against the port's own numpy GF
product.  Imports nothing of JAX, so it runs on a card host without the
JAX package's test harness:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

On a host without a card it skips.  chip_smoke.py covers the same ground
at the main path's shapes.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from seaweedfs_tpu_torch.models import rs
from seaweedfs_tpu_torch.ops import dispatch, gf, gf_cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    """Runs where a card is present (chip_smoke.py covers the same ground
    at the main path's shapes); skips on a CPU-only host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    C = rs.get_code(10, 4).decode_matrix(
        [1, 2, 4, 5, 6, 7, 8, 9, 11, 13], [0, 3, 10, 12])
    mat = gf_cuda.CudaGFMatrix(C)
    g = np.random.default_rng(8)
    for n in (1, 255, 4097, 1 << 16):
        x = g.integers(0, 256, (10, n), dtype=np.uint8)
        dev = dispatch.device_empty((10, n), torch.device("cuda"))
        dev.copy_(torch.from_numpy(x))
        before = gf_cuda.LAUNCHES["gf_apply"]
        staged = gf_cuda.STAGED["gf_apply"]
        got = mat(dev).cpu().numpy()
        assert gf_cuda.LAUNCHES["gf_apply"] == before + 1
        assert gf_cuda.STAGED["gf_apply"] == staged  # read in place
        assert np.array_equal(got, gf.gf_matmul(C, x))
    # a view the kernel cannot read in place is staged once, then launched
    before = gf_cuda.LAUNCHES["gf_apply"]
    staged = gf_cuda.STAGED["gf_apply"]
    got = mat(torch.from_numpy(x).cuda()[:, 1:]).cpu().numpy()
    assert gf_cuda.LAUNCHES["gf_apply"] == before + 1
    assert gf_cuda.STAGED["gf_apply"] == staged + 1
    assert np.array_equal(got, gf.gf_matmul(C, x[:, 1:]))
    before = dict(gf_cuda.LAUNCHES)
    mat(dispatch.device_empty((10, 0), torch.device("cuda")))
    assert gf_cuda.LAUNCHES == before  # an empty input launches nothing
    xb = torch.from_numpy(g.integers(0, 256, (3, 10, 4096), dtype=np.uint8))
    assert np.array_equal(mat.apply_batch(xb.cuda()).cpu().numpy(),
                          mat.apply_batch(xb).numpy())
    assert gf_cuda.LAUNCHES["gf_apply_batch"] == before["gf_apply_batch"] + 1


@pytest.mark.cuda
def test_cuda_kernel_every_shape(card):
    """m = 1..16 at k = 10, k in {1, 17, 32}, ragged n, and a [:, :n] view
    of a wider buffer, read in place."""
    g = np.random.default_rng(9)
    shapes = [(m, 10, 4097) for m in range(1, 17)] + \
        [(4, k, n) for k in (1, 17, 32) for n in (1, 15, 17, 4097)]
    for m, k, n in shapes:
        C = g.integers(0, 256, (m, k), dtype=np.uint8)
        x = g.integers(0, 256, (k, n), dtype=np.uint8)
        dev = dispatch.device_empty((k, n), card)
        dev.copy_(torch.from_numpy(x))
        got = gf_cuda.CudaGFMatrix(C)(dev).cpu().numpy()
        assert np.array_equal(got, gf.gf_matmul(C, x)), (m, k, n)
    C = rs.get_code(10, 4).parity_matrix
    wide = g.integers(0, 256, (10, 8192), dtype=np.uint8)
    view = torch.from_numpy(wide).to(card)[:, :3000]
    mat = gf_cuda.CudaGFMatrix(C)
    staged = dict(gf_cuda.STAGED)
    assert np.array_equal(mat(view).cpu().numpy(),
                          gf.gf_matmul(C, wide[:, :3000]))
    assert gf_cuda.STAGED == staged


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4097, 1 << 20])
@pytest.mark.parametrize("units", [1, 4, 8])
def test_cuda_dispatch_parity_batch(card, units, n):
    """The fleet's seam: a pinned [U, 10, n] batch staged into a padded
    slot buffer, one launch of K2, no staged copy, equal to the plain
    version."""
    codec = gf_cuda.get_codec(10, 4, device=card)
    host = dispatch.host_empty((units, 10, n), card)
    host.copy_(torch.from_numpy(np.random.default_rng(units).integers(
        0, 256, (units, 10, n), dtype=np.uint8)))
    before, staged = dict(gf_cuda.LAUNCHES), dict(gf_cuda.STAGED)
    parity = dispatch.dispatch_parity_batch(
        codec, host, staging=dispatch.device_empty((units, 10, n), card))
    got = dispatch.materialize(parity)
    assert gf_cuda.LAUNCHES["gf_apply_batch"] == \
        before["gf_apply_batch"] + 1
    assert gf_cuda.LAUNCHES["gf_apply"] == before["gf_apply"]
    assert gf_cuda.STAGED == staged
    bit = codec._parity.bitmat.to(card)
    want = gf_cuda.gf_apply_plain(bit, host.to(card)).cpu().numpy()
    assert np.array_equal(got, want)


@pytest.mark.cuda
def test_cuda_fleet_equals_cpu_fleet(card, tmp_path):
    """convert_volumes on the card writes the files it writes on the CPU,
    for a fleet with large rows, ragged tails, an empty volume and 100 B
    units (slot rows padded to 112 B), in one K2 launch per batch."""
    from seaweedfs_tpu_torch.ops import fleet_convert
    geom = dict(large_block=10_000, small_block=100, batch_size=1000)
    sizes = [250_000, 0, 12_345, 100_001]
    files = {}
    for dev in ("cpu", "cuda"):
        d = tmp_path / dev
        d.mkdir()
        rng = np.random.default_rng(6)
        bases = [str(d / str(i)) for i in range(len(sizes))]
        for b, s in zip(bases, sizes):
            (d / (b.rsplit("/", 1)[1] + ".dat")).write_bytes(
                rng.integers(0, 256, s, dtype=np.uint8).tobytes())
        before, staged = dict(gf_cuda.LAUNCHES), dict(gf_cuda.STAGED)
        fleet_convert.convert_volumes(bases, device=dev, **geom)
        launched = gf_cuda.LAUNCHES["gf_apply_batch"] - \
            before["gf_apply_batch"]
        # 70 + 0 + 13 + 11 units carry data: ceil(94 / 4) batches
        assert launched == (0 if dev == "cpu" else 24)
        assert gf_cuda.STAGED == staged
        files[dev] = {p.name: p.read_bytes() for p in sorted(d.iterdir())}
    assert files["cpu"] == files["cuda"]
    assert len(files["cpu"]) == 4 * 16  # .dat, 14 shards, .vif each


@pytest.mark.cuda
def test_cuda_codec_any_width(card):
    """CudaRSCodec.encode / reconstruct on a contiguous [10, 700] on the
    card, which the first port refused."""
    codec = gf_cuda.get_codec(10, 4, device=card)
    code = rs.get_code(10, 4)
    data = np.random.default_rng(10).integers(0, 256, (10, 700),
                                              dtype=np.uint8)
    want = np.concatenate([data, gf.gf_matmul(code.parity_matrix, data)])
    shards = codec.encode(torch.from_numpy(data).to(card))
    assert np.array_equal(shards.cpu().numpy(), want)
    assert np.array_equal(
        codec.encode_parity(torch.from_numpy(data).to(card)).cpu().numpy(),
        want[10:])
    lost = (0, 3, 10, 12)
    out = codec.reconstruct({i: torch.from_numpy(want[i]).to(card)
                             for i in range(14) if i not in lost})
    for i in lost:
        assert np.array_equal(out[i].cpu().numpy(), want[i]), i


@pytest.mark.cuda
@pytest.mark.parametrize("n", [17, 4097, (1 << 20) + 5])
@pytest.mark.parametrize("j", [1, 3, 5, 10])
def test_cuda_apply_matrix_equals_cpu(card, j, n):
    """Repair's partial apply on the card: [1, j] @ [j, n] in one K1
    launch on rows it reads in place, equal to the CPU's apply."""
    C = rs.get_code(10, 4).decode_matrix([0, 1, 2, 4, 5, 6, 7, 8, 9, 10],
                                         [3])[:, :j]
    stack = np.random.default_rng(j * 7919 + n).integers(
        0, 256, (j, n), dtype=np.uint8)
    before, staged = dict(gf_cuda.LAUNCHES), dict(gf_cuda.STAGED)
    got = dispatch.apply_matrix(gf_cuda.get_codec(10, 4, device=card), C,
                                stack)
    assert gf_cuda.LAUNCHES["gf_apply"] == before["gf_apply"] + 1
    assert gf_cuda.STAGED == staged
    want = dispatch.apply_matrix(gf_cuda.get_codec(10, 4, device="cpu"), C,
                                 stack)
    assert np.array_equal(got, want)
    assert np.array_equal(got, gf.gf_matmul(C, stack))


@pytest.mark.cuda
def test_cuda_rebuild_ec_reduced_equals_cpu(card, tmp_path, monkeypatch):
    """rebuild_ec_reduced on the card writes the files and returns the
    result dict it does on the CPU: two losses in sequence over 10 000 B
    shards at 1 KiB segments and 4 KiB batches (ragged ranges, so the
    kernel's byte tail runs), the helpers' partials on the same device."""
    from seaweedfs_tpu_torch.ops import regen
    from seaweedfs_tpu_torch.storage.ec import ec_files, layout
    monkeypatch.setattr(ec_files, "DEFAULT_BATCH", 4096)
    monkeypatch.setattr(regen, "DEFAULT_SEG_ALIGN", 1024)
    code = rs.get_code(10, 4)
    data = np.random.default_rng(12).integers(0, 256, (10, 10_000),
                                              dtype=np.uint8)
    full = np.concatenate([data, gf.gf_matmul(code.parity_matrix, data)])
    lost = [1, 12]
    groups = [{"node": "a:1", "shards": [6, 7, 8], "locality": 1},
              {"node": "b:2", "shards": [9, 10, 11, 13], "locality": 3}]
    results, files = {}, {}
    for dev in ("cpu", "cuda"):
        d = tmp_path / dev
        d.mkdir()
        for s in (0, 2, 3, 4, 5):
            (d / ("4" + layout.to_ext(s))).write_bytes(full[s].tobytes())
        codec = gf_cuda.get_codec(10, 4, device=dev)

        def fetch(group, sids, coeff, off, n, codec=codec):
            rows = np.stack([full[s][off:off + n] for s in sids])
            return dispatch.apply_matrix(codec, coeff, rows).tobytes()
        before, staged = dict(gf_cuda.LAUNCHES), dict(gf_cuda.STAGED)
        results[dev] = ec_files.rebuild_ec_reduced(
            str(d / "4"), lost, groups, fetch, device=dev)
        launched = gf_cuda.LAUNCHES["gf_apply"] - before["gf_apply"]
        assert (launched > 0) == (dev == "cuda")
        assert gf_cuda.STAGED == staged
        files[dev] = {p.name: p.read_bytes() for p in sorted(d.iterdir())}
    assert results["cpu"] == results["cuda"]
    assert files["cpu"] == files["cuda"]
    for s in lost:
        assert files["cuda"]["4" + layout.to_ext(s)] == full[s].tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", [(17, 10), (17, 33), (32, 64), (33, 72),
                                 (72, 72), (8, 72), (16, 72), (4, 200),
                                 (20, 200), (1, 255)])
def test_cuda_kernel_any_shape(card, m, k):
    """Matrices past 16 rows or 32 columns (fault 3.3): one launch per
    row block of 16, rows read in place, equal to the port's numpy GF
    product at ragged n, on a [:, :n] view, and batched.  [20, 200]'s
    first block needs 100 KB of tables, past the 48 KB default."""
    g = np.random.default_rng(m * 1000 + k)
    C = g.integers(0, 256, (m, k), dtype=np.uint8)
    mat = gf_cuda.CudaGFMatrix(C)
    blocks = -(-m // 16)
    for n in (1, 17, 4097):
        x = g.integers(0, 256, (k, n), dtype=np.uint8)
        dev = dispatch.device_empty((k, n), card)
        dev.copy_(torch.from_numpy(x))
        before, staged = dict(gf_cuda.LAUNCHES), dict(gf_cuda.STAGED)
        got = mat(dev).cpu().numpy()
        assert gf_cuda.LAUNCHES["gf_apply"] == before["gf_apply"] + blocks
        assert gf_cuda.STAGED == staged
        assert np.array_equal(got, gf.gf_matmul(C, x)), (m, k, n)
    wide = torch.from_numpy(g.integers(0, 256, (4, k, 8192), dtype=np.uint8))
    before = dict(gf_cuda.LAUNCHES)
    got = mat.apply_batch(wide.to(card)[:, :, :3001]).cpu()
    assert gf_cuda.LAUNCHES["gf_apply_batch"] == \
        before["gf_apply_batch"] + blocks
    assert torch.equal(got, mat.apply_batch(wide[:, :, :3001]))


@pytest.mark.cuda
@pytest.mark.parametrize("tag,losses,blocks", [
    ("lrc_10_2_2", (2, 5, 11), (10_000, 100)),
    ("msr_9_16", (0, 13), (8000, 400))])
def test_cuda_codec_volume_equals_cpu(card, tmp_path, tag, losses, blocks):
    """write_ec_files, degraded reads through EcVolume and rebuild_ec_files
    of an LRC and an MSR volume on the card write the files they write on
    the CPU and return the same needles, with no input staged by the
    kernel wrapper (MSR's de-interleave lands in rows it reads in
    place)."""
    from seaweedfs_tpu_torch.storage import needle
    from seaweedfs_tpu_torch.storage.ec import ec_files, ec_volume, layout
    from seaweedfs_tpu_torch.storage.volume import Volume
    large, small = blocks
    # one .dat for both devices: needles carry their append time
    src = tmp_path / "src"
    src.mkdir()
    v = Volume(str(src), "", 3)
    rng = np.random.default_rng(5)
    blobs = {}
    for i in range(1, 71):
        data = rng.bytes(int(rng.integers(1, 7000)))
        v.append_needle(needle.Needle(cookie=9, id=i, data=data))
        blobs[i] = data
    v.close()
    files = {}
    for dev in ("cpu", "cuda"):
        d = tmp_path / dev
        d.mkdir()
        for ext in (".dat", ".idx"):
            shutil.copy(src / ("3" + ext), d / ("3" + ext))
        base = str(d / "3")
        before, staged = dict(gf_cuda.LAUNCHES), dict(gf_cuda.STAGED)
        ec_files.write_ec_files(base, large_block=large, small_block=small,
                                batch_size=small * 10, codec_tag=tag,
                                device=dev)
        ec_files.write_sorted_ecx(base + ".idx")
        files[dev] = {p.name: p.read_bytes() for p in sorted(d.iterdir())}
        for s in losses:
            os.remove(base + layout.to_ext(s))
        ev = ec_volume.EcVolume(base, large, small, device=dev)
        try:
            for nid, data in blobs.items():
                assert ev.read_needle(nid).data == data, (dev, nid)
        finally:
            ev.close()
        assert sorted(ec_files.rebuild_ec_files(base, device=dev)) == \
            sorted(losses)
        for s in losses:
            name = "3" + layout.to_ext(s)
            assert (d / name).read_bytes() == files[dev][name]
        launched = gf_cuda.LAUNCHES["gf_apply"] - before["gf_apply"]
        assert (launched > 0) == (dev == "cuda")
        assert gf_cuda.STAGED == staged
    assert files["cpu"] == files["cuda"]


def _msr_repair_matrices(c: int):
    """MSR repair's two matrices for a helper node of c shards, lost 0:
    the block-diagonal [c, 8c] helper coefficients and the [8, c] post."""
    from seaweedfs_tpu_torch.ops import msr
    code = msr.get_code(9, 16)
    helpers = list(range(1, 17))
    phi = code.repair_coeff(0)
    coeff = np.zeros((c, 8 * c), dtype=np.uint8)
    for i in range(c):
        coeff[i, 8 * i:8 * (i + 1)] = phi[0]
    R = code.repair_matrix(0, helpers)
    return coeff, np.ascontiguousarray(R[:, :c])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [17, 4097, (2 << 20) + 5])
@pytest.mark.parametrize("c", [1, 4, 5, 6])
def test_cuda_apply_matrix_msr_repair_shapes(card, c, n):
    """MSR repair's applies on the card, [c, 8c] @ [8c, n] (a helper's
    sub-rows, k up to 48) and [8, c] @ [c, n] (the post), one K1 launch
    each on rows read in place, equal to the CPU's apply at ragged n."""
    coeff, post = _msr_repair_matrices(c)
    g = np.random.default_rng(c * 31 + n)
    for C in (coeff, post):
        stack = g.integers(0, 256, (C.shape[1], n), dtype=np.uint8)
        before, staged = dict(gf_cuda.LAUNCHES), dict(gf_cuda.STAGED)
        got = dispatch.apply_matrix(gf_cuda.get_codec(10, 4, device=card),
                                    C, stack)
        assert gf_cuda.LAUNCHES["gf_apply"] == before["gf_apply"] + 1
        assert gf_cuda.STAGED == staged
        assert np.array_equal(got, dispatch.apply_matrix(
            gf_cuda.get_codec(10, 4, device="cpu"), C, stack))
        assert np.array_equal(got, gf.gf_matmul(C, stack))


@pytest.mark.cuda
@pytest.mark.parametrize("tag,lost,d", [("lrc_10_2_2", [2], None),
                                        ("lrc_10_2_2", [12], 10),
                                        ("msr_9_16", [0, 13], None)])
def test_cuda_rebuild_ec_reduced_codecs_equal_cpu(card, tmp_path,
                                                  monkeypatch, tag, lost, d):
    """LRC and MSR rebuild_ec_reduced on the card write the files and
    return the result dict they do on the CPU (16 000 B shards, 4 KiB
    batches: MSR's 512 B sub-row chunks end in a ragged one), with the
    helpers' partials on the same device and no input staged."""
    from seaweedfs_tpu_torch.ops import codecs, regen
    from seaweedfs_tpu_torch.storage.ec import ec_files, layout
    monkeypatch.setattr(ec_files, "DEFAULT_BATCH", 4096)
    monkeypatch.setattr(regen, "DEFAULT_SEG_ALIGN", 1024)
    cpu = codecs.make_codec(tag, device="cpu")
    a = 8 if tag == "msr_9_16" else 1
    data = np.random.default_rng(13).integers(0, 256, (cpu.k, 16_000),
                                              dtype=np.uint8)
    full = cpu.encode(torch.from_numpy(data)).numpy()
    spans = ([("a:1", range(6, 9), 1), ("b:2", range(9, 14), 3)] if a == 1
             else [("a:1", range(6, 12), 1), ("c:3", (12,), 2),
                   ("b:2", range(13, 18), 3)])
    groups = [{"node": n, "shards": list(s), "locality": loc}
              for n, s, loc in spans]
    results, files = {}, {}
    for dev in ("cpu", "cuda"):
        d_ = tmp_path / dev
        d_.mkdir()
        base = str(d_ / "4")
        for s in range(6):
            if s not in lost:
                (d_ / ("4" + layout.to_ext(s))).write_bytes(full[s].tobytes())
        ec_files.write_vif(base, 10 * 16_000, codec=tag)
        codec = codecs.make_codec(tag, device=dev)

        def fetch(group, vids, coeff, off, n, codec=codec):
            rows = np.stack([full[v // a][off * a:(off + n) * a]
                             .reshape(n, a)[:, v % a] for v in vids])
            return dispatch.apply_matrix(codec, coeff, rows).tobytes()
        before, staged = dict(gf_cuda.LAUNCHES), dict(gf_cuda.STAGED)
        results[dev] = ec_files.rebuild_ec_reduced(base, lost, groups,
                                                   fetch, d=d, device=dev)
        launched = gf_cuda.LAUNCHES["gf_apply"] - before["gf_apply"]
        assert (launched > 0) == (dev == "cuda")
        assert gf_cuda.STAGED == staged
        files[dev] = {p.name: p.read_bytes() for p in sorted(d_.iterdir())}
    assert results["cpu"] == results["cuda"]
    assert files["cpu"] == files["cuda"]
    for s in lost:
        assert files["cuda"]["4" + layout.to_ext(s)] == full[s].tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [17, 4097, (1 << 20) + 5])
def test_cuda_native_product_equals_kernel(card, n):
    """The native host codec's product equals K1's on the same inputs,
    under every kernel this CPU has (GFNI only where CPUID finds it)."""
    from seaweedfs_tpu_torch import native
    C = rs.get_code(10, 4).parity_matrix
    x = np.random.default_rng(n).integers(0, 256, (10, n), dtype=np.uint8)
    dev = dispatch.device_empty((10, n), card)
    dev.copy_(torch.from_numpy(x))
    want = gf_cuda.CudaGFMatrix(C)(dev).cpu().numpy()
    native.set_gf_impl(native.GF_IMPL_AUTO)
    impls = [native.GF_IMPL_AVX2, native.GF_IMPL_SCALAR]
    if native.gf_impl() == native.GF_IMPL_GFNI:
        impls.append(native.GF_IMPL_GFNI)
    try:
        for impl in impls:
            native.set_gf_impl(impl)
            got = np.empty_like(want)
            native.gf_matmul_ptrs(C, list(x), list(got), n)
            assert np.array_equal(got, want), impl
    finally:
        native.set_gf_impl(native.GF_IMPL_AUTO)


@pytest.mark.cuda
def test_cuda_native_shards_equal_card(card, tmp_path, monkeypatch):
    """One .dat encoded by the card's codec and by the native host codec
    (WEEDTPU_EC_CODEC=native, no kernel launched): the same shards, and
    the host-serial rebuild of a lost shard set gives them back."""
    from seaweedfs_tpu_torch.storage.ec import ec_files, layout
    src = np.random.default_rng(11).integers(0, 256, 345_678,
                                             dtype=np.uint8).tobytes()
    files = {}
    for who in ("card", "native"):
        d = tmp_path / who
        d.mkdir()
        base = str(d / "1")
        (d / "1.dat").write_bytes(src)
        if who == "native":
            monkeypatch.setenv("WEEDTPU_EC_CODEC", "native")
        before = dict(gf_cuda.LAUNCHES)
        ec_files.write_ec_files(base, large_block=10_000, small_block=100,
                                batch_size=1000)
        assert (gf_cuda.LAUNCHES != before) == (who == "card")
        files[who] = {i: (d / ("1" + layout.to_ext(i))).read_bytes()
                      for i in range(14)}
    assert files["card"] == files["native"]
    for i in (0, 3, 10, 12):
        os.remove(str(tmp_path / "native" / ("1" + layout.to_ext(i))))
    st: dict = {}
    ec_files.rebuild_ec_files(str(tmp_path / "native" / "1"), stats=st)
    assert st["mode"] == "host-serial"
    assert {i: (tmp_path / "native" / ("1" + layout.to_ext(i))).read_bytes()
            for i in range(14)} == files["card"]


@pytest.mark.cuda
def test_cuda_encode_uring_direct_equals_cpu(card, tmp_path, monkeypatch):
    """One .dat encoded and rebuilt on the card under WEEDTPU_AIO=uring
    with O_DIRECT (parity rows straight from the pinned D2H buffers, 4 KiB
    multiples, so aligned runs go out direct), and on the CPU under the
    default engine: the same shards."""
    from seaweedfs_tpu_torch.storage import aio
    from seaweedfs_tpu_torch.storage.ec import ec_files, layout
    if not aio.probe_uring():
        pytest.skip("io_uring unavailable on this host")
    geom = dict(large_block=1 << 20, small_block=64 << 10,
                batch_size=256 << 10)
    src = np.random.default_rng(13).integers(0, 256, 12_345_678,
                                             dtype=np.uint8).tobytes()
    files = {}
    for dev in ("cpu", "cuda"):
        d = tmp_path / dev
        d.mkdir()
        base = str(d / "1")
        (d / "1.dat").write_bytes(src)
        with monkeypatch.context() as mp:
            if dev == "cuda":
                mp.setenv("WEEDTPU_AIO", "uring")
                mp.setenv("WEEDTPU_AIO_DIRECT", "1")
            st: dict = {}
            ec_files.write_ec_files(base, device=dev, stats=st, **geom)
            assert st["aio_mode"] == ("uring" if dev == "cuda"
                                      else aio.engine_mode())
            files[dev] = {i: (d / ("1" + layout.to_ext(i))).read_bytes()
                          for i in range(14)}
            for i in (0, 3, 10, 12):
                os.remove(base + layout.to_ext(i))
            rst: dict = {}
            ec_files.rebuild_ec_files(base, batch_size=geom["batch_size"],
                                      stats=rst, device=dev)
            assert rst["aio_mode"] == st["aio_mode"]
            assert {i: (d / ("1" + layout.to_ext(i))).read_bytes()
                    for i in range(14)} == files[dev]
    assert files["cpu"] == files["cuda"]


@pytest.mark.cuda
def test_cuda_fleet_flush_settings_equal(card, tmp_path, monkeypatch):
    """convert_volumes on the card with the submission batcher (the
    default FLUSH_BYTES) and without it (FLUSH_BYTES = 1, a flush per
    unit): the same files, byte for byte."""
    from seaweedfs_tpu_torch.ops import fleet_convert
    from seaweedfs_tpu_torch.storage.ec import ec_files
    geom = dict(large_block=10_000, small_block=100, batch_size=1000)
    sizes = [250_000, 12_345, 100_001]
    files = {}
    for flush in (ec_files.FLUSH_BYTES, 1):
        d = tmp_path / str(flush)
        d.mkdir()
        rng = np.random.default_rng(6)
        bases = [str(d / str(i)) for i in range(len(sizes))]
        for b, s in zip(bases, sizes):
            (d / (b.rsplit("/", 1)[1] + ".dat")).write_bytes(
                rng.integers(0, 256, s, dtype=np.uint8).tobytes())
        with monkeypatch.context() as mp:
            mp.setattr(ec_files, "FLUSH_BYTES", flush)
            fleet_convert.convert_volumes(bases, device="cuda", **geom)
        files[flush] = {p.name: p.read_bytes() for p in sorted(d.iterdir())}
    assert files[1] == files[ec_files.FLUSH_BYTES]
    assert len(files[1]) == 3 * 16


def _trace_kernels(trace_dir, name):
    """Kernel events whose name holds `name` in the one Chrome trace
    `torch_profile` wrote into trace_dir."""
    import json
    (path,) = [os.path.join(trace_dir, p) for p in os.listdir(trace_dir)]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "kernel"
            and name in e.get("name", "")]


@pytest.mark.cuda
def test_cuda_kernel_rows_and_trace_count_the_launches(card, tmp_path):
    """A 64 MiB encode on the card: the kernel profile's
    encode_parity[device] calls equal K1's counted launches, its bytes the
    layout's [k, step] batches, and the torch_profile trace of the
    encode holds one K1 kernel event per launch."""
    from seaweedfs_tpu_torch.stats.profile import KERNELS
    from seaweedfs_tpu_torch.storage.ec import ec_files, layout
    from seaweedfs_tpu_torch.utils import grace
    base = str(tmp_path / "1")
    size = 64 << 20
    with open(base + ".dat", "wb") as f:
        f.write(np.random.default_rng(3).integers(
            0, 256, size, dtype=np.uint8).tobytes())
    k0 = KERNELS.snapshot().get("encode_parity[device]",
                                {"calls": 0.0, "bytes": 0.0})
    before = gf_cuda.LAUNCHES["gf_apply"]
    with grace.torch_profile(str(tmp_path / "trace")):
        ec_files.write_ec_files(base)
        torch.cuda.synchronize()
    launched = gf_cuda.LAUNCHES["gf_apply"] - before
    row = KERNELS.snapshot()["encode_parity[device]"]
    units = sum(1 for u in ec_files._iter_units(
        size, layout.LARGE_BLOCK_SIZE, layout.SMALL_BLOCK_SIZE,
        ec_files.DEFAULT_BATCH))
    assert launched == units == row["calls"] - k0["calls"]
    assert row["bytes"] - k0["bytes"] == units * 10 * layout.SMALL_BLOCK_SIZE
    assert len(_trace_kernels(str(tmp_path / "trace"),
                              "gf_apply_kernel")) == launched


@pytest.mark.cuda
def test_cuda_store_decode_equals_cpu(card, tmp_path):
    """A small store's volume encoded on the card, mounted as an EC
    volume, two needles deleted through the store, two data shards lost
    and the volume decoded back: the same files as the same steps on the
    CPU, and the decoded volume mounts with the deleted needles gone."""
    from seaweedfs_tpu_torch.storage import needle, store
    from seaweedfs_tpu_torch.storage.ec import ec_files, layout
    from seaweedfs_tpu_torch.storage.volume import Volume
    src = tmp_path / "src"
    src.mkdir()
    g = np.random.default_rng(10)
    v = Volume(str(src), "", 3)
    blobs = {nid: g.bytes(int(g.integers(1, 400_000))) for nid in range(1, 41)}
    for nid, data in blobs.items():
        v.append_needle(needle.Needle(cookie=nid, id=nid, data=data,
                                      append_at_ns=nid))
    v.close()
    files = {}
    for dev in ("cpu", "cuda"):
        d = tmp_path / dev
        shutil.copytree(src, d)
        base = str(d / "3")
        before = gf_cuda.LAUNCHES["gf_apply"]
        ec_files.write_ec_files(base, device=dev)
        ec_files.write_sorted_ecx(base + ".idx")
        os.remove(base + ".dat")
        os.remove(base + ".idx")
        s = store.Store([str(d)], device=None if dev == "cuda" else "cpu")
        for nid in (7, 30):
            s.delete_needle(3, nid)
        s.close()
        for i in (2, 8):
            os.remove(base + layout.to_ext(i))
        ec_files.rebuild_ec_files(base, device=dev)
        ec_files.write_dat_file(base, ec_files.find_dat_file_size(base))
        ec_files.write_idx_from_ecx(base + ".ecx")
        launched = gf_cuda.LAUNCHES["gf_apply"] - before
        assert (launched > 0) == (dev == "cuda")
        files[dev] = {p.name: p.read_bytes() for p in sorted(d.iterdir())}
        s = store.Store([str(d)], device=None if dev == "cuda" else "cpu")
        for nid, data in blobs.items():
            if nid in (7, 30):
                with pytest.raises(KeyError):
                    s.read_needle(3, nid)
            else:
                assert s.read_needle(3, nid, nid).data == data
        s.close()
    assert files["cpu"] == files["cuda"]
    assert files["cuda"]["3.dat"] == (src / "3.dat").read_bytes()


@pytest.mark.cuda
def test_cuda_hedged_and_quarantined_reads_from_two_threads(card, tmp_path,
                                                            monkeypatch):
    """Two threads read one shard set's needles at once through
    `Store.read_needle` on the card and on the CPU: one hedged against a
    peer 0.2 s late on shards 0 and 1 (its node holds 2-13), one over a
    quarantined range of shard 2 (its node holds every shard).  Every
    read equals the CPU's and the written bytes, and on the card K1
    grows exactly as the volumes' reconstruct batches do."""
    import threading
    import time
    from seaweedfs_tpu_torch.maintenance import scrub
    from seaweedfs_tpu_torch.storage import needle, store, types
    from seaweedfs_tpu_torch.storage.ec import ec_files, layout
    from seaweedfs_tpu_torch.storage.volume import Volume
    monkeypatch.setenv("WEEDTPU_HEDGE_PCT", "99")
    monkeypatch.setenv("WEEDTPU_HEDGE_MAX_MS", "50")
    src = tmp_path / "src"
    src.mkdir()
    g = np.random.default_rng(11)
    v = Volume(str(src), "", 3)
    blobs = {nid: g.bytes(int(g.integers(1, 400_000))) for nid in range(1, 41)}
    for nid, data in blobs.items():
        v.append_needle(needle.Needle(cookie=nid, id=nid, data=data,
                                      append_at_ns=nid))
    v.close()
    full = str(src / "3")
    ec_files.write_ec_files(full, device="cpu")
    ec_files.write_sorted_ecx(full + ".idx")

    def node(name, keep):
        d = tmp_path / name
        d.mkdir()
        for ext in [layout.to_ext(i) for i in keep] + [".ecx", ".vif"]:
            shutil.copy(full + ext, str(d / ("3" + ext)))
        return str(d)

    def reader(sid, off, size):
        if sid not in (0, 1):
            return None
        time.sleep(0.2)
        with open(full + layout.to_ext(sid), "rb") as f:
            return os.pread(f.fileno(), size, off)

    def shards_of(ev, nid):
        off, size = ev.find_needle(nid)
        return {iv.to_shard_id_and_offset()[0] for iv in layout.locate_data(
            ev.large_block, ev.small_block, ev.dat_size, off,
            types.actual_size(size, ev.version))}

    hedged_dir = node("hedged", range(2, 14))
    quar_dir = node("quarantined", range(14))
    with open(os.path.join(quar_dir, "3" + layout.to_ext(2)), "r+b") as f:
        f.seek(5000)
        f.write(bytes(128))
    got = {}
    for dev in ("cpu", "cuda"):
        kw = {"device": "cpu"} if dev == "cpu" else {}
        hs, qs = store.Store([hedged_dir], **kw), store.Store([quar_dir], **kw)
        hev, qev = hs.get_ec_volume(3), qs.get_ec_volume(3)
        found = scrub.syndrome_scan(qev)
        assert [c["shard"] for c in found] == [2]
        for c in found:
            qev.quarantine_range(c["shard"], c["offset"], c["size"])
        hedged = [nid for nid in blobs if shards_of(hev, nid) & {0, 1}][:6]
        quarantined = [nid for nid in blobs if any(
            c["offset"] < iv_end and iv_off < c["offset"] + c["size"]
            for c in found for iv_off, iv_end in _shard_spans(qev, nid, 2))]
        assert hedged and quarantined
        reads: dict = {}
        errors: list = []

        def run(s, nids, reader=None):
            try:
                for nid in nids:
                    reads[nid] = s.read_needle(3, nid, nid,
                                               shard_reader=reader).data
            except Exception as e:  # surfaced after join
                errors.append(e)

        before = gf_cuda.LAUNCHES["gf_apply"]
        b0 = sum(ev.read_stats_snapshot()["reconstruct_batches"]
                 for ev in (hev, qev))
        threads = [threading.Thread(target=run, args=(hs, hedged, reader)),
                   threading.Thread(target=run, args=(qs, quarantined))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads) and not errors, errors
        batches = sum(ev.read_stats_snapshot()["reconstruct_batches"]
                      for ev in (hev, qev)) - b0
        assert batches >= len(hedged) + len(quarantined)
        launched = gf_cuda.LAUNCHES["gf_apply"] - before
        assert launched == (batches if dev == "cuda" else 0)
        for nid, data in reads.items():
            assert data == blobs[nid], nid
        got[dev] = reads
        time.sleep(0.25)  # the abandoned fetches finish
        hs.close()
        qs.close()
    assert got["cpu"] == got["cuda"]


def _shard_spans(ev, nid, shard):
    """(start, end) shard-file offsets of a needle's intervals on one
    shard."""
    from seaweedfs_tpu_torch.storage import types
    from seaweedfs_tpu_torch.storage.ec import layout
    off, size = ev.find_needle(nid)
    out = []
    for iv in layout.locate_data(ev.large_block, ev.small_block, ev.dat_size,
                                 off, types.actual_size(size, ev.version)):
        sid, soff = iv.to_shard_id_and_offset()
        if sid == shard:
            out.append((soff, soff + iv.size))
    return out


@pytest.mark.cuda
def test_cuda_volume_server_generate_and_degraded_get(card, tmp_path):
    """The port's volume server on the card, in process behind a master
    stand-in: /admin/ec/generate writes the shard set the CPU encode
    writes of the same .dat, launching K1; once mounted with data shards
    0 and 3 gone, a GET of each blob equals its bytes, and K1 grows
    exactly as the volume's reconstruct batches do."""
    import asyncio
    import json
    import socket
    import threading
    import urllib.request
    from aiohttp import web
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    from seaweedfs_tpu_torch.storage.ec import ec_files

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    async def heartbeat(req):
        return web.json_response({})

    app = web.Application()
    app.add_routes([web.post("/heartbeat", heartbeat)])
    loop = asyncio.new_event_loop()
    threading.Thread(target=loop.run_forever, daemon=True).start()

    def run(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(120)

    runner = web.AppRunner(app)
    mport = free_port()
    run(runner.setup())
    run(web.TCPSite(runner, "127.0.0.1", mport).start())
    d = tmp_path / "vs"
    vs = VolumeServer([str(d)], f"127.0.0.1:{mport}", port=free_port())
    assert vs.device.type == "cuda"
    run(vs.start())

    def call(path, data=None, method=None):
        req = urllib.request.Request(
            f"http://{vs.url}{path}", data=data,
            method=method or ("POST" if data is not None else "GET"),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.read()

    try:
        call("/admin/assign_volume", json.dumps({"volume": 3}).encode())
        g = np.random.default_rng(12)
        blobs = {}
        for k in range(1, 41):
            f = f"3,{k:x}{k:08x}"
            blobs[f] = g.bytes(int(g.integers(1, 300_000)))
            call("/" + f, blobs[f], "PUT")
        call("/admin/volume/readonly", b'{"volume": 3}')
        before = gf_cuda.LAUNCHES["gf_apply"]
        call("/admin/ec/generate", b'{"volume": 3}')
        assert gf_cuda.LAUNCHES["gf_apply"] > before
        cpu = tmp_path / "cpu"
        cpu.mkdir()
        shutil.copy(d / "3.dat", cpu / "3.dat")
        ec_files.write_ec_files(str(cpu / "3"), device="cpu")
        for i in range(14):
            assert (d / f"3.ec{i:02d}").read_bytes() == \
                (cpu / f"3.ec{i:02d}").read_bytes(), i
        call("/admin/ec/mount", b'{"volume": 3}')
        call("/admin/volume/delete", b'{"volume": 3}')
        call("/admin/ec/delete_shards", b'{"volume": 3, "shards": [0, 3]}')
        ev = vs.store.get_ec_volume(3)
        before = gf_cuda.LAUNCHES["gf_apply"]
        b0 = ev.read_stats_snapshot()["reconstruct_batches"]
        for f, data in blobs.items():
            assert call("/" + f) == data, f
        batches = ev.read_stats_snapshot()["reconstruct_batches"] - b0
        assert batches > 0
        assert gf_cuda.LAUNCHES["gf_apply"] - before == batches
    finally:
        run(vs.stop())
        run(runner.cleanup())
        loop.call_soon_threadsafe(loop.stop)


@pytest.mark.cuda
def test_cuda_server_fleet_convert_and_reduced_repair(card, tmp_path,
                                                      monkeypatch):
    """Two port volume servers on the card, in process behind a master
    stand-in.  A's /admin/ec/fleet_convert of two volumes launches K2 and
    writes the shard sets and .ecx the CPU's convert_volumes writes of
    the same volumes; then A's reduced rebuild of a lost shard, with B
    serving partials of the shards it copied, launches K1 on both sides
    and rebuilds the shard the CPU wrote, B's bytes equal to the plan's."""
    import asyncio
    import json
    import socket
    import threading
    import urllib.request
    from aiohttp import web
    from seaweedfs_tpu_torch.ops import fleet_convert
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    from seaweedfs_tpu_torch.storage.ec import ec_files

    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "0")

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    async def heartbeat(req):
        await req.read()
        return web.json_response({})

    app = web.Application()
    app.add_routes([web.post("/heartbeat", heartbeat)])
    loop = asyncio.new_event_loop()
    threading.Thread(target=loop.run_forever, daemon=True).start()

    def run(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(120)

    runner = web.AppRunner(app)
    mport = free_port()
    run(runner.setup())
    run(web.TCPSite(runner, "127.0.0.1", mport).start())
    dirs = [tmp_path / "a", tmp_path / "b"]
    servers = [VolumeServer([str(d)], f"127.0.0.1:{mport}",
                            port=free_port()) for d in dirs]
    for vs in servers:
        run(vs.start())
    a, b = servers

    def call(vs, path, body=None, data=None, method=None):
        if body is not None:
            data = json.dumps(body).encode()
        req = urllib.request.Request(
            f"http://{vs.url}{path}", data=data,
            method=method or ("POST" if data is not None else "GET"),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            raw = r.read()
        return json.loads(raw) if raw[:1] == b"{" else raw

    try:
        g = np.random.default_rng(14)
        for vid in (3, 4):
            call(a, "/admin/assign_volume", {"volume": vid})
            for k in range(1, 31):
                call(a, f"/{vid},{k:x}{k:08x}",
                     data=g.bytes(int(g.integers(1, 200_000))),
                     method="PUT")
        cpu = tmp_path / "cpu"
        cpu.mkdir()
        for vid in (3, 4):
            a.store.get_volume(vid).flush()
            shutil.copy(dirs[0] / f"{vid}.dat", cpu / f"{vid}.dat")
            shutil.copy(dirs[0] / f"{vid}.idx", cpu / f"{vid}.idx")
        fleet_convert.convert_volumes([str(cpu / "3"), str(cpu / "4")],
                                      device="cpu")
        before = dict(gf_cuda.LAUNCHES)
        r = call(a, "/admin/ec/fleet_convert", {"volumes": [3, 4]})
        assert r["converted"] == [3, 4]
        assert gf_cuda.LAUNCHES["gf_apply_batch"] > \
            before["gf_apply_batch"]
        assert gf_cuda.LAUNCHES["gf_apply"] == before["gf_apply"]
        for vid in (3, 4):
            ec_files.write_sorted_ecx(str(cpu / f"{vid}.idx"))
            for ext in [f".ec{i:02d}" for i in range(14)] + [".ecx",
                                                             ".vif"]:
                assert (dirs[0] / f"{vid}{ext}").read_bytes() == \
                    (cpu / f"{vid}{ext}").read_bytes(), (vid, ext)
        held = [10, 11, 12, 13]
        call(b, "/admin/ec/copy", {"volume": 3, "source": a.url,
                                   "shards": held})
        call(b, "/admin/ec/mount", {"volume": 3})
        call(a, "/admin/ec/delete_shards", {"volume": 3,
                                            "shards": held + [2]})
        size = os.path.getsize(cpu / "3.ec02")
        before = gf_cuda.LAUNCHES["gf_apply"]
        staged = dict(gf_cuda.STAGED)
        r = call(a, "/admin/ec/rebuild", {
            "volume": 3, "codec": "rs_10_4",
            "reduced": {"lost": [2], "shard_size": size, "groups": [
                {"node": b.url, "shards": held, "locality": 1}]}})
        assert r["helper_bytes"] == r["predicted"]["per_node"] == \
            {b.url: size}
        # one segment (the shard is under the plan's 4 MiB alignment)
        # and one chunk: B's partial and A's local apply
        assert size <= 4 << 20
        assert gf_cuda.LAUNCHES["gf_apply"] - before == 2
        assert (dirs[0] / "3.ec02").read_bytes() == \
            (cpu / "3.ec02").read_bytes()
        assert gf_cuda.STAGED == staged  # the kernel read every row in place
    finally:
        for vs in servers:
            run(vs.stop())
        run(runner.cleanup())
        loop.call_soon_threadsafe(loop.stop)


def _card_servers(tmp_path, n):
    """`n` port volume servers on the card, in process on a loop thread
    behind a master stand-in that takes beats and answers /dir/ec/lookup
    from them; returns (servers, run, call, stop)."""
    import asyncio
    import json
    import socket
    import threading
    import urllib.request
    from aiohttp import web
    from seaweedfs_tpu_torch import pb
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer

    beats = {}

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    async def heartbeat(req):
        raw = await req.read()
        beat = pb.heartbeat_from_bytes(raw) \
            if req.headers.get("Content-Type") == pb.CONTENT_TYPE \
            else json.loads(raw)
        beats[beat["url"]] = beat
        return web.json_response({})

    async def ec_lookup(req):
        vid = int(req.query["volumeId"])
        shards = {}
        for u, b in sorted(beats.items()):
            for e in b["ec_shards"]:
                if e["id"] == vid:
                    for s in e["shard_ids"]:
                        shards.setdefault(str(s), []).append({"url": u})
        return web.json_response({"volumeId": vid, "shards": shards})

    app = web.Application()
    app.add_routes([web.post("/heartbeat", heartbeat),
                    web.get("/dir/ec/lookup", ec_lookup)])
    loop = asyncio.new_event_loop()
    threading.Thread(target=loop.run_forever, daemon=True).start()

    def run(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(300)

    runner = web.AppRunner(app)
    mport = free_port()
    run(runner.setup())
    run(web.TCPSite(runner, "127.0.0.1", mport).start())
    servers = []
    for i in range(n):
        d = tmp_path / f"s{i}"
        d.mkdir()
        servers.append(VolumeServer([str(d)], f"127.0.0.1:{mport}",
                                    port=free_port()))
        run(servers[-1].start())

    def call(vs, path, body=None, data=None, method=None):
        if body is not None:
            data = json.dumps(body).encode()
        req = urllib.request.Request(
            f"http://{vs.url}{path}", data=data,
            method=method or ("POST" if data is not None else "GET"),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            raw = r.read()
        return json.loads(raw) if raw[:1] == b"{" else raw

    def stop():
        for vs in servers:
            run(vs.stop())
        run(runner.cleanup())
        loop.call_soon_threadsafe(loop.stop)

    return servers, run, call, stop


@pytest.mark.cuda
def test_cuda_unconvert_rebuilds_on_the_card(card, tmp_path, monkeypatch):
    """/admin/volume/unconvert of a shard set missing 0/3/10/12 on a card
    server: its rebuild builds its codec on cuda and launches the K1 that
    `rebuild_ec_files` launches for the same loss; the decoded .dat is
    the volume's own."""
    from seaweedfs_tpu_torch.storage.ec import ec_files
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "0")
    servers, run, call, stop = _card_servers(tmp_path, 1)
    (a,) = servers
    try:
        g = np.random.default_rng(15)
        call(a, "/admin/assign_volume", {"volume": 5})
        for k in range(1, 41):
            call(a, f"/5,{k:x}{k:08x}",
                 data=g.bytes(int(g.integers(1, 300_000))), method="PUT")
        call(a, "/admin/volume/readonly", {"volume": 5})
        call(a, "/admin/ec/generate", {"volume": 5})
        base = tmp_path / "s0" / "5"
        dat = (tmp_path / "s0" / "5.dat").read_bytes()
        ref = tmp_path / "ref"
        ref.mkdir()
        for i in range(14):
            if i not in (0, 3, 10, 12):
                shutil.copy(f"{base}.ec{i:02d}", ref / f"5.ec{i:02d}")
        shutil.copy(f"{base}.vif", ref / "5.vif")
        before = gf_cuda.LAUNCHES["gf_apply"]
        ec_files.rebuild_ec_files(str(ref / "5"))
        want = gf_cuda.LAUNCHES["gf_apply"] - before
        assert want > 0
        call(a, "/admin/volume/unmount", {"volume": 5})
        for ext in (".dat", ".idx"):
            os.remove(f"{base}{ext}")
        for i in (0, 3, 10, 12):
            os.remove(f"{base}.ec{i:02d}")
        call(a, "/admin/ec/mount", {"volume": 5})
        before = gf_cuda.LAUNCHES["gf_apply"]
        r = call(a, "/admin/volume/unconvert", {"volume": 5})
        assert r["decoded"] is True
        assert gf_cuda.LAUNCHES["gf_apply"] - before == want
        assert (tmp_path / "s0" / "5.dat").read_bytes() == dat
        assert a.store.get_volume(5) is not None
        assert a.store.get_ec_volume(5) is None
    finally:
        stop()


@pytest.mark.cuda
def test_cuda_partitioned_peer_reads_reconstruct(card, tmp_path,
                                                 monkeypatch):
    """A holds shards 4-13 and B 0-3 on the card; with the volume role
    partitioned from B (A's /admin/faults), every GET from A of a needle
    on shards 0-3 reconstructs on the card: K1 == those needles, and
    each payload is byte-equal."""
    from seaweedfs_tpu_torch.maintenance import faults
    from seaweedfs_tpu_torch.storage import types as t
    from seaweedfs_tpu_torch.storage.ec import layout
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "0")
    monkeypatch.setenv("WEEDTPU_HEDGE_PCT", "0")
    servers, run, call, stop = _card_servers(tmp_path, 2)
    a, b = servers
    try:
        g = np.random.default_rng(16)
        call(a, "/admin/assign_volume", {"volume": 6})
        blobs = {}
        for k in range(1, 41):
            f = f"6,{k:x}{k:08x}"
            blobs[f] = g.bytes(int(g.integers(1, 300_000)))
            call(a, "/" + f, data=blobs[f], method="PUT")
        call(a, "/admin/volume/readonly", {"volume": 6})
        call(a, "/admin/ec/generate", {"volume": 6})
        call(b, "/admin/ec/copy", {"volume": 6, "source": a.url,
                                   "shards": [0, 1, 2, 3]})
        call(b, "/admin/ec/mount", {"volume": 6})
        call(a, "/admin/ec/delete_shards", {"volume": 6,
                                            "shards": [0, 1, 2, 3]})
        call(a, "/admin/ec/mount", {"volume": 6})
        call(a, "/admin/volume/delete", {"volume": 6})
        ev = a.store.get_ec_volume(6)

        def on_b(f):
            off, size = ev.find_needle(t.FileId.parse(f).key)
            return any(iv.to_shard_id_and_offset(
                ev.large_block, ev.small_block)[0] < 4
                for iv in layout.locate_data(
                    ev.large_block, ev.small_block, ev.dat_size, off,
                    t.actual_size(size, ev.version)))
        touching = [f for f in blobs if on_b(f)]
        call(a, "/admin/faults", {"faults": [
            {"action": "partition", "a": "volume", "b": b.url}]})
        before = gf_cuda.LAUNCHES["gf_apply"]
        import urllib.request
        for f, data in blobs.items():
            with urllib.request.urlopen(f"http://{a.url}/{f}",
                                        timeout=300) as r:
                assert r.read() == data, f
        assert gf_cuda.LAUNCHES["gf_apply"] - before == len(touching)
    finally:
        faults.clear_net()
        stop()


@pytest.mark.cuda
def test_cuda_mesh_equals_the_cpu_mesh(card, tmp_path):
    """A 4-position mesh on one card against the same mesh on the CPU:
    the column encode and rebuild, the shard-placement exchange on
    (2, 2), the unit fleet, and WEEDTPU_EC_CODEC=mesh's shard files, all
    byte-equal; one launch per position, nothing staged."""
    from seaweedfs_tpu_torch.ops import fleet_convert
    from seaweedfs_tpu_torch.parallel import mesh as pmesh
    from seaweedfs_tpu_torch.storage.ec import ec_files, layout
    code = rs.get_code(10, 4)
    g = np.random.default_rng(19)
    on = {d: [d] * 4 for d in ("cuda:0", "cpu")}
    data = g.integers(0, 256, (10, 4 * 4096 + 7), dtype=np.uint8)
    vols = g.integers(0, 256, (4, 10, 2 * 4096), dtype=np.uint8)
    units = g.integers(0, 256, (4, 10, 3000), dtype=np.uint8)
    got = {}
    staged = dict(gf_cuda.STAGED)
    for d, devs in on.items():
        enc = pmesh.ShardedRSEncoder(code, pmesh.make_mesh(devices=devs))
        before = dict(gf_cuda.LAUNCHES)
        full = enc.encode(data).numpy()
        surv = {i: full[i] for i in range(14) if i not in (0, 13)}
        back = enc.reconstruct(surv)
        place = pmesh.ShardedRSEncoder(
            code, pmesh.make_mesh(4, ("vol", "col"), shape=(2, 2),
                                  devices=devs),
            col_axis="col", vol_axis="vol")
        placed = place.encode_batch_place(vols)
        fleet = pmesh.FleetUnitEncoder(code, pmesh.make_mesh(
            devices=devs, axis_names=("unit",)))
        par = fleet.encode_parity_batch(fleet.place(units)).numpy()
        if d.startswith("cuda"):
            assert gf_cuda.LAUNCHES["gf_apply"] - before["gf_apply"] == 8
            assert gf_cuda.LAUNCHES["gf_apply_batch"] - \
                before["gf_apply_batch"] == 8
            assert [s.data.device.type for s in placed.shards] == \
                ["cuda"] * 4
        got[d] = [full, back[0].numpy(), back[13].numpy(),
                  placed.numpy(), par]
    assert gf_cuda.STAGED == staged
    for x, y in zip(got["cuda:0"], got["cpu"]):
        assert np.array_equal(x, y)
    assert np.array_equal(got["cpu"][0][10:],
                          gf.gf_matmul(code.parity_matrix, data))
    # the mesh EC codec and the unit fleet through the files
    dat = g.integers(0, 256, 300_000, dtype=np.uint8).tobytes()
    files = {}
    old = os.environ.get("WEEDTPU_EC_CODEC")
    os.environ["WEEDTPU_EC_CODEC"] = "mesh"
    try:
        for d, devs in on.items():
            os.makedirs(tmp_path / d)
            base = str(tmp_path / d / "1")
            with open(base + ".dat", "wb") as f:
                f.write(dat)
            ec_files.write_ec_files(base, large_block=10_000,
                                    small_block=100, device=devs)
            os.remove(base + layout.to_ext(3))
            ec_files.rebuild_ec_files(base, device=devs)
            fleet_convert.convert_volumes(
                [base], large_block=10_000, small_block=100,
                batch_size=1000, codec=fleet_convert.fleet_codec(
                    "mesh", device=devs))
            files[d] = [open(base + layout.to_ext(i), "rb").read()
                        for i in range(14)]
    finally:
        if old is None:
            os.environ.pop("WEEDTPU_EC_CODEC", None)
        else:
            os.environ["WEEDTPU_EC_CODEC"] = old
    assert files["cuda:0"] == files["cpu"]
