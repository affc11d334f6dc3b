"""The port's LRC and MSR codec families, and GF(2^8) matrices of any
shape, held against the JAX package.

Inputs are made with numpy from fixed seeds and handed to both packages.
GF(2^8) arithmetic is exact, so every comparison is exact byte equality.
The port runs on the CPU (`device="cpu"`: `CudaGFMatrix`'s plain
version); the reference runs its numpy codec (`WEEDTPU_EC_CODEC=numpy`)
or its Pallas kernel in interpret mode.

Volumes use tests/test_codecs.py's block sizes: (10000, 100) for LRC and
the alpha-aligned (8000, 400) for MSR.
"""

import hashlib
import itertools
import os
import shutil

import numpy as np
import pytest
import torch

from seaweedfs_tpu.maintenance import scrub as ref_scrub
from seaweedfs_tpu.models import rs as ref_rs
from seaweedfs_tpu.ops import codecs as ref_codecs
from seaweedfs_tpu.ops import lrc as ref_lrc
from seaweedfs_tpu.ops import msr as ref_msr
from seaweedfs_tpu.ops import pallas_gf
from seaweedfs_tpu.storage.ec import ec_files as ref_ec
from seaweedfs_tpu.storage.ec import ec_volume as ref_ecv

from seaweedfs_tpu_torch.maintenance import scrub
from seaweedfs_tpu_torch.ops import codecs, gf, gf_cuda, lrc, msr
from seaweedfs_tpu_torch.storage import needle
from seaweedfs_tpu_torch.storage.ec import ec_files, ec_volume, layout
from seaweedfs_tpu_torch.storage.volume import Volume

LARGE, SMALL = 10000, 100  # tests/test_codecs.py's block sizes
BLOCKS = {"lrc_10_2_2": (LARGE, SMALL), "msr_9_16": (8000, 400)}
LOSSES = {"lrc_10_2_2": (2, 5, 11), "msr_9_16": (0, 13)}


@pytest.fixture
def numpy_reference(monkeypatch):
    monkeypatch.setenv("WEEDTPU_EC_CODEC", "numpy")


# ---- fault 3.3: matrices of any shape ------------------------------------

def _msr_decode(wanted):
    code = ref_msr.get_code()
    rows = [r for i in range(code.n_nodes) if i not in wanted
            for r in code.node_rows(i)]
    return code.decode_matrix(rows, [r for w in wanted
                                     for r in code.node_rows(w)])


MATRICES = {
    "rs_33_4 parity [4,33]": lambda: ref_rs.get_code(33, 4).parity_matrix,
    "rs_10_17 parity [17,10]": lambda: ref_rs.get_code(10, 17).parity_matrix,
    "msr parity [72,72]": lambda: ref_msr.get_code().parity_matrix,
    "msr decode [8,72]": lambda: _msr_decode([4]),
    "msr decode [16,72]": lambda: _msr_decode([0, 13]),
}


@pytest.mark.parametrize("n", [1, 17, 300])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_any_shape_equals_pallas(name, n):
    """CudaGFMatrix takes what PallasGFMatrix takes (fault 3.3), and its
    product equals the reference kernel's in interpret mode."""
    C = MATRICES[name]()
    x = np.random.default_rng(n + C.shape[0]).integers(
        0, 256, (C.shape[1], n), dtype=np.uint8)
    got = gf_cuda.CudaGFMatrix(C)(torch.from_numpy(x)).numpy()
    want = np.asarray(pallas_gf.PallasGFMatrix(C, tile=256,
                                               interpret=True)(x))
    assert got.shape == (C.shape[0], n)
    assert np.array_equal(got, want)
    assert np.array_equal(got, gf.gf_matmul(C, x))


@pytest.mark.parametrize("k,m", [(33, 4), (10, 17)])
def test_wide_rs_codec_equals_pallas_codec(k, m):
    """Encode and reconstruct at RS(33,4) and RS(10,17), which the port
    refused before, equal the reference's Pallas codec."""
    mine = gf_cuda.get_codec(k, m, device="cpu")
    ref = pallas_gf.PallasRSCodec(ref_rs.get_code(k, m), tile=256,
                                  interpret=True)
    data = np.random.default_rng(k * m).integers(0, 256, (k, 300),
                                                 dtype=np.uint8)
    shards = mine.encode(torch.from_numpy(data)).numpy()
    assert np.array_equal(shards, np.asarray(ref.encode(data)))
    lost = list(range(0, k + m, 3))[:m]
    present = {i: shards[i] for i in range(k + m) if i not in lost}
    out = mine.reconstruct({i: torch.from_numpy(v)
                            for i, v in present.items()})
    ref_out = ref.reconstruct(present)
    for i in lost:
        assert np.array_equal(out[i].numpy(), shards[i])
        assert np.array_equal(out[i].numpy(), np.asarray(ref_out[i]))


@pytest.mark.parametrize("tag", ["rs_10_4", "rs_33_4", "rs_10_17"])
def test_rs_tags_build_rs_k_m_unlike_the_reference(numpy_reference, tag):
    """ROADMAP fault 3.4, repaired: the port once built RS(k, m) from an
    `rs_<k>_<m>` tag, unlike the reference, which builds RS(10, 4) for
    every `rs_*` tag.  Now both give the same code: k, m and the parity
    matrix equal the reference's, on the card's shell and the native
    one."""
    ref = ref_codecs.make_codec(tag)
    for kind in (None, "native"):
        mine = codecs.make_codec(tag, device="cpu", kind=kind)
        assert (mine.k, mine.m) == (ref.k, ref.m) == (10, 4)
        assert np.array_equal(mine.code.parity_matrix,
                              ref.code.parity_matrix if hasattr(ref, "code")
                              else ref.parity_matrix)


def test_shape_limit_is_the_fields():
    with pytest.raises(ValueError, match="k \\+ m <= 256"):
        gf_cuda.CudaGFMatrix(np.ones((2, 255), np.uint8))
    assert gf_cuda.CudaGFMatrix(np.ones((1, 255), np.uint8)).k == 255


# ---- tag grammar -----------------------------------------------------------

@pytest.mark.parametrize("env,tag", [
    ({}, "lrc"), ({}, "msr"), ({"WEEDTPU_CODEC_LRC": "12,3,2"}, "lrc"),
    ({"WEEDTPU_CODEC_MSR": "5,8"}, "msr"), ({}, "lrc_10_2_2"),
    ({}, "msr_9_16"), ({"WEEDTPU_CODEC_LRC": "bad"}, "lrc")])
def test_parse_tag_equals_reference(monkeypatch, env, tag):
    for key, v in env.items():
        monkeypatch.setenv(key, v)
    ref = ref_codecs.parse_tag(tag)
    if "bad" in env.values():
        # the reference quietly falls back to the default params; the
        # port refuses a malformed knob
        assert ref.tag == "lrc_10_2_2"
        with pytest.raises(ValueError, match="WEEDTPU_CODEC_LRC='bad'"):
            codecs.parse_tag(tag)
        return
    mine = codecs.parse_tag(tag)
    assert (mine.tag, mine.family, mine.k, mine.m, mine.n, mine.alpha,
            mine.params) == \
        (ref.tag, ref.family, ref.k, ref.m, ref.n, ref.alpha, ref.params)


@pytest.mark.parametrize("var,raw", [("WEEDTPU_CODEC_LRC", "12,3"),
                                     ("WEEDTPU_CODEC_MSR", "9,x")])
def test_malformed_family_params_raise(monkeypatch, var, raw):
    monkeypatch.setenv(var, raw)
    with pytest.raises(ValueError, match=var):
        codecs.parse_tag(var.rsplit("_", 1)[1].lower())


def test_make_codec_builds_every_family_on_the_cpu():
    lc = codecs.make_codec("lrc_10_2_2", device="cpu")
    mc = codecs.make_codec("msr_9_16", device="cpu")
    assert isinstance(lc.code, lrc.LRCCode) and lc.device.type == "cpu"
    assert isinstance(mc, msr.MSRFileCodec) and mc.device.type == "cpu"
    assert (mc.k, mc.m, mc.n, mc.alpha) == (9, 9, 18, 8)
    assert codecs.make_codec("lrc_10_2_2", device="cpu") is lc


# ---- LRC ------------------------------------------------------------------

def test_lrc_matrix_equals_reference():
    for params in ((10, 2, 2), (12, 3, 2), (6, 2, 1)):
        assert np.array_equal(lrc.get_code(*params).matrix,
                              ref_lrc.get_code(*params).matrix)


@pytest.fixture(scope="module")
def lrc_stripe():
    code = ref_lrc.get_code(10, 2, 2)
    data = np.random.default_rng(0x16C).integers(0, 256, (10, 64),
                                                 dtype=np.uint8)
    return code.encode_numpy(data)


@pytest.mark.parametrize("t", [1, 2, 3])
def test_lrc_every_loss_pattern_equals_reference(lrc_stripe, t):
    """All 14 + 91 + 364 = 469 patterns of up to 3 losses (LRC(10,2,2)'s
    distance is 4): the port's basis and decode matrix equal the
    reference's, and the port's codec rebuilds the reference's bytes."""
    mine, ref = lrc.get_code(10, 2, 2), ref_lrc.get_code(10, 2, 2)
    codec = gf_cuda.CudaRSCodec(mine, device="cpu")
    full = lrc_stripe
    assert np.array_equal(mine.encode_numpy(full[:10]), full)
    count = 0
    for lost in itertools.combinations(range(14), t):
        lost = list(lost)
        avail = [i for i in range(14) if i not in lost]
        basis = mine.decode_select(avail, lost)
        assert basis == ref.decode_select(avail, lost), lost
        assert np.array_equal(mine.decode_matrix(avail, lost),
                              ref.decode_matrix(avail, lost)), lost
        out = codec.reconstruct({i: torch.from_numpy(full[i])
                                 for i in avail}, lost)
        ref_out = ref.reconstruct_numpy({i: full[i] for i in avail}, lost)
        for s in lost:
            assert np.array_equal(out[s].numpy(), ref_out[s]), (lost, s)
            assert np.array_equal(out[s].numpy(), full[s]), (lost, s)
        count += 1
    assert count == {1: 14, 2: 91, 3: 364}[t]


def test_lrc_single_loss_stays_in_its_group():
    code = lrc.get_code(10, 2, 2)
    everyone = list(range(code.n))
    for lost in range(code.k + code.l):
        others = [s for s in everyone if s != lost]
        support = code.repair_support(lost, others)
        assert support is not None and len(support) == code.r
        assert set(support) <= set(code.group_members(code.group_of(lost)))
        assert code.decode_select(others, [lost]) == support
    assert code.repair_support(code.k + code.l, everyone) is None
    assert code.repair_support(2, [s for s in everyone
                                   if s not in (2, 3)]) is None


# ---- MSR ------------------------------------------------------------------

def test_msr_code_equals_reference():
    mine, ref = msr.get_code(9, 16), ref_msr.get_code(9, 16)
    for name in ("x", "phi", "lam", "G", "parity_matrix"):
        assert np.array_equal(getattr(mine, name), getattr(ref, name)), name


@pytest.fixture(scope="module")
def msr_stripe():
    fc = ref_codecs.make_codec("msr_9_16", "numpy")
    data = np.random.default_rng(0x359).integers(0, 256, (9, 5 * 8),
                                                 dtype=np.uint8)
    return fc, fc.encode(data)


def _msr_patterns(kind):
    if kind == "single":
        return [(i,) for i in range(18)]
    if kind == "double":
        return list(itertools.combinations(range(18), 2))
    return [tuple(range(9)), tuple(range(9, 18)), tuple(range(0, 18, 2))]


@pytest.mark.parametrize("kind", ["single", "double", "nine"])
def test_msr_loss_patterns_equal_reference(msr_stripe, kind):
    """18 single, 153 double and the three 9-loss corners: the port's
    file codec rebuilds the reference's bytes, through the same basis and
    the same inner decode matrix."""
    ref_fc, full = msr_stripe
    fc = codecs.make_codec("msr_9_16", device="cpu")
    a = fc.alpha
    assert np.array_equal(fc.encode(torch.from_numpy(full[:9])).numpy(),
                          full)
    for lost in _msr_patterns(kind):
        avail = [i for i in range(18) if i not in lost]
        basis = fc.basis(avail, lost)
        assert list(basis) == ref_fc.decode_select(avail, list(lost))
        rows = [s * a + j for s in basis for j in range(a)]
        want = [w * a + j for w in lost for j in range(a)]
        assert np.array_equal(fc.code.decode_matrix(rows, want),
                              ref_fc.code.decode_matrix(rows, want)), lost
        out = fc.reconstruct({i: torch.from_numpy(full[i]) for i in avail},
                             list(lost))
        ref_out = ref_fc.reconstruct({i: full[i] for i in avail}, list(lost))
        for s in lost:
            assert np.array_equal(out[s].numpy(), ref_out[s]), (lost, s)
            assert np.array_equal(out[s].numpy(), full[s]), (lost, s)


@pytest.mark.parametrize("lead", [(), (3,)])
def test_msr_interleave_equals_reference(lead):
    """The torch de-interleave of a strided view lands in rows 16 bytes
    apart and equals the reference's numpy interleave; the torch merge
    equals the reference's and inverts the split."""
    g = np.random.default_rng(len(lead))
    wide = g.integers(0, 256, (*lead, 9, 1000), dtype=np.uint8)
    x = torch.from_numpy(wide)[..., :8 * 101]
    v = msr.split_rows(x, 8)
    assert v.shape == (*lead, 72, 101) and v.stride(-2) % 16 == 0
    flat = wide[..., :808].reshape(-1, 9, 808)
    want = np.stack([ref_msr.interleave_split(u, 9, 8) for u in flat])
    assert np.array_equal(v.numpy().reshape(-1, 72, 101), want)
    assert torch.equal(msr.merge_rows(v, 8), x)
    assert np.array_equal(
        msr.merge_rows(torch.from_numpy(want[0]), 8).numpy(),
        ref_msr.interleave_merge(want[0], 9, 8))
    with pytest.raises(ValueError, match="8-aligned"):
        msr.split_rows(torch.zeros((9, 12), dtype=torch.uint8), 8)


def test_msr_encode_parity_batch_equals_per_unit():
    fc = codecs.make_codec("msr_9_16", device="cpu")
    units = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (3, 9, 64), dtype=np.uint8))
    got = fc.encode_parity_batch(units)
    for u in range(3):
        assert torch.equal(got[u], fc.encode_parity(units[u]))


# ---- volumes crossing packages ------------------------------------------

def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture(scope="module")
def encoded(tmp_path_factory):
    """encoded(tag): one .dat (70 needles, ragged sizes, over more than
    one large row), encoded under the tag by each package into its own
    directory; made once per tag."""
    made: dict = {}

    def make(tag):
        if tag not in made:
            made[tag] = _encode_both(tag, tmp_path_factory.mktemp(tag))
        return made[tag]
    return make


def _encode_both(tag, root):
    large, small = BLOCKS[tag]
    v = Volume(str(root), "", 3)
    rng = np.random.default_rng(5)
    blobs = {}
    for i in range(1, 71):
        data = rng.bytes(int(rng.integers(1, 7000)))
        v.append_needle(needle.Needle(cookie=9, id=i, data=data))
        blobs[i] = data
    v.close()
    bases = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WEEDTPU_EC_CODEC", "numpy")
        for who in ("ref", "port"):
            d = root / who
            d.mkdir()
            for ext in (".dat", ".idx"):
                shutil.copy(root / ("3" + ext), d / ("3" + ext))
            base = str(d / "3")
            if who == "ref":
                ref_ec.write_ec_files(base, large_block=large,
                                      small_block=small,
                                      batch_size=small * 10, codec_tag=tag)
            else:
                # the port takes no reference kind
                mp.delenv("WEEDTPU_EC_CODEC")
                ec_files.write_ec_files(base, large_block=large,
                                        small_block=small,
                                        batch_size=small * 10,
                                        codec_tag=tag, device="cpu")
            ec_files.write_sorted_ecx(base + ".idx")
            bases[who] = base
    return {"tag": tag, "blobs": blobs, **bases}


@pytest.fixture(params=sorted(BLOCKS))
def volumes(request, encoded):
    return encoded(request.param)


@pytest.fixture
def lrc_volume(encoded):
    return encoded("lrc_10_2_2")


def _copy(base, dst):
    os.makedirs(dst)
    src = os.path.dirname(base)
    for name in os.listdir(src):
        shutil.copy(os.path.join(src, name), dst)
    return os.path.join(dst, "3")


def test_shard_files_equal_reference(volumes):
    spec = codecs.parse_tag(volumes["tag"])
    large, _ = BLOCKS[volumes["tag"]]
    assert os.path.getsize(volumes["port"] + ".dat") > large * spec.k
    for ext in [layout.to_ext(i) for i in range(spec.n)] + [".ecx", ".vif"]:
        with open(volumes["port"] + ext, "rb") as a, \
                open(volumes["ref"] + ext, "rb") as b:
            assert a.read() == b.read(), ext
    assert not os.path.exists(volumes["port"] + layout.to_ext(spec.n))


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_volume_crosses_packages(volumes, tmp_path, monkeypatch, writer,
                                 reader):
    """A shard set one package wrote, with shards lost: the other package
    reads every needle and rebuilds sha256-equal shards."""
    if reader == "ref":
        monkeypatch.setenv("WEEDTPU_EC_CODEC", "numpy")
    tag = volumes["tag"]
    large, small = BLOCKS[tag]
    base = _copy(volumes[writer], str(tmp_path / "v"))
    want = {s: _sha(base + layout.to_ext(s)) for s in LOSSES[tag]}
    for s in LOSSES[tag]:
        os.remove(base + layout.to_ext(s))
    if reader == "port":
        ev = ec_volume.EcVolume(base, large, small, device="cpu")
        assert ev.spec.tag == tag
    else:
        ev = ref_ecv.EcVolume(base, large, small)
    try:
        for nid, data in volumes["blobs"].items():
            assert ev.read_needle(nid).data == data, nid
    finally:
        ev.close()
    st: dict = {}
    if reader == "port":
        got = ec_files.rebuild_ec_files(base, stats=st, device="cpu")
        assert st["codec"] == tag
    else:
        got = ref_ec.rebuild_ec_files(base)
    assert sorted(got) == sorted(LOSSES[tag])
    for s, h in want.items():
        assert _sha(base + layout.to_ext(s)) == h, s


def test_lrc_degraded_read_touches_one_group(lrc_volume, tmp_path):
    """A single lost LRC shard is read back from its own local group: at
    most r + 1 shards, all members of the group, never k."""
    base = _copy(lrc_volume["port"], str(tmp_path / "v"))
    os.remove(base + layout.to_ext(2))
    code = lrc.get_code(10, 2, 2)
    members = set(code.group_members(code.group_of(2)))
    ev = ec_volume.EcVolume(base, LARGE, SMALL, device="cpu")
    gathered = []
    orig = ev._gather_survivors

    def spy(exclude, segs, want=None, need=None):
        rows = orig(exclude, segs, want=want, need=need)
        gathered.append(set(rows))
        return rows
    ev._gather_survivors = spy
    try:
        for nid, data in lrc_volume["blobs"].items():
            assert ev.read_needle(nid).data == data, nid
    finally:
        ev.close()
    assert gathered
    for got in gathered:
        assert len(got) <= code.r + 1 and got <= members, got


def test_lrc_degraded_read_retries_past_an_unreadable_basis(lrc_volume,
                                                            tmp_path):
    """Shard 2 lost and its group's local parity 10 unreadable: the read
    widens to k + 1 survivors and still returns every needle."""
    base = _copy(lrc_volume["port"], str(tmp_path / "v"))
    os.remove(base + layout.to_ext(2))
    with open(base + layout.to_ext(10), "r+b") as f:
        f.truncate(0)  # present, but every read of it comes back short
    ev = ec_volume.EcVolume(base, LARGE, SMALL, device="cpu")
    try:
        for nid, data in lrc_volume["blobs"].items():
            assert ev.read_needle(nid).data == data, nid
    finally:
        ev.close()


@pytest.mark.parametrize("tag,lost", [("msr_9_16", (0, 5)),
                                      ("lrc_10_2_2", (2, 3))])
def test_degraded_read_skips_a_basis_with_an_absent_shard(encoded, tmp_path,
                                                          tag, lost):
    """A basis that names a shard already absent is never tried: the read
    goes straight to the unrestricted gather, so no restricted gather
    fails and no survivor is read twice."""
    vol = encoded(tag)
    large, small = BLOCKS[tag]
    base = _copy(vol["port"], str(tmp_path / "v"))
    for s in lost:
        os.remove(base + layout.to_ext(s))
    ev = ec_volume.EcVolume(base, large, small, device="cpu")
    calls = []
    orig = ev._gather_survivors

    def spy(exclude, segs, want=None, need=None):
        try:
            rows = orig(exclude, segs, want=want, need=need)
        except IOError:
            calls.append("failed")
            raise
        calls.append(need)
        return rows
    ev._gather_survivors = spy
    try:
        for nid, data in vol["blobs"].items():
            assert ev.read_needle(nid).data == data, nid
    finally:
        ev.close()
    assert calls and "failed" not in calls
    assert codecs.parse_tag(tag).k + (tag.startswith("lrc")) in calls


def test_codec_basis_is_chosen_once_per_pattern(monkeypatch):
    """`basis` caches the survivor choice: a degraded pattern runs LRC's
    Gaussian-elimination selection once, however often it is read."""
    codec = gf_cuda.CudaRSCodec(lrc.LRCCode(10, 2, 2), device="cpu")
    calls = []
    orig = codec.code.decode_select

    def count(available, wanted):
        calls.append(tuple(wanted))
        return orig(available, wanted)
    monkeypatch.setattr(codec.code, "decode_select", count)
    present = [i for i in range(14) if i not in (2, 5, 11)]
    first = codec.basis(present, [2, 5, 11])
    assert codec.basis(tuple(reversed(present)), (2, 5, 11)) is first
    assert calls == [(2, 5, 11)]
    assert list(first) == ref_lrc.get_code(10, 2, 2).decode_select(
        present, [2, 5, 11])
    x = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (len(first), 33), dtype=np.uint8))
    for _ in range(3):
        basis, _mat = codec.decoder(tuple(present), (2, 5, 11))
        assert basis is first
    # one more selection, inside decode_matrix on the decoder's first miss
    assert len(calls) == 2
    assert codec.decoder(tuple(present), (2, 5, 11))[1](x).shape == (3, 33)


def test_scrub_equals_reference(volumes, tmp_path, monkeypatch):
    """A clean pass finds nothing; one flipped byte is found, localised
    on LRC and not on MSR (shard -1), as the reference's scan reports."""
    monkeypatch.setattr(scrub, "DEFAULT_WINDOW", 1000)
    tag = volumes["tag"]
    large, small = BLOCKS[tag]
    base = _copy(volumes["port"], str(tmp_path / "v"))
    flipped = 1 if tag.startswith("lrc") else 6
    offset = 1234
    results = []
    for flip in (False, True):
        if flip:
            with open(base + layout.to_ext(flipped), "r+b") as f:
                b = os.pread(f.fileno(), 1, offset)
                os.pwrite(f.fileno(), bytes([b[0] ^ 0x10]), offset)
        ev = ec_volume.EcVolume(base, large, small, device="cpu")
        rev = ref_ecv.EcVolume(base, large, small)
        try:
            st: dict = {}
            got = scrub.syndrome_scan(ev, st)
            with monkeypatch.context() as mp:
                mp.setenv("WEEDTPU_EC_CODEC", "numpy")
                assert got == ref_scrub.syndrome_scan(rev, window=1000)
            assert st["windows"] == -(-ev.shard_size // 1000)
        finally:
            ev.close()
            rev.close()
        results.append(got)
    assert results[0] == []
    (found,) = results[1]
    want_shard = flipped if tag.startswith("lrc") else -1
    assert found["shard"] == want_shard
    assert found["offset"] <= offset < found["offset"] + found["size"]
