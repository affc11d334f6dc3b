"""Reduced-read repair of LRC and MSR volumes in the PyTorch/CUDA port,
held against the JAX package.

Topologies: LRC(10,2,2) uses tests/test_torch_regen.py's (the repairing
node holds shards 0-5, a same-rack helper "a:1" 6-8, an other-DC helper
"b:2" 9-13); PM-MSR(9,16) a four-node one (repairing node 0-5, "a:1"
6-11, a same-DC "c:3" holding 12 alone, "b:2" 13-17), in which any one
helper node can die and still leave d = 16 survivors only when it is
c:3, plus a mixed one whose node names sort against their localities.
The port runs on the CPU, where `dispatch.apply_matrix` takes the plain
version.  The plan sweeps and the in-memory repairs hand the reference
its numpy codec; the on-disk repairs run the reference's
`rebuild_ec_reduced` with `WEEDTPU_EC_CODEC=tpu`, which for these two
families is its XLA shell (gfmat_jax).  Plans, bytes, byte ledgers,
errors and result dicts must be equal, field for field.
"""

import os

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import codecs as ref_codecs
from seaweedfs_tpu.ops import gf as ref_gf
from seaweedfs_tpu.ops import msr as ref_msr
from seaweedfs_tpu.ops import regen as ref_regen
from seaweedfs_tpu.storage.ec import ec_files as ref_ec
from seaweedfs_tpu.storage.ec import ec_volume as ref_ecv

from seaweedfs_tpu_torch.ops import codecs, dispatch, gf, msr, regen
from seaweedfs_tpu_torch.storage import needle
from seaweedfs_tpu_torch.storage.ec import ec_files, ec_volume, layout
from seaweedfs_tpu_torch.storage.volume import Volume

LRC, MSR = "lrc_10_2_2", "msr_9_16"
L = 16_000  # bytes per shard file (an alpha multiple: 2000 sub-row bytes)
A = 8  # msr_9_16's alpha

SPANS = {
    LRC: [("", range(0, 6), 0), ("a:1", range(6, 9), 1),
          ("b:2", range(9, 14), 3)],
    MSR: [("", range(0, 6), 0), ("a:1", range(6, 12), 1),
          ("c:3", (12,), 2), ("b:2", range(13, 18), 3)],
    "msr_mixed": [("", (0, 1, 2, 3), 0), ("z:9", (4, 5, 6, 7, 8), 1),
                  ("m:5", (9, 10), 2), ("b:2", (11, 12, 13), 3),
                  ("a:1", (14, 15, 16, 17), 3)],
}


def _pkg(port: bool):
    return regen if port else ref_regen


def _codec(port: bool, tag: str):
    return codecs.make_codec(tag, device="cpu") if port \
        else ref_codecs.make_codec(tag, "numpy")


def _plan_code(port: bool, tag: str):
    """What rebuild_ec_reduced hands the planner: the file codec for MSR,
    its code for LRC."""
    c = _codec(port, tag)
    return c if tag == MSR else c.code


def _groups(port: bool, spans, lost):
    return [_pkg(port).HelperGroup(n, tuple(s for s in span if s not in lost),
                                   loc)
            for n, span, loc in spans]


@pytest.fixture(scope="module")
def stripes():
    """Full shard sets of each family from one seed, as numpy rows."""
    out = {}
    for tag, k in ((LRC, 10), (MSR, 9)):
        data = np.random.default_rng(0x7E6).integers(0, 256, (k, L),
                                                     dtype=np.uint8)
        out[tag] = np.asarray(ref_codecs.make_codec(tag, "numpy")
                              .encode(data))
    return out


def _plan_fields(plan):
    """A plan as plain values: everything the executor and the ledgers
    read, the MSR post matrices and sub-row count included."""
    return (plan.lost, plan.k, plan.d, plan.length, plan.out_rows,
            [(s.offset, s.size,
              [(p.group.node, p.group.locality, p.group.shards, p.shards,
                p.coeff.dtype.str, p.coeff.tolist(),
                None if p.post is None else
                (p.post.dtype.str, p.post.tolist())) for p in s.parts])
             for s in plan.segments])


def _outcome(plan_fn):
    """A planner call as plain values: the plan, its ledgers and naive
    costs, or the type and message of what it raised."""
    try:
        plan = plan_fn()
    except ValueError as e:
        return ("ValueError", str(e))
    return (_plan_fields(plan), plan.predicted_bytes(),
            [plan.naive_remote_bytes(n) for n in (0, 4, 5, 6, 10)])


# ---- plans ------------------------------------------------------------------

@pytest.mark.parametrize("align", [512, 1024])
@pytest.mark.parametrize("d", [None, 10, 11, 12, 13])
@pytest.mark.parametrize("lost", range(14))
def test_lrc_plan_equals_reference(lost, d, align):
    """Every single LRC loss at every d: the port's plan (group-local
    support, basis-ordered columns, parts outside the basis dropped)
    equals the reference's field for field, or both raise the same
    ValueError (ROADMAP fault 3.5)."""
    got = [_outcome(lambda port=port: _pkg(port).plan_repair(
        _plan_code(port, LRC), lost, _groups(port, SPANS[LRC], {lost}), L,
        d=d, align=align)) for port in (True, False)]
    assert got[0] == got[1]


def test_lrc_group_local_plan_reads_one_group():
    """A data shard's plan reads r = 5 shards of its own group: the
    repairing node's 4 and b:2's local parity, one segment."""
    plan = regen.plan_repair(_plan_code(True, LRC), 2,
                             _groups(True, SPANS[LRC], {2}), L)
    (seg,) = plan.segments
    assert [(p.group.node, p.shards, p.coeff.shape) for p in seg.parts] == \
        [("", (0, 1, 3, 4), (1, 4)), ("b:2", (10,), (1, 1))]
    assert plan.predicted_bytes()["per_node"] == {"b:2": L}
    assert plan.naive_remote_bytes(5) == 5 * L


def test_lrc_undecodable_window_raises_as_reference():
    """ROADMAP fault 3.5: the rotating windows ignore that LRC is not MDS,
    so a global parity at d = None meets a window the code cannot decode
    once the range is long enough to stripe over them (here 1 KiB
    segments; on the card, 4 MiB of a 103 MiB shard).  The port raises
    the reference's ValueError; d = 10 plans."""
    msg = ("lrc: cannot reconstruct [12] from [0, 1, 2, 3, 4, 5, 7, 8, 9, "
           "10] (undecodable loss pattern)")
    for port in (True, False):
        with pytest.raises(ValueError) as e:
            _pkg(port).plan_repair(_plan_code(port, LRC), 12,
                                   _groups(port, SPANS[LRC], {12}), L,
                                   align=1024)
        assert str(e.value) == msg
        plan = _pkg(port).plan_repair(_plan_code(port, LRC), 12,
                                      _groups(port, SPANS[LRC], {12}), L,
                                      d=10)
        assert plan.predicted_bytes()["per_node"] == {"a:1": L, "b:2": L}


@pytest.mark.parametrize("topo", [MSR, "msr_mixed"])
@pytest.mark.parametrize("d", [None, 16, 17])
@pytest.mark.parametrize("lost", range(18))
def test_msr_plan_equals_reference(lost, d, topo):
    """Every single MSR loss at d in {None, 16, 17} over two topologies:
    coeff, post, virtual shard ids, out_rows and the sub-row length equal
    the reference's."""
    got = [_outcome(lambda port=port: _pkg(port).plan_msr_repair(
        _codec(port, MSR), lost, _groups(port, SPANS[topo], {lost}), L,
        d=d)) for port in (True, False)]
    assert got[0] == got[1]
    if d == 17:  # R is [alpha, d] at the code's d = 16
        assert got[0] == ("ValueError", "msr repair needs d=16 helpers, "
                          "got 17")
        return
    fields = got[0][0]
    assert fields[3:5] == (L // A, A)
    vids = [v for p in fields[5][0][2] for v in p[3]]
    assert len(vids) == A * 16 and all(v // A != lost for v in vids)


@pytest.mark.parametrize("case", ["few_helpers", "ragged_length",
                                  "d_past_survivors"])
def test_msr_plan_errors_equal_reference(case):
    spans, length, d = SPANS[MSR], L, None
    if case == "few_helpers":
        spans = [(n, [s for s in span if s not in (13, 14)], loc)
                 for n, span, loc in spans]
    elif case == "ragged_length":
        length = L + 3
    else:
        d = 18
    got = [_outcome(lambda port=port: _pkg(port).plan_msr_repair(
        _codec(port, MSR), 0, _groups(port, spans, {0}), length, d=d))
        for port in (True, False)]
    assert got[0][0] == "ValueError" and got[0] == got[1]


# ---- the PM-MSR repair matrices ---------------------------------------------

def test_msr_repair_matrices_equal_reference():
    mine, ref = msr.get_code(9, 16), ref_msr.get_code(9, 16)
    assert np.array_equal(mine.psi, ref.psi)
    assert mine.repair_ratio() == ref.repair_ratio() == 16 / 72
    for lost in range(18):
        others = [i for i in range(18) if i != lost]
        assert np.array_equal(mine.repair_coeff(lost),
                              ref.repair_coeff(lost))
        for helpers in (others[:16], others[1:], others[::-1][:16]):
            assert np.array_equal(mine.repair_matrix(lost, helpers),
                                  ref.repair_matrix(lost, helpers)), lost
    for bad in ([1, 2], [0] + others[:15]):
        msgs = []
        for code in (mine, ref):
            with pytest.raises(ValueError) as e:
                code.repair_matrix(0, bad)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


@pytest.mark.parametrize("lost", [0, 8, 17])
def test_msr_repair_moves_d_over_k_alpha_of_naive(lost):
    """tests/test_codecs.py's check through the port's own helpers: every
    helper ships ONE combined sub-row, d/alpha shard-equivalents in all,
    16/72 of the naive copy, and R rebuilds the lost file."""
    fc = codecs.make_codec(MSR, device="cpu")
    code = fc.code
    n = 4 * code.alpha
    data = np.random.default_rng(11).integers(0, 256, (fc.k, n),
                                              dtype=np.uint8)
    full = fc.encode(torch.from_numpy(data))
    helpers = [i for i in range(fc.n) if i != lost][:code.d]
    coeff = code.repair_coeff(lost)
    sent = [gf.gf_matmul(coeff, msr.split_rows(full[h][None, :],
                                               code.alpha).numpy())[0]
            for h in helpers]
    moved = sum(r.nbytes for r in sent)
    assert moved == code.d * n // code.alpha
    assert moved / (fc.k * n) == pytest.approx(code.repair_ratio())
    R = code.repair_matrix(lost, helpers)
    rebuilt = msr.merge_rows(torch.from_numpy(
        gf.gf_matmul(R, np.stack(sent))), code.alpha)[0]
    assert torch.equal(rebuilt, full[lost])
    plan = regen.plan_msr_repair(fc, lost, [regen.HelperGroup(
        "h", tuple(helpers), 3)], n)
    assert plan.predicted_bytes()["remote"] == moved
    assert plan.naive_remote_bytes(0) == fc.k * n


# ---- repair_shard in memory -------------------------------------------------

def _sub(files, vid: int, a: int, off: int, n: int) -> np.ndarray:
    """Virtual row `vid` over sub-row range [off, off+n) (a = 1: the file
    range itself), as a helper reads it."""
    return files[vid // a][off * a:(off + n) * a].reshape(n, a)[:, vid % a]


def _fetcher(port: bool, files, a: int, die=None, calls=None):
    """A helper stand-in: its partial through each package's numpy GF
    product.  `calls` gets each node's requests in order; `die = (node,
    after)` makes that node raise HelperDied at every call past its
    after-th."""
    calls = {} if calls is None else calls
    matmul = gf.gf_matmul if port else ref_gf.gf_matmul

    def fetch(group, sids, coeff, off, n):
        calls.setdefault(group.node, []).append(
            (tuple(sids), np.asarray(coeff).tolist(), off, n))
        if die and die[0] == group.node and \
                len(calls[group.node]) > die[1]:
            raise _pkg(port).HelperDied(group.node, tuple(sids))
        rows = np.stack([_sub(files, s, a, off, n) for s in sids])
        return matmul(np.asarray(coeff, np.uint8), rows).tobytes()
    return fetch


STAGES = ("read_s", "apply_s", "wait_s", "xor_s", "write_s")


def _repair(port: bool, tag: str, files, lost: int, spans, d=None,
            die=None, unreadable=(), calls=None):
    """One repair_shard of `lost` by either package, as rebuild_ec_reduced
    calls it: (file bytes, plan, stats without the port's stage
    seconds)."""
    a = A if tag == MSR else 1
    out = np.zeros(L, dtype=np.uint8)

    def sink(off, rows):
        if a == 1:
            out[off:off + len(rows)] = rows
        else:
            out[off * a:(off + rows.shape[1]) * a] = rows.T.reshape(-1)

    def read_local(vid, off, n):
        if vid // a in unreadable:
            return None
        return _sub(files, vid, a, off, n).tobytes()

    kw = {} if tag != MSR else {"planner": _pkg(port).plan_msr_repair}
    stats: dict = {}
    plan = _pkg(port).repair_shard(
        _plan_code(port, tag), _codec(port, tag), lost,
        _groups(port, spans, {lost}), L, read_local,
        _fetcher(port, files, a, die, calls), sink, d=d,
        batch_size=4096 // a, align=1024, stats=stats, **kw)
    if port:  # a plan with no local part reads nothing locally
        assert all(stats.pop(k, 0.0) >= 0 for k in STAGES)
    return out, plan, stats


@pytest.mark.parametrize("d", [None, 10])
@pytest.mark.parametrize("lost", range(14))
def test_lrc_repair_equals_reference(stripes, lost, d):
    """Each LRC loss rebuilds the reference's bytes with the same helper
    calls, plan and ledgers; where the reference's planner raises, the
    port raises the same."""
    files = stripes[LRC]
    got = []
    for port in (True, False):
        calls: dict = {}
        try:
            out, plan, stats = _repair(port, LRC, files, lost, SPANS[LRC],
                                       d=d, calls=calls)
        except ValueError as e:
            got.append(("ValueError", str(e)))
            continue
        assert np.array_equal(out, files[lost]), (port, lost)
        assert stats.get("helper_bytes", {}) == \
            plan.predicted_bytes()["per_node"]
        got.append((calls, _plan_fields(plan), stats))
    assert got[0] == got[1]


@pytest.mark.parametrize("topo", [MSR, "msr_mixed"])
@pytest.mark.parametrize("lost", range(18))
def test_msr_repair_equals_reference(stripes, lost, topo):
    """Each MSR loss regenerates the reference's bytes from d = 16 helper
    sub-rows: the same calls (virtual ids, sub-row offsets), plan and
    ledgers, with exactly one sub-row per helper shard on the wire."""
    files = stripes[MSR]
    got = []
    for port in (True, False):
        calls: dict = {}
        out, plan, stats = _repair(port, MSR, files, lost, SPANS[topo],
                                   calls=calls)
        assert np.array_equal(out, files[lost]), (port, lost)
        got.append((calls, _plan_fields(plan), stats))
    assert got[0] == got[1]
    remote = sum(got[0][2]["helper_bytes"].values())
    local = sum(len(s) for n, s, _ in SPANS[topo] if n == "") - \
        (lost in SPANS[topo][0][1])
    assert remote == (16 - min(local, 16)) * L // A


@pytest.mark.parametrize("case", ["helper_death", "local_read_failure"])
def test_msr_repair_replans_as_reference(stripes, case):
    """A dying helper node (c:3 at its third call) or an unreadable local
    file re-plans over the rest: the bytes stay the reference's, and
    `dead_helpers` lists file shard ids, not virtual ones."""
    files = stripes[MSR]
    kw = {"die": ("c:3", 2)} if case == "helper_death" \
        else {"unreadable": (3,)}
    got = []
    for port in (True, False):
        out, plan, stats = _repair(port, MSR, files, 0, SPANS[MSR], **kw)
        assert np.array_equal(out, files[0])
        got.append((_plan_fields(plan), stats["replans"],
                    stats["dead_helpers"]))
    assert got[0] == got[1]
    assert got[0][2] == ([{"node": "c:3", "shards": [12]}]
                         if case == "helper_death"
                         else [{"node": "", "shards": [3]}])


# ---- on disk: rebuild_ec_reduced --------------------------------------------

def _write_set(d, tag, files, present):
    os.makedirs(d, exist_ok=True)
    base = os.path.join(d, "5")
    for sid in present:
        with open(base + layout.to_ext(sid), "wb") as f:
            f.write(files[sid].tobytes())
    ec_files.write_vif(base, 10 * L, codec=tag)
    return base


def _disk_fetcher(port: bool, tag: str, files, die=None):
    """The helper stand-in of the on-disk cases: the port's partial
    through `dispatch.apply_matrix`, the reference's through its GF
    product; `die` names a node that raises at every call."""
    a = A if tag == MSR else 1
    codec = _codec(True, tag)

    def fetch(group, sids, coeff, off, n):
        if group.node == die:
            raise _pkg(port).HelperDied(group.node, tuple(sids))
        rows = np.stack([_sub(files, s, a, off, n) for s in sids])
        if port:
            return dispatch.apply_matrix(codec, coeff, rows).tobytes()
        return ref_gf.gf_matmul(np.asarray(coeff, np.uint8), rows).tobytes()
    return fetch


# lost, d, local shards, remote groups, the node that dies at every call,
# a local shard cut short (a local read failure midway)
DISK_CASES = {
    "lrc [2]": (LRC, [2], None, range(6), SPANS[LRC][1:], None, None),
    "lrc [12] d=10": (LRC, [12], 10, range(6), SPANS[LRC][1:], None, None),
    "msr [0]": (MSR, [0], None, range(6), SPANS[MSR][1:], None, None),
    "msr [0, 13]": (MSR, [0, 13], None, range(6), SPANS[MSR][1:], None,
                    None),
    # c:3 is the first plan's only remote node, so its death leaves no
    # other payload in flight and the ledgers stay deterministic
    "msr helper death": (MSR, [0], None, range(16),
                         [("c:3", (16,), 2), ("b:2", (17,), 3)], "c:3",
                         None),
    "msr local read failure": (MSR, [0], None, range(6), SPANS[MSR][1:],
                               None, 3),
}


def _rebuild_both(tmp_path, monkeypatch, case, files):
    """rebuild_ec_reduced of one case (a DISK_CASES value) by each package
    on its own copy of the files: ({port, ref}: result or (type,
    message)), the two directories."""
    tag, lost, d, local, remote, die, short = case
    groups = [{"node": n, "shards": [int(s) for s in span],
               "locality": loc} for n, span, loc in remote]
    monkeypatch.setattr(ec_files, "DEFAULT_BATCH", 4096)
    monkeypatch.setattr(regen, "DEFAULT_SEG_ALIGN", 1024)
    present = [s for s in local if s not in lost]
    out, dirs = {}, {}
    for who in ("port", "ref"):
        dirs[who] = tmp_path / who
        base = _write_set(str(dirs[who]), tag, files, present)
        if short is not None:
            os.truncate(base + layout.to_ext(short), L // 2)
        fetch = _disk_fetcher(who == "port", tag, files, die)
        try:
            if who == "port":
                out[who] = ec_files.rebuild_ec_reduced(
                    base, lost, groups, fetch, d=d, device="cpu")
            else:
                with monkeypatch.context() as mp:
                    mp.setenv("WEEDTPU_EC_CODEC", "tpu")
                    out[who] = ref_ec.rebuild_ec_reduced(
                        base, lost, groups, fetch, d=d, batch_size=4096,
                        align=1024)
        except ValueError as e:
            out[who] = (type(e).__name__, str(e))
    return out, dirs


@pytest.mark.parametrize("case", sorted(DISK_CASES))
def test_rebuild_ec_reduced_equals_reference(tmp_path, stripes, monkeypatch,
                                             case):
    """LRC and MSR rebuild_ec_reduced on the CPU against the reference's,
    on copies of the same files: the rebuilt files equal the encode's,
    no .tmp is left, and the result dicts are equal."""
    tag, lost, *_, die, short = DISK_CASES[case]
    files = stripes[tag]
    got, dirs = _rebuild_both(tmp_path, monkeypatch, DISK_CASES[case], files)
    assert got["port"] == got["ref"]
    res = got["port"]
    assert res["rebuilt"] == lost
    for who, d in dirs.items():
        base = str(d / "5")
        for sid in lost:
            with open(base + layout.to_ext(sid), "rb") as f:
                assert f.read() == files[sid].tobytes(), (who, sid)
        assert not [p for p in os.listdir(d) if p.endswith(".tmp")]
    if die or short is not None:
        assert res["replans"] == 1
        assert res["dead_helpers"] == [
            {"node": die, "shards": [16]} if die else
            {"node": "", "shards": [short]}]
    else:
        assert res["replans"] == 0
        assert res["helper_bytes"] == res["predicted"]["per_node"]
    if tag == MSR and not (die or short is not None):
        # d/alpha shard-equivalents cross the network or the local disk
        per_shard = res["predicted"]["remote"] + res["predicted"]["local"]
        assert per_shard == 16 * L // A * len(lost)


@pytest.mark.parametrize("case", ["lrc [2, 3]", "lrc [12] d=None"])
def test_rebuild_ec_reduced_raises_as_reference(tmp_path, stripes,
                                                monkeypatch, case):
    """Where the reference's planner cannot plan, the port raises its
    ValueError and leaves the directory as it found it: [2, 3] (no window
    holds the globals shard 2 would need) and [12] at d = None (fault
    3.5)."""
    lost = [2, 3] if case == "lrc [2, 3]" else [12]
    got, dirs = _rebuild_both(
        tmp_path, monkeypatch,
        (LRC, lost, None, range(6), SPANS[LRC][1:], None, None),
        stripes[LRC])
    assert got["port"] == got["ref"]
    assert got["port"][0] == "ValueError"
    assert "undecodable loss pattern" in got["port"][1]
    names = sorted(os.listdir(dirs["port"]))
    assert names == sorted(os.listdir(dirs["ref"]))
    assert names == sorted(["5.vif"] + ["5" + layout.to_ext(s)
                                        for s in range(6) if s not in lost])


def test_msr_repair_survives_apply_cache_clears(tmp_path, stripes,
                                                monkeypatch):
    """An MSR plan applies up to 8 distinct matrices; with the apply cache
    bounded at 3 it is cleared inside every chunk, and the rebuilt bytes
    and ledgers stay the reference's."""
    monkeypatch.setattr(dispatch, "_APPLY_CACHE", {})
    monkeypatch.setattr(dispatch, "_APPLY_CACHE_MAX", 3)
    built = []
    orig = dispatch.apply_matrix

    def spy(codec, C, stack):
        out = orig(codec, C, stack)
        built.append(len(dispatch._APPLY_CACHE))
        return out
    monkeypatch.setattr(dispatch, "apply_matrix", spy)
    got, dirs = _rebuild_both(tmp_path, monkeypatch,
                              DISK_CASES["msr [0, 13]"], stripes[MSR])
    assert got["port"] == got["ref"]
    assert max(built) <= 3 and built.count(1) > 2
    for sid in (0, 13):
        assert (dirs["port"] / ("5" + layout.to_ext(sid))).read_bytes() == \
            stripes[MSR][sid].tobytes()


# ---- an MSR volume across the packages --------------------------------------

@pytest.fixture(scope="module")
def msr_volumes(tmp_path_factory):
    """One .dat of 70 needles, encoded as msr_9_16 by each package at
    (8000, 400) blocks: {"ref": base, "port": base, "blobs": ...}."""
    root = tmp_path_factory.mktemp("msr_vol")
    v = Volume(str(root), "", 3)
    rng = np.random.default_rng(9)
    blobs = {}
    for i in range(1, 71):
        data = rng.bytes(int(rng.integers(1, 7000)))
        v.append_needle(needle.Needle(cookie=9, id=i, data=data))
        blobs[i] = data
    v.close()
    out = {"blobs": blobs}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WEEDTPU_EC_CODEC", "numpy")
        for who in ("ref", "port"):
            d = root / who
            d.mkdir()
            for ext in (".dat", ".idx"):
                (d / ("3" + ext)).write_bytes((root / ("3" + ext))
                                              .read_bytes())
            base = str(d / "3")
            if who == "ref":
                ref_ec.write_ec_files(base, large_block=8000,
                                      small_block=400, batch_size=4000,
                                      codec_tag=MSR)
            else:
                # the port takes no reference kind
                mp.delenv("WEEDTPU_EC_CODEC")
                ec_files.write_ec_files(base, large_block=8000,
                                        small_block=400, batch_size=4000,
                                        codec_tag=MSR, device="cpu")
            ec_files.write_sorted_ecx(base + ".idx")
            out[who] = base
    return out


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_msr_volume_repair_crosses_packages(tmp_path, msr_volumes,
                                            monkeypatch, writer):
    """A volume one package encoded loses shards 0 and 13; the other
    package's rebuild_ec_reduced regenerates them from helper sub-rows,
    sha256-equal, and the writer's EcVolume reads every needle from the
    repaired set with shards 1 and 2 gone."""
    src = msr_volumes[writer]
    d = tmp_path / "v"
    d.mkdir()
    names = ["3" + layout.to_ext(s) for s in range(18)] + ["3.ecx", "3.vif"]
    files = {}
    for name in names:
        files[name] = open(os.path.join(os.path.dirname(src), name),
                           "rb").read()
        (d / name).write_bytes(files[name])
    base = str(d / "3")
    shards = {s: np.frombuffer(files["3" + layout.to_ext(s)], np.uint8)
              for s in range(18)}
    lost = [0, 13]
    for s in {0, *range(6, 18)}:
        os.remove(base + layout.to_ext(s))
    groups = [{"node": "a:1", "shards": list(range(6, 12)), "locality": 1},
              {"node": "c:3", "shards": [12], "locality": 2},
              {"node": "b:2", "shards": list(range(13, 18)), "locality": 3}]
    repairer = "port" if writer == "ref" else "ref"
    if repairer == "port":
        monkeypatch.setattr(ec_files, "DEFAULT_BATCH", 8192)
        got = ec_files.rebuild_ec_reduced(
            base, lost, groups, _disk_fetcher(True, MSR, shards),
            device="cpu")
    else:
        with monkeypatch.context() as mp:
            mp.setenv("WEEDTPU_EC_CODEC", "numpy")
            got = ref_ec.rebuild_ec_reduced(
                base, lost, groups, _disk_fetcher(False, MSR, shards),
                batch_size=8192)
    assert got["rebuilt"] == lost
    assert got["helper_bytes"] == got["predicted"]["per_node"]
    for s in lost:
        name = "3" + layout.to_ext(s)
        assert (d / name).read_bytes() == files[name], s
    for s in range(6, 18):
        (d / ("3" + layout.to_ext(s))).write_bytes(
            files["3" + layout.to_ext(s)])
    for s in (1, 2):
        os.remove(base + layout.to_ext(s))
    if writer == "ref":
        monkeypatch.setenv("WEEDTPU_EC_CODEC", "numpy")
        ev = ref_ecv.EcVolume(base, 8000, 400)
    else:
        ev = ec_volume.EcVolume(base, 8000, 400, device="cpu")
    try:
        for nid, data in msr_volumes["blobs"].items():
            assert ev.read_needle(nid).data == data, nid
    finally:
        ev.close()
