"""Reduced-read repair of the PyTorch/CUDA port held against the JAX package.

The stripe is tests/test_regen.py's: RS(10,4), 10 000 B shards from a
fixed seed, the repairing node holding shards 0-5, a same-rack helper "a:1"
6-8 and an other-DC helper "b:2" 9-13.  The port runs on the CPU, where
`dispatch.apply_matrix` takes the plain version.  The broad sweeps hand
the reference the numpy `RSCode`, as tests/test_regen.py does; the
on-disk and `apply_matrix` cases run the reference through its Pallas
kernel in interpret mode (`WEEDTPU_EC_CODEC=tpu`, or a `PallasRSCodec`),
as tests/test_torch_scrub.py does.  Plans, bytes, byte ledgers and
result dicts must be equal, field for field.
"""

import os
import sys
import threading

import numpy as np
import pytest

from seaweedfs_tpu.models import rs as ref_rs
from seaweedfs_tpu.ops import dispatch as ref_dispatch
from seaweedfs_tpu.ops import gf as ref_gf
from seaweedfs_tpu.ops import pallas_gf
from seaweedfs_tpu.ops import regen as ref_regen
from seaweedfs_tpu.storage.ec import ec_files as ref_ec_files

from seaweedfs_tpu_torch.models import rs
from seaweedfs_tpu_torch.ops import dispatch, gf, gf_cuda, regen
from seaweedfs_tpu_torch.storage.ec import ec_files, layout

REF_CODE = ref_rs.get_code(10, 4)
CODE = rs.get_code(10, 4)
L = 10_000  # bytes per shard in the synthetic stripe

# (node, shards, locality): the repairing node, a same-rack and an other-DC
# helper, sized so the same-rack helper dying leaves >= k survivors
SPANS = [("", range(0, 6), 0), ("a:1", range(6, 9), 1),
         ("b:2", range(9, 14), 3)]


@pytest.fixture(scope="module")
def shards():
    rng = np.random.default_rng(0xEC)
    data = rng.integers(0, 256, (10, L), dtype=np.uint8)
    return REF_CODE.encode_numpy(data)


@pytest.fixture(scope="module")
def codec():
    return gf_cuda.get_codec(10, 4, device="cpu")


def _pkg(port: bool):
    return regen if port else ref_regen


def _groups(port: bool, lost: set[int]):
    return [_pkg(port).HelperGroup(n, tuple(s for s in span if s not in lost),
                                   loc)
            for n, span, loc in SPANS]


def _fetcher(port: bool, shards, fetched: dict, die: dict | None = None,
             calls: dict | None = None):
    """A helper stand-in: the partial product of the shards it is asked
    for (the port's through its own numpy GF product).  `calls` gets each
    node's requests in the order it received them.  `die` makes node
    die["node"] raise HelperDied at every call after its die["after"]-th,
    counted per node so the dying call is the same in both packages."""
    calls = {} if calls is None else calls
    matmul = gf.gf_matmul if port else ref_gf.gf_matmul

    def fetch(group, sids, coeff, off, n):
        calls.setdefault(group.node, []).append(
            (tuple(sids), np.asarray(coeff).tolist(), off, n))
        if die and die["node"] == group.node and \
                len(calls[group.node]) > die["after"]:
            raise _pkg(port).HelperDied(group.node, tuple(sids))
        out = matmul(np.asarray(coeff, dtype=np.uint8),
                     np.stack([shards[s][off:off + n] for s in sids]))
        fetched[group.node] = fetched.get(group.node, 0) + out.nbytes
        return out.tobytes()

    return fetch


def _repair(port: bool, codec, shards, lost: int, length: int = L, d=None,
            align=1024, batch=4096, die=None, read_local=None, calls=None):
    """One repair_shard of `lost` by either package: (bytes, plan,
    fetched bytes per node, stats)."""
    fetched: dict = {}
    stats: dict = {}
    out = np.zeros(length, dtype=np.uint8)

    def sink(off, row):
        out[off:off + len(row)] = row

    plan = _pkg(port).repair_shard(
        CODE if port else REF_CODE, codec if port else REF_CODE, lost,
        _groups(port, {lost}), length,
        read_local or (lambda sid, off, n: shards[sid][off:off + n].tobytes()),
        _fetcher(port, shards, fetched, die, calls), sink, d=d,
        batch_size=batch,
        align=align, stats=stats)
    return out, plan, fetched, stats


STAGES = ("read_s", "apply_s", "wait_s", "xor_s", "write_s")


def _ledgers(stats: dict) -> dict:
    """The stats without the port's stage seconds, which the reference
    does not keep."""
    assert set(STAGES) <= set(stats) and \
        all(stats[k] >= 0 for k in STAGES), stats
    return {k: v for k, v in stats.items() if k not in STAGES}


def _plan_fields(plan):
    """A plan as plain values: everything the executor and the ledgers
    read."""
    assert all(getattr(p, "post", None) is None
               for s in plan.segments for p in s.parts)
    return (plan.lost, plan.k, plan.d, plan.length,
            [(s.offset, s.size,
              [(p.group.node, p.group.locality, p.group.shards, p.shards,
                p.coeff.dtype.str, p.coeff.tolist()) for p in s.parts])
             for s in plan.segments])


# ---- plans ------------------------------------------------------------------

@pytest.mark.parametrize("align", [512, 1024])
@pytest.mark.parametrize("d", [None, 10, 11, 12, 13])
@pytest.mark.parametrize("lost", range(14))
def test_plan_equals_reference(lost, d, align):
    """Segments, parts (node, shards, coeff) and predicted ledgers of the
    port's plan equal the reference's for every single loss and d."""
    mine = regen.plan_repair(CODE, lost, _groups(True, {lost}), L, d=d,
                             align=align)
    ref = ref_regen.plan_repair(REF_CODE, lost, _groups(False, {lost}), L,
                                d=d, align=align)
    assert _plan_fields(mine) == _plan_fields(ref)
    assert mine.predicted_bytes() == ref.predicted_bytes()
    for n_local in (0, 5, 6, 10):
        assert mine.naive_remote_bytes(n_local) == \
            ref.naive_remote_bytes(n_local)


# node names that sort against their localities, two nodes in one
# class: the planner orders helpers by (locality, node)
MIXED = [("", (0, 1, 2, 3), 0), ("z:9", (4, 5, 6), 1), ("m:5", (7, 8), 2),
         ("b:2", (9, 10, 11), 3), ("a:1", (12, 13), 3)]


@pytest.mark.parametrize("d", [None, 11])
@pytest.mark.parametrize("lost", [0, 5, 8, 10, 13])
def test_plan_orders_helpers_as_reference(lost, d):
    plans = []
    for port in (True, False):
        groups = [_pkg(port).HelperGroup(n, tuple(x for x in s if x != lost),
                                         loc) for n, s, loc in MIXED]
        plans.append(_pkg(port).plan_repair(CODE if port else REF_CODE, lost,
                                            groups, L, d=d, align=512))
    assert _plan_fields(plans[0]) == _plan_fields(plans[1])
    assert plans[0].predicted_bytes() == plans[1].predicted_bytes()


def test_too_few_survivors_raises_as_reference():
    """Fewer than k survivors is a critical volume, not a plan."""
    msgs = []
    for port in (True, False):
        groups = [_pkg(port).HelperGroup("", tuple(range(9)), 0)]
        with pytest.raises(ValueError, match="survivors") as e:
            _pkg(port).plan_repair(CODE if port else REF_CODE, 13, groups, L)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---- repair_shard -----------------------------------------------------------

@pytest.mark.parametrize("lost", range(14))
def test_repair_bytes_equal_reference_and_naive(shards, codec, lost):
    """Every single loss rebuilds byte-identically to the reference and to
    the naive decode; each helper is asked for the same ranges in the same
    order; measured bytes per node equal the plan's prediction and the
    reference's, and so do the stats ledgers."""
    calls: dict = {}
    ref_calls: dict = {}
    out, plan, fetched, stats = _repair(True, codec, shards, lost,
                                        calls=calls)
    ref_out, ref_plan, ref_fetched, ref_stats = _repair(
        False, codec, shards, lost, calls=ref_calls)
    assert calls == ref_calls and set(calls) == {"a:1", "b:2"}
    naive = REF_CODE.reconstruct_numpy(
        {s: shards[s] for s in range(14) if s != lost}, [lost])[lost]
    assert np.array_equal(out, shards[lost])
    assert np.array_equal(out, ref_out) and np.array_equal(out, naive)
    assert fetched == plan.predicted_bytes()["per_node"] == ref_fetched
    assert _ledgers(stats) == ref_stats
    assert stats["helper_bytes"] == fetched


@pytest.mark.parametrize("d", [11, 12, 13])
def test_d_sweep_reads_sub_shard_ranges(shards, codec, d):
    """d > k helpers: output stays byte-identical while each remote helper
    reads only sub-shard ranges, and ships at most one range per node."""
    out, plan, fetched, _ = _repair(True, codec, shards, 3, d=d, align=512)
    ref_out, ref_plan, ref_fetched, _ = _repair(False, codec, shards, 3, d=d,
                                                align=512)
    assert np.array_equal(out, shards[3]) and np.array_equal(out, ref_out)
    assert plan.d == d and _plan_fields(plan) == _plan_fields(ref_plan)
    pred = plan.predicted_bytes()
    for node, nbytes in pred["helper_reads"].items():
        span = sum(len(g.shards) for g in _groups(True, {3})
                   if g.node == node) * L
        assert nbytes < span, f"{node} read its whole span under d={d}"
    assert 0 < pred["remote"] <= 2 * L
    assert pred["remote"] < plan.naive_remote_bytes(5)
    assert fetched == pred["per_node"] == ref_fetched


def test_helper_death_replans_as_reference(shards, codec):
    """A helper dying mid-transfer (a:1 at its third call) re-plans with a
    substitute: the bytes stay identical, and replans, dead_helpers and
    the completed plan equal the reference's."""
    die = {"node": "a:1", "after": 2}
    out, plan, _, stats = _repair(True, codec, shards, 2, die=die)
    ref_out, ref_plan, _, ref_stats = _repair(False, codec, shards, 2,
                                              die=die)
    assert np.array_equal(out, shards[2]) and np.array_equal(out, ref_out)
    assert stats["replans"] == ref_stats["replans"] >= 1
    assert stats["dead_helpers"] == ref_stats["dead_helpers"]
    assert [h["node"] for h in stats["dead_helpers"]] == ["a:1"]
    assert _plan_fields(plan) == _plan_fields(ref_plan)
    assert "a:1" not in plan.predicted_bytes()["per_node"]


def test_local_read_failure_excludes_shard(shards, codec):
    """A local shard that reads short is excluded like a dead helper; the
    replacement plan pulls the slack from the remote pool."""
    def read_local(sid, off, n):
        return None if sid == 4 else shards[sid][off:off + n].tobytes()

    got = [_repair(port, codec, shards, 0, read_local=read_local)
           for port in (True, False)]
    (out, plan, fetched, stats), (ref_out, ref_plan, ref_fetched,
                                  ref_stats) = got
    assert np.array_equal(out, shards[0]) and np.array_equal(out, ref_out)
    assert stats["dead_helpers"] == ref_stats["dead_helpers"] == \
        [{"node": "", "shards": [4]}]
    assert stats["replans"] == ref_stats["replans"] == 1
    assert _plan_fields(plan) == _plan_fields(ref_plan)


@pytest.mark.parametrize("length", [1, 511, 512, 513, 4097])
def test_unaligned_length_and_tiny_ranges(shards, codec, length):
    """Segment cutting covers lengths that do not divide by the alignment,
    collapses when the range is smaller than one segment, and survives a
    batch larger than the range."""
    sub = {s: shards[s][:length] for s in range(14)}
    out, plan, _, _ = _repair(True, codec, sub, 0, length=length,
                              align=512, batch=1 << 20)
    ref_out, ref_plan, _, _ = _repair(False, codec, sub, 0, length=length,
                                      align=512, batch=1 << 20)
    assert np.array_equal(out, shards[0][:length])
    assert np.array_equal(out, ref_out)
    assert _plan_fields(plan) == _plan_fields(ref_plan)


# ---- apply_matrix -----------------------------------------------------------

@pytest.fixture(scope="module")
def ref_pallas():
    return pallas_gf.PallasRSCodec(REF_CODE, tile=256, interpret=True)


@pytest.mark.parametrize("rows, n", [((0, 4, 11), 2048), ((3,), 4097),
                                     ((1, 2, 5, 6, 8), 17)])
def test_apply_matrix_equals_reference(shards, codec, ref_pallas, rows, n):
    """The port's apply on the CPU equals the reference's GF product and
    the reference's apply_matrix through its Pallas kernel."""
    stack = np.stack([shards[s][:n] for s in rows])
    C = REF_CODE.decode_matrix([0, 1, 2, 3, 4, 5, 6, 7, 8, 11],
                               [13])[:, :len(rows)]
    got = dispatch.apply_matrix(codec, C, stack)
    assert got.shape == (1, n) and got.dtype == np.uint8
    assert np.array_equal(got, ref_gf.gf_matmul(C, stack))
    assert np.array_equal(got, ref_dispatch.apply_matrix(ref_pallas, C,
                                                         stack))


def test_apply_matrix_cache_is_bounded(shards, codec, monkeypatch):
    """Past 64 distinct matrices the cache is cleared, never grown, and
    every apply stays right."""
    monkeypatch.setattr(dispatch, "_APPLY_CACHE", {})
    stack = np.stack([shards[s][:64] for s in (0, 1)])
    for i in range(150):
        C = np.array([[i % 256, (7 * i + 1) % 256]], dtype=np.uint8)
        assert np.array_equal(dispatch.apply_matrix(codec, C, stack),
                              ref_gf.gf_matmul(C, stack))
        assert 1 <= len(dispatch._APPLY_CACHE) <= dispatch._APPLY_CACHE_MAX


def test_apply_matrix_cache_under_threads(shards, monkeypatch):
    """24 threads apply 4 matrices at once under a 1 us switch interval:
    each matrix's apply is built exactly once, and every result is
    right."""
    monkeypatch.setattr(dispatch, "_APPLY_CACHE", {})
    codec = gf_cuda.CudaRSCodec(CODE, device="cpu")
    built = []
    factory = codec._factory

    def counting(C):
        built.append(C.tobytes())
        return factory(C)
    codec._factory = counting
    mats = [np.array([[c, 3, 200]], dtype=np.uint8) for c in (1, 2, 77, 255)]
    stack = np.stack([shards[s][:257] for s in (5, 6, 7)])
    want = [ref_gf.gf_matmul(C, stack) for C in mats]
    errors = []

    def work(t):
        try:
            for i in range(8):
                j = (t + i) % len(mats)
                if not np.array_equal(
                        dispatch.apply_matrix(codec, mats[j], stack), want[j]):
                    errors.append((t, j))
        except BaseException as e:  # reported by the asserting thread
            errors.append(e)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(24)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert errors == []
    assert sorted(built) == sorted(C.tobytes() for C in mats)


# ---- on disk: rebuild_ec_reduced --------------------------------------------

def _write_shards(d, shards, present):
    os.makedirs(d, exist_ok=True)
    base = os.path.join(d, "7")
    for sid in present:
        with open(base + layout.to_ext(sid), "wb") as f:
            f.write(shards[sid].tobytes())
    return base


def _port_disk_fetcher(codec, shards, die_node=None):
    """The port's helper stand-in: its partial through
    `dispatch.apply_matrix`, as a helper node computes it."""
    def fetch(group, sids, coeff, off, n):
        if group.node == die_node or die_node == "*":
            raise regen.HelperDied(group.node, tuple(sids))
        rows = np.stack([shards[s][off:off + n] for s in sids])
        return dispatch.apply_matrix(codec, coeff, rows).tobytes()
    return fetch


def _ref_disk_fetcher(shards, die_node=None):
    def fetch(group, sids, coeff, off, n):
        if group.node == die_node or die_node == "*":
            raise ref_regen.HelperDied(group.node, tuple(sids))
        rows = np.stack([shards[s][off:off + n] for s in sids])
        return ref_gf.gf_matmul(np.asarray(coeff, np.uint8), rows).tobytes()
    return fetch


def _small_chunks(monkeypatch, batch: int, align: int) -> None:
    """The port's repair chunk and segment alignment at the sizes the
    reference is handed as arguments."""
    monkeypatch.setattr(ec_files, "DEFAULT_BATCH", batch)
    monkeypatch.setattr(regen, "DEFAULT_SEG_ALIGN", align)


# lost, local shards, remote groups, the node that dies at its first call
DISK_CASES = {
    "multi_loss": ([1, 12], [0, 2, 3, 4, 5, 6],
                   [("a:1", [7, 8, 9, 10], 1), ("b:2", [11, 13], 3)], None),
    # a:1's shards fill the first window alone, so it dies with no other
    # fetch in flight and the ledgers stay deterministic
    "helper_death": ([13], list(range(7)),
                     [("a:1", [7, 8, 9], 1), ("b:2", [10, 11, 12], 3)],
                     "a:1"),
}


@pytest.mark.parametrize("case", sorted(DISK_CASES))
def test_rebuild_ec_reduced_equals_reference(tmp_path, shards, codec,
                                             monkeypatch, case):
    """rebuild_ec_reduced on the CPU against the reference's, run through
    its Pallas kernel, on copies of the same files: the rebuilt files, no
    .tmp left, and equal result dicts."""
    _small_chunks(monkeypatch, 4096, 512)
    lost, local, remote, die = DISK_CASES[case]
    groups = [{"node": n, "shards": s, "locality": loc}
              for n, s, loc in remote]
    base = _write_shards(str(tmp_path / "port"), shards, local)
    ref_base = _write_shards(str(tmp_path / "ref"), shards, local)
    stats: dict = {}
    got = ec_files.rebuild_ec_reduced(
        base, lost, groups, _port_disk_fetcher(codec, shards, die),
        stats=stats, device="cpu")
    monkeypatch.setenv("WEEDTPU_EC_CODEC", "tpu")
    want = ref_ec_files.rebuild_ec_reduced(
        ref_base, lost, groups, _ref_disk_fetcher(shards, die),
        batch_size=4096, align=512)
    assert got == want
    assert got["rebuilt"] == lost
    for sid in lost:
        with open(base + layout.to_ext(sid), "rb") as f:
            assert f.read() == shards[sid].tobytes(), sid
    assert not [p for p in os.listdir(tmp_path / "port")
                if p.endswith(".tmp")]
    assert got["helper_bytes"] == got["predicted"]["per_node"]
    if die:
        assert got["replans"] == 1
        assert got["dead_helpers"] == [{"node": "a:1", "shards": [7, 8, 9]}]
    else:
        assert got["predicted"]["remote"] <= \
            0.6 * got["predicted"]["naive_remote"]
    assert stats["mode"] == "reduced" and stats["codec"] == "rs_10_4"
    assert stats["bytes"] == L * len(lost)
    assert stats["reconstruct_s"] > 0 and stats["wall_s"] > 0
    assert sum(stats[k] for k in STAGES) <= stats["reconstruct_s"]


def test_rebuild_ec_reduced_both_helpers_dead(tmp_path, shards, codec,
                                              monkeypatch):
    """With both helpers dead fewer than k survivors remain: ValueError as
    the reference raises, and no .tmp and no partial shard left."""
    groups = [{"node": "a:1", "shards": [7, 8], "locality": 1},
              {"node": "b:2", "shards": list(range(9, 13)), "locality": 3}]
    base = _write_shards(str(tmp_path / "port"), shards, range(7))
    ref_base = _write_shards(str(tmp_path / "ref"), shards, range(7))
    # which helper is found dead first depends on the order the two
    # fetches complete in, and so does the survivor count in the message
    msg = "need >= 10 survivors to repair shard 13"
    _small_chunks(monkeypatch, 4096, 2048)
    with pytest.raises(ValueError, match=msg):
        ec_files.rebuild_ec_reduced(
            base, [13], groups, _port_disk_fetcher(codec, shards, "*"),
            device="cpu")
    monkeypatch.setenv("WEEDTPU_EC_CODEC", "tpu")
    with pytest.raises(ValueError, match=msg):
        ref_ec_files.rebuild_ec_reduced(
            ref_base, [13], groups, _ref_disk_fetcher(shards, "*"),
            batch_size=4096, align=2048)
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "ref")) == \
        ["7" + layout.to_ext(s) for s in range(7)]


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_shard_set_crosses_packages(tmp_path, codec, monkeypatch, writer):
    """A shard set written by one package's write_ec_files is repaired by
    the other's rebuild_ec_reduced, byte for byte."""
    base = str(tmp_path / "3")
    with open(base + ".dat", "wb") as f:
        f.write(np.random.default_rng(31).integers(
            0, 256, 200_000, dtype=np.uint8).tobytes())
    geom = dict(large_block=10_000, small_block=100)
    if writer == "ref":
        with monkeypatch.context() as mp:
            mp.setenv("WEEDTPU_EC_CODEC", "numpy")
            ref_ec_files.write_ec_files(base, **geom)
    else:
        ec_files.write_ec_files(base, device="cpu", **geom)
    files = {s: open(base + layout.to_ext(s), "rb").read()
             for s in range(14)}
    helper = {s: np.frombuffer(b, np.uint8) for s, b in files.items()}
    lost = [1, 12]
    for s in lost + [7, 8, 9, 10, 11, 13]:
        os.remove(base + layout.to_ext(s))
    groups = [{"node": "a:1", "shards": [7, 8, 9], "locality": 1},
              {"node": "b:2", "shards": [10, 11, 12, 13], "locality": 3}]
    if writer == "ref":
        _small_chunks(monkeypatch, 8192, 4096)
        got = ec_files.rebuild_ec_reduced(
            base, lost, groups, _port_disk_fetcher(codec, helper),
            device="cpu")
    else:
        monkeypatch.setenv("WEEDTPU_EC_CODEC", "numpy")
        got = ref_ec_files.rebuild_ec_reduced(
            base, lost, groups, _ref_disk_fetcher(helper),
            batch_size=8192, align=4096)
    assert got["rebuilt"] == lost
    assert got["helper_bytes"] == got["predicted"]["per_node"]
    for s in lost:
        with open(base + layout.to_ext(s), "rb") as f:
            assert f.read() == files[s], s
