"""The port's device mesh (seaweedfs_tpu_torch/parallel/) held against the
JAX package's, byte for byte.

The reference runs on the conftest's 8 virtual CPU devices
(`column_mesh`, `unit_mesh`, meshes of `jax.devices()`); the port on a
mesh of 8 positions on "cpu" (`make_mesh(devices=["cpu"] * 8)`), where
every position applies the plain version.  Inputs are drawn with numpy
from fixed seeds.  GF(2^8) arithmetic is exact: every comparison is
equality, no tolerance.
"""

import os

import numpy as np
import pytest
import torch

from seaweedfs_tpu.models import rs as ref_rs
from seaweedfs_tpu.ops import codecs as ref_codecs
from seaweedfs_tpu.ops import dispatch as ref_dispatch
from seaweedfs_tpu.ops import fleet_convert as ref_fleet
from seaweedfs_tpu.parallel import mesh as ref_mesh
from seaweedfs_tpu.stats import profile as ref_profile
from seaweedfs_tpu.storage.ec import ec_files as ref_ec

from seaweedfs_tpu_torch.models import rs
from seaweedfs_tpu_torch.ops import (codecs, dispatch, fleet_convert, gf,
                                     gf_cuda, native_codec)
from seaweedfs_tpu_torch.parallel import dryrun
from seaweedfs_tpu_torch.parallel import mesh as pmesh
from seaweedfs_tpu_torch.stats.profile import KERNELS
from seaweedfs_tpu_torch.storage.ec import ec_files, layout

CPU8 = ["cpu"] * 8


def _port_mesh(axis_names=("data",), shape=None):
    return pmesh.make_mesh(axis_names=axis_names, shape=shape, devices=CPU8)


def _coord(mesh, device):
    """A reference device's coordinate in its mesh."""
    return tuple(int(i) for i in np.argwhere(mesh.devices == device)[0])


def _bounds(index, shape):
    return tuple(s.indices(n)[:2] for s, n in zip(index, shape))


def _blocks_equal(port_out, ref_out, ref_mesh_):
    """Every position's block of the port's result equals the reference's
    addressable shard at the same mesh coordinate, at the same place."""
    assert tuple(port_out.shape) == tuple(ref_out.shape)
    ref = {_coord(ref_mesh_, sh.device): sh for sh in ref_out.addressable_shards}
    assert sorted(s.position for s in port_out.shards) == sorted(ref)
    for s in port_out.shards:
        r = ref[s.position]
        assert _bounds(s.index, port_out.shape) == \
            _bounds(r.index, ref_out.shape), s.position
        assert np.array_equal(s.data.numpy(), np.asarray(r.data)), s.position
    return len(port_out.shards)


# ---- the mesh ------------------------------------------------------------

def test_make_mesh_positions(no_card):
    m = pmesh.make_mesh(devices="cpu")
    assert m.shape == {"data": 1}
    m = pmesh.make_mesh(6, ("vol", "col"), shape=(3, 2), devices=CPU8)
    assert m.shape == {"vol": 3, "col": 2}
    assert [c for c, _ in m.positions("col")] == [(0, 0), (0, 1)]
    assert [c for c, _ in m.positions("vol")] == [(0, 0), (1, 0), (2, 0)]
    with pytest.raises(ValueError, match="8 positions, 2 given"):
        pmesh.make_mesh(8, devices=["cpu"] * 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.make_mesh()  # every card: there is none
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.make_mesh(devices=["cpu", "cuda"])
    with pytest.raises(ValueError, match="dry run over 8 positions"):
        dryrun.dryrun_multichip(8, devices=["cpu"] * 4)


def test_mesh_refuses_mixed_positions():
    arr = np.empty(2, dtype=object)
    arr[:] = [torch.device("cpu"), torch.device("cuda", 0)]
    with pytest.raises(ValueError, match="all cards or all CPU"):
        pmesh.Mesh(arr, ("data",))


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


# ---- twins of tests/test_parallel.py -------------------------------------

def test_column_sharded_encode_matches_reference(column_mesh):
    code, ref_code = rs.get_code(10, 4), ref_rs.get_code(10, 4)
    mesh = _port_mesh()
    enc = pmesh.ShardedRSEncoder(code, mesh)
    ref = ref_mesh.ShardedRSEncoder(ref_code, column_mesh)
    data = np.random.default_rng(0).integers(0, 256, (10, 8 * 512),
                                             dtype=np.uint8)
    out = enc.encode(pmesh.shard_columns(mesh, data))
    want = ref.encode(ref_mesh.shard_columns(column_mesh, data))
    assert _blocks_equal(out, want, column_mesh) == 8
    assert np.array_equal(out.numpy(), ref_code.encode_numpy(data))


def test_column_sharded_reconstruct(column_mesh):
    code, ref_code = rs.get_code(10, 4), ref_rs.get_code(10, 4)
    enc = pmesh.ShardedRSEncoder(code, _port_mesh())
    ref = ref_mesh.ShardedRSEncoder(ref_code, column_mesh)
    data = np.random.default_rng(1).integers(0, 256, (10, 8 * 256),
                                             dtype=np.uint8)
    shards = ref_code.encode_numpy(data)
    survivors = {i: shards[i] for i in range(14) if i not in (0, 3, 9, 12)}
    got = enc.reconstruct(survivors)
    want = ref.reconstruct(survivors)
    assert sorted(got) == sorted(want) == [0, 3, 9, 12]
    for i in got:
        assert np.array_equal(got[i].numpy(), np.asarray(want[i])), i
        assert np.array_equal(got[i].numpy(), shards[i]), i


@pytest.mark.parametrize("shape", [(4, 2), (3, 2)])
def test_batch_encode_with_shard_placement(device_mesh_devices, shape):
    """Every position's block equals the reference's at the same mesh
    coordinate: position (v, c) holds shard rows [v*S/D, (v+1)*S/D) of
    every volume in column slice c; rows past 14 are zero.  (3, 2) pads
    14 rows to S = 15, one pad row per group."""
    code, ref_code = rs.get_code(10, 4), ref_rs.get_code(10, 4)
    n_pos = shape[0] * shape[1]
    mesh = _port_mesh(("vol", "col"), shape)
    rmesh = ref_mesh.make_mesh(n_pos, ("vol", "col"), shape=shape)
    enc = pmesh.ShardedRSEncoder(code, mesh, col_axis="col", vol_axis="vol")
    ref = ref_mesh.ShardedRSEncoder(ref_code, rmesh, col_axis="col",
                                    vol_axis="vol")
    V, n = 2 * shape[0], 2 * 256
    vols = np.random.default_rng(2).integers(0, 256, (V, 10, n),
                                             dtype=np.uint8)
    out = enc.encode_batch_place(vols)
    want = ref.encode_batch_place(vols)
    S = enc.placement_groups()
    assert S == ref.placement_groups() == -(-14 // shape[0]) * shape[0]
    assert out.shape == (V, S, n)
    assert _blocks_equal(out, want, rmesh) == n_pos
    host = out.numpy()
    for v in range(V):
        assert np.array_equal(host[v, :14], ref_code.encode_numpy(vols[v]))
        assert (host[v, 14:] == 0).all()


def test_batch_place_on_a_one_position_volume_axis():
    """D == 1: no pad and no exchange, [V, 14, n] where it was made."""
    code = rs.get_code(10, 4)
    mesh = pmesh.make_mesh(2, ("vol", "col"), shape=(1, 2), devices=CPU8)
    enc = pmesh.ShardedRSEncoder(code, mesh, col_axis="col", vol_axis="vol")
    vols = np.random.default_rng(4).integers(0, 256, (3, 10, 64),
                                             dtype=np.uint8)
    out = enc.encode_batch_place(vols)
    assert enc.placement_groups() == 14 and out.shape == (3, 14, 64)
    assert [s.data.shape for s in out.shards] == [(3, 14, 32)] * 2
    ref_code = ref_rs.get_code(10, 4)
    host = out.numpy()
    for v in range(3):
        assert np.array_equal(host[v], ref_code.encode_numpy(vols[v]))
    with pytest.raises(ValueError, match="split evenly"):
        enc.encode_batch_place(vols[:, :, :63])


@pytest.mark.parametrize("k,m", [(10, 4), (6, 3), (12, 4)])
def test_sharded_encode_byte_identity_rs_sweep(column_mesh, unit_mesh, k, m):
    """Both mesh shapes, every RS geometry, against the reference's mesh
    and its numpy code, including a ragged n that divides neither the
    mesh nor the kernel's 16-byte rows."""
    code, ref_code = rs.get_code(k, m), ref_rs.get_code(k, m)
    enc = pmesh.ShardedRSEncoder(code, _port_mesh())
    fleet = pmesh.FleetUnitEncoder(code, _port_mesh(("unit",)))
    ref = ref_mesh.ShardedRSEncoder(ref_code, column_mesh)
    ref_fleet_enc = ref_mesh.FleetUnitEncoder(ref_code, unit_mesh)
    rng = np.random.default_rng(17 * k + m)
    for n in (8 * 384, 8 * 384 + 5):
        data = rng.integers(0, 256, (k, n), dtype=np.uint8)
        want = ref_code.encode_numpy(data)[k:]
        got = enc.encode_parity(data).numpy()
        assert np.array_equal(got, np.asarray(ref.encode_parity(data)))
        assert np.array_equal(got, want), (k, m, n)
        U = fleet.unit_slots(8)
        assert U == ref_fleet_enc.unit_slots(8)
        units = rng.integers(0, 256, (U, k, n), dtype=np.uint8)
        par = fleet.encode_parity_batch(fleet.place(units))
        got = np.zeros((U, m, n), dtype=np.uint8)
        blocks = list(fleet.unit_shards(par))
        for a, b, arr in blocks:
            got[a:b] = arr
        ref_blocks = list(ref_fleet_enc.unit_shards(
            ref_fleet_enc.encode_parity_batch(ref_fleet_enc.place(units))))
        assert [(a, b) for a, b, _ in blocks] == \
            [(a, b) for a, b, _ in ref_blocks]
        for (_, _, x), (_, _, y) in zip(blocks, ref_blocks):
            assert np.array_equal(x, y)
        assert np.array_equal(got, np.stack(
            [ref_code.encode_numpy(units[u])[k:] for u in range(U)]))


def test_fleet_encoder_matched_shardings_chain():
    """Consecutive unit batches keep one split: each call's parity sits on
    the positions and unit ranges its input was placed on, so a chain of
    batches never moves data between positions."""
    fleet = pmesh.FleetUnitEncoder(rs.get_code(10, 4), _port_mesh(("unit",)))
    rng = np.random.default_rng(3)
    layout_ = None
    for _ in range(3):
        units = fleet.place(rng.integers(0, 256, (8, 10, 512),
                                         dtype=np.uint8))
        par = fleet.encode_parity_batch(units)
        split = [(s.position, s.index) for s in units.shards]
        assert split == [(s.position, s.index) for s in par.shards]
        assert split == [((u,), (slice(u, u + 1),)) for u in range(8)]
        layout_ = layout_ or split
        assert split == layout_
        assert par.kernel == "fleet_encode"


def _shard_files(base, n=14):
    out = {}
    for i in range(n):
        with open(base + layout.to_ext(i), "rb") as f:
            out[i] = f.read()
    return out


def test_ec_files_mesh_codec_roundtrip(tmp_path, monkeypatch):
    """WEEDTPU_EC_CODEC=mesh drives the shard-file pipeline through the
    mesh codec in both packages: the port over 8 CPU positions, the
    reference over its 8 devices; the shard files, .vif and the rebuilt
    shards are byte-equal, and an odd column count takes the pad."""
    monkeypatch.setenv("WEEDTPU_EC_CODEC", "mesh")
    rng = np.random.default_rng(11)
    dat = rng.integers(0, 256, 200_000, dtype=np.uint8).tobytes()
    bases = {}
    for who in ("port", "ref"):
        os.makedirs(tmp_path / who)
        bases[who] = str(tmp_path / who / "1")
        with open(bases[who] + ".dat", "wb") as f:
            f.write(dat)
    ec_files.write_ec_files(bases["port"], large_block=10_000,
                            small_block=100, device=CPU8)
    ref_ec.write_ec_files(bases["ref"], large_block=10_000, small_block=100)
    assert _shard_files(bases["port"]) == _shard_files(bases["ref"])
    with open(bases["port"] + ".vif", "rb") as f, \
            open(bases["ref"] + ".vif", "rb") as g:
        assert f.read() == g.read()
    want = _shard_files(bases["ref"])
    for who, base in bases.items():
        for sid in (0, 12):
            os.remove(base + layout.to_ext(sid))
    assert ec_files.rebuild_ec_files(bases["port"], device=CPU8) == [0, 12]
    assert sorted(ref_ec.rebuild_ec_files(bases["ref"])) == [0, 12]
    assert _shard_files(bases["port"]) == _shard_files(bases["ref"]) == want
    codec = ec_files._get_codec(CPU8)
    ref = ref_ec._get_codec("mesh")
    code = ref_rs.get_code(10, 4)
    data = rng.integers(0, 256, (10, 1003), dtype=np.uint8)
    full = code.encode_numpy(data)
    surv = {i: full[i] for i in range(14) if i not in (1, 13)}
    got = codec.reconstruct(surv, wanted=[1, 13])
    want = ref.reconstruct(surv, wanted=[1, 13])
    for i in (1, 13):
        assert np.array_equal(got[i].numpy(), np.asarray(want[i]))
        assert np.array_equal(got[i].numpy(), full[i])


def test_ec_codec_mesh_builds_a_sharded_encoder(monkeypatch):
    """WEEDTPU_EC_CODEC=mesh builds RS as a ShardedRSEncoder over the
    positions `device` names, one per positions; a sequence of devices
    is the mesh kind's alone."""
    monkeypatch.setenv("WEEDTPU_EC_CODEC", "mesh")
    c8 = ec_files._get_codec(CPU8)
    assert isinstance(c8, pmesh.ShardedRSEncoder)
    assert c8.mesh.shape == {"data": 8} and c8 is ec_files._get_codec(CPU8)
    c1 = ec_files._get_codec("cpu")
    assert c1.mesh.shape == {"data": 1} and c1 is not c8
    assert (c8.k, c8.m, c8.n_shards) == (10, 4, 14)
    assert c8.device == torch.device("cpu")
    for kind in ("cuda", "native", None):
        with pytest.raises(ValueError, match="runs on one device"):
            codecs.make_codec("rs_10_4", CPU8, kind)


def test_lrc_and_msr_under_mesh_are_the_one_device_codec(monkeypatch):
    """The reference's registry gives LRC and MSR its one-device shell
    under mesh (`_shell_for`); the port gives them the cuda kind's
    codec on the one device named."""
    monkeypatch.setenv("WEEDTPU_EC_CODEC", "mesh")
    for tag in ("lrc_10_2_2", "msr_9_16"):
        got = ec_files._get_codec("cpu", tag)
        assert got is codecs.make_codec(tag, "cpu", "cuda")
        assert not hasattr(got, "mesh")
        ref = ref_codecs.make_codec(tag, "mesh")
        assert not hasattr(ref, "mesh") and (got.k, got.m) == (ref.k, ref.m)
        with pytest.raises(ValueError, match="one device under mesh"):
            ec_files._get_codec(CPU8, tag)


def test_apply_matrix_under_mesh_runs_on_the_first_position():
    """Kept difference (ROADMAP 3): under the mesh codec the reference
    computes a repair partial on the host (`gf.gf_matmul`: the mesh codec
    has no `_factory`, so the row is `repair_partial[host]`); the port
    applies it on the mesh's first position by K1, booked `[device]`.
    The bytes are the same."""
    rng = np.random.default_rng(21)
    C = rng.integers(0, 256, (2, 5), dtype=np.uint8)
    stack = rng.integers(0, 256, (5, 4099), dtype=np.uint8)
    codec = pmesh.ShardedRSEncoder(rs.get_code(10, 4), _port_mesh())
    before = KERNELS.snapshot().get("repair_partial[device]", {})
    ref_before = ref_profile.KERNELS.snapshot().get("repair_partial[host]",
                                                    {})
    got = dispatch.apply_matrix(codec, C, stack)
    want = ref_dispatch.apply_matrix(ref_ec._mesh_codec(10, 4), C, stack)
    assert np.array_equal(got, want)
    assert np.array_equal(got, gf.gf_matmul(C, stack))
    after = KERNELS.snapshot()["repair_partial[device]"]
    assert after["calls"] == before.get("calls", 0) + 1
    ref_after = ref_profile.KERNELS.snapshot()["repair_partial[host]"]
    assert ref_after["calls"] == ref_before.get("calls", 0) + 1
    assert codec.device == codec.mesh.devices.flat[0]


# ---- the fleet on the mesh -------------------------------------------------

def _make_volumes(dirname, sizes, seed=7):
    rng = np.random.default_rng(seed)
    bases = []
    for i, sz in enumerate(sizes):
        base = os.path.join(str(dirname), str(i + 1))
        with open(base + ".dat", "wb") as f:
            f.write(rng.integers(0, 256, sz, dtype=np.uint8).tobytes())
        bases.append(base)
    return bases


def test_convert_volumes_byte_identity(tmp_path, unit_mesh):
    """The port's fleet on an 8-position unit mesh against the reference's
    fleet on its `unit_mesh`: every shard file and .vif equal, ragged
    tails included, the unit batch an even split (8 per batch)."""
    sizes = [200_000, 137_777, 95_001]
    os.makedirs(tmp_path / "port")
    os.makedirs(tmp_path / "ref")
    port = _make_volumes(tmp_path / "port", sizes)
    ref = _make_volumes(tmp_path / "ref", sizes)
    geom = dict(large_block=10_000, small_block=100, batch_size=1000)
    stats: dict = {}
    rep = fleet_convert.convert_volumes(
        port, codec=pmesh.FleetUnitEncoder(rs.get_code(10, 4),
                                           _port_mesh(("unit",))),
        stats=stats, **geom)
    ref_stats: dict = {}
    ref_fleet.convert_volumes(
        ref, codec=ref_mesh.FleetUnitEncoder(ref_rs.get_code(10, 4),
                                             unit_mesh),
        stats=ref_stats, **geom)
    assert rep["bytes"] == sum(sizes)
    assert stats["mode"] == "fleet" and stats["unit_batch"] % 8 == 0
    assert stats["unit_batch"] == ref_stats["unit_batch"] == 8
    for p, r in zip(port, ref):
        assert _shard_files(p) == _shard_files(r)
        with open(p + ".vif", "rb") as f, open(r + ".vif", "rb") as g:
            assert f.read() == g.read()
    assert not [x for x in os.listdir(tmp_path / "port")
                if x.endswith(".tmp")]


def test_dispatch_parity_batch_books_h2d_exactly_once(unit_mesh):
    """A mesh codec's place() books the H2D; dispatch_parity_batch does
    not book it again, whether it places or the caller placed first.
    Twin of tests/test_perf_obs.py's."""
    enc = pmesh.FleetUnitEncoder(rs.get_code(10, 4), _port_mesh(("unit",)))
    ref = ref_mesh.FleetUnitEncoder(ref_rs.get_code(10, 4), unit_mesh)
    units = np.random.default_rng(3).integers(0, 256, (8, 10, 256),
                                              dtype=np.uint8)
    for placed in (None, enc.place(units)):
        before = KERNELS.snapshot().get("fleet_encode[device]", {})
        if placed is not None:  # place() above booked its own H2D
            before = dict(before, h2d_bytes=before.get("h2d_bytes", 0.0) -
                          units.nbytes)
        parity = dispatch.dispatch_parity_batch(enc, units, placed=placed)
        blocks = list(dispatch.unit_parity_shards(parity))
        after = KERNELS.snapshot()["fleet_encode[device]"]
        h2d = after["h2d_bytes"] - before.get("h2d_bytes", 0.0)
        d2h = after["d2h_bytes"] - before.get("d2h_bytes", 0.0)
        assert h2d == units.nbytes  # once, not twice
        assert d2h == sum(b.nbytes for _, _, b in blocks) == 8 * 4 * 256
        assert after["calls"] == before.get("calls", 0) + 1
    ref_blocks = list(ref_dispatch.unit_parity_shards(
        ref_dispatch.dispatch_parity_batch(ref, units)))
    assert len(blocks) == len(ref_blocks) == 8
    for (a, b, x), (c, d, y) in zip(blocks, ref_blocks):
        assert (a, b) == (c, d) and np.array_equal(x, y)
    with pytest.raises(TypeError, match="needs a codec with place"):
        dispatch.dispatch_parity_batch(
            gf_cuda.get_codec(10, 4, device="cpu"), units, placed=placed)


def test_unit_parity_shards_of_one_device_results():
    """A Pending or a host result yields one block."""
    codec = gf_cuda.get_codec(10, 4, device="cpu")
    units = np.random.default_rng(5).integers(0, 256, (3, 10, 100),
                                              dtype=np.uint8)
    blocks = list(dispatch.unit_parity_shards(
        dispatch.dispatch_parity_batch(codec, units)))
    assert [(a, b) for a, b, _ in blocks] == [(0, 3)]
    host = np.zeros((3, 4, 100), dtype=np.uint8)
    assert [(a, b) for a, b, _ in dispatch.unit_parity_shards(host)] == \
        [(0, 3)]


def test_ragged_batch_leaves_the_last_positions_empty():
    """With a pooled slot a ragged last batch fills positions in order:
    a position with no unit launches nothing (the port's ragged rule)."""
    enc = pmesh.FleetUnitEncoder(rs.get_code(10, 4),
                                 pmesh.make_mesh(devices=["cpu"] * 4,
                                                 axis_names=("unit",)))
    U = enc.unit_slots(8)
    slot = enc.empty_slot(U, 64)
    assert U == 8 and [t.shape for t in slot] == [(2, 10, 64)] * 4
    units = np.random.default_rng(6).integers(0, 256, (5, 10, 64),
                                              dtype=np.uint8)
    placed = enc.place(units, slot)
    assert [s.index for s in placed.shards] == \
        [(slice(0, 2),), (slice(2, 4),), (slice(4, 5),)]
    par = enc.encode_parity_batch(placed).numpy()
    code = ref_rs.get_code(10, 4)
    for u in range(5):
        assert np.array_equal(par[u], code.encode_numpy(units[u])[10:])
    with pytest.raises(ValueError, match="do not split"):
        enc.place(units)


@pytest.mark.parametrize("value", ["mesh", "fleet", "cuda", "native",
                                   "bogus", None])
def test_convert_codec_knob(monkeypatch, value):
    """WEEDTPU_CONVERT_CODEC: mesh and fleet build the unit encoder over
    the positions `device` names, cuda and native the EC codec of that
    kind, unset the EC codec on one named device; any other value raises
    (kept difference, ROADMAP 3: the reference hands it to its EC codec's
    selection, whose last resort takes anything)."""
    if value is None:
        monkeypatch.delenv("WEEDTPU_CONVERT_CODEC", raising=False)
    else:
        monkeypatch.setenv("WEEDTPU_CONVERT_CODEC", value)
    monkeypatch.delenv("WEEDTPU_EC_CODEC", raising=False)
    if value in ("mesh", "fleet"):
        got = fleet_convert.fleet_codec(device=CPU8)
        assert isinstance(got, pmesh.FleetUnitEncoder)
        assert got.n_devices == 8 and got is fleet_convert.fleet_codec(
            device=CPU8)
        one = fleet_convert.fleet_codec(device="cpu")
        assert one.n_devices == 1 and one.unit_slots(4) == 4
    elif value == "cuda" or value is None:
        got = fleet_convert.fleet_codec(device="cpu")
        assert got is gf_cuda.get_codec(10, 4, device="cpu")
    elif value == "native":
        assert fleet_convert.fleet_codec() is native_codec.get_codec(10, 4)
    else:
        with pytest.raises(ValueError, match="WEEDTPU_CONVERT_CODEC"):
            fleet_convert.fleet_codec(device="cpu")
        assert ref_fleet.fleet_codec() is not None  # takes anything


def test_convert_through_the_knob_equals_the_one_device_fleet(tmp_path,
                                                             monkeypatch):
    """convert_volumes with WEEDTPU_CONVERT_CODEC=mesh on one position
    writes the bytes of the default fleet."""
    geom = dict(large_block=10_000, small_block=100, batch_size=1000)
    out = {}
    for who in ("mesh", "default"):
        os.makedirs(tmp_path / who)
        bases = _make_volumes(tmp_path / who, [120_000, 3_333])
        if who == "mesh":
            monkeypatch.setenv("WEEDTPU_CONVERT_CODEC", "mesh")
        else:
            monkeypatch.delenv("WEEDTPU_CONVERT_CODEC", raising=False)
        st: dict = {}
        fleet_convert.convert_volumes(bases, device="cpu", stats=st, **geom)
        assert st["unit_batch"] == 4
        out[who] = [_shard_files(b) for b in bases]
    assert out["mesh"] == out["default"]


# ---- the dry run and the entry ----------------------------------------------

def _reference_dryrun(n_devices):
    """The reference's dry run, step for step on its 8 devices, keeping
    what it computes (its own `dryrun_multichip` returns nothing)."""
    code = ref_rs.get_code(10, 4)
    rng = np.random.default_rng(1)
    out = {}

    def run_mesh(vol_dim, col_dim):
        mesh = ref_mesh.make_mesh(vol_dim * col_dim, ("vol", "col"),
                                  shape=(vol_dim, col_dim))
        enc = ref_mesh.ShardedRSEncoder(code, mesh, col_axis="col",
                                        vol_axis="vol")
        V, n = 2 * vol_dim, col_dim * 512
        vols = rng.integers(0, 256, (V, 10, n), dtype=np.uint8)
        placed = np.asarray(enc.encode_batch_place(vols))
        survivors = {i: placed[0][i] for i in range(14) if i not in (2, 12)}
        rebuilt = np.asarray(enc.reconstruct(survivors)[2])
        out[(vol_dim, col_dim)] = {"volumes": vols, "placed": placed,
                                   "rebuilt": rebuilt}

    vol_dim = max(1, n_devices // 2)
    run_mesh(vol_dim, n_devices // vol_dim)
    if n_devices >= 6 and (vol_dim, n_devices // vol_dim) != (3, 2):
        run_mesh(3, 2)
    return out


def test_dryrun_multichip_equals_reference(device_mesh_devices):
    import __graft_entry__
    __graft_entry__.dryrun_multichip(8)  # the reference's own asserts
    got = dryrun.dryrun_multichip(8, devices=CPU8)
    want = _reference_dryrun(8)
    assert sorted(got) == sorted(want) == [(3, 2), (4, 2)]
    for shape in want:
        for key in ("volumes", "placed", "rebuilt"):
            assert np.array_equal(got[shape][key], want[shape][key]), \
                (shape, key)


def test_entry_equals_reference():
    import __graft_entry__
    fn, (example,) = dryrun.entry(device="cpu")
    ref_fn, (ref_example,) = __graft_entry__.entry()
    assert np.array_equal(example.numpy(), np.asarray(ref_example))
    out = fn(example)
    assert tuple(out.shape) == (14, 65536) and out.dtype == torch.uint8
    assert np.array_equal(out.numpy(), np.asarray(ref_fn(ref_example)))


def test_parity_mismatch_and_scrub_under_mesh(tmp_path, monkeypatch):
    """The scrub seam (`dispatch.parity_mismatch`) and a syndrome scan run
    through the mesh codec, as the reference's do through its."""
    from seaweedfs_tpu_torch.maintenance import scrub
    from seaweedfs_tpu_torch.storage.ec import ec_volume
    codec = pmesh.ShardedRSEncoder(rs.get_code(10, 4), _port_mesh())
    rng = np.random.default_rng(23)
    data = rng.integers(0, 256, (10, 4099), dtype=np.uint8)
    parity = gf.gf_matmul(codec.code.parity_matrix, data)
    bad = parity[1].copy()
    bad[7] ^= 1
    got = dispatch.parity_mismatch(codec, data, {0: parity[0], 1: bad})
    assert not got[0].any() and np.flatnonzero(got[1]).tolist() == [7]
    monkeypatch.setenv("WEEDTPU_EC_CODEC", "mesh")
    base = str(tmp_path / "1")
    with open(base + ".dat", "wb") as f:
        f.write(rng.integers(0, 256, 50_000, dtype=np.uint8).tobytes())
    ec_files.write_ec_files(base, large_block=10_000, small_block=100,
                            device=CPU8)
    open(base + ".ecx", "wb").close()
    ev = ec_volume.EcVolume(base, 10_000, 100, device=CPU8)
    try:
        assert isinstance(ev.codec, pmesh.ShardedRSEncoder)
        monkeypatch.setattr(scrub, "DEFAULT_WINDOW", 512)
        assert scrub.syndrome_scan(ev) == []
    finally:
        ev.close()
