"""The port's host write engine (seaweedfs_tpu_torch/storage/aio.py) and
the writer layer over it (ec_files' _ShardWriterPool, _ShardFlusher and
the FLUSH nudge) held against the JAX package's, byte for byte.

Case for case after tests/test_aio.py: the engine's own contracts (the
aligned split, the deferred unaligned tail, registered buffers, mode
resolution), then encode, rebuild and fleet conversion in every mode
(`WEEDTPU_AIO` x `WEEDTPU_AIO_DIRECT`), each against the reference's
files written in the same mode.  The port runs on the CPU: its plain
codec (`device="cpu"`) and its native host codec; the reference runs its
native codec.  Ring cases skip, with the reason, where this host's
io_uring probe fails; a filesystem that refuses O_DIRECT shows as the
EINVAL latch, as in tests/test_aio.py.  Also pinned: the port's two
deviations (an unknown `WEEDTPU_AIO`, `buffered` among them, and a
forced `uring` that cannot have its ring raise), the `buffered` mode a
platform without os.pwritev resolves to by itself, and the batcher's
byte-count knob.
"""

import errno
import fcntl
import os
import threading

import numpy as np
import pytest

from seaweedfs_tpu.ops import fleet_convert as ref_fleet
from seaweedfs_tpu.ops import native_codec as ref_native_codec
from seaweedfs_tpu.storage import aio as ref_aio
from seaweedfs_tpu.storage.ec import ec_files as ref_ec

from seaweedfs_tpu_torch.ops import fleet_convert, native_codec
from seaweedfs_tpu_torch.storage import aio
from seaweedfs_tpu_torch.storage.ec import ec_files, layout

MODES = aio.MODES
# (WEEDTPU_AIO, WEEDTPU_AIO_DIRECT): O_DIRECT is opt-in, so the aligned
# split and the deferred tail get a column of their own
CONFIGS = [(m, "0") for m in MODES] + [("uring", "1")]
CONFIG_IDS = [f"{m}{'+direct' if d == '1' else ''}" for m, d in CONFIGS]
# tests/test_aio.py's geometry (1 KiB units: shards not a multiple of
# 4096), and one of 4 KiB units, whose aligned runs can go out O_DIRECT
GEOMS = {"small": dict(large_block=16384, small_block=1024, batch_size=8192),
         "aligned": dict(large_block=65536, small_block=4096,
                         batch_size=4096)}
SIZES = [100_001, 3 * 4096 * 10]

needs_ring = pytest.mark.skipif(not aio.probe_uring(),
                                reason="io_uring unavailable on this host")


@pytest.fixture(scope="module", autouse=True)
def _fresh_native_codec():
    """The native codec is one cached instance per process, and the
    decoders it caches outlive a test: this module leaves a new one to
    the files run after it in the same process."""
    yield
    native_codec.get_codec.cache_clear()


@pytest.fixture(autouse=True)
def _fresh_probe():
    """The probes cache process-wide; a test that patches them or forces
    a mode must not leak its verdict."""
    aio._reset_probe_cache()
    ref_aio._reset_probe_cache()
    yield
    aio._reset_probe_cache()
    ref_aio._reset_probe_cache()


def _set_mode(mp, mode, direct="0"):
    mp.setenv("WEEDTPU_AIO", mode)
    mp.setenv("WEEDTPU_AIO_DIRECT", direct)


def _skip_without_ring(mode):
    if mode == "uring" and not aio.probe_uring():
        pytest.skip("io_uring unavailable on this host")


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _shards(base):
    return [_read(base + layout.to_ext(i)) for i in range(14)]


# ---- the engine -------------------------------------------------------------

def test_aligned_empty_is_aligned():
    buf = aio.aligned_empty((4, 8192))
    assert aio._buf_addr(buf) % aio.ALIGN == 0
    # rows stay aligned when the stride is a multiple of ALIGN
    assert aio._buf_addr(buf[2]) % aio.ALIGN == 0
    # ec_files re-exports the engine's primitives it calls
    assert ec_files._aligned_empty is aio.aligned_empty
    assert ec_files._pwrite_all is aio._pwrite_all


@pytest.mark.parametrize("mode,direct", CONFIGS, ids=CONFIG_IDS)
def test_writev_modes_equal_reference_with_ragged_tail(tmp_path, monkeypatch,
                                                       mode, direct):
    """One aligned registered run plus a 777-byte tail, then 300 bytes at
    an odd offset, through the port's engine and the reference's: the
    same file in every mode, 1 MiB + 1090 bytes (not a 4096 multiple)."""
    _skip_without_ring(mode)
    _set_mode(monkeypatch, mode, direct)
    rng = np.random.default_rng(5)
    body = aio.aligned_empty((1, 1024 * 1024))[0]
    body[:] = rng.integers(0, 256, body.shape, dtype=np.uint8)
    tail = rng.integers(0, 256, 777, dtype=np.uint8)
    odd = rng.integers(0, 256, 300, dtype=np.uint8)
    got = {}
    for who, mod in (("port", aio), ("ref", ref_aio)):
        p = str(tmp_path / who)
        fd = os.open(p, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            eng = mod.WriteEngine(reg=[body])
            assert eng.mode == mod.engine_mode() == mode
            eng.writev(fd, [body, tail], 0)
            eng.writev(fd, [odd], body.nbytes + tail.nbytes + 13)
            eng.drain()
            eng.close()
        finally:
            os.close(fd)
        got[who] = _read(p)
    want = body.tobytes() + tail.tobytes() + b"\0" * 13 + odd.tobytes()
    assert got["port"] == got["ref"] == want
    assert len(want) % aio.ALIGN


@needs_ring
def test_auto_resolves_ring_only_with_direct(monkeypatch):
    """`auto` takes the ring only when O_DIRECT gives its completions
    device latency to hide; an explicit `uring` always engages; the
    reference resolves every case the same."""
    for req, direct, want in ((None, "0", "pwritev"), (None, "1", "uring"),
                              ("uring", "0", "uring")):
        if req is None:
            monkeypatch.delenv("WEEDTPU_AIO", raising=False)
        else:
            monkeypatch.setenv("WEEDTPU_AIO", req)
        monkeypatch.setenv("WEEDTPU_AIO_DIRECT", direct)
        assert aio.engine_mode() == ref_aio.engine_mode() == want
    info = aio.engine_info()
    assert info == ref_aio.engine_info()
    assert info["requested"] == "uring" and info["uring_available"]


@pytest.mark.parametrize("knob,value,ref_reads", [
    ("WEEDTPU_AIO", "io_uring", "auto"),
    ("WEEDTPU_AIO", "direct", "auto"),
    ("WEEDTPU_AIO", "buffered", "buffered"),
    ("WEEDTPU_AIO_DIRECT", "yes", None)])
def test_malformed_knob_raises(tmp_path, monkeypatch, knob, value, ref_reads):
    """Deviation 1: an unknown mode (the reference's `buffered` too) or a
    malformed direct flag raises ValueError naming the variable, at the
    encode's start, with no shard file left; the reference takes an
    unknown mode as auto."""
    monkeypatch.setenv(knob, value)
    if ref_reads is not None:
        assert ref_aio.requested_mode() == ref_reads
    with pytest.raises(ValueError, match=knob):
        aio.WriteEngine()
    base = str(tmp_path / "v")
    np.zeros(5000, np.uint8).tofile(base + ".dat")
    with pytest.raises(ValueError, match=knob):
        ec_files.write_ec_files(base, device="cpu", **GEOMS["small"])
    assert sorted(os.listdir(tmp_path)) == ["v.dat"]


def test_forced_uring_without_probe_raises(tmp_path, monkeypatch, capsys):
    """Deviation 2: a forced `uring` on a host whose probe fails raises
    (the reference warns and writes with pwritev); under auto the probe
    failure just means pwritev, silently, in both packages."""
    monkeypatch.setattr(aio, "probe_uring", lambda: False)
    monkeypatch.setattr(ref_aio, "probe_uring", lambda: False)
    monkeypatch.setenv("WEEDTPU_AIO", "uring")
    with pytest.raises(RuntimeError, match="probe failed"):
        aio.engine_mode()
    assert ref_aio.engine_mode() == "pwritev"
    assert "io_uring" in capsys.readouterr().err
    base = str(tmp_path / "v")
    np.zeros(5000, np.uint8).tofile(base + ".dat")
    with pytest.raises(RuntimeError, match="probe failed"):
        ec_files.write_ec_files(base, device="cpu", **GEOMS["small"])
    assert sorted(os.listdir(tmp_path)) == ["v.dat"]
    monkeypatch.delenv("WEEDTPU_AIO")
    monkeypatch.setenv("WEEDTPU_AIO_DIRECT", "1")
    assert aio.engine_mode() == ref_aio.engine_mode() == "pwritev"
    info = aio.engine_info()
    assert info["mode"] == "pwritev" and not info["uring_available"]
    assert capsys.readouterr().err == ""


@needs_ring
@pytest.mark.parametrize("forced", [True, False], ids=["forced", "auto"])
def test_ring_setup_failure(tmp_path, monkeypatch, forced):
    """A worker whose ring cannot be set up where the probe passed: a
    forced `uring` raises and leaves no shard file; under auto (with
    direct) every such engine degrades alone to pwritev, the stats say
    so, and the shards equal the reference's."""
    assert aio.probe_uring()  # cached before the ring breaks
    if forced:
        _set_mode(monkeypatch, "uring")
    else:
        monkeypatch.delenv("WEEDTPU_AIO", raising=False)
        monkeypatch.setenv("WEEDTPU_AIO_DIRECT", "1")

    def no_ring(depth):
        raise OSError(errno.EMFILE, "io_uring_setup failed")

    monkeypatch.setattr(aio, "_Ring", no_ring)
    base = str(tmp_path / "v")
    np.random.default_rng(3).integers(0, 256, 100_001, dtype=np.uint8) \
        .tofile(base + ".dat")
    st: dict = {}
    if forced:
        with pytest.raises(RuntimeError, match="io_uring setup failed"):
            ec_files.write_ec_files(base, device="cpu", stats=st,
                                    **GEOMS["small"])
        assert sorted(os.listdir(tmp_path)) == ["v.dat"]
        return
    ec_files.write_ec_files(base, device="cpu", stats=st, **GEOMS["small"])
    assert st["aio_mode"] == "pwritev"
    assert st["aio_degraded_engines"] == ec_files._writer_threads(14)
    assert "aio_direct_bytes" not in st
    monkeypatch.undo()
    ref = str(tmp_path / "r")
    os.link(base + ".dat", ref + ".dat")
    monkeypatch.setenv("WEEDTPU_EC_CODEC", "cpp")
    ref_ec.write_ec_files(ref, **GEOMS["small"])
    assert _shards(base) == _shards(ref)


@needs_ring
def test_engine_writes_identical_after_fallback(tmp_path, monkeypatch):
    """The degraded engine is not a different writer, only a slower one:
    auto + direct on a host whose probe fails (pwritev) writes the bytes
    a forced ring writes."""
    data = np.random.default_rng(9).integers(0, 256, 256 * 1024 + 999,
                                             dtype=np.uint8)

    def write(name):
        p = str(tmp_path / name)
        fd = os.open(p, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            eng = aio.WriteEngine()
            eng.writev(fd, [data], 0)
            eng.drain()
            eng.close()
        finally:
            os.close(fd)
        return eng.mode, _read(p)

    _set_mode(monkeypatch, "uring")
    ring = write("ring")
    monkeypatch.delenv("WEEDTPU_AIO")
    monkeypatch.setenv("WEEDTPU_AIO_DIRECT", "1")
    monkeypatch.setattr(aio, "probe_uring", lambda: False)
    fallback = write("fallback")
    assert ring == ("uring", data.tobytes())
    assert fallback == ("pwritev", data.tobytes())


@needs_ring
def test_odirect_is_opt_in_and_engages_on_aligned_runs(tmp_path, monkeypatch):
    """Aligned runs ride the page cache by default (direct_bytes 0);
    WEEDTPU_AIO_DIRECT=1 routes them around it, registered, as WRITE_FIXED;
    the reference counts the same bytes."""
    body = aio.aligned_empty((1, 256 * 1024))[0]
    body[:] = 3

    def run(mod, direct):
        _set_mode(monkeypatch, "uring", direct)
        p = str(tmp_path / f"{mod.__name__}{direct}")
        fd = os.open(p, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            eng = mod.WriteEngine(reg=[body])
            eng.writev(fd, [body], 0)
            eng.drain()
            got = (eng.direct_bytes, eng.fixed_bytes)
            eng.close()
        finally:
            os.close(fd)
        assert _read(p) == body.tobytes()
        return got

    assert run(aio, "0") == run(ref_aio, "0") == (0, body.nbytes)
    got = run(aio, "1")
    assert got == run(ref_aio, "1")
    if got[0] == 0:
        pytest.skip("filesystem refused O_DIRECT (the EINVAL latch took it)")
    assert got == (body.nbytes, body.nbytes)


@needs_ring
def test_uring_engages_ring_without_direct(tmp_path, monkeypatch):
    """A forced ring without O_DIRECT still submits every run as SQEs
    (aligned or not) and reaps them at drain: nothing is parked in the
    deferred synchronous tail list."""
    _set_mode(monkeypatch, "uring", "0")
    body = aio.aligned_empty((1, 256 * 1024))[0]
    body[:] = 7
    tail = np.full(777, 9, dtype=np.uint8)
    p = str(tmp_path / "ring")
    fd = os.open(p, os.O_RDWR | os.O_CREAT, 0o644)
    try:
        eng = aio.WriteEngine(reg=[body])
        assert eng.mode == "uring" and eng._ring is not None
        eng.writev(fd, [body], 0)
        assert not eng._tails
        assert eng._ring.inflight == 1 and len(eng._pending) == 1
        eng.writev(fd, [tail], body.nbytes)
        assert not eng._tails and eng._ring.inflight == 2
        eng.drain()
        assert eng.wbytes == body.nbytes + tail.nbytes
        assert eng.fixed_bytes == body.nbytes  # registered: WRITE_FIXED
        assert eng.direct_bytes == 0
        eng.close()
    finally:
        os.close(fd)
    assert _read(p) == body.tobytes() + tail.tobytes()


def test_odirect_einval_latch_rescues_all_inflight_runs(tmp_path):
    """Every in-flight direct run that completes with -EINVAL is
    rewritten buffered, not only the first (which already un-latched the
    fd)."""
    a = aio.aligned_empty(aio.ALIGN)
    a[:] = 1
    b = aio.aligned_empty(aio.ALIGN)
    b[:] = 2
    p = str(tmp_path / "latch")
    fd = os.open(p, os.O_RDWR | os.O_CREAT, 0o644)
    try:
        eng = aio.WriteEngine(mode="pwritev")  # _complete needs no ring
        eng._direct_fds.add(fd)
        eng._pending[1] = (aio._OP_WRITEV, fd, [a], 0, a.nbytes,
                           None, 0, True)
        eng._pending[2] = (aio._OP_WRITEV, fd, [b], aio.ALIGN, b.nbytes,
                           None, 0, True)
        eng._complete(1, -errno.EINVAL)  # latches the fd buffered
        eng._complete(2, -errno.EINVAL)  # rewrites too, does not raise
        assert fd in eng._no_direct_fds
        assert eng.wbytes == a.nbytes + b.nbytes and eng.direct_bytes == 0
        eng.close()
    finally:
        os.close(fd)
    assert _read(p) == a.tobytes() + b.tobytes()


@needs_ring
def test_fcntl_refusing_odirect_latches_the_fd(tmp_path, monkeypatch):
    """A filesystem that refuses the O_DIRECT flag itself (fcntl EINVAL,
    as tmpfs did before Linux 6.6) latches that fd buffered: its runs go
    out as plain ring writes, no direct byte is counted, and the file is
    the one a direct-capable filesystem gets."""
    _set_mode(monkeypatch, "uring", "1")

    def refuse(self, fd):
        raise OSError(errno.EINVAL, "Invalid argument")

    monkeypatch.setattr(aio.WriteEngine, "_set_direct", refuse)
    body = aio.aligned_empty((2, aio.ALIGN))
    body[:] = 8
    tail = np.full(777, 1, dtype=np.uint8)
    p = str(tmp_path / "nodirect")
    fd = os.open(p, os.O_RDWR | os.O_CREAT, 0o644)
    try:
        eng = aio.WriteEngine()
        eng.writev(fd, [body[0], tail], 0)
        assert fd in eng._no_direct_fds and not eng._tails
        eng.writev(fd, [body[1]], 2 * aio.ALIGN)
        eng.drain()
        assert eng.direct_bytes == 0
        assert eng.wbytes == 2 * aio.ALIGN + 777
        eng.close()
    finally:
        os.close(fd)
    assert _read(p) == body[0].tobytes() + tail.tobytes() + \
        b"\0" * (aio.ALIGN - 777) + body[1].tobytes()


@needs_ring
def test_ensure_buffered_flushes_deferred_tails(tmp_path, monkeypatch):
    """The barrier before non-engine I/O on an fd writes out the fd's
    deferred tails and drops O_DIRECT, so a copy_file_range after it
    lands over fully ordered writes."""
    _set_mode(monkeypatch, "uring", "1")
    body = aio.aligned_empty(aio.ALIGN)
    body[:] = 4
    tail = np.full(777, 5, dtype=np.uint8)  # unaligned: deferred
    p = str(tmp_path / "barrier")
    fd = os.open(p, os.O_RDWR | os.O_CREAT, 0o644)
    try:
        eng = aio.WriteEngine()
        assert eng.mode == "uring"
        eng.writev(fd, [body, tail], 0)
        assert eng._tails  # parked for the buffered write after the ring
        eng.ensure_buffered(fd)
        assert not eng._tails and eng._ring.inflight == 0
        assert not fcntl.fcntl(fd, fcntl.F_GETFL) & os.O_DIRECT
        assert os.pread(fd, aio.ALIGN + 777, 0) == \
            body.tobytes() + tail.tobytes()
        eng.drain()
        eng.close()
    finally:
        os.close(fd)


# ---- the writers under encode, rebuild and fleet conversion -----------------

def _make_dat(base, size, seed=42):
    np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8) \
        .tofile(base + ".dat")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's native encode of each size and geometry, and its
    rebuild of shards 3 and 12, in every mode: {(config, geom, size):
    shards}."""
    out = {}
    root = tmp_path_factory.mktemp("ref_modes")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WEEDTPU_EC_CODEC", "cpp")
        mp.setenv("WEEDTPU_EC_PIPELINE", "pipelined")
        for (mode, direct), cid in zip(CONFIGS, CONFIG_IDS):
            if mode == "uring" and not ref_aio.probe_uring():
                continue
            _set_mode(mp, mode, direct)
            ref_aio._reset_probe_cache()
            for gname, geom in GEOMS.items():
                for size in SIZES:
                    base = str(root / f"{cid}_{gname}_{size}")
                    _make_dat(base, size)
                    st: dict = {}
                    ref_ec.write_ec_files(base, stats=st, **geom)
                    assert st["aio_mode"] == mode
                    enc = _shards(base)
                    for i in (3, 12):
                        os.remove(base + layout.to_ext(i))
                    ref_ec.rebuild_ec_files(base,
                                            batch_size=geom["batch_size"])
                    assert _shards(base) == enc
                    out[(cid, gname, size)] = enc
    return out


@pytest.mark.parametrize("codec", ["cpu", "native"])
@pytest.mark.parametrize("gname", sorted(GEOMS))
@pytest.mark.parametrize("mode,direct", CONFIGS, ids=CONFIG_IDS)
def test_encode_rebuild_equal_reference_across_modes(tmp_path, monkeypatch,
                                                     reference, mode, direct,
                                                     gname, codec):
    """write_ec_files and rebuild_ec_files of the port (the plain codec
    on the CPU, staged rebuild; the native codec, host-serial rebuild)
    write the reference's shards in every mode, for a ragged 100 001-byte
    volume and a 3 x 4096 x 10 one; the stats name the mode and, for the
    native codec's aligned ring under direct, the O_DIRECT bytes."""
    _skip_without_ring(mode)
    _set_mode(monkeypatch, mode, direct)
    cid = CONFIG_IDS[CONFIGS.index((mode, direct))]
    kw = {"device": "cpu"}
    if codec == "native":
        monkeypatch.setenv("WEEDTPU_EC_CODEC", "native")
        kw = {}
    geom = GEOMS[gname]
    for size in SIZES:
        base = str(tmp_path / f"v{size}")
        _make_dat(base, size)
        st: dict = {}
        ec_files.write_ec_files(base, stats=st, **geom, **kw)
        assert st["aio_mode"] == mode
        assert "aio_degraded_engines" not in st
        assert 0.0 <= st["overlap_frac"] <= 1.0
        assert _shards(base) == reference[(cid, gname, size)], size
        if codec == "native" and gname == "aligned" and direct == "1":
            # the registered parity ring's 4 KiB rows; 0 where the
            # filesystem refused O_DIRECT and the latch rewrote them
            assert st.get("aio_direct_bytes", 0) in (0, 4 * 4096 * 3)
        for i in (3, 12):
            os.remove(base + layout.to_ext(i))
        rst: dict = {}
        assert ec_files.rebuild_ec_files(base, batch_size=geom["batch_size"],
                                         stats=rst, **kw) == [3, 12]
        assert rst["mode"] == ("host-serial" if codec == "native"
                               else "staged")
        assert rst["aio_mode"] == mode and "overlap_frac" in rst
        assert _shards(base) == reference[(cid, gname, size)], size
        assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]


@pytest.mark.parametrize("mode,direct", CONFIGS, ids=CONFIG_IDS)
def test_fleet_equals_reference_across_modes(tmp_path, monkeypatch, mode,
                                             direct):
    """convert_volumes of the port over the two sizes (tests/test_aio.py's
    fleet geometry, and the 4 KiB one) writes the reference fleet's
    shards in every mode."""
    _skip_without_ring(mode)
    _set_mode(monkeypatch, mode, direct)
    for gname, geom in (("fleet", dict(large_block=10_000, small_block=100,
                                       batch_size=1000)),
                        ("aligned", GEOMS["aligned"])):
        out = {}
        for who in ("port", "ref"):
            d = tmp_path / f"{gname}_{who}"
            d.mkdir()
            bases = []
            for v, size in enumerate(SIZES):
                bases.append(str(d / str(v + 1)))
                _make_dat(bases[-1], size, seed=v)
            st: dict = {}
            if who == "port":
                fleet_convert.convert_volumes(bases, device="cpu", stats=st,
                                              **geom)
                assert st["aio_mode"] == mode
                assert st["overlap_frac"] == ec_files.overlap_fraction(st)
            else:
                ref_fleet.convert_volumes(
                    bases, codec=ref_native_codec.get_codec(10, 4), **geom)
            out[who] = [_shards(b) + [_read(b + ".vif")] for b in bases]
        assert out["port"] == out["ref"], gname


@pytest.mark.parametrize("req", [None, "pwritev"], ids=["auto", "pwritev"])
def test_no_pwritev_resolves_buffered(tmp_path, monkeypatch, reference, req):
    """A platform without os.pwritev resolves the synchronous mode to
    `buffered` by itself, as the reference does (one pwrite per buffer),
    and the stats say so; the shards are the reference's."""
    monkeypatch.delattr(os, "pwritev")
    if req is None:
        monkeypatch.delenv("WEEDTPU_AIO", raising=False)
    else:
        monkeypatch.setenv("WEEDTPU_AIO", req)
    assert aio.engine_mode() == ref_aio.engine_mode() == "buffered"
    base = str(tmp_path / "v")
    _make_dat(base, SIZES[0])
    st: dict = {}
    ec_files.write_ec_files(base, device="cpu", stats=st, **GEOMS["small"])
    assert st["aio_mode"] == "buffered" and "aio_degraded_engines" not in st
    assert _shards(base) == reference[("pwritev", "small", SIZES[0])]


@pytest.mark.parametrize("mode", ["pwritev", "uring"])
def test_staged_rebuild_copies_rows_only_for_the_ring(tmp_path, monkeypatch,
                                                      reference, mode):
    """A staged rebuild hands the decoded rows to synchronous writers as
    they are; only a ring engine gets them copied into the registered
    output ring (WRITE_FIXED).  The rebuilt shards are the reference's
    either way."""
    _skip_without_ring(mode)
    _set_mode(monkeypatch, mode)
    geom = GEOMS["small"]
    base = str(tmp_path / "v")
    _make_dat(base, SIZES[0])
    ec_files.write_ec_files(base, device="cpu", **geom)
    decoded, written = [], []
    orig_rec, orig_put = ec_files._reconstruct_batch, \
        ec_files._ShardWriterPool.put

    def rec(*a, **kw):
        out = orig_rec(*a, **kw)
        decoded.extend(out.values())
        return out

    def put(self, shard, data, off, release=None):
        written.append((data, release))
        return orig_put(self, shard, data, off, release)

    monkeypatch.setattr(ec_files, "_reconstruct_batch", rec)
    monkeypatch.setattr(ec_files._ShardWriterPool, "put", put)
    for i in (3, 12):
        os.remove(base + layout.to_ext(i))
    ec_files.rebuild_ec_files(base, batch_size=geom["batch_size"],
                              device="cpu")
    assert written and decoded
    as_is = [any(d is r for r in decoded) for d, _ in written]
    released = [rel is not None for _, rel in written]
    if mode == "pwritev":
        assert all(as_is) and not any(released)
    else:
        assert not any(as_is) and all(released)
    assert _shards(base) == reference[("pwritev", "small", SIZES[0])]


@needs_ring
def test_fleet_crash_leaves_no_shard_set_under_uring(tmp_path, monkeypatch):
    """A failure mid-stream leaves no partial shard set and no .tmp: the
    staging and abort hold under the ring's async writes."""
    _set_mode(monkeypatch, "uring")
    bases = []
    for v in range(2):
        bases.append(str(tmp_path / f"c{v}"))
        _make_dat(bases[-1], 120_000, seed=v)
    orig = fleet_convert.dispatch_parity_batch
    calls = {"n": 0}

    def failing(codec, units, staging=None):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise RuntimeError("injected mid-convert failure")
        return orig(codec, units, staging)

    monkeypatch.setattr(fleet_convert, "dispatch_parity_batch", failing)
    with pytest.raises(RuntimeError, match="injected"):
        fleet_convert.convert_volumes(bases, device="cpu", large_block=10_000,
                                      small_block=100, batch_size=1000)
    assert sorted(os.listdir(tmp_path)) == ["c0.dat", "c1.dat"]


def test_fleet_drain_flushes_each_batch(tmp_path, monkeypatch):
    """The drain ships the parity of the volumes a batch touched as soon
    as the batch is on the host (a parity flush lands between two
    batches' D2H), not at the next flush group, and the shards still
    equal write_ec_files'."""
    log: list = []
    orig_blocks = fleet_convert.unit_parity_shards
    orig_flush = ec_files._ShardFlusher.flush

    def logged_blocks(parity):
        for block in orig_blocks(parity):  # one block: one card
            log.append("d2h")
            yield block

    def logged_flush(self):
        if any(self._jobs) and threading.current_thread().name == \
                "fleet-drain":
            log.append("flush")
        return orig_flush(self)

    monkeypatch.setattr(fleet_convert, "unit_parity_shards", logged_blocks)
    monkeypatch.setattr(ec_files._ShardFlusher, "flush", logged_flush)
    geom = dict(large_block=10_000, small_block=100, batch_size=1000)
    bases = []
    for v in range(2):
        bases.append(str(tmp_path / f"s{v}"))
        _make_dat(bases[-1], 60_000, seed=v)
    fleet_convert.convert_volumes(bases, device="cpu", **geom)
    d2h = [i for i, e in enumerate(log) if e == "d2h"]
    assert len(d2h) >= 4
    assert all("flush" in log[a:b] for a, b in zip(d2h, d2h[1:])), log
    monkeypatch.undo()
    for b in bases:
        ref = b + "_one"
        os.link(b + ".dat", ref + ".dat")
        ec_files.write_ec_files(ref, device="cpu", **geom)
        assert _shards(ref) == _shards(b)


# ---- the writer layer -------------------------------------------------------

@needs_ring
def test_submit_complete_stage_accounting(tmp_path, monkeypatch):
    """A ring encode publishes the engine's submit / complete split with
    its worker counts, and overlap_fraction leaves them out: they are a
    finer cut of the seconds the write stages already hold."""
    _set_mode(monkeypatch, "uring")
    base = str(tmp_path / "v")
    _make_dat(base, 300_000, seed=1)
    st: dict = {}
    ec_files.write_ec_files(base, device="cpu", stats=st, **GEOMS["small"])
    assert st["aio_mode"] == "uring"
    assert st["submit_s"] > 0 and st["complete_s"] > 0
    n = ec_files._writer_threads(14)
    assert st["submit_workers"] == st["complete_workers"] == n
    assert st["write_data_workers"] + st["write_parity_workers"] == \
        pytest.approx(n)
    frac = ec_files.overlap_fraction(st)
    assert frac == st["overlap_frac"]
    assert ec_files.overlap_fraction(
        dict(st, submit_s=99.0, complete_s=99.0)) == frac


@pytest.mark.parametrize("size", [0, 1, 999, 100_000, 100_001, 163_840,
                                  163_841, 1_000_001])
def test_unit_steps_and_ring_size_equal_reference(size):
    """_unit_steps and both branches of _parity_ring_size equal the
    reference's over a grid of layouts."""
    for geom in list(GEOMS.values()) + [
            dict(large_block=10_000, small_block=100, batch_size=1000),
            dict(large_block=1 << 30, small_block=1 << 20,
                 batch_size=16 << 20),
            dict(large_block=1 << 20, small_block=1 << 18,
                 batch_size=1 << 20)]:
        for k in (9, 10):
            steps = ec_files._unit_steps(size, **geom, data_shards=k)
            assert steps == ref_ec._unit_steps(size, **geom, data_shards=k)
            assert ec_files._parity_ring_size(*steps) == \
                ref_ec._parity_ring_size(*steps)
    assert (ec_files.FLUSH_BYTES, ec_files.DIRECT_MIN) == \
        (ref_ec.FLUSH_BYTES, ref_ec.DIRECT_MIN)


@pytest.mark.parametrize("stats", [
    {},
    {"wall_s": 1.0},
    {"wall_s": 0.0, "read_s": 1.0},
    {"wall_s": 1.0, "read_s": 0.5, "encode_s": 0.25},
    {"wall_s": 1.0, "read_s": 0.75, "encode_s": 0.5, "write_data_s": 1.5,
     "write_parity_s": 0.25, "stall_s": 9.0, "submit_s": 9.0,
     "complete_s": 9.0, "mode": "pipelined", "bytes": 5, "aio_mode": "uring",
     "write_data_workers": 3.0},
    {"wall_s": 2.5, "reconstruct_s": 1.0, "write_s": 1.0},
    {"wall_s": 0.3, "d2h_s": 0.1, "write_s": 2},
])
def test_overlap_fraction_equals_reference(stats):
    assert ec_files.overlap_fraction(stats) == \
        ref_ec.overlap_fraction(stats)


def test_byte_knobs(monkeypatch):
    """The batcher's flush group takes an integer of at least 1; a
    malformed one raises ValueError naming the variable."""
    knob, least = "WEEDTPU_EC_FLUSH_BYTES", 1
    monkeypatch.delenv(knob, raising=False)
    assert ec_files._env_bytes(knob, 7, least) == 7
    monkeypatch.setenv(knob, str(least))
    assert ec_files._env_bytes(knob, 7, least) == least
    for bad in ("8M", "1.5", str(least - 1)):
        monkeypatch.setenv(knob, bad)
        with pytest.raises(ValueError, match=knob):
            ec_files._env_bytes(knob, 7, least)


def test_flush_nudge_keeps_a_small_ring_moving(tmp_path, monkeypatch):
    """A native encode of small units whose parity ring holds one buffer
    and whose flusher never fills a flush group finishes: when the ring
    runs dry the dispatch sends FLUSH, and the drain ships the jobs whose
    releases refill it.  Without the nudge this encode never ends."""
    monkeypatch.setenv("WEEDTPU_EC_CODEC", "native")
    monkeypatch.setattr(ec_files, "FLUSH_BYTES", 1 << 40)
    monkeypatch.setattr(ec_files, "DIRECT_MIN", 1 << 40)  # batched sink
    sizes = []
    monkeypatch.setattr(ec_files, "_parity_ring_size",
                        lambda lo, hi: sizes.append((lo, hi)) or 1)
    base = str(tmp_path / "v")
    _make_dat(base, 300_000, seed=4)
    err: list = []

    def run():
        try:
            ec_files.write_ec_files(base, **GEOMS["small"])
        except BaseException as e:
            err.append(e)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout=60)
    assert not th.is_alive(), "the encode hung on its own parity ring"
    assert not err, err
    assert sizes == [(1024, 8192)]
    monkeypatch.setenv("WEEDTPU_EC_CODEC", "cpp")
    ref = str(tmp_path / "r")
    os.link(base + ".dat", ref + ".dat")
    ref_ec.write_ec_files(ref, **GEOMS["small"])
    assert _shards(base) == _shards(ref)


@pytest.mark.parametrize("mode,direct", CONFIGS, ids=CONFIG_IDS)
def test_writer_error_mid_batch_fires_every_release(tmp_path, monkeypatch,
                                                    mode, direct):
    """A write that fails in the middle of a batch (an offset past the
    filesystem's largest file) surfaces in `.errors` after close, the
    batches after it are skipped, and every release hook of that batch and
    of the later ones fires, once, after the engine drained."""
    _skip_without_ring(mode)
    _set_mode(monkeypatch, mode, direct)
    fd = os.open(str(tmp_path / "s0"), os.O_RDWR | os.O_CREAT, 0o644)
    fired = []
    lock = threading.Lock()

    def release(tag):
        def hit():
            eng = pool._engines[0]
            with lock:  # nothing of the batch is still queued or in flight
                fired.append((tag, len(eng._pending) + len(eng._tails)))
        return hit

    buf = aio.aligned_empty((8, aio.ALIGN))
    buf[:] = 6
    try:
        pool = ec_files._ShardWriterPool([fd], reg_bufs=[buf])
        pool.put_many(0, [(buf[0], None, 0, release("a0")),
                          (buf[1], None, aio.ALIGN, release("a1")),
                          (buf[2], None, 1 << 62, release("bad")),
                          (buf[3], None, 8 * aio.ALIGN, release("a3"))])
        pool.put_many(0, [(buf[4], None, 16 * aio.ALIGN, release("b0"))])
        pool.put(0, buf[5], 32 * aio.ALIGN, release=release("c0"))
        pool.close()
    finally:
        os.close(fd)
    assert pool.errors and isinstance(pool.errors[0], OSError)
    assert sorted(fired) == sorted((tag, 0) for tag in
                                   ("a0", "a1", "bad", "a3", "b0", "c0"))
    # the batches after the failing one never reached the file
    assert os.path.getsize(tmp_path / "s0") <= 9 * aio.ALIGN
