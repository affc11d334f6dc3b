"""Host write engine for shard files: io_uring through ctypes, O_DIRECT,
registered buffers.

Counterpart of `seaweedfs_tpu/storage/aio.py`, the port's own copy (numpy
and ctypes only; no torch).  The writer pool (`storage/ec/ec_files.py`,
`_ShardWriterPool`) gives each of its worker threads one `WriteEngine`;
encode, rebuild and fleet conversion write every shard byte through it.

Two modes behind one surface (`WEEDTPU_AIO=auto|uring|pwritev`):

  uring     one submission/completion ring per writer thread, driven by
            raw syscalls.  A batch of merged runs is stamped into SQEs
            and submitted with one io_uring_enter; completions are reaped
            at drain().  With `WEEDTPU_AIO_DIRECT=1`, runs whose file
            offset, buffer addresses and lengths are all ALIGN multiples
            go out with O_DIRECT (no page-cache copy); the unaligned tail
            of a shard is deferred and written buffered once the ring is
            quiet and the fd has dropped O_DIRECT.  Buffers inside a
            registered region (IORING_REGISTER_BUFFERS) go out as
            WRITE_FIXED, which skips the per-op page pinning.
  pwritev   one synchronous pwritev per merged run on the calling thread
            (on a platform without os.pwritev the mode resolves, by
            itself, to `buffered`: one pwrite per buffer).

`auto` uses the ring only when `WEEDTPU_AIO_DIRECT=1` and the probe
passes (a page-cache write completes inside the syscall, so the ring has
no device latency to hide), else pwritev.

Two deviations from the reference, by the port's rule that a forced or
malformed knob raises: an unknown `WEEDTPU_AIO` value (`buffered` among
them, which the reference accepts) or a malformed `WEEDTPU_AIO_DIRECT`
raises ValueError, and a forced `WEEDTPU_AIO=uring` raises RuntimeError
when the probe fails or a worker's ring cannot be set up (the reference
warns and uses pwritev).  Under `auto` the host's own limits still
degrade, each visible in the stats the writer pool folds: a worker whose
ring setup fails degrades to pwritev alone (`aio_mode`,
`aio_degraded_engines`), a filesystem that refuses O_DIRECT latches that
fd buffered and rewrites the failed run (`aio_direct_bytes` stays
short), and a failed buffer registration means plain WRITEV opcodes.

Accounting: every engine sums `submit_s` (SQE stamping, submitting
enters, and the synchronous modes' write calls) and `complete_s`
(waiting enters, CQE reaping, deferred tails); the pool folds both into
the stats next to `write_data_s` / `write_parity_s`.

Knobs: `WEEDTPU_AIO` (mode, above) and `WEEDTPU_AIO_DIRECT=1` (O_DIRECT
for aligned runs in uring mode; default off).  A ring holds DEPTH
entries per writer thread (the reference's default; no knob).
"""

from __future__ import annotations

import ctypes
import errno
import fcntl
import mmap
import os
import struct
import threading
import time

import numpy as np

# O_DIRECT wants the file offset, each buffer address and each buffer
# length aligned to the logical block size; 4096 satisfies every sane
# device and matches the page cache the direct write bypasses
ALIGN = 4096

MODES = ("uring", "pwritev")

DEPTH = 64  # ring entries per writer thread

# x86_64 / aarch64 share these numbers (asm-generic)
_NR_io_uring_setup = 425
_NR_io_uring_enter = 426
_NR_io_uring_register = 427

_IORING_OFF_SQ_RING = 0
_IORING_OFF_CQ_RING = 0x8000000
_IORING_OFF_SQES = 0x10000000

_IORING_ENTER_GETEVENTS = 1
_IORING_FEAT_SINGLE_MMAP = 1
_IORING_REGISTER_BUFFERS = 0

_OP_NOP = 0
_OP_WRITEV = 2
_OP_WRITE_FIXED = 5

_libc = ctypes.CDLL(None, use_errno=True)
_syscall = _libc.syscall
_syscall.restype = ctypes.c_long


class _SQOff(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in
                ("head", "tail", "ring_mask", "ring_entries", "flags",
                 "dropped", "array", "resv1")] + \
               [("user_addr", ctypes.c_uint64)]


class _CQOff(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in
                ("head", "tail", "ring_mask", "ring_entries", "overflow",
                 "cqes", "flags", "resv1")] + \
               [("user_addr", ctypes.c_uint64)]


class _Params(ctypes.Structure):
    _fields_ = [("sq_entries", ctypes.c_uint32),
                ("cq_entries", ctypes.c_uint32),
                ("flags", ctypes.c_uint32),
                ("sq_thread_cpu", ctypes.c_uint32),
                ("sq_thread_idle", ctypes.c_uint32),
                ("features", ctypes.c_uint32),
                ("wq_fd", ctypes.c_uint32),
                ("resv", ctypes.c_uint32 * 3),
                ("sq_off", _SQOff),
                ("cq_off", _CQOff)]


class _IoVec(ctypes.Structure):
    _fields_ = [("base", ctypes.c_uint64), ("len", ctypes.c_uint64)]


def _pwrite_all(fd: int, view, off: int) -> None:
    """pwrite may write short (RLIMIT_FSIZE edge, fs under pressure); a
    silent short write would commit a shard with a zero gap."""
    mv = memoryview(view)
    while len(mv) > 0:
        n = os.pwrite(fd, mv, off)
        if n <= 0:
            raise OSError("pwrite returned 0")
        mv = mv[n:]
        off += n


def _pwritev_all(fd: int, bufs: list, off: int) -> None:
    """Vectored pwrite of buffers destined for one contiguous file range:
    a run of per-unit parity blocks lands in a single syscall instead of
    one pwrite per unit.  Short writes (possibly mid-iovec) resume."""
    if not hasattr(os, "pwritev"):
        for b in bufs:
            _pwrite_all(fd, b, off)
            off += memoryview(b).nbytes
        return
    mvs = [memoryview(b) for b in bufs]
    while mvs:
        n = os.pwritev(fd, mvs, off)
        if n <= 0:
            raise OSError("pwritev returned 0")
        off += n
        while mvs and n >= len(mvs[0]):
            n -= len(mvs[0])
            mvs.pop(0)
        if mvs and n:
            mvs[0] = mvs[0][n:]


def aligned_empty(shape, align: int = ALIGN) -> np.ndarray:
    """np.empty whose base address is `align`-aligned: the parity rings
    and rebuild output pools allocate through this so their rows qualify
    for O_DIRECT (a row is aligned when the base is and the trailing
    dimension is an align-multiple — true for every production block
    size; tiny test volumes simply fall back to buffered writes)."""
    if isinstance(shape, int):
        shape = (shape,)
    n = 1
    for s in shape:
        n *= int(s)
    raw = np.empty(n + align, dtype=np.uint8)
    off = (-raw.ctypes.data) % align
    return raw[off:off + n].reshape(shape)


def _buf_addr(buf) -> int:
    if isinstance(buf, np.ndarray):
        return buf.ctypes.data
    mv = memoryview(buf)
    return ctypes.addressof(ctypes.c_char.from_buffer(mv))


# -- the ring --------------------------------------------------------------

class _Ring:
    """One io_uring instance: SQ/CQ mmaps, SQE stamping, batched enter.
    NOT thread-safe — each writer thread owns its own ring."""

    def __init__(self, depth: int):
        p = _Params()
        fd = _syscall(_NR_io_uring_setup, ctypes.c_uint(depth),
                      ctypes.byref(p))
        if fd < 0:
            raise OSError(ctypes.get_errno(), "io_uring_setup failed")
        self.fd = fd
        self.depth = p.sq_entries
        try:
            sq_sz = p.sq_off.array + p.sq_entries * 4
            cq_sz = p.cq_off.cqes + p.cq_entries * 16
            if p.features & _IORING_FEAT_SINGLE_MMAP:
                sz = max(sq_sz, cq_sz)
                self._sq = mmap.mmap(fd, sz, flags=mmap.MAP_SHARED,
                                     prot=mmap.PROT_READ | mmap.PROT_WRITE,
                                     offset=_IORING_OFF_SQ_RING)
                self._cq = self._sq
            else:
                self._sq = mmap.mmap(fd, sq_sz, flags=mmap.MAP_SHARED,
                                     prot=mmap.PROT_READ | mmap.PROT_WRITE,
                                     offset=_IORING_OFF_SQ_RING)
                self._cq = mmap.mmap(fd, cq_sz, flags=mmap.MAP_SHARED,
                                     prot=mmap.PROT_READ | mmap.PROT_WRITE,
                                     offset=_IORING_OFF_CQ_RING)
            self._sqes = mmap.mmap(fd, p.sq_entries * 64,
                                   flags=mmap.MAP_SHARED,
                                   prot=mmap.PROT_READ | mmap.PROT_WRITE,
                                   offset=_IORING_OFF_SQES)
        except BaseException:
            os.close(fd)
            raise
        o = p.sq_off
        self._sq_head_off, self._sq_tail_off = o.head, o.tail
        self._sq_mask = struct.unpack_from("<I", self._sq, o.ring_mask)[0]
        self._sq_array_off = o.array
        c = p.cq_off
        self._cq_head_off, self._cq_tail_off = c.head, c.tail
        self._cq_mask = struct.unpack_from("<I", self._cq, c.ring_mask)[0]
        self._cqes_off = c.cqes
        self._to_submit = 0
        self.inflight = 0

    # -- raw ring ops -----------------------------------------------------

    def _u32(self, m, off) -> int:
        return struct.unpack_from("<I", m, off)[0]

    def sq_space(self) -> int:
        head = self._u32(self._sq, self._sq_head_off)
        tail = self._u32(self._sq, self._sq_tail_off)
        return self.depth - (tail - head)

    def push(self, opcode: int, fd: int, addr: int, ln: int, off: int,
             user_data: int, buf_index: int = 0) -> None:
        """Stamp one SQE; the caller guarantees sq_space() > 0."""
        tail = self._u32(self._sq, self._sq_tail_off)
        idx = tail & self._sq_mask
        sqe = struct.pack("<BBHiQQIIQH", opcode, 0, 0, fd, off, addr, ln,
                          0, user_data, buf_index)
        self._sqes[idx * 64:idx * 64 + len(sqe)] = sqe
        self._sqes[idx * 64 + len(sqe):idx * 64 + 64] = \
            b"\0" * (64 - len(sqe))
        struct.pack_into("<I", self._sq,
                         self._sq_array_off + idx * 4, idx)
        struct.pack_into("<I", self._sq, self._sq_tail_off,
                         (tail + 1) & 0xFFFFFFFF)
        self._to_submit += 1
        self.inflight += 1

    def enter(self, min_complete: int = 0) -> None:
        flags = _IORING_ENTER_GETEVENTS if min_complete else 0
        while True:
            r = _syscall(_NR_io_uring_enter, ctypes.c_uint(self.fd),
                         ctypes.c_uint(self._to_submit),
                         ctypes.c_uint(min_complete),
                         ctypes.c_uint(flags), ctypes.c_void_p(0),
                         ctypes.c_size_t(0))
            if r >= 0:
                self._to_submit -= min(self._to_submit, int(r))
                return
            e = ctypes.get_errno()
            if e == errno.EINTR:
                continue
            raise OSError(e, "io_uring_enter failed")

    def pop(self):
        """-> (user_data, res) or None when the CQ is empty."""
        head = self._u32(self._cq, self._cq_head_off)
        tail = self._u32(self._cq, self._cq_tail_off)
        if head == tail:
            return None
        idx = head & self._cq_mask
        user_data, res = struct.unpack_from(
            "<Qi", self._cq, self._cqes_off + idx * 16)
        struct.pack_into("<I", self._cq, self._cq_head_off,
                         (head + 1) & 0xFFFFFFFF)
        self.inflight -= 1
        return user_data, res

    def register_buffers(self, arrays) -> list[tuple[int, int]]:
        """IORING_REGISTER_BUFFERS over the given numpy arrays; returns
        the [(addr, len)] regions on success, [] when the kernel refuses
        (memlock limits, too many/huge regions) — callers then just use
        plain WRITEV."""
        if not arrays:
            return []
        iov = (_IoVec * len(arrays))()
        regions = []
        for i, a in enumerate(arrays):
            addr, ln = _buf_addr(a), memoryview(a).nbytes
            iov[i].base, iov[i].len = addr, ln
            regions.append((addr, ln))
        r = _syscall(_NR_io_uring_register, ctypes.c_uint(self.fd),
                     ctypes.c_uint(_IORING_REGISTER_BUFFERS),
                     ctypes.byref(iov), ctypes.c_uint(len(arrays)))
        return regions if r == 0 else []

    def close(self) -> None:
        if self.fd >= 0:
            try:
                if self._sqes is not None:
                    self._sqes.close()
                if self._cq is not self._sq and self._cq is not None:
                    self._cq.close()
                if self._sq is not None:
                    self._sq.close()
            except (BufferError, ValueError):
                pass
            os.close(self.fd)
            self.fd = -1


# -- probe + mode resolution ----------------------------------------------

_probe_lock = threading.Lock()
_URING_OK: bool | None = None


def probe_uring() -> bool:
    """One NOP through a real ring, cached: io_uring may be compiled out,
    seccomp-filtered, or (in containers) sysctl-disabled — the probe is
    the only honest answer."""
    global _URING_OK
    with _probe_lock:
        if _URING_OK is None:
            try:
                ring = _Ring(4)
                try:
                    ring.push(_OP_NOP, -1, 0, 0, 0, 1)
                    ring.enter(min_complete=1)
                    cqe = ring.pop()
                    _URING_OK = cqe is not None and cqe[1] >= 0
                finally:
                    ring.close()
            except Exception:
                _URING_OK = False
        return _URING_OK


def _reset_probe_cache() -> None:
    """Tests: force the next probe_uring() to re-probe."""
    global _URING_OK
    with _probe_lock:
        _URING_OK = None


def requested_mode() -> str:
    """The mode WEEDTPU_AIO asks for (unset: auto); any other value
    raises ValueError (the reference takes an unknown one as auto, and
    also accepts `buffered`)."""
    mode = os.environ.get("WEEDTPU_AIO", "auto").strip().lower() or "auto"
    if mode not in MODES + ("auto",):
        raise ValueError(f"WEEDTPU_AIO={mode!r}: expected one of "
                         f"auto, {', '.join(MODES)}")
    return mode


def _sync_mode() -> str:
    return "pwritev" if hasattr(os, "pwritev") else "buffered"


def engine_mode() -> str:
    """The resolved engine mode for this process right now.

    `auto` picks the ring only when O_DIRECT is opted in: an async engine
    pays off when completions have device latency to hide, and a direct
    write has it.  A page-cache write completes at memcpy speed inside
    the syscall, and a filesystem without NOWAIT buffered writes punts
    every ring write to an io-wq worker.  A forced `uring` takes the ring
    for buffered writes too, and raises RuntimeError when the probe
    fails."""
    req = requested_mode()
    if req == "pwritev":
        return _sync_mode()
    if req == "uring":
        if not probe_uring():
            raise RuntimeError("WEEDTPU_AIO=uring, but the io_uring probe "
                               "failed on this host")
        return "uring"
    if _direct_enabled() and probe_uring():
        return "uring"
    return _sync_mode()


def engine_info() -> dict:
    """Requested vs resolved mode and the probe's verdict."""
    return {"requested": requested_mode(), "mode": engine_mode(),
            "uring_available": probe_uring(), "align": ALIGN}


def _direct_enabled() -> bool:
    """WEEDTPU_AIO_DIRECT: "1" on, unset or "0" off; anything else raises
    ValueError."""
    raw = os.environ.get("WEEDTPU_AIO_DIRECT", "").strip()
    if raw not in ("", "0", "1"):
        raise ValueError(f"WEEDTPU_AIO_DIRECT={raw!r}: expected 0 or 1")
    return raw == "1"


# -- the engine ------------------------------------------------------------

class WriteEngine:
    """Per-thread write engine: queue merged runs with writev(), finish
    them with drain().  Owned by exactly one writer thread (rings are
    not thread-safe); the synchronous modes complete inside writev() and
    drain() is a no-op for them.

    Accounting: ``submit_s`` (SQE stamping + enter()s that only submit +
    the synchronous modes' whole write calls), ``complete_s`` (enter()s
    that wait + CQE reaping + deferred-tail writes), ``wbytes`` (bytes
    fully written), ``direct_bytes`` (subset written with O_DIRECT),
    ``fixed_bytes`` (subset via registered buffers)."""

    def __init__(self, mode: str | None = None, reg=None):
        self.mode = mode or engine_mode()
        self.submit_s = 0.0
        self.complete_s = 0.0
        self.wbytes = 0
        self.direct_bytes = 0
        self.fixed_bytes = 0
        self._ring: _Ring | None = None
        self._regions: list[tuple[int, int]] = []
        self._pending: dict[int, tuple] = {}
        self._tails: list[tuple[int, list, int]] = []
        self._seq = 0
        self._direct_fds: set[int] = set()
        self._no_direct_fds: set[int] = set()
        self._errors: list[BaseException] = []
        if self.mode == "uring":
            try:
                self._ring = _Ring(DEPTH)
                if reg:
                    self._regions = self._ring.register_buffers(list(reg))
            except Exception as e:
                # a ring per thread can fail where the probe passed
                # (RLIMIT_NOFILE, memlock): a forced uring raises, auto
                # degrades this engine alone
                if requested_mode() == "uring":
                    raise RuntimeError(
                        f"WEEDTPU_AIO=uring, but a writer's io_uring "
                        f"setup failed: {e}") from e
                self._ring = None
                self.mode = _sync_mode()

    # -- O_DIRECT bookkeeping ---------------------------------------------

    def _set_direct(self, fd: int) -> None:
        if fd in self._direct_fds:
            return
        fl = fcntl.fcntl(fd, fcntl.F_GETFL)
        fcntl.fcntl(fd, fcntl.F_SETFL, fl | os.O_DIRECT)
        self._direct_fds.add(fd)

    def _try_direct(self, fd: int) -> bool:
        """Set O_DIRECT on fd; False, with the fd latched buffered, where
        the filesystem refuses the flag itself (fcntl EINVAL; the
        reference lets that error fail the write)."""
        try:
            self._set_direct(fd)
            return True
        except OSError as e:
            if e.errno != errno.EINVAL:
                raise
            self._no_direct_fds.add(fd)
            return False

    def _clear_direct(self, fd: int) -> None:
        if fd not in self._direct_fds:
            return
        fl = fcntl.fcntl(fd, fcntl.F_GETFL)
        fcntl.fcntl(fd, fcntl.F_SETFL, fl & ~os.O_DIRECT)
        self._direct_fds.discard(fd)

    def _split_aligned(self, bufs: list, off: int):
        """-> (aligned_prefix, tail_bufs, tail_off): the longest prefix
        of buffers whose file offset, address and length all stay
        ALIGN-multiples; everything after the first violation rides the
        buffered tail path (a mid-run violation breaks the offsets of
        every later buffer anyway)."""
        pre = []
        cur = off
        for i, b in enumerate(bufs):
            addr, ln = _buf_addr(b), memoryview(b).nbytes
            if cur % ALIGN or addr % ALIGN or ln % ALIGN:
                return pre, bufs[i:], cur
            pre.append((b, addr, ln))
            cur += ln
        return pre, [], cur

    def _buf_index(self, addr: int, ln: int) -> int:
        for i, (base, rlen) in enumerate(self._regions):
            if addr >= base and addr + ln <= base + rlen:
                return i
        return -1

    # -- submission --------------------------------------------------------

    def ensure_buffered(self, fd: int) -> None:
        """Barrier for non-engine I/O on fd (copy_file_range): completes
        in-flight ring writes, writes out deferred tails targeting fd,
        and drops the direct flag so the next op sees plain buffered
        semantics over fully-ordered prior writes."""
        if self._ring is None:
            return  # sync modes complete in writev(); nothing queued
        t0 = time.perf_counter()
        try:
            if self._ring.inflight:
                self._reap_all()
            self._clear_direct(fd)
            if self._tails:
                keep = []
                for tfd, tbufs, toff in self._tails:
                    if tfd != fd:
                        keep.append((tfd, tbufs, toff))
                        continue
                    _pwritev_all(tfd, tbufs, toff)
                    self.wbytes += sum(memoryview(b).nbytes
                                       for b in tbufs)
                self._tails = keep
        finally:
            self.complete_s += time.perf_counter() - t0

    def writev(self, fd: int, bufs: list, off: int) -> None:
        """Write `bufs` contiguously at `off`.  Synchronous modes finish
        here; uring queues SQEs and returns — drain() is the barrier.
        The caller keeps the buffers alive until drain() returns."""
        t0 = time.perf_counter()
        if self._ring is None:
            try:
                _pwritev_all(fd, bufs, off)  # pwrite by pwrite without pwritev
                self.wbytes += sum(memoryview(b).nbytes for b in bufs)
            finally:
                self.submit_s += time.perf_counter() - t0
            return
        try:
            direct = _direct_enabled() and fd not in self._no_direct_fds
            if direct:
                # O_DIRECT classification: only the aligned prefix may
                # carry the flag; the unaligned tail is deferred to a
                # buffered pwrite at drain(), after the ring quiesces
                # and the fd drops O_DIRECT
                pre, tail, tail_off = self._split_aligned(bufs, off)
                if pre:
                    direct = self._try_direct(fd)
            if direct:
                if pre:
                    self._submit_run(fd, pre, off, direct=True)
                if tail:
                    self._tails.append((fd, list(tail), tail_off))
            else:
                # plain (page-cache) ring writes have no alignment
                # requirement: the WHOLE run goes out as SQEs — batched
                # submission is the point of the engine whether or not
                # O_DIRECT is opted in
                run = [(b, _buf_addr(b), memoryview(b).nbytes)
                       for b in bufs]
                self._submit_run(fd, run, off, direct=False)
        finally:
            self.submit_s += time.perf_counter() - t0

    def _submit_run(self, fd: int, run: list, off: int,
                    direct: bool) -> None:
        """Stamp SQEs for one contiguous run of (buf, addr, len): one SQE
        per buffer when every one sits in a registered region
        (WRITE_FIXED skips the per-op page pinning); else one vectored
        SQE for the whole run."""
        if not run:
            return
        idxs = [self._buf_index(a, ln) for _, a, ln in run]
        if all(i >= 0 for i in idxs):
            cur = off
            for (b, a, ln), bi in zip(run, idxs):
                self._push((_OP_WRITE_FIXED, fd, a, ln, cur, bi),
                           [b], None, direct)
                cur += ln
        else:
            iov = (_IoVec * len(run))()
            for i, (_, a, ln) in enumerate(run):
                iov[i].base, iov[i].len = a, ln
            self._push((_OP_WRITEV, fd, ctypes.addressof(iov),
                        len(run), off, 0),
                       [b for b, _, _ in run], iov, direct)

    def _push(self, sqe_args, bufs, keepalive, direct: bool) -> None:
        ring = self._ring
        while ring.sq_space() <= 0:
            self._reap_some(1)
        op, fd, addr, ln, off, bi = sqe_args
        self._seq += 1
        ud = self._seq
        nbytes = ln if op == _OP_WRITE_FIXED else \
            sum(memoryview(b).nbytes for b in bufs)
        self._pending[ud] = (op, fd, bufs, off, nbytes, keepalive, bi,
                             direct)
        ring.push(op, fd, addr, ln, off, ud, bi if bi >= 0 else 0)
        # no enter() here: SQEs accumulate and go to the kernel in ONE
        # enter at the next reap (enter always flushes _to_submit) — the
        # whole point of the ring over a syscall per pwritev

    # -- completion --------------------------------------------------------

    def _complete(self, ud: int, res: int) -> None:
        op, fd, bufs, off, nbytes, _keep, bi, direct = \
            self._pending.pop(ud)
        if res == nbytes:
            self.wbytes += nbytes
            if direct:
                self.direct_bytes += nbytes
            if op == _OP_WRITE_FIXED:
                self.fixed_bytes += nbytes
            return
        if res == -errno.EINVAL and direct:
            # this filesystem (or this fd's backing store) refuses
            # O_DIRECT after the probe said otherwise: latch the fd
            # buffered and rewrite the whole failed run.  The per-op
            # flag (not fd membership in _direct_fds) decides — the
            # FIRST failing CQE already un-latched the fd, and every
            # other in-flight direct run completing after it must take
            # this same rewrite path instead of hard-failing the encode
            self._clear_direct(fd)
            self._no_direct_fds.add(fd)
            _pwritev_all(fd, bufs, off)
            self.wbytes += nbytes
            return
        if res < 0:
            raise OSError(-res, os.strerror(-res))
        # short write: finish the remainder synchronously (a direct op
        # clears the flag first — the remainder is no longer aligned)
        if direct:
            self._clear_direct(fd)
            self._no_direct_fds.add(fd)
        mvs = [memoryview(b) for b in bufs]
        skip = res
        rest_off = off + res
        rest = []
        for mv in mvs:
            if skip >= len(mv):
                skip -= len(mv)
                continue
            rest.append(mv[skip:] if skip else mv)
            skip = 0
        _pwritev_all(fd, rest, rest_off)
        self.wbytes += nbytes

    def _reap_some(self, want: int) -> None:
        ring = self._ring
        got = 0
        while got < want and ring.inflight:
            cqe = ring.pop()
            if cqe is None:
                ring.enter(min_complete=1)
                continue
            got += 1
            try:
                self._complete(*cqe)
            except BaseException as e:
                self._errors.append(e)

    def _reap_all(self) -> None:
        if self._ring is not None:
            self._reap_some(self._ring.inflight + len(self._pending))

    def drain(self) -> None:
        """Complete every queued write (including deferred unaligned
        tails); raises the first error.  No-op for synchronous modes."""
        t0 = time.perf_counter()
        try:
            self._reap_all()
            tails, self._tails = self._tails, []
            for fd, bufs, off in tails:
                try:
                    self._clear_direct(fd)
                    _pwritev_all(fd, bufs, off)
                    self.wbytes += sum(memoryview(b).nbytes for b in bufs)
                except BaseException as e:
                    self._errors.append(e)
        finally:
            self.complete_s += time.perf_counter() - t0
        if self._errors:
            err, self._errors = self._errors[0], []
            raise err

    def close(self) -> None:
        try:
            self.drain()
        finally:
            for fd in list(self._direct_fds):
                try:
                    self._clear_direct(fd)
                except OSError:
                    pass
            if self._ring is not None:
                self._ring.close()
                self._ring = None
