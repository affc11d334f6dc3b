"""EC shard file generation and rebuild on the card.

Counterpart of `seaweedfs_tpu/storage/ec/ec_files.py` (reference:
weed/storage/erasure_coding/ec_encoder.go, ec_decoder.go).  A volume's
.dat streams through the codec as [k, B] uint8 batches; data shards are
written straight from the .dat and only parity ([m, B]) comes back from
the device.  The files are byte-identical to the reference package's.
Every shard byte goes through the writer pool (`_ShardWriterPool`), one
`aio.WriteEngine` per worker thread, with the submission batcher
(`_ShardFlusher`) in front of it for small units.

  write_ec_files      <- WriteEcFiles (ec_encoder.go:56)
  rebuild_ec_files    <- RebuildEcFiles (ec_encoder.go:91)
  rebuild_ec_reduced  reduced-read repair of lost shards (ops/regen.py)
  write_sorted_ecx    <- WriteSortedFileFromIdx (ec_encoder.go:27)
  find_dat_file_size  <- FindDatFileSize (ec_decoder.go:48)
  write_dat_file      <- WriteDatFile (ec_decoder.go:153)
  write_idx_from_ecx  <- WriteIdxFileFromEcIndex (ec_decoder.go:18)

Every entry point takes `device`: None means the card (and raises when
there is none); "cpu" runs the same pipeline over the plain version.
With WEEDTPU_EC_CODEC=native the host CPU codec runs instead (never by
default), and the encode and rebuild take its zero-copy host paths: the
GF(2^8) product runs by row address straight off the source mmaps into a
ring of parity or output buffers, each back in its ring once its writers
have written it.  The encode always runs the pipelined reader/dispatch/
drain threads (the reference's own default); the rebuild says in
`stats["mode"]` whether it ran host-serial or staged.
"""

from __future__ import annotations

import contextlib
import json
import mmap as mmap_mod
import os
import queue
import sys
import threading
import time

import numpy as np
import torch

from seaweedfs_tpu_torch import native
from seaweedfs_tpu_torch.maintenance import faults
from seaweedfs_tpu_torch.ops import codecs, regen
from seaweedfs_tpu_torch.ops.dispatch import (
    dispatch_parity as _dispatch_parity,
    device_empty as _device_empty,
    host_empty as _host_empty,
    materialize as _materialize,
    reconstruct_batch as _reconstruct_batch,
)
from seaweedfs_tpu_torch.ops.native_codec import NativeRSCodec
from seaweedfs_tpu_torch.stats import netflow, pipeline
from seaweedfs_tpu_torch.stats.profile import KERNELS
from seaweedfs_tpu_torch.storage import aio as _aio
from seaweedfs_tpu_torch.storage import idx as idxf
from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage.ec import layout
# the raw write primitives live with the write engine; re-exported here,
# where the reference's callers (and tests) reach them
from seaweedfs_tpu_torch.storage.aio import (
    _pwrite_all, aligned_empty as _aligned_empty)

DEFAULT_BATCH = 16 * 1024 * 1024  # bytes per shard per device round-trip

PIPELINE_DEPTH = 3  # batch buffers in flight: read N+1 / encode N / drain N-1
WRITER_DEPTH = 4  # queued batches per shard fd before submission blocks


def _env_bytes(name: str, default: int, least: int) -> int:
    """A byte-count knob: `default` when unset; a value that is not an
    integer of at least `least` raises ValueError."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        val = int(raw)
    except ValueError:
        val = None
    if val is None or val < least:
        raise ValueError(f"{name}={raw!r}: expected an integer >= {least}")
    return val


# the submission batcher ships each shard's queued jobs once per this much
# volume data (WEEDTPU_EC_FLUSH_BYTES; 1 flushes after every unit)
FLUSH_BYTES = _env_bytes("WEEDTPU_EC_FLUSH_BYTES", 8 * 1024 * 1024, 1)
# units of at least this many bytes skip the batcher: a queue hop per
# 256 KiB+ write is noise, and direct submission lets the writers start
# (and release pooled buffers) as soon as a job exists
DIRECT_MIN = 256 * 1024


def _get_codec(device=None, tag: str | None = None):
    """The EC codec for `tag` (None: RS(10,4)).  Its backend kind is the
    WEEDTPU_EC_CODEC knob (`codecs.make_codec`): unset or "cuda" runs
    the kernel on `device` ("cuda" or None; raises without a card), or
    the same codec shell over the plain version when `device` is "cpu";
    "native" the host codec; "mesh" RS over the mesh of the positions
    `device` names (None: every card; a device or a sequence of them,
    parallel/mesh.py), each position copying its own columns; any other
    value raises.  No fallback between them."""
    kind = os.environ.get("WEEDTPU_EC_CODEC") or None
    return codecs.make_codec(tag or codecs.DEFAULT_TAG, device, kind)


def _writer_threads(nshards: int) -> int:
    """Writer threads for an nshards-wide pool: one per shard on a wide
    host, at least two."""
    return max(2, min(nshards, os.cpu_count() or 2))


def _map_readonly(fd: int, size: int) -> mmap_mod.mmap:
    """Read-only map of a source file; pre-faulted (MAP_POPULATE) when the
    file fits in a quarter of RAM, else demand-faulted with sequential
    readahead."""
    flags = mmap_mod.MAP_SHARED
    populate = getattr(mmap_mod, "MAP_POPULATE", 0)
    try:
        ram = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    except (ValueError, OSError, AttributeError):
        ram = 0
    if populate and ram and size <= ram // 4:
        flags |= populate
    mm = mmap_mod.mmap(fd, 0, flags=flags, prot=mmap_mod.PROT_READ)
    try:
        mm.madvise(mmap_mod.MADV_SEQUENTIAL)
    except (AttributeError, OSError):
        pass
    return mm


_CFR_OK = True  # copy_file_range support, latched off on first failure


def _copy_range(src_fd: int, dst_fd: int, src_off: int, dst_off: int,
                count: int, src_view: np.ndarray) -> None:
    """In-kernel copy of a .dat slice into a shard file, falling back to
    pwrite from the mmap view where copy_file_range is unsupported."""
    global _CFR_OK
    if _CFR_OK and hasattr(os, "copy_file_range"):
        try:
            while count > 0:
                n = os.copy_file_range(src_fd, dst_fd, count, src_off, dst_off)
                if n <= 0:
                    raise OSError("copy_file_range returned 0")
                src_off += n
                dst_off += n
                count -= n
            return
        except OSError:
            _CFR_OK = False  # resume where it stopped, by pwrite
    if count > 0:
        _pwrite_all(dst_fd, src_view[src_off:src_off + count], dst_off)


class EncodeCancelled(RuntimeError):
    pass


def _countdown(n: int, cb):
    """A thunk that calls cb on its n-th call: the release hook of a ring
    buffer fanned out to n shard writers."""
    lock = threading.Lock()
    left = [n]

    def hit() -> None:
        with lock:
            left[0] -= 1
            if left[0] > 0:
                return
        cb()
    return hit


class _Timer:
    """Accumulates wall seconds into stats[key]."""

    def __init__(self, stats: dict, key: str):
        self.stats, self.key = stats, key

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.stats[self.key] = self.stats.get(self.key, 0.0) + \
            (time.perf_counter() - self.t0)
        return False


class _ShardWriterPool:
    """Shard-file writers: worker threads over the shard fds behind
    bounded queues, each worker with its own `aio.WriteEngine`.

    Shards map to workers by a fixed shard -> worker stripe, so writes to
    one shard stay in order while different shards land concurrently.  A
    queue item is one job (`put`, `copy`) or a batch of them (`put_many`,
    from a `_ShardFlusher`); the worker merges a batch's jobs that target
    contiguous offsets into one `writev` of up to _IOV_RUN buffers, and
    barriers the engine (`ensure_buffered`) before each in-kernel copy.
    Release hooks fire only after the engine has drained the batch: with
    an async ring the kernel may still read a buffer after submission
    returned, and a ring buffer handed back early would be overwritten
    under it.  `reg_bufs` (the parity or output ring) are registered with
    every worker's ring, so their rows go out as WRITE_FIXED.

    Workers never die: after the first error they drain the rest without
    touching the fds (still calling every release hook), so producers
    cannot deadlock on a full queue or an empty ring; the error surfaces
    via `.errors` after close().  close() folds the busy seconds into
    stats[stage_key(shard)], and the engines' `submit_s`, `complete_s`,
    `aio_direct_bytes`, `aio_mode` (the most degraded engine's) and
    `aio_degraded_engines` beside them."""

    _IOV_RUN = 512  # most buffers merged into one writev (< IOV_MAX)

    def __init__(self, fds, highwater=None, stats=None, stage_key=None,
                 reg_bufs=None):
        self._fds = list(fds)
        self._hw = highwater
        self._stats = stats
        self._stage_key = stage_key or (lambda i: "write_s")
        self._mode = _aio.engine_mode()
        self._reg = list(reg_bufs) if reg_bufs else None
        self._engines: list = []
        self._nworkers = max(1, min(len(self._fds),
                                    _writer_threads(len(self._fds))))
        per = -(-len(self._fds) // self._nworkers)
        self._queues = [queue.Queue(maxsize=WRITER_DEPTH * per)
                        for _ in range(self._nworkers)]
        self._busy = [0.0] * len(self._fds)
        self._wbytes = [0] * len(self._fds)  # bytes written per shard
        self.errors: list[BaseException] = []
        self._closed = False
        self._threads = [
            threading.Thread(target=self._run, args=(w,),
                             name=f"ec-writer-{w:02d}", daemon=True)
            for w in range(self._nworkers)]
        for th in self._threads:
            th.start()

    @property
    def failed(self) -> bool:
        return bool(self.errors)

    def _q(self, shard: int) -> queue.Queue:
        return self._queues[shard % self._nworkers]

    def put(self, shard: int, data, off: int, release=None) -> None:
        """Queue a write of a 1-D uint8 buffer at `off`; the queue item
        keeps `data` alive until it is written.  `release()`, when given,
        is called once the write is drained or skipped, after which the
        caller may reuse `data`'s memory."""
        self._q(shard).put((shard, [(data, None, off, release)]))

    def copy(self, shard: int, src_fd: int, src_off: int, dst_off: int,
             count: int, src_view) -> None:
        """Queue an in-kernel copy of a source range into the shard file."""
        self._q(shard).put(
            (shard, [(None, (src_fd, src_off, count, src_view), dst_off,
                      None)]))

    def put_many(self, shard: int, jobs: list) -> None:
        """Queue a batch of jobs as one queue item: one worker wakeup per
        batch, not per job (see _ShardFlusher)."""
        self._q(shard).put((shard, jobs))

    # a bare pool stands in for a _ShardFlusher, so producers submit
    # directly where units are big enough (see _make_sink)
    def account(self, nbytes: int) -> None:
        pass

    def flush(self) -> None:
        pass

    def _run(self, w: int) -> None:
        q = self._queues[w]
        try:
            eng = _aio.WriteEngine(mode=self._mode, reg=self._reg)
        except BaseException as e:  # a forced uring without its ring
            self.errors.append(e)
            eng = None
        if eng is not None:
            self._engines.append(eng)
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                shard, jobs = batch
                t0 = time.perf_counter()
                releases = self._write_batch(eng, shard, jobs)
                self._busy[shard] += time.perf_counter() - t0
                for rel in releases:
                    rel()
        finally:
            if eng is not None:
                try:
                    eng.close()
                except BaseException as e:
                    self.errors.append(e)

    def _write_batch(self, eng, shard: int, jobs: list) -> list:
        """Write one batch through the engine and drain it; returns the
        batch's release hooks, every one of them even after an error."""
        fd = self._fds[shard]
        releases: list = []
        ends: list[tuple[int, int]] = []  # (end offset, bytes) per write
        idx = 0
        while idx < len(jobs):
            data, cfr, off, release = jobs[idx]
            if release is not None:
                releases.append(release)
            idx += 1
            if self.errors:
                continue  # drain without touching the fd
            try:
                if cfr is not None:
                    src_fd, src_off, count, src_view = cfr
                    # an in-kernel copy wants plain buffered fd semantics
                    # over every earlier write: barrier the engine first
                    eng.ensure_buffered(fd)
                    _copy_range(src_fd, fd, src_off, off, count, src_view)
                    ends.append((off + count, count))
                    continue
                # merge the run of writes at contiguous offsets
                bufs = [np.ascontiguousarray(data)]
                end = off + bufs[0].nbytes
                while (idx < len(jobs) and len(bufs) < self._IOV_RUN
                       and jobs[idx][1] is None and jobs[idx][2] == end):
                    nxt = np.ascontiguousarray(jobs[idx][0])
                    bufs.append(nxt)
                    end += nxt.nbytes
                    if jobs[idx][3] is not None:
                        releases.append(jobs[idx][3])
                    idx += 1
                eng.writev(fd, bufs, off)
                ends.append((end, end - off))
            except BaseException as e:  # surfaced after close
                self.errors.append(e)
        if eng is not None:
            try:
                eng.drain()
            except BaseException as e:
                self.errors.append(e)
        if not self.errors:
            for end, n in ends:
                self._wbytes[shard] += n
                if self._hw is not None:
                    self._hw[shard] = max(self._hw[shard], end)
        return releases

    def close(self) -> None:
        """Drain every queue, join the workers, fold the stage seconds and
        the engines' stats into stats, and book the writes in the kernel
        profile's `shard_write[host]` row (the same busy seconds, and the
        bytes written).  Idempotent; does not raise (callers read
        `.errors`, so a producer's error wins)."""
        if self._closed:
            return
        self._closed = True
        for q in self._queues:
            q.put(None)
        for th in self._threads:
            th.join()
        busy_total, wrote = sum(self._busy), sum(self._wbytes)
        if busy_total > 0 and wrote > 0:
            KERNELS.record("shard_write", "host", calls=0,
                           wall_s=busy_total, nbytes=wrote)
        if self._stats is None:
            return
        st = self._stats
        # the engines' finer cut of the write stages' seconds: SQE
        # stamping and submitting calls against waits for completions
        sub = sum(e.submit_s for e in self._engines)
        comp = sum(e.complete_s for e in self._engines)
        if sub or comp:
            st["submit_s"] = st.get("submit_s", 0.0) + sub
            st["complete_s"] = st.get("complete_s", 0.0) + comp
            for key in ("submit_workers", "complete_workers"):
                st[key] = st.get(key, 0.0) + self._nworkers
        direct = sum(e.direct_bytes for e in self._engines)
        if direct:
            st["aio_direct_bytes"] = st.get("aio_direct_bytes", 0) + direct
        # the mode the engines resolved to, the most degraded one: under
        # auto a worker whose ring setup failed degrades alone
        rank = {"buffered": 0, "pwritev": 1, "uring": 2}
        modes = [e.mode for e in self._engines]
        resolved = min(modes, key=rank.__getitem__) if modes else self._mode
        cur = st.get("aio_mode")
        if cur is None or rank[resolved] < rank[cur]:
            st["aio_mode"] = resolved
        degraded = sum(1 for m in modes if m != self._mode)
        if degraded:
            st["aio_degraded_engines"] = \
                st.get("aio_degraded_engines", 0) + degraded
        key_busy: dict[str, float] = {}
        for i, busy in enumerate(self._busy):
            key = self._stage_key(i)
            st[key] = st.get(key, 0.0) + busy
            key_busy[key] = key_busy.get(key, 0.0) + busy
        # the pool's threads split across its stages by busy share, summed
        # over pools (the fleet's volumes share one stats dict)
        total = sum(key_busy.values())
        if total > 0:
            for key, busy in key_busy.items():
                wkey = key[:-2] + "_workers"
                st[wkey] = st.get(wkey, 0.0) + \
                    self._nworkers * busy / total


def _make_sink(writers: _ShardWriterPool, nshards: int, min_step: int):
    """The submission front for a writer pool: the pool itself (direct,
    one job at a time) when every unit is at least DIRECT_MIN bytes, else
    a _ShardFlusher that batches the small units."""
    if min_step >= DIRECT_MIN:
        return writers
    return _ShardFlusher(writers, nshards)


def _parity_ring_size(min_step: int, max_step: int) -> int:
    """Buffers in the countdown-released parity ring.  Direct submission
    needs only the pipeline's headroom (writers release job by job); the
    batched path must cover a whole unflushed flush group of units, or
    the encode waits on its own batching."""
    if min_step >= DIRECT_MIN:
        return PIPELINE_DEPTH + 1
    return PIPELINE_DEPTH + max(1, FLUSH_BYTES // max_step)


class _ShardFlusher:
    """Producer-side submission batcher for a _ShardWriterPool: each
    shard's jobs gather here and go to the pool as one `put_many` batch
    per FLUSH_BYTES of volume data (or at `flush()`), so a small-block
    layout's many small units cost one queue hop a batch, not one a job,
    and the worker merges their contiguous runs into one writev.  One
    producer thread per flusher: its lists are unlocked."""

    def __init__(self, writers: _ShardWriterPool, nshards: int):
        self._writers = writers
        self._jobs: list[list] = [[] for _ in range(nshards)]
        self._acc = 0

    def put(self, shard: int, data, off: int, release=None) -> None:
        self._jobs[shard].append((data, None, off, release))

    def copy(self, shard: int, src_fd: int, src_off: int, dst_off: int,
             count: int, src_view) -> None:
        self._jobs[shard].append(
            (None, (src_fd, src_off, count, src_view), dst_off, None))

    def account(self, nbytes: int) -> None:
        """Called once per unit; crossing FLUSH_BYTES ships every shard's
        pending batch."""
        self._acc += nbytes
        if self._acc >= FLUSH_BYTES:
            self.flush()

    def flush(self) -> None:
        self._acc = 0
        for shard, jobs in enumerate(self._jobs):
            if jobs:
                self._writers.put_many(shard, jobs)
                self._jobs[shard] = []


def overlap_fraction(stats: dict) -> float | None:
    """Achieved stage overlap of an encode or rebuild: 1 - wall / (sum of
    the stage seconds).  0.0 means fully serial.  stall_s is the producer
    waiting, not a stage, and submit_s / complete_s are the write engine's
    finer cut of seconds the write stages already hold, so all three are
    left out.  None without a wall clock or stage time."""
    wall = stats.get("wall_s")
    total = sum(v for key, v in stats.items()
                if key.endswith("_s")
                and key not in ("wall_s", "stall_s", "submit_s",
                                "complete_s")
                and isinstance(v, float))
    if not wall or total <= 0:
        return None
    return round(max(0.0, 1.0 - wall / total), 3)


def write_ec_files(base: str, dat_path: str | None = None,
                   large_block: int = layout.LARGE_BLOCK_SIZE,
                   small_block: int = layout.SMALL_BLOCK_SIZE,
                   batch_size: int = DEFAULT_BATCH,
                   progress=None, cancel=None, stats=None,
                   codec_tag: str | None = None, device=None) -> None:
    """Encode `<base>.dat` (or dat_path) into its n shard files (`.ec00`
    .. `.ec13` for RS(10,4)) under the code `codec_tag` names (None: the
    default, `codecs.default_tag()`), plus a `<base>.vif` sidecar
    recording the encode-time dat size, version and codec tag.  The
    stripe width is the codec's k (9 for msr_9_16).

    `progress(bytes_done)` is called per batch, `cancel()` returning True
    aborts, and `stats`, when a dict, receives per-stage seconds.  Shards
    build under `.tmp` names and commit by rename only when the whole
    encode succeeds; stale `.tmp` files are reused in place."""
    dat_path = dat_path or base + ".dat"
    dat_size = os.path.getsize(dat_path)
    spec = codecs.parse_tag(codec_tag or codecs.default_tag())
    codec = _get_codec(device, spec.tag)
    # an armed shard_write_error fails the encode like a dying disk,
    # before any tmp shard file exists: the previous shard set stays
    faults.check_shard_write(base)
    tmp_paths = [base + layout.to_ext(i) + ".tmp" for i in range(spec.n)]
    out_fds = [os.open(p_, os.O_RDWR | os.O_CREAT, 0o644) for p_ in tmp_paths]
    ok = False
    try:
        _encode_stream(codec, dat_path, dat_size, large_block, small_block,
                       batch_size, out_fds, progress, cancel,
                       stats if stats is not None else {})
        ok = True
    finally:
        for fd in out_fds:
            os.close(fd)
        if ok:
            write_vif(base, dat_size, codec=spec.tag)
            for i, p_ in enumerate(tmp_paths):
                os.replace(p_, base + layout.to_ext(i))
        else:
            for p_ in tmp_paths:
                with contextlib.suppress(OSError):
                    os.remove(p_)


def _iter_units(dat_size: int, large_block: int, small_block: int,
                batch_size: int, data_shards: int = layout.DATA_SHARDS):
    """Yield (row_start, block, col, step, shard_off) column-batch work
    units in shard file order: the large-block rows (while more than one
    large row remains), then small-block rows.  shard_off is the unit's
    byte offset inside every shard file."""
    k = data_shards
    processed = 0
    remaining = dat_size
    shard_base = 0
    while remaining > large_block * k:
        step = min(batch_size, large_block)
        assert large_block % step == 0, (large_block, step)
        for col in range(0, large_block, step):
            yield processed, large_block, col, step, shard_base + col
        processed += large_block * k
        remaining -= large_block * k
        shard_base += large_block
    while remaining > 0:
        step = min(batch_size, small_block)
        assert small_block % step == 0, (small_block, step)
        for col in range(0, small_block, step):
            yield processed, small_block, col, step, shard_base + col
        processed += small_block * k
        remaining -= small_block * k
        shard_base += small_block


def _unit_steps(dat_size: int, large_block: int, small_block: int,
                batch_size: int,
                data_shards: int = layout.DATA_SHARDS) -> tuple[int, int]:
    """(min, max) column-batch step _iter_units cuts for this volume: min
    picks direct or batched submission, max sizes the pooled buffers (a
    small-block-only volume never needs large-step buffers)."""
    row = large_block * data_shards
    n_large = (dat_size - 1) // row if dat_size > row else 0
    steps = []
    if n_large:
        steps.append(min(batch_size, large_block))
    if dat_size - n_large * row > 0:
        steps.append(min(batch_size, small_block))
    if not steps:
        steps = [batch_size]
    return min(steps), max(steps)


def _unit_coverage(dat_size: int, row_start: int, block: int, col: int,
                   step: int,
                   data_shards: int = layout.DATA_SHARDS) -> tuple[int, int]:
    """-> (nz, tail): nz = number of leading rows carrying any data in this
    unit, tail = valid bytes in row nz-1 (== step when that row is full)."""
    nz = 0
    tail = step
    for j in range(data_shards):
        off = row_start + j * block + col
        n = min(step, dat_size - off)
        if n <= 0:
            break
        nz = j + 1
        tail = n
    return nz, tail


def _finalize_shards(out_fds, highwater, shard_size: int) -> None:
    """Cut every shard file to exactly shard_size: truncate to the written
    high-water mark (drops stale bytes of a reused tmp file), then extend;
    the zero suffix becomes a hole."""
    for fd, hw in zip(out_fds, highwater):
        os.ftruncate(fd, min(hw, shard_size))
        if hw < shard_size:
            os.ftruncate(fd, shard_size)


def _encode_stream(codec, dat_path: str, dat_size: int, large_block: int,
                   small_block: int, batch_size: int, out_fds,
                   progress, cancel, stats: dict) -> None:
    """Stream the .dat through the codec into the shard fds, tracked as an
    `ec_encode` pipeline job.  Units wholly beyond the .dat are never
    read, encoded or written: their parity is zero, so they become
    holes."""
    stats["mode"] = "pipelined"
    stats["bytes"] = dat_size
    shard_size = layout.shard_file_size(dat_size, large_block, small_block,
                                        data_shards=codec.k)
    highwater = [0] * (codec.k + codec.m)
    if dat_size > 0:
        t_wall = time.perf_counter()
        with pipeline.track("ec_encode", stats, dat_size,
                            meta={"mode": stats["mode"]}) as pjob, \
                open(dat_path, "rb") as datf:
            mm = _map_readonly(datf.fileno(), dat_size)
            dat_view = np.frombuffer(mm, dtype=np.uint8)
            try:
                _encode_pipelined(codec, datf.fileno(), dat_view, dat_size,
                                  large_block, small_block, batch_size,
                                  out_fds, highwater, progress, cancel, stats,
                                  pjob)
            finally:
                del dat_view
                with contextlib.suppress(BufferError):
                    mm.close()  # a traceback may still hold views
            stats["wall_s"] = time.perf_counter() - t_wall
            frac = overlap_fraction(stats)
            if frac is not None:
                stats["overlap_frac"] = frac
            _book_stage_bytes(pjob, stats, dat_size, codec.m * shard_size)
    _finalize_shards(out_fds, highwater, shard_size)


def _book_stage_bytes(pjob, stats: dict, data_bytes: int,
                      parity_bytes: int) -> None:
    """Book the run's bytes (fixed by the layout) to the stages that ran:
    a stage without seconds gets none, so no rate is made up."""
    for key, nbytes in (("read_s", data_bytes), ("encode_s", data_bytes),
                        ("d2h_s", parity_bytes),
                        ("write_data_s", data_bytes),
                        ("write_parity_s", parity_bytes),
                        ("reconstruct_s", data_bytes),
                        ("write_s", parity_bytes)):
        if stats.get(key):
            pjob.add_bytes(key[:-2], nbytes)


def _host_parity_unit(codec, dat_view: np.ndarray, tailbuf: np.ndarray,
                      pbuf: np.ndarray, row_start: int, block: int,
                      col: int, step: int, nz: int, tail: int) -> None:
    """Parity of one column unit by the native codec, straight off the
    .dat mmap into pbuf's m rows: a partial tail row is staged into the
    zeroed tailbuf first, and a unit with nz < k rows of data takes the
    parity matrix's first nz columns."""
    rows = [dat_view[row_start + j * block + col:
                     row_start + j * block + col + step]
            for j in range(nz)]
    if tail < step:
        tailbuf[:tail] = rows[nz - 1][:tail]
        tailbuf[tail:step] = 0
        rows[nz - 1] = tailbuf
    mat = codec.code.parity_matrix
    if nz < codec.k:
        mat = np.ascontiguousarray(mat[:, :nz])
    # this path bypasses the dispatch seam, so it books its own row
    with KERNELS.timed("encode_parity", nbytes=nz * step):
        native.gf_matmul_ptrs(mat, rows, list(pbuf), step)


def _encode_pipelined(codec, dat_fd: int, dat_view: np.ndarray,
                      dat_size: int, large_block: int, small_block: int,
                      batch_size: int, out_fds, highwater,
                      progress, cancel, stats: dict, pjob) -> None:
    """Overlapped reader -> dispatch -> drain -> shard-writer pipeline.

      reader   walks the units; data shards go to their writers by
               in-kernel copy on the way (they never visit the device),
               batched through a _ShardFlusher, and the stripe is staged
               from the mmap into a pooled pinned host buffer (read_s)
      dispatch (caller's thread, on its own CUDA stream) copies the
               stripe into the slot's device buffer and enqueues the
               parity kernel on a [:, :step] view of it (encode_s)
      drain    waits on the dispatch's event and copies parity D2H
               (d2h_s), returns the slot to the pool, and hands the m
               parity rows to the writers: directly when every unit is at
               least DIRECT_MIN bytes, else through a _ShardFlusher
      writers  the _ShardWriterPool over the shard fds

    The pool of (host, device) slots is the backpressure: a slot comes
    back only once its parity is on the host, so neither buffer is
    overwritten while the device may still read it.  The parity rows are
    views of the pinned array `materialize` returns; the queue items and
    the write engine hold them until written, so the caching host
    allocator cannot hand that block to another D2H while a ring write
    still reads it.

    The native codec skips the staging: the reader passes each unit's
    coverage on, the dispatch computes its parity off the mmap into a
    buffer of the aligned, registered parity ring (`_host_parity_unit`;
    waiting for one is stall_s), and the drain hands its rows to the
    writers, which return it to the ring once all m are written.  When
    the ring runs dry the dispatch sends FLUSH to the drain first: its
    flusher may hold the very jobs whose releases refill the ring."""
    device = codec.device
    host = isinstance(codec, NativeRSCodec)
    k, m = codec.k, codec.m
    min_step, max_step = _unit_steps(dat_size, large_block, small_block,
                                     batch_size, k)
    pool: queue.Queue = queue.Queue()
    reg_bufs = None
    if host:
        tailbuf = np.zeros(max_step, dtype=np.uint8)
        reg_bufs = [_aligned_empty((m, max_step))
                    for _ in range(_parity_ring_size(min_step, max_step))]
        for b in reg_bufs:
            pool.put(b)
    else:
        # a mesh codec copies each position's columns into buffers of
        # its own: the slot is the host batch alone
        for _ in range(PIPELINE_DEPTH):
            dev = _device_empty((k, max_step), device) \
                if device.type == "cuda" and not hasattr(codec, "mesh") \
                else None
            pool.put((_host_empty((k, max_step), device), dev))
    q_read: queue.Queue = queue.Queue(maxsize=PIPELINE_DEPTH)
    q_disp: queue.Queue = queue.Queue()  # bounded by the pool, and FLUSH
    FLUSH = object()
    errors: list[BaseException] = []
    writers = _ShardWriterPool(
        out_fds, highwater, stats,
        stage_key=lambda i: "write_data_s" if i < k else "write_parity_s",
        reg_bufs=reg_bufs)
    done = 0

    def reader() -> None:
        nonlocal done
        flusher = _ShardFlusher(writers, k)  # data shards only
        try:
            for row_start, block, col, step, shard_off in _iter_units(
                    dat_size, large_block, small_block, batch_size,
                    data_shards=k):
                if errors or writers.failed:  # downstream died: stop
                    break
                if cancel is not None and cancel():
                    raise EncodeCancelled("ec encode cancelled")
                nz, tail = _unit_coverage(dat_size, row_start, block, col,
                                          step, data_shards=k)
                if nz == 0:
                    continue
                for j in range(nz):
                    flusher.copy(j, dat_fd, row_start + j * block + col,
                                 shard_off, step if j < nz - 1 else tail,
                                 dat_view)
                if host:  # the dispatch encodes off the mmap itself
                    q_read.put((None, step, shard_off,
                                (row_start, block, col, nz, tail)))
                else:
                    with _Timer(stats, "stall_s"):
                        slot = pool.get()
                    with _Timer(stats, "read_s"):
                        batch = slot[0].numpy()[:, :step]
                        for j in range(k):
                            off = row_start + j * block + col
                            n = max(0, min(step, dat_size - off))
                            if n > 0:
                                np.copyto(batch[j, :n],
                                          dat_view[off:off + n])
                            if n < step:
                                batch[j, n:] = 0
                    q_read.put((slot, step, shard_off, None))
                done += (nz - 1) * step + tail
                flusher.account(step)
                if progress is not None:
                    progress(done)
            flusher.flush()
        except BaseException as e:  # surfaced by the caller's thread
            errors.append(e)
        finally:
            q_read.put(None)

    def drain() -> None:
        sink = _make_sink(writers, k + m, min_step)
        while True:
            item = q_disp.get()
            if item is None:
                sink.flush()
                return
            if item is FLUSH:
                sink.flush()
                continue
            slot, step, shard_off, parity, release = item
            if errors or writers.failed:
                if release is not None:
                    for _ in range(m):
                        release()
                else:
                    pool.put(slot)
                continue
            if release is not None:  # host parity, computed in place
                for i in range(m):
                    sink.put(k + i, parity[i, :step], shard_off,
                             release=release)
                sink.account(step)
                continue
            try:
                with _Timer(stats, "d2h_s"):
                    pnp = _materialize(parity)
            except BaseException as e:
                errors.append(e)
                pool.put(slot)
                continue
            pool.put(slot)  # the device is done with both buffers
            for i in range(m):
                sink.put(k + i, pnp[i, :step], shard_off)
            sink.account(step)

    t_r = threading.Thread(target=reader, name="ec-reader", daemon=True)
    t_d = threading.Thread(target=drain, name="ec-drain", daemon=True)
    t_r.start()
    t_d.start()
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    try:
        with torch.cuda.stream(stream) if stream is not None \
                else contextlib.nullcontext():
            while True:
                item = q_read.get()
                if item is None:
                    break
                # stage-queue depth at the consume site
                pjob.queue("q_read", q_read.qsize(), PIPELINE_DEPTH)
                slot, step, shard_off, coverage = item
                if errors or writers.failed:
                    if slot is not None:
                        pool.put(slot)
                    continue
                if host:
                    row_start, block, col, nz, tail = coverage
                    try:
                        pbuf = pool.get_nowait()
                    except queue.Empty:
                        q_disp.put(FLUSH)  # else the wait may never end
                        with _Timer(stats, "stall_s"):
                            pbuf = pool.get()
                    with _Timer(stats, "encode_s"):
                        _host_parity_unit(codec, dat_view, tailbuf, pbuf,
                                          row_start, block, col, step, nz,
                                          tail)
                    release = _countdown(m, lambda b=pbuf: pool.put(b))
                    q_disp.put((None, step, shard_off, pbuf, release))
                    continue
                with _Timer(stats, "encode_s"):
                    parity = _dispatch_parity(
                        codec, slot[0][:, :step],
                        staging=slot[1])
                q_disp.put((slot, step, shard_off, parity, None))
    except BaseException as e:
        errors.append(e)
    finally:
        q_disp.put(None)
        t_d.join()
        while t_r.is_alive():  # unblock a reader stuck on a full q_read
            try:
                item = q_read.get(timeout=0.05)
            except queue.Empty:
                continue
            if item is not None and item[0] is not None:
                pool.put(item[0])
        t_r.join()
        writers.close()  # after the producers: no submission can block now
    if errors:
        raise errors[0]
    if writers.errors:
        raise writers.errors[0]


def rebuild_ec_files(base: str, batch_size: int = DEFAULT_BATCH,
                     progress=None, cancel=None, stats=None,
                     device=None, codec_tag: str | None = None) -> list[int]:
    """Regenerate whichever shard files are missing from the present
    ones, under `codec_tag` (the caller's tag wins, as in the reference:
    a rebuilder holding copied shards but no `.vif` must still decode
    with the right matrix) or else the code the `.vif` names; returns the
    rebuilt shard ids.

    Survivors (`codec.basis`: one local group for an LRC single loss)
    are mmap'd.  "staged" mode (the card, the plain version, and MSR on
    any backend): each batch of their columns goes to the card in one
    transfer and is decoded in one apply (one kernel launch per row block
    of the decode matrix); MSR batches are alpha multiples.  "host-serial"
    mode (the native RS or LRC codec): the decode matrix runs by row
    address straight off the survivors' mmaps into a ring of output
    buffers, each back in the ring once its writers are done.  The
    rebuilt rows stream to per-shard writers into `.tmp` files, committed
    by rename only on success (reference: RebuildEcFiles,
    ec_encoder.go:237-291).  The output ring is aligned and registered
    with the writers' engines; staged mode copies its decoded rows into
    it only under the io_uring engine, where they then go out as
    WRITE_FIXED, and otherwise hands them to the writers as they are.  `stats`
    gets mode, bytes, codec, reconstruct_s, stall_s, write_s, wall_s,
    overlap_frac and the write engine's keys (`_ShardWriterPool`)."""
    spec = codecs.parse_tag(codec_tag or
                            (read_vif(base) or {}).get("codec"))
    present = [i for i in range(spec.n)
               if os.path.exists(base + layout.to_ext(i))]
    missing = [i for i in range(spec.n) if i not in present]
    if not missing:
        return []
    if len(present) < spec.k:
        raise ValueError(
            f"need >= {spec.k} shards to rebuild, have {len(present)}")
    # fail like a dying disk before any tmp shard file exists
    faults.check_shard_write(base)
    codec = _get_codec(device, spec.tag)
    use = list(codec.basis(present, missing))
    shard_size = os.path.getsize(base + layout.to_ext(use[0]))
    stats = stats if stats is not None else {}
    stats["bytes"] = shard_size * len(use)
    stats["codec"] = spec.tag
    host = isinstance(codec, NativeRSCodec)
    stats["mode"] = "host-serial" if host else "staged"
    # MSR sub-packetization: every chunk a codec's interleave must see is
    # an alpha multiple (shard files themselves are block multiples)
    if spec.alpha > 1:
        batch_size = max(spec.alpha, batch_size - batch_size % spec.alpha)
        if shard_size % spec.alpha:
            raise ValueError(
                f"shard size {shard_size} not {spec.alpha}-aligned")
    # a rebuild is repair work: unless the caller declared a class, a hop
    # made on this thread while it runs books as repair
    flow_token = netflow.set_class(netflow.current_class() or "repair")
    pjob = pipeline.track("ec_rebuild", stats, shard_size * len(use),
                          meta={"missing": len(missing), "codec": spec.tag})
    t_wall = time.perf_counter()
    ins: dict[int, object] = {}
    maps: dict[int, mmap_mod.mmap] = {}
    views: dict[int, np.ndarray] = {}
    tmp_paths = {i: base + layout.to_ext(i) + ".tmp" for i in missing}
    out_fds: dict[int, int] = {}
    writers = None
    ok = False
    try:
        for i in use:
            ins[i] = open(base + layout.to_ext(i), "rb")
        for i, p_ in tmp_paths.items():
            out_fds[i] = os.open(p_, os.O_RDWR | os.O_CREAT, 0o644)
        # an aligned output ring registered with the writers' engines; a
        # buffer goes back once all its rows are written.  The staged
        # decode's rows are copied into it only where a ring engine can
        # write them as WRITE_FIXED: a synchronous writer takes them as
        # they are, and the queue item holds them until written
        obufs = []
        if host or _aio.engine_mode() == "uring":
            obufs = [_aligned_empty((len(missing),
                                     min(batch_size, max(shard_size, 1))))
                     for _ in range(PIPELINE_DEPTH)]
        ring: queue.Queue = queue.Queue()
        for b in obufs:
            ring.put(b)
        writers = _ShardWriterPool([out_fds[i] for i in missing], None, stats,
                                   reg_bufs=obufs)
        if shard_size:
            for i, f in ins.items():
                maps[i] = _map_readonly(f.fileno(), shard_size)
                views[i] = np.frombuffer(maps[i], dtype=np.uint8)
        if host and shard_size:
            _, dec = codec.decoder(tuple(present), tuple(missing))
        done = 0
        for off in range(0, shard_size, batch_size):
            if cancel is not None and cancel():
                raise EncodeCancelled("ec rebuild cancelled")
            if writers.failed:
                break
            n = min(batch_size, shard_size - off)
            release = None
            if obufs:
                with _Timer(stats, "stall_s"):
                    obuf = ring.get()
                release = _countdown(len(missing), lambda b=obuf: ring.put(b))
            with _Timer(stats, "reconstruct_s"):
                if host:
                    with KERNELS.timed("reconstruct", nbytes=len(use) * n):
                        native.gf_matmul_ptrs(
                            dec.C, [views[i][off:off + n] for i in use],
                            list(obuf), n)
                    rows = list(obuf[:, :n])
                else:
                    rebuilt = _reconstruct_batch(
                        codec, {i: views[i][off:off + n] for i in use},
                        missing)
                    rows = [rebuilt[i] for i in missing]
                    if obufs:
                        for r, row in enumerate(rows):
                            np.copyto(obuf[r, :n], row)
                        rows = list(obuf[:, :n])
            for r, row in enumerate(rows):
                writers.put(r, row, off, release=release)
            done += n * len(use)
            if progress is not None:
                progress(done)
        writers.close()
        if writers.errors:
            raise writers.errors[0]
        for fd in out_fds.values():
            os.ftruncate(fd, shard_size)
        stats["wall_s"] = time.perf_counter() - t_wall
        frac = overlap_fraction(stats)
        if frac is not None:
            stats["overlap_frac"] = frac
        _book_stage_bytes(pjob, stats, shard_size * len(use),
                          shard_size * len(missing))
        ok = True
    finally:
        netflow.reset(flow_token)
        if writers is not None:
            writers.close()  # idempotent; the fds must outlive the workers
        # sealed after close() folded the writers' seconds into stats; a
        # failed rebuild's job carries the error in flight
        pjob.finish(None if ok else
                    (sys.exc_info()[1] or "rebuild failed"))
        for f in ins.values():
            f.close()
        views.clear()
        for mm in maps.values():
            with contextlib.suppress(BufferError):
                mm.close()
        for fd in out_fds.values():
            os.close(fd)
        if ok:
            for i, p_ in tmp_paths.items():
                os.replace(p_, base + layout.to_ext(i))
        else:
            for p_ in tmp_paths.values():
                with contextlib.suppress(OSError):
                    os.remove(p_)
    return missing


def rebuild_ec_reduced(base: str, lost: list[int], groups: list[dict],
                       fetch_partial, *, d: int | None = None,
                       progress=None, cancel=None,
                       stats: dict | None = None,
                       codec_tag: str | None = None, device=None) -> dict:
    """Reduced-read rebuild of the `lost` shards under the code `codec_tag`
    names (None: the `.vif`'s; a caller's tag wins, as for a repairing
    node holding copied shards without the sidecar): instead of copying k full
    survivor shards here, each remote helper node ships XOR-combinable
    partial products (ops/regen.py), so
    repair bytes per remote node drop to one range per lost shard (RS),
    one range inside the lost shard's local group (LRC single loss), or
    one sub-row per held shard (MSR), and the output is byte-identical to
    a full decode.

    `groups` lists the REMOTE helper nodes: {"node": name, "shards":
    [ids], "locality": class}, optionally "shard_size" (the size to
    repair when no survivor is local).  The local survivor group is the
    shard files next to `base`, and each rebuilt shard joins it for the
    next pass.  `fetch_partial(group, shards, coeff_rows, offset, size) ->
    bytes` is the caller's hop to a helper; its failures raise
    regen.HelperDied and trigger a re-plan with a substitute survivor.
    For MSR the shard ids are virtual (`file_sid * alpha + j`, sub-row j
    of the file) and offset and size are in sub-row bytes: the helper
    reads file bytes [offset*alpha, (offset+size)*alpha) and takes column
    j of their [size, alpha] view.  Each lost shard builds under a `.tmp`
    name and commits by rename, so a dead helper, a plan the code cannot
    decode (ValueError) or a crash never leaves a partial shard visible.

    Chunks are DEFAULT_BATCH bytes (MSR: DEFAULT_BATCH / alpha sub-row
    bytes, so a helper's file read stays one batch) and segments align
    to regen.DEFAULT_SEG_ALIGN, both read at call time.

    `progress(bytes_done)` sees the rebuilt bytes after each lost shard
    commits; `cancel()`, polled before each chunk, aborts with
    EncodeCancelled (the shard in progress is dropped, earlier ones
    stay committed).

    Returns the accounting: measured helper bytes per node and locality
    class, the completed plans' predictions (with the naive copy-then-
    rebuild cost, `naive_remote`), replans and dead helpers.  `stats`,
    when a dict, also gets mode, bytes, codec, reconstruct_s, wall_s and
    the repairing thread's stage seconds (regen.execute_plan)."""
    # fail like a dying disk before any tmp shard file exists
    faults.check_shard_write(base)
    spec = codecs.parse_tag(codec_tag or
                            (read_vif(base) or {}).get("codec"))
    codec = _get_codec(device, spec.tag)
    alpha = spec.alpha
    batch_size = DEFAULT_BATCH
    if spec.family == "msr":
        batch_size = max(alpha, batch_size // alpha)
    lost = sorted(set(lost))
    local_fds: dict[int, int] = {}
    stats = stats if stats is not None else {}
    stats.setdefault("mode", "reduced")
    flow_token = netflow.set_class(netflow.current_class() or "repair")
    t_wall = time.perf_counter()
    try:
        shard_size = 0
        for i in range(spec.n):
            p_ = base + layout.to_ext(i)
            if i not in lost and os.path.exists(p_):
                local_fds[i] = os.open(p_, os.O_RDONLY)
                shard_size = max(shard_size, os.path.getsize(p_))
        if shard_size == 0:
            for g in groups:
                if g.get("shard_size"):
                    shard_size = int(g["shard_size"])
                    break
        if shard_size <= 0:
            raise ValueError(f"cannot size shards of {base}")
        stats["bytes"] = shard_size * len(lost)
        stats["codec"] = spec.tag
        if shard_size % alpha:
            raise ValueError(
                f"shard size {shard_size} not {alpha}-aligned for {spec.tag}")

        def read_local(sid: int, off: int, n: int) -> bytes | None:
            fd = local_fds.get(sid)
            if fd is None:
                return None
            try:
                return os.pread(fd, n, off)
            except OSError:
                return None

        # MSR plans address sub-rows: one pread of the file range
        # [off*alpha, (off+n)*alpha) holds all alpha of a file's sub-rows,
        # so a one-slot cache serves the alpha consecutive reads
        # execute_plan makes per local file from that single pread
        _vblk: dict = {}

        def read_local_sub(vid: int, off: int, n: int) -> bytes | None:
            fsid = vid // alpha
            fd = local_fds.get(fsid)
            if fd is None:
                return None
            key = (fsid, off, n)
            blk = _vblk.get(key)
            if blk is None:
                try:
                    raw = os.pread(fd, n * alpha, off * alpha)
                except OSError:
                    return None
                if len(raw) != n * alpha:
                    return None
                blk = np.frombuffer(raw, np.uint8).reshape(n, alpha)
                _vblk.clear()
                _vblk[key] = blk
            return blk[:, vid % alpha].tobytes()

        remote_groups = [
            regen.HelperGroup(node=g["node"],
                              shards=tuple(int(s) for s in g["shards"]
                                           if int(s) not in lost),
                              locality=int(g.get("locality", 3)))
            for g in groups if g.get("shards")]
        predicted: dict = {"per_node": {}, "by_locality": {},
                           "remote": 0, "local": 0}
        done = 0
        for sid in lost:
            tmp = base + layout.to_ext(sid) + ".tmp"
            out_fd = os.open(tmp, os.O_RDWR | os.O_CREAT, 0o644)
            committed = False
            try:
                if spec.family == "msr":
                    # [alpha, n] sub-rows back into file byte order
                    def sink(off: int, rows: np.ndarray,
                             fd: int = out_fd) -> None:
                        _pwrite_all(fd, rows.T.reshape(-1), off * alpha)

                    planner, plan_code = regen.plan_msr_repair, codec
                    reader = read_local_sub
                else:
                    def sink(off: int, row: np.ndarray,
                             fd: int = out_fd) -> None:
                        _pwrite_all(fd, row, off)

                    planner, plan_code = regen.plan_repair, codec.code
                    reader = read_local

                local_group = regen.HelperGroup(
                    node="", shards=tuple(sorted(local_fds)), locality=0)
                with _Timer(stats, "reconstruct_s"):
                    plan = regen.repair_shard(
                        plan_code, codec, sid,
                        [local_group] + remote_groups, shard_size,
                        reader, fetch_partial, sink,
                        d=d, batch_size=batch_size,
                        align=regen.DEFAULT_SEG_ALIGN, cancel=cancel,
                        stats=stats, planner=planner)
                os.ftruncate(out_fd, shard_size)
                os.close(out_fd)
                out_fd = -1
                os.replace(tmp, base + layout.to_ext(sid))
                committed = True
                pred = plan.predicted_bytes()
                for key in ("remote", "local"):
                    predicted[key] += pred[key]
                for dim in ("per_node", "by_locality"):
                    for k_, v in pred[dim].items():
                        predicted[dim][k_] = predicted[dim].get(k_, 0) + v
                predicted["naive_remote"] = \
                    predicted.get("naive_remote", 0) + \
                    plan.naive_remote_bytes(len(local_group.shards))
                # the rebuilt shard is a local survivor for the next pass
                local_fds[sid] = os.open(base + layout.to_ext(sid),
                                         os.O_RDONLY)
                done += shard_size
                if progress is not None:
                    progress(done)
            finally:
                if out_fd >= 0:
                    os.close(out_fd)
                if not committed:
                    with contextlib.suppress(OSError):
                        os.remove(tmp)
        stats["wall_s"] = time.perf_counter() - t_wall
        return {"rebuilt": lost, "shard_size": shard_size,
                "helper_bytes": stats.get("helper_bytes", {}),
                "by_locality": stats.get("by_locality", {}),
                "predicted": predicted,
                "replans": stats.get("replans", 0),
                "dead_helpers": stats.get("dead_helpers", [])}
    finally:
        netflow.reset(flow_token)
        for fd in local_fds.values():
            os.close(fd)


def write_dat_file(base: str, dat_size: int,
                   large_block: int = layout.LARGE_BLOCK_SIZE,
                   small_block: int = layout.SMALL_BLOCK_SIZE,
                   out_path: str | None = None) -> None:
    """Data shard files -> `<base>.dat`, or `out_path` (row-major
    interleave copy; the recode decodes into a temporary name).  The
    stripe width k comes from the volume's .vif codec tag."""
    data_shards = codecs.parse_tag((read_vif(base) or {}).get("codec")).k
    rows = layout.n_large_rows(dat_size, large_block, small_block,
                               data_shards=data_shards)
    ins = [open(base + layout.to_ext(i), "rb")
           for i in range(data_shards)]
    written = 0
    try:
        with open(out_path or (base + ".dat"), "wb") as dat:
            for r in range(rows):
                for j in range(data_shards):
                    ins[j].seek(r * large_block)
                    n = min(large_block, dat_size - written)
                    if n <= 0:
                        return
                    dat.write(ins[j].read(n))
                    written += n
            small_base = rows * large_block
            r = 0
            while written < dat_size:
                for j in range(data_shards):
                    ins[j].seek(small_base + r * small_block)
                    n = min(small_block, dat_size - written)
                    if n <= 0:
                        return
                    dat.write(ins[j].read(n))
                    written += n
                r += 1
    finally:
        for f in ins:
            f.close()


def write_idx_from_ecx(ecx_path: str, idx_path: str | None = None) -> None:
    """.ecx (+ replayed .ecj tombstones) -> .idx for decode-to-volume."""
    idx_path = idx_path or ecx_path[: -len(".ecx")] + ".idx"
    deleted = read_ecj(ecx_path[: -len(".ecx")] + ".ecj")
    with open(ecx_path, "rb") as f:
        data = f.read()
    ids, offs, sizes = idxf.read_columns(data)
    with open(idx_path, "wb") as out:
        for nid, off, size in zip(ids.tolist(), offs.tolist(), sizes.tolist()):
            out.write(idxf.pack_entry(nid, off, size))
        for nid in deleted:
            out.write(idxf.pack_entry(nid, 0, t.TOMBSTONE_FILE_SIZE))


def write_sorted_ecx(idx_path: str, ecx_path: str | None = None) -> None:
    """.idx -> .ecx: 16-byte entries sorted by needle id ascending, ONE entry
    per id.  The .idx is a log, so the last occurrence of an id (re-write or
    tombstone) is its truth."""
    ecx_path = ecx_path or idx_path[: -len(".idx")] + ".ecx"
    with open(idx_path, "rb") as f:
        data = f.read()
    ids, offs, sizes = idxf.read_columns(data)
    latest: dict[int, tuple[int, int]] = {}
    for nid, off, size in zip(ids.tolist(), offs.tolist(), sizes.tolist()):
        latest[nid] = (off, size)
    with open(ecx_path, "wb") as out:
        for nid in sorted(latest):
            off, size = latest[nid]
            out.write(idxf.pack_entry(nid, off, size))


def write_vif(base: str, dat_size: int,
              version: int = t.CURRENT_VERSION,
              codec: str | None = None) -> None:
    doc: dict = {"version": version, "dat_file_size": dat_size}
    if codec:
        doc["codec"] = codec
    with open(base + ".vif", "w") as f:
        json.dump(doc, f)


def read_vif(base: str) -> dict | None:
    try:
        with open(base + ".vif") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def volume_codec_tag(base: str) -> str:
    """Codec tag of an EC volume from its .vif sidecar.  Volumes written
    before codec tags existed (or whose .vif is missing) are RS."""
    return codecs.parse_tag((read_vif(base) or {}).get("codec")).tag


def find_dat_file_size(base: str, version: int = t.CURRENT_VERSION) -> int:
    """The original .dat size: the encode-time size from the .vif sidecar
    when present, else the max end offset of live .ecx entries
    (reference: ec_decoder.go:48-70)."""
    vif = read_vif(base)
    if vif and "dat_file_size" in vif:
        return int(vif["dat_file_size"])
    with open(base + ".ecx", "rb") as f:
        data = f.read()
    _, offs, sizes = idxf.read_columns(data)
    max_end = 0
    for off, size in zip(offs.tolist(), sizes.tolist()):
        if t.size_is_valid(size):
            end = t.from_offset_units(off) + t.actual_size(size, version)
            max_end = max(max_end, end)
    return max_end


def read_ecj(ecj_path: str) -> list[int]:
    """Deletion journal: 8-byte big-endian needle ids, appended per delete."""
    if not os.path.exists(ecj_path):
        return []
    with open(ecj_path, "rb") as f:
        data = f.read()
    n = len(data) // 8
    return [int.from_bytes(data[i * 8:(i + 1) * 8], "big") for i in range(n)]
