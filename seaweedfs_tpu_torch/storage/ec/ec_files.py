"""EC shard file generation and rebuild on the card.

Counterpart of `seaweedfs_tpu/storage/ec/ec_files.py` (reference:
weed/storage/erasure_coding/ec_encoder.go, ec_decoder.go).  A volume's
.dat streams through the codec as [k, B] uint8 batches; data shards are
written straight from the .dat and only parity ([m, B]) comes back from
the device.  The files are byte-identical to the reference package's.

  write_ec_files      <- WriteEcFiles (ec_encoder.go:56)
  rebuild_ec_files    <- RebuildEcFiles (ec_encoder.go:91)
  rebuild_ec_reduced  reduced-read repair of lost shards (ops/regen.py)
  write_sorted_ecx    <- WriteSortedFileFromIdx (ec_encoder.go:27)
  find_dat_file_size  <- FindDatFileSize (ec_decoder.go:48)

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
import threading
import time

import numpy as np
import torch

from seaweedfs_tpu_torch import native
from seaweedfs_tpu_torch.ops import codecs, regen
from seaweedfs_tpu_torch.ops.dispatch import (
    dispatch_parity as _dispatch_parity,
    device_empty as _device_empty,
    host_empty as _host_empty,
    materialize as _materialize,
    reconstruct_batch as _reconstruct_batch,
)
from seaweedfs_tpu_torch.ops.native_codec import NativeRSCodec
from seaweedfs_tpu_torch.storage import idx as idxf
from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage.ec import layout

DEFAULT_BATCH = 16 * 1024 * 1024  # bytes per shard per device round-trip

PIPELINE_DEPTH = 3  # batch buffers in flight: read N+1 / encode N / drain N-1
WRITER_DEPTH = 4  # queued writes per shard fd before submission blocks
RING_ALIGN = 4096  # host ring buffers start on O_DIRECT's alignment


def _get_codec(device=None, tag: str | None = None):
    """The EC codec for `tag` (None: RS(10,4)).  Its backend kind is the
    WEEDTPU_EC_CODEC knob (`codecs.make_codec`): unset or "cuda" runs
    the kernel on `device` ("cuda" or None; raises without a card), or
    the same codec shell over the plain version when `device` is "cpu";
    "native" the host codec; any other value raises.  No fallback between
    them."""
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


def _pwrite_all(fd: int, buf, off: int) -> None:
    view = memoryview(np.ascontiguousarray(buf)).cast("B")
    while view:
        n = os.pwrite(fd, view, off)
        view = view[n:]
        off += n


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


def _aligned_empty(shape) -> np.ndarray:
    """An uninitialised uint8 array whose base is RING_ALIGN-aligned."""
    n = int(np.prod(shape))
    raw = np.empty(n + RING_ALIGN, dtype=np.uint8)
    off = -raw.ctypes.data % RING_ALIGN
    return raw[off:off + n].reshape(shape)


def _parity_ring_size() -> int:
    """Buffers in the host codec's parity ring: the pipeline's depth and
    one more.  Each row goes to its writer as one job and comes back when
    written, so no batch of unflushed jobs has to fit in the ring."""
    return PIPELINE_DEPTH + 1


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
    """pwrite / copy_file_range workers over the shard fds behind bounded
    queues.  Shards map to workers by a fixed shard -> worker stripe, so
    writes to one shard stay in order while different shards land
    concurrently.  Workers never die: after the first error they drain
    the rest without touching the fds (still calling their release
    hooks), so producers cannot deadlock on a full queue or an empty
    ring; the error surfaces via `.errors` after close().  Busy seconds
    fold into stats[stage_key(shard)] on close."""

    def __init__(self, fds, highwater=None, stats=None, stage_key=None):
        self._fds = list(fds)
        self._hw = highwater
        self._stats = stats
        self._stage_key = stage_key or (lambda i: "write_s")
        self._nworkers = max(1, min(len(self._fds),
                                    _writer_threads(len(self._fds))))
        per = -(-len(self._fds) // self._nworkers)
        self._queues = [queue.Queue(maxsize=WRITER_DEPTH * per)
                        for _ in range(self._nworkers)]
        self._busy = [0.0] * len(self._fds)
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

    def put(self, shard: int, data, off: int, release=None) -> None:
        """Queue a pwrite of a 1-D uint8 buffer at `off`; the queue item
        keeps `data` alive until it is written.  `release()`, when given,
        is called once the write is done or skipped, after which the
        caller may reuse `data`'s memory."""
        self._queues[shard % self._nworkers].put(
            (shard, data, None, off, release))

    def copy(self, shard: int, src_fd: int, src_off: int, dst_off: int,
             count: int, src_view) -> None:
        """Queue an in-kernel copy of a source range into the shard file."""
        self._queues[shard % self._nworkers].put(
            (shard, None, (src_fd, src_off, count, src_view), dst_off,
             None))

    def _run(self, w: int) -> None:
        q = self._queues[w]
        while True:
            item = q.get()
            if item is None:
                return
            shard, data, cfr, off, release = item
            try:
                if not self.errors:  # else drain without touching the fds
                    self._write(shard, data, cfr, off)
            finally:
                if release is not None:
                    release()

    def _write(self, shard: int, data, cfr, off: int) -> None:
        fd = self._fds[shard]
        t0 = time.perf_counter()
        try:
            if cfr is not None:
                src_fd, src_off, count, src_view = cfr
                _copy_range(src_fd, fd, src_off, off, count, src_view)
                end = off + count
            else:
                _pwrite_all(fd, data, off)
                end = off + len(data)
            if self._hw is not None and end > self._hw[shard]:
                self._hw[shard] = end
        except BaseException as e:  # surfaced after close
            self.errors.append(e)
        self._busy[shard] += time.perf_counter() - t0

    def close(self) -> None:
        """Drain every queue, join the workers, fold busy seconds into
        stats.  Idempotent; does not raise (callers read `.errors`)."""
        if self._closed:
            return
        self._closed = True
        for q in self._queues:
            q.put(None)
        for th in self._threads:
            th.join()
        if self._stats is not None:
            for i, busy in enumerate(self._busy):
                key = self._stage_key(i)
                self._stats[key] = self._stats.get(key, 0.0) + busy


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


def _max_step(dat_size: int, large_block: int, small_block: int,
              batch_size: int, data_shards: int) -> int:
    """The widest column batch _iter_units cuts for this volume: it sizes
    the pooled staging buffers (a small-block-only volume never needs
    large-step buffers)."""
    if dat_size > large_block * data_shards:
        return max(min(batch_size, large_block), min(batch_size, small_block))
    return min(batch_size, small_block)


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
    """Stream the .dat through the codec into the shard fds.  Units wholly
    beyond the .dat are never read, encoded or written: their parity is
    zero, so they become holes."""
    stats["mode"] = "pipelined"
    stats["bytes"] = dat_size
    shard_size = layout.shard_file_size(dat_size, large_block, small_block,
                                        data_shards=codec.k)
    highwater = [0] * (codec.k + codec.m)
    if dat_size > 0:
        t_wall = time.perf_counter()
        with open(dat_path, "rb") as datf:
            mm = _map_readonly(datf.fileno(), dat_size)
            dat_view = np.frombuffer(mm, dtype=np.uint8)
            try:
                _encode_pipelined(codec, datf.fileno(), dat_view, dat_size,
                                  large_block, small_block, batch_size,
                                  out_fds, highwater, progress, cancel, stats)
            finally:
                del dat_view
                with contextlib.suppress(BufferError):
                    mm.close()  # a traceback may still hold views
        stats["wall_s"] = time.perf_counter() - t_wall
    _finalize_shards(out_fds, highwater, shard_size)


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
    native.gf_matmul_ptrs(mat, rows, list(pbuf), step)


def _encode_pipelined(codec, dat_fd: int, dat_view: np.ndarray,
                      dat_size: int, large_block: int, small_block: int,
                      batch_size: int, out_fds, highwater,
                      progress, cancel, stats: dict) -> None:
    """Overlapped reader -> dispatch -> drain -> shard-writer pipeline.

      reader   walks the units; data shards go to their writers by
               in-kernel copy on the way (they never visit the device),
               and the stripe is staged from the mmap into a pooled
               pinned host buffer (read_s)
      dispatch (caller's thread, on its own CUDA stream) copies the
               stripe into the slot's device buffer and enqueues the
               parity kernel on a [:, :step] view of it (encode_s)
      drain    waits on the dispatch's event and copies parity D2H
               (d2h_s), returns the slot to the pool, and hands the m
               parity rows to their writers
      writers  pwrite workers over the shard fds

    The pool of (host, device) slots is the backpressure: a slot comes
    back only once its parity is on the host, so neither buffer is
    overwritten while the device may still read it.

    The native codec skips the staging: the reader passes each unit's
    coverage on, the dispatch computes its parity off the mmap into a
    buffer of the parity ring (`_host_parity_unit`; waiting for one is
    stall_s), and the drain hands its rows to the writers, which return
    it to the ring once all m are written."""
    device = codec.device
    host = isinstance(codec, NativeRSCodec)
    k, m = codec.k, codec.m
    max_step = _max_step(dat_size, large_block, small_block, batch_size, k)
    pool: queue.Queue = queue.Queue()
    if host:
        tailbuf = np.zeros(max_step, dtype=np.uint8)
        for _ in range(_parity_ring_size()):
            pool.put(_aligned_empty((m, max_step)))
    else:
        for _ in range(PIPELINE_DEPTH):
            dev = _device_empty((k, max_step), device) \
                if device.type == "cuda" else None
            pool.put((_host_empty((k, max_step), device), dev))
    q_read: queue.Queue = queue.Queue(maxsize=PIPELINE_DEPTH)
    q_disp: queue.Queue = queue.Queue()  # bounded by the pool
    errors: list[BaseException] = []
    writers = _ShardWriterPool(
        out_fds, highwater, stats,
        stage_key=lambda i: "write_data_s" if i < k else "write_parity_s")
    done = 0

    def reader() -> None:
        nonlocal done
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
                    writers.copy(j, dat_fd, row_start + j * block + col,
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
                if progress is not None:
                    progress(done)
        except BaseException as e:  # surfaced by the caller's thread
            errors.append(e)
        finally:
            q_read.put(None)

    def drain() -> None:
        while True:
            item = q_disp.get()
            if item is None:
                return
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
                    writers.put(k + i, parity[i, :step], shard_off,
                                release=release)
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
                writers.put(k + i, pnp[i, :step], shard_off)

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
                slot, step, shard_off, coverage = item
                if errors or writers.failed:
                    if slot is not None:
                        pool.put(slot)
                    continue
                if host:
                    row_start, block, col, nz, tail = coverage
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
                     device=None) -> list[int]:
    """Regenerate whichever shard files are missing from the present
    ones, under the code the `.vif` names; returns the rebuilt shard ids.

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
    ec_encoder.go:237-291).  `stats` gets mode, bytes, codec,
    reconstruct_s, stall_s, write_s and wall_s."""
    spec = codecs.parse_tag((read_vif(base) or {}).get("codec"))
    present = [i for i in range(spec.n)
               if os.path.exists(base + layout.to_ext(i))]
    missing = [i for i in range(spec.n) if i not in present]
    if not missing:
        return []
    if len(present) < spec.k:
        raise ValueError(
            f"need >= {spec.k} shards to rebuild, have {len(present)}")
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
        writers = _ShardWriterPool([out_fds[i] for i in missing], None, stats)
        wpos = {i: r for r, i in enumerate(missing)}
        if shard_size:
            for i, f in ins.items():
                maps[i] = _map_readonly(f.fileno(), shard_size)
                views[i] = np.frombuffer(maps[i], dtype=np.uint8)
        if host and shard_size:
            _, dec = codec.decoder(tuple(present), tuple(missing))
            ring: queue.Queue = queue.Queue()
            for _ in range(PIPELINE_DEPTH):
                ring.put(_aligned_empty(
                    (len(missing), min(batch_size, shard_size))))
        done = 0
        for off in range(0, shard_size, batch_size):
            if cancel is not None and cancel():
                raise EncodeCancelled("ec rebuild cancelled")
            if writers.failed:
                break
            n = min(batch_size, shard_size - off)
            if host:
                with _Timer(stats, "stall_s"):
                    obuf = ring.get()
                with _Timer(stats, "reconstruct_s"):
                    native.gf_matmul_ptrs(
                        dec.C, [views[i][off:off + n] for i in use],
                        list(obuf), n)
                release = _countdown(len(missing),
                                     lambda b=obuf: ring.put(b))
                for i in missing:
                    writers.put(wpos[i], obuf[wpos[i], :n], off,
                                release=release)
            else:
                with _Timer(stats, "reconstruct_s"):
                    rebuilt = _reconstruct_batch(
                        codec, {i: views[i][off:off + n] for i in use},
                        missing)
                for i in missing:
                    writers.put(wpos[i], rebuilt[i], off)
            done += n * len(use)
            if progress is not None:
                progress(done)
        writers.close()
        if writers.errors:
            raise writers.errors[0]
        for fd in out_fds.values():
            os.ftruncate(fd, shard_size)
        stats["wall_s"] = time.perf_counter() - t_wall
        ok = True
    finally:
        if writers is not None:
            writers.close()  # idempotent; the fds must outlive the workers
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
                       stats: dict | None = None, device=None) -> dict:
    """Reduced-read rebuild of the `lost` shards under the code the `.vif`
    names: instead of copying k full survivor shards here, each remote
    helper node ships XOR-combinable partial products (ops/regen.py), so
    repair bytes per remote node drop to one range per lost shard (RS),
    one range inside the lost shard's local group (LRC single loss), or
    one sub-row per held shard (MSR), and the output is byte-identical to
    a full decode.

    `groups` lists the REMOTE helper nodes: {"node": name, "shards":
    [ids], "locality": class}.  The local survivor group is the shard
    files next to `base`, and each rebuilt shard joins it for the next
    pass.  `fetch_partial(group, shards, coeff_rows, offset, size) ->
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

    Returns the accounting: measured helper bytes per node and locality
    class, the completed plans' predictions (with the naive copy-then-
    rebuild cost, `naive_remote`), replans and dead helpers.  `stats`,
    when a dict, also gets mode, bytes, codec, reconstruct_s, wall_s and
    the repairing thread's stage seconds (regen.execute_plan)."""
    spec = codecs.parse_tag((read_vif(base) or {}).get("codec"))
    codec = _get_codec(device, spec.tag)
    alpha = spec.alpha
    batch_size = DEFAULT_BATCH
    if spec.family == "msr":
        batch_size = max(alpha, batch_size // alpha)
    lost = sorted(set(lost))
    local_fds: dict[int, int] = {}
    stats = stats if stats is not None else {}
    stats.setdefault("mode", "reduced")
    t_wall = time.perf_counter()
    try:
        shard_size = 0
        for i in range(spec.n):
            p_ = base + layout.to_ext(i)
            if i not in lost and os.path.exists(p_):
                local_fds[i] = os.open(p_, os.O_RDONLY)
                shard_size = max(shard_size, os.path.getsize(p_))
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
                        align=regen.DEFAULT_SEG_ALIGN, stats=stats,
                        planner=planner)
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
        for fd in local_fds.values():
            os.close(fd)


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
