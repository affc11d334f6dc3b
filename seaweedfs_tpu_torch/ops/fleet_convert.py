"""Batched multi-volume EC conversion: one stream of unit batches on the card.

Counterpart of `seaweedfs_tpu/ops/fleet_convert.py`.  `write_ec_files`
converts one volume, and between volumes the card drains and the writers
idle.  Fleet conversion (what operators run to turn a backlog of sealed
cold volumes into EC shard sets) interleaves N volumes' column units into
one stream of [U, k, W] unit batches, each encoded by one launch of the
batched kernel (K2, `dispatch.dispatch_parity_batch`):

    reader     stages units round-robin across volumes into a pooled
               pinned [U, k, W] host batch; data shards go to each
               volume's writers by in-kernel copy (they never visit the
               card), through the volume's data flusher
    dispatch   (caller's thread, on its own CUDA stream) copies the batch
               into the slot's device buffer and launches K2 on it
    drain      waits on the dispatch's event, copies parity D2H
               (`dispatch.unit_parity_shards`: on a mesh, position by
               position) and fans rows out to the owning volume's
               parity flusher, flushing the volumes each block touched,
               then returns the slot to the pool; a volume whose
               last unit lands is finalized (both flushers flushed, cut
               to size, .vif, .tmp -> rename) while the stream feeds the
               others
    writers    one _ShardWriterPool per volume, a write engine per worker

W is the widest unit step of any volume, so one pool serves a fleet that
mixes large- and small-block volumes; shorter units are zero-filled to W,
as the reference does.  Any error aborts the whole run: volumes not yet
committed roll back to their previous shard set (or to none), committed
ones stay.

`progress(bytes_done)` sees the volume bytes staged across the fleet;
`cancel()`, polled before each batch, aborts the whole run with
EncodeCancelled (the volume server's /admin/ec/fleet_convert and
/admin/ec/cancel drive both).

The geometry is fixed: UNIT_BATCH units per batch (rounded up to an
even split over a mesh's positions), PIPELINE_DEPTH batches in flight
(the reference's defaults).  The codec (`fleet_codec`, or the caller's
`codec=`) is a mesh's `FleetUnitEncoder` (parallel/mesh.py), which
splits each batch over its positions, one K2 launch per position holding
units, and streams each position's parity back as it completes
(`dispatch.unit_parity_shards`); or the EC codec on one card; or the
native host codec, which encodes a batch unit by unit and needs no
device buffer.
"""

from __future__ import annotations

import contextlib
import functools
import os
import queue
import threading
import time

import numpy as np
import torch

from seaweedfs_tpu_torch.maintenance import faults
from seaweedfs_tpu_torch.ops import codecs
from seaweedfs_tpu_torch.ops.dispatch import (Pending, device_empty,
                                              dispatch_parity_batch,
                                              host_empty, unit_parity_shards)
from seaweedfs_tpu_torch.stats import netflow, pipeline
from seaweedfs_tpu_torch.storage.ec import layout
from seaweedfs_tpu_torch.storage.ec.ec_files import (
    DEFAULT_BATCH, EncodeCancelled, _book_stage_bytes, _get_codec,
    _iter_units,
    _map_readonly, _ShardFlusher, _ShardWriterPool, _Timer, _unit_coverage,
    _unit_steps, overlap_fraction, write_vif)

UNIT_BATCH = 4  # units per batch: one K2 launch, or one per position
PIPELINE_DEPTH = 2  # batches in flight: the pool holds one more

CONVERT_KINDS = ("mesh", "fleet", "cuda", "native")


@functools.lru_cache(maxsize=4)
def _fleet_unit_encoder(k: int, m: int, positions: tuple):
    from seaweedfs_tpu_torch.models import rs
    from seaweedfs_tpu_torch.parallel import mesh
    return mesh.FleetUnitEncoder(rs.get_code(k, m), mesh.make_mesh(
        devices=list(positions), axis_names=("unit",)))


def fleet_codec(kind: str | None = None, device=None):
    """The codec a fleet conversion rides, by `kind` (None: the
    WEEDTPU_CONVERT_CODEC knob): "mesh" or "fleet", a `FleetUnitEncoder`
    over the positions `device` names (None: every card); "cuda" or
    "native", the EC codec of that kind on `device`; unset, the
    `FleetUnitEncoder` over every card when more than one is attached and
    `device` names no single one, else `ec_files._get_codec(device)`
    (WEEDTPU_EC_CODEC's).  Any other value raises, where the reference
    hands it to its EC codec's selection, whose last resort takes
    anything."""
    from seaweedfs_tpu_torch.parallel import mesh
    kind = kind or os.environ.get("WEEDTPU_CONVERT_CODEC") or None
    k, m = layout.DATA_SHARDS, layout.PARITY_SHARDS
    if kind in ("mesh", "fleet"):
        return _fleet_unit_encoder(k, m, tuple(mesh.mesh_devices(device)))
    if kind in ("cuda", "native"):
        return codecs.make_codec(codecs.DEFAULT_TAG, device, kind)
    if kind is not None:
        raise ValueError(f"WEEDTPU_CONVERT_CODEC={kind!r}: the port takes "
                         f"{', '.join(CONVERT_KINDS)} (unset: the mesh of "
                         f"every card when there are several)")
    if device is None and torch.cuda.is_available() and \
            torch.cuda.device_count() > 1:
        return _fleet_unit_encoder(k, m, tuple(mesh.mesh_devices(None)))
    return _get_codec(device)


class _VolumeJob:
    """One volume mid-conversion: source map, recycled .tmp shard fds, its
    writer pool, and completion accounting."""

    def __init__(self, base: str, large_block: int, small_block: int,
                 batch_size: int, stats: dict):
        self.base = base
        self.dat_path = base + ".dat"
        self.dat_size = os.path.getsize(self.dat_path)
        self.shard_size = layout.shard_file_size(
            self.dat_size, large_block, small_block)
        self.tmp_paths = [base + layout.to_ext(i) + ".tmp"
                          for i in range(layout.TOTAL_SHARDS)]
        self.out_fds = [os.open(p, os.O_RDWR | os.O_CREAT, 0o644)
                        for p in self.tmp_paths]
        self.dat_f = open(self.dat_path, "rb")
        self.mm = None
        self.view: np.ndarray | None = None
        if self.dat_size:
            self.mm = _map_readonly(self.dat_f.fileno(), self.dat_size)
            self.view = np.frombuffer(self.mm, dtype=np.uint8)
        self.committed = False
        self._stats = stats
        self.highwater = [0] * layout.TOTAL_SHARDS
        k = layout.DATA_SHARDS
        self.writers = _ShardWriterPool(
            self.out_fds, self.highwater, stats,
            stage_key=lambda i: "write_data_s" if i < k
            else "write_parity_s")
        # one submission batcher per producer thread (a flusher is
        # unlocked): the reader's data-shard copies, the drain's parity
        self.data_flusher = _ShardFlusher(self.writers, layout.TOTAL_SHARDS)
        self.parity_flusher = _ShardFlusher(self.writers,
                                            layout.TOTAL_SHARDS)
        self.units = _iter_units(self.dat_size, large_block, small_block,
                                 batch_size)
        # one unit of lookahead: the last unit is known as the last when it
        # is read, so the drain can finalize the moment it lands
        self._ahead = next(self.units, None)
        self.units_read = 0
        self.units_total: int | None = 0 if self._ahead is None else None
        self.units_drained = 0  # written by the drain thread only
        self.units_skipped = 0  # written by the reader thread only

    def next_unit(self):
        u, self._ahead = self._ahead, next(self.units, None)
        if u is not None:
            self.units_read += 1
            if self._ahead is None:
                self.units_total = self.units_read
        return u

    def drained_all(self) -> bool:
        return self.units_total is not None and \
            self.units_drained + self.units_skipped >= self.units_total

    def finalize(self) -> None:
        """All units drained: barrier on the writers, cut the shards to
        size, commit by rename.  Runs on the drain thread while the stream
        keeps feeding the other volumes.  The reader is done with the
        volume's data flusher by then: a unit reaches the drain only after
        the reader has queued its copies."""
        self.data_flusher.flush()
        self.parity_flusher.flush()
        self.writers.close()
        if self.writers.errors:
            raise self.writers.errors[0]
        for fd, hw in zip(self.out_fds, self.highwater):
            os.ftruncate(fd, min(hw, self.shard_size))
            if hw < self.shard_size:
                os.ftruncate(fd, self.shard_size)
        for fd in self.out_fds:
            os.close(fd)
        self.out_fds = []
        # no codec key, as the reference fleet writes it: a reader takes a
        # missing key as RS
        write_vif(self.base, self.dat_size)
        for i, p in enumerate(self.tmp_paths):
            os.replace(p, self.base + layout.to_ext(i))
        self.committed = True
        # a caller that must react per volume sees the commits even when a
        # later volume fails the run
        self._stats.setdefault("committed_bases", []).append(self.base)

    def abort(self) -> None:
        """Failure path: drop the fds and every .tmp, so no partial shard
        set is ever visible; a previous shard set stays untouched."""
        self.writers.close()
        for fd in self.out_fds:
            with contextlib.suppress(OSError):
                os.close(fd)
        self.out_fds = []
        if not self.committed:
            for p in self.tmp_paths:
                with contextlib.suppress(OSError):
                    os.remove(p)

    def release(self) -> None:
        self.view = None
        if self.mm is not None:
            with contextlib.suppress(BufferError):
                self.mm.close()  # a traceback may still hold views
            self.mm = None
        self.dat_f.close()


def _wait(parity) -> None:
    """Wait for every event of a dispatch's result."""
    if isinstance(parity, Pending):
        events = [parity.event]
    else:
        events = [s.event for s in getattr(parity, "shards", ())]
    for ev in events:
        if ev is not None:
            ev.synchronize()


def convert_volumes(bases: list[str], *,
                    large_block: int = layout.LARGE_BLOCK_SIZE,
                    small_block: int = layout.SMALL_BLOCK_SIZE,
                    batch_size: int = DEFAULT_BATCH, progress=None,
                    cancel=None, stats: dict | None = None,
                    device=None, codec=None) -> dict:
    """Convert the volumes `<base>.dat` into EC shard sets through one
    interleaved stream of unit batches through `codec` (None:
    `fleet_codec(device=device)`; `device` None means the card, and raises
    without one).  Returns per-volume accounting.

    `progress(bytes_done)` sees the total volume bytes staged so far;
    `cancel()` is polled before each batch and, when true, aborts the
    run with EncodeCancelled (volumes not yet committed roll back).

    `stats` receives per-stage seconds, `mode`, `unit_batch`,
    `committed_bases`, `volumes`, `units`, `overlap_frac` and the write
    engine's keys (`ec_files._ShardWriterPool`).  The run is tracked as a
    `fleet_convert` pipeline job, and its threads carry the `convert`
    traffic class (unless the caller declared one)."""
    if not bases:
        return {"volumes": {}, "bytes": 0}
    codec = codec if codec is not None else fleet_codec(device=device)
    device = codec.device
    # an armed shard_write_error fails the run like a dying disk, before
    # any tmp shard file exists
    for base in bases:
        faults.check_shard_write(base)
    k, m = layout.DATA_SHARDS, layout.PARITY_SHARDS
    placing = getattr(codec, "place", None) is not None
    # a mesh takes an even split of units over its positions
    U = codec.unit_slots(UNIT_BATCH) if placing else UNIT_BATCH
    stats = stats if stats is not None else {}
    stats["mode"] = "fleet"
    stats["unit_batch"] = U
    t_wall = time.perf_counter()
    jobs: list[_VolumeJob] = []
    pool: queue.Queue = queue.Queue()
    try:
        for b in bases:
            jobs.append(_VolumeJob(b, large_block, small_block, batch_size,
                                   stats))
        # one staging width covers every volume (shorter units zero-fill);
        # each slot is a pinned host batch and its device twin: a mesh's
        # buffer on each position, one card's padded buffer, or none (a
        # host codec's slot is the host batch alone)
        W = max(_unit_steps(j.dat_size, large_block, small_block,
                            batch_size)[1] for j in jobs)
        for _ in range(PIPELINE_DEPTH + 1):
            twin = codec.empty_slot(U, W) if placing else \
                device_empty((U, k, W), device) \
                if device.type == "cuda" else None
            pool.put((host_empty((U, k, W), device), twin))
    except BaseException:
        for job in jobs:
            job.abort()
            job.release()
        raise
    stats["bytes"] = sum(j.dat_size for j in jobs)
    # the class is per thread: stamped here and on each pipeline thread
    flow_cls = netflow.current_class() or "convert"
    flow_token = netflow.set_class(flow_cls)
    q_read: queue.Queue = queue.Queue(maxsize=PIPELINE_DEPTH)
    q_disp: queue.Queue = queue.Queue()  # bounded by the pool
    errors: list[BaseException] = []

    def reader() -> None:
        """Round-robin units across volumes into staged unit batches."""
        active = list(jobs)
        done_total = 0
        netflow.set_class(flow_cls)
        try:
            while active and not errors:
                if cancel is not None and cancel():
                    raise EncodeCancelled("fleet conversion cancelled")
                with _Timer(stats, "stall_s"):
                    slot = pool.get()
                buf = slot[0].numpy()
                metas = []
                with _Timer(stats, "read_s"):
                    while len(metas) < U and active:
                        # index by units filled so far, so ragged endings
                        # land the same units in the same slots
                        job = active[len(metas) % len(active)]
                        unit = job.next_unit()
                        if unit is None:
                            active.remove(job)
                            continue
                        row_start, block, col, step, shard_off = unit
                        nz, tail = _unit_coverage(
                            job.dat_size, row_start, block, col, step)
                        if nz == 0:  # wholly beyond the .dat: a hole
                            job.units_skipped += 1
                            continue
                        for j in range(nz):
                            job.data_flusher.copy(
                                j, job.dat_f.fileno(),
                                row_start + j * block + col, shard_off,
                                step if j < nz - 1 else tail, job.view)
                        unit_buf = buf[len(metas)]
                        for j in range(k):
                            off = row_start + j * block + col
                            n = max(0, min(step, job.dat_size - off))
                            if n > 0:
                                np.copyto(unit_buf[j, :n],
                                          job.view[off:off + n])
                            if n < W:
                                unit_buf[j, n:] = 0
                        metas.append((job, shard_off, step))
                        job.data_flusher.account(step)
                        done_total += (nz - 1) * step + tail
                    if progress is not None:
                        progress(done_total)
                if metas:
                    q_read.put((slot, metas))
                else:
                    pool.put(slot)
        except BaseException as e:  # surfaced by the caller's thread
            errors.append(e)
        finally:
            q_read.put(None)

    def drain() -> None:
        """Sync each batch, fan its parity rows out, and finalize each
        volume the moment its last unit lands."""
        failed = False
        netflow.set_class(flow_cls)
        while True:
            item = q_disp.get()
            if item is None:
                return
            slot, metas, parity = item
            try:
                if failed or errors:
                    continue
                # block by block as each position's event fires (one
                # block off one card), each block's parity on to the
                # writers before the next is waited for
                blocks = unit_parity_shards(parity)
                while True:
                    with _Timer(stats, "d2h_s"):
                        blk = next(blocks, None)
                    if blk is None:
                        break
                    a, b, out = blk
                    touched = []
                    for rows, (job, shard_off, step) in zip(out,
                                                            metas[a:b]):
                        # views of the pinned D2H buffer: each queued row
                        # keeps it alive until the writer has written it
                        for i in range(m):
                            job.parity_flusher.put(k + i, rows[i, :step],
                                                   shard_off)
                        job.parity_flusher.account(step)
                        job.units_drained += 1
                        if job.drained_all():
                            job.finalize()
                        elif job not in touched:
                            touched.append(job)
                    # the block's parity goes to the writers now, not at
                    # the volume's next flush group
                    for job in touched:
                        job.parity_flusher.flush()
                # every block's event has fired: the devices are done
                # with the slot's buffers
                pool.put(slot)
                slot = None
            except BaseException as e:  # surfaced by the caller's thread
                errors.append(e)
                failed = True
            finally:
                if slot is not None:
                    _wait(parity)  # a device may still read the slot
                    pool.put(slot)

    t_r = threading.Thread(target=reader, name="fleet-reader", daemon=True)
    t_d = threading.Thread(target=drain, name="fleet-drain", daemon=True)
    pjob = pipeline.track("fleet_convert", stats, stats["bytes"],
                          meta={"volumes": len(jobs), "unit_batch": U})
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
                # stage-queue depths at the consume site: a full q_read
                # says the dispatch bounds the run, a deep q_disp the
                # drain and writers
                pjob.queue("q_read", q_read.qsize(), PIPELINE_DEPTH)
                pjob.queue("q_disp", q_disp.qsize())
                slot, metas = item
                if errors:
                    pool.put(slot)
                    continue
                nu = len(metas)  # a ragged last batch launches its units only
                try:
                    with _Timer(stats, "encode_s"):
                        parity = dispatch_parity_batch(
                            codec, slot[0][:nu],
                            staging=slot[1] if placing or slot[1] is None
                            else slot[1][:nu])
                    q_disp.put((slot, metas, parity))
                except BaseException:
                    if stream is not None:  # an H2D may read the slot
                        for dev in set(codec.mesh.devices.flat) \
                                if placing else (device,):
                            torch.cuda.synchronize(dev)
                    pool.put(slot)
                    raise
    except BaseException as e:  # stops the reader; rolls the run back
        errors.append(e)
    finally:
        q_disp.put(None)
        t_d.join()
        while t_r.is_alive():  # unblock a reader stuck on a full q_read
            try:
                item = q_read.get(timeout=0.05)
            except queue.Empty:
                continue
            if item is not None:
                pool.put(item[0])
        t_r.join()
        # empty volumes never enter the stream: commit them here; on any
        # error roll every uncommitted volume back
        for job in jobs:
            try:
                if not errors and not job.committed and job.drained_all():
                    job.finalize()
            except BaseException as e:
                errors.append(e)
        for job in jobs:
            if errors and not job.committed:
                job.abort()
            job.release()
        netflow.reset(flow_token)
        stats["wall_s"] = time.perf_counter() - t_wall
        # only committed volumes' bytes: an aborted run must not be
        # credited with bytes it never moved
        done = [j for j in jobs if j.committed]
        _book_stage_bytes(pjob, stats, sum(j.dat_size for j in done),
                          layout.PARITY_SHARDS *
                          sum(j.shard_size for j in done))
        pjob.finish(errors[0] if errors else None)
    if errors:
        raise errors[0]
    stats["volumes"] = len(jobs)
    stats["units"] = sum(j.units_read for j in jobs)
    frac = overlap_fraction(stats)
    if frac is not None:
        stats["overlap_frac"] = frac
    return {"volumes": {j.base: {"bytes": j.dat_size,
                                 "shard_size": j.shard_size}
                        for j in jobs},
            "bytes": stats["bytes"], "units": stats["units"],
            "wall_s": round(stats["wall_s"], 4)}

