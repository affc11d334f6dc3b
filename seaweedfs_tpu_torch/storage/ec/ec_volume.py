"""EC volume runtime: serve needle reads and deletes from shard files.

Counterpart of `seaweedfs_tpu/storage/ec/ec_volume.py` (reference:
weed/storage/erasure_coding/ec_volume.go, ec_shard.go, store_ec.go).  The
.ecx index is loaded as numpy columns and binary-searched in memory; the
file stays the source of truth and deletes are written through (plus the
.ecj journal, replayed at open).

Reads take an optional `shard_reader(shard_id, offset, size)` that
fetches a range from a peer (the volume server's remote shard reader).
A needle read plans every interval up front, coalesces adjacent ranges of
one shard file, probes the reconstruction LRU, reads the local shards
concurrently on one shared pool, fetches what the local disks miss from
peers, and rebuilds every range still missing in ONE codec dispatch: the
survivor slices of all failed ranges concatenate column-wise into a
single GF(2^8) apply (RS and LRC decode byte position by byte position,
MSR alpha-block by alpha-block, so concatenated ranges rebuild exactly
as they would one by one).  `mode="serial"` (or WEEDTPU_EC_READ=serial)
is the per-interval loop, the baseline.

The remote wait is hedged (utils/resilience.py): after
`resilience.hedge_delay_s()` the ranges still in flight go to
reconstruction from other survivors; if that finds too few, the read
waits out the abandoned fetches under the ambient deadline.  Outcomes
count into `weedtpu_hedge_total{outcome}` (fired, hedge_won,
primary_rescued).

The volume's code comes from its `.vif` (`spec`).  The survivors a
reconstruction gathers are the codec's basis (`codec.basis`): an LRC
single loss reads its own local group (r + 1 shards at most), through
the reader where a member is remote, and retries unrestricted when the
basis cannot be read; MSR widens each range to alpha boundaries and
slices the lead back off after the decode.  Without a reader, a basis
naming a shard absent from the local disk is not tried.

Scrub-verdicted ranges (`quarantine_range`) read as unreadable, so every
caller reconstructs them.  Each read records the reference's spans under
a sampled trace (`ec.plan`, `ec.coalesce`, `ec.local_pread`,
`ec.remote_fetch`, `ec.gather_survivors`, `ec.reconstruct_batch`), books
its stages into the process's `ec_read` flow account, and a read that
reconstructs under foreground traffic marks the volume `degraded` in the
heat tracker.
"""

from __future__ import annotations

import copy
import os
import threading
import time
from collections import OrderedDict
from concurrent.futures import (ThreadPoolExecutor,
                                TimeoutError as _FutTimeout,
                                as_completed, wait as _futures_wait)
from typing import Callable

import numpy as np

from seaweedfs_tpu_torch.ops import codecs
from seaweedfs_tpu_torch.stats import heat, metrics, pipeline, trace
from seaweedfs_tpu_torch.storage import idx as idxf
from seaweedfs_tpu_torch.storage import needle as ndl
from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage.ec import ec_files, layout
from seaweedfs_tpu_torch.utils import resilience

ShardReader = Callable[[int, int, int], "bytes | None"]

# bytes of reconstructed ranges kept per EcVolume, so a hot degraded
# needle is not rebuilt again (0 disables)
RECONSTRUCT_CACHE_BYTES = int(os.environ.get(
    "WEEDTPU_EC_RECONSTRUCT_CACHE", str(8 * 1024 * 1024)))

READ_MODES = ("batched", "serial")

# one long-lived pool for LOCAL shard preads.  Remote fetches never ride
# it: a blackholed peer parks its thread for the whole RPC timeout, and a
# few of those would starve every degraded read's local preads; they get
# a throwaway pool per call instead, whose stragglers die with it
READ_WORKERS = 16
_READ_POOL: ThreadPoolExecutor | None = None
_READ_POOL_LOCK = threading.Lock()


def _read_pool() -> ThreadPoolExecutor:
    global _READ_POOL
    pool = _READ_POOL
    if pool is None:
        with _READ_POOL_LOCK:
            pool = _READ_POOL
            if pool is None:
                pool = _READ_POOL = ThreadPoolExecutor(
                    max_workers=READ_WORKERS, thread_name_prefix="ec-read")
    return pool


def read_mode(mode: str | None = None) -> str:
    """`mode`, else WEEDTPU_EC_READ, else "batched"; anything but
    "batched" or "serial" raises ValueError."""
    mode = mode or os.environ.get("WEEDTPU_EC_READ", "batched")
    if mode not in READ_MODES:
        raise ValueError(f"EC read mode {mode!r}: want one of {READ_MODES}")
    return mode


class EcVolume:
    def __init__(self, base: str,
                 large_block: int = layout.LARGE_BLOCK_SIZE,
                 small_block: int = layout.SMALL_BLOCK_SIZE,
                 version: int = t.CURRENT_VERSION, device=None):
        self.base = base
        # the volume id, the heat tracker's key: base names are "<vid>" or
        # "<collection>_<vid>"
        self.vid = os.path.basename(base).rsplit("_", 1)[-1]
        self.large_block = large_block
        self.small_block = small_block
        vif = ec_files.read_vif(base)
        self.version = vif.get("version", version) if vif else version
        self.spec = codecs.parse_tag((vif or {}).get("codec"))
        self.codec_tag = self.spec.tag
        # the codec resolves the device: the card (raising without one)
        # unless the caller named the CPU or the native host codec
        self.codec = ec_files._get_codec(device, self.spec.tag)
        self.device = self.codec.device

        # replay any crash-left journal into the .ecx, as the reference
        # does at mount (RebuildEcxFile, ec_volume_delete.go:51-98)
        self._replay_ecj()
        self._ecx = open(base + ".ecx", "r+b")
        self.ids, self.offs, self.sizes = idxf.read_columns(self._ecx.read())

        self.shards: dict[int, object] = {}
        for i in range(self.spec.n):
            p = base + layout.to_ext(i)
            if os.path.exists(p):
                self.shards[i] = open(p, "rb")
        # every shard file has the same size; the scrubber walks it
        self.shard_size = os.fstat(next(iter(self.shards.values())).fileno()
                                   ).st_size if self.shards else 0
        self.dat_size = ec_files.find_dat_file_size(base, self.version)

        # the read engine's counters, and an LRU of reconstructed
        # (shard, offset, size) ranges
        self.read_stats: dict[str, int] = {
            "local_shard_reads": 0, "remote_shard_reads": 0,
            "intervals_coalesced": 0, "reconstruct_batches": 0,
            "reconstruct_intervals": 0, "reconstruct_cache_hits": 0,
        }
        self._stats_lock = threading.Lock()
        self._recon_cache: OrderedDict[tuple[int, int, int], bytes] = \
            OrderedDict()
        self._recon_cache_bytes = 0
        self._recon_lock = threading.Lock()
        # scrub-verdicted corrupt ranges per shard, merged; a rebuild and
        # remount replaces the file and this object, which clears them
        self._quarantine: dict[int, list[tuple[int, int]]] = {}
        self._quarantine_lock = threading.Lock()

    # -- index ---------------------------------------------------------

    def _replay_ecj(self) -> None:
        ecj = self.base + ".ecj"
        deleted = ec_files.read_ecj(ecj)
        if not deleted:
            return
        with open(self.base + ".ecx", "r+b") as f:
            ids, _, _ = idxf.read_columns(f.read())
            for nid in deleted:
                pos = int(np.searchsorted(ids, nid))
                if pos < len(ids) and ids[pos] == nid:
                    f.seek(pos * 16 + 12)
                    f.write(t.TOMBSTONE_FILE_SIZE.to_bytes(4, "big", signed=True))
        os.remove(ecj)

    def find_needle(self, needle_id: int) -> tuple[int, int]:
        """-> (dat_offset_bytes, size); raises KeyError if absent/deleted."""
        pos = int(np.searchsorted(self.ids, needle_id))
        if pos >= len(self.ids) or self.ids[pos] != needle_id:
            raise KeyError(f"needle {needle_id:x} not in ec volume")
        size = int(self.sizes[pos])
        if not t.size_is_valid(size):
            raise KeyError(f"needle {needle_id:x} deleted")
        return t.from_offset_units(int(self.offs[pos])), size

    def delete_needle(self, needle_id: int) -> None:
        """Tombstone in .ecx (in place) + append to the .ecj journal."""
        pos = int(np.searchsorted(self.ids, needle_id))
        if pos >= len(self.ids) or self.ids[pos] != needle_id:
            return
        self.sizes[pos] = t.TOMBSTONE_FILE_SIZE
        self._ecx.seek(pos * 16 + 12)
        self._ecx.write(t.TOMBSTONE_FILE_SIZE.to_bytes(4, "big", signed=True))
        self._ecx.flush()
        with open(self.base + ".ecj", "ab") as j:
            j.write(needle_id.to_bytes(8, "big"))

    # -- stats / cache --------------------------------------------------

    def _bump(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self.read_stats[key] += n

    def read_stats_snapshot(self) -> dict[str, int]:
        with self._stats_lock:
            return dict(self.read_stats)

    def _cache_get(self, key: tuple[int, int, int]) -> bytes | None:
        with self._recon_lock:
            data = self._recon_cache.get(key)
            if data is not None:
                self._recon_cache.move_to_end(key)
        return data

    def _cache_put(self, key: tuple[int, int, int], data: bytes) -> None:
        if RECONSTRUCT_CACHE_BYTES <= 0 or \
                len(data) > RECONSTRUCT_CACHE_BYTES:
            return
        with self._recon_lock:
            old = self._recon_cache.pop(key, None)
            if old is not None:
                self._recon_cache_bytes -= len(old)
            self._recon_cache[key] = data
            self._recon_cache_bytes += len(data)
            while self._recon_cache_bytes > RECONSTRUCT_CACHE_BYTES and \
                    self._recon_cache:
                _, ev = self._recon_cache.popitem(last=False)
                self._recon_cache_bytes -= len(ev)

    # -- quarantine ------------------------------------------------------

    def quarantine_range(self, shard_id: int, offset: int, size: int) -> None:
        """Mark [offset, offset + size) of one shard corrupt: local reads
        of any overlapping range fail over to reconstruction.  Adjacent
        and overlapping ranges merge."""
        with self._quarantine_lock:
            ranges = self._quarantine.get(shard_id, [])
            ranges.append((offset, size))
            ranges.sort()
            merged: list[tuple[int, int]] = []
            for off, sz in ranges:
                if merged and off <= merged[-1][0] + merged[-1][1]:
                    lo, lsz = merged[-1]
                    merged[-1] = (lo, max(lsz, off + sz - lo))
                else:
                    merged.append((off, sz))
            self._quarantine[shard_id] = merged

    def _is_quarantined(self, shard_id: int, offset: int, size: int) -> bool:
        with self._quarantine_lock:
            ranges = self._quarantine.get(shard_id)
            if not ranges:
                return False
            return any(off < offset + size and offset < off + sz
                       for off, sz in ranges)

    def clear_quarantine(self, shard_id: int) -> None:
        """Forget a shard's quarantined ranges: called when the shard
        file is deleted, so that a rebuilt or re-copied replacement does
        not inherit them."""
        with self._quarantine_lock:
            self._quarantine.pop(shard_id, None)

    def quarantine_snapshot(self) -> dict[str, list[list[int]]]:
        with self._quarantine_lock:
            return {str(sid): [[off, sz] for off, sz in ranges]
                    for sid, ranges in self._quarantine.items() if ranges}

    # -- reads ----------------------------------------------------------

    def _read_local(self, shard_id: int, offset: int, size: int) -> bytes | None:
        """Positional read of one shard range (os.pread: no shared file
        position, so concurrent reads of one volume never race); None
        when the shard is absent, the range is quarantined or the read
        comes back short."""
        f = self.shards.get(shard_id)
        if f is None:
            return None
        if self._quarantine and self._is_quarantined(shard_id, offset, size):
            return None
        try:
            data = os.pread(f.fileno(), size, offset)
        except OSError:
            return None
        return data if len(data) == size else None

    def read_interval(self, shard_id: int, offset: int, size: int,
                      shard_reader: ShardReader | None = None) -> bytes:
        """One interval, the serial baseline: local, then the reader,
        then a reconstruction of this range alone (not cached)."""
        data = self._read_local(shard_id, offset, size)
        if data is not None:
            self._bump("local_shard_reads")
            return data
        if shard_reader is not None:
            data = shard_reader(shard_id, offset, size)
            if data is not None and len(data) == size:
                self._bump("remote_shard_reads")
                return data
        return self._reconstruct_ranges([(shard_id, offset, size)],
                                        shard_reader, use_cache=False)[0]

    def _read_segs_local(self, shard_id: int,
                         segs: list[tuple[int, int]]) -> bytes | None:
        """Every (offset, size) segment of one shard, concatenated; None
        when any of them is unreadable."""
        parts = []
        for off, size in segs:
            data = self._read_local(shard_id, off, size)
            if data is None:
                return None
            parts.append(data)
        return b"".join(parts)

    def _gather_survivors(self, exclude: set[int],
                          segs: list[tuple[int, int]],
                          shard_reader: ShardReader | None = None,
                          want: list[int] | None = None,
                          need: int | None = None
                          ) -> dict[int, np.ndarray]:
        """Survivor rows covering every segment, the segments of each
        shard concatenated: local shards first, concurrently on the shared
        pool with an early exit at `need`, then the rest from peers in
        parallel (store_ec.go:349-382), without waiting for stragglers.

        `want` restricts reads to a codec-chosen basis (an LRC local
        group); `need` is how many rows suffice (default len(want), else
        k).  Raises IOError when fewer than that (k, unrestricted) are
        readable, so the caller can retry unrestricted."""
        k = self.spec.k
        universe = want if want is not None else list(range(self.spec.n))
        need = need if need is not None else \
            (len(want) if want is not None else k)
        floor = min(need, k) if want is None else need
        local = [i for i in universe
                 if i not in exclude and i in self.shards]
        results: dict[int, bytes] = {}
        if len(local) == 1:
            data = self._read_segs_local(local[0], segs)
            if data is not None:
                results[local[0]] = data
        elif local:
            futs = {_read_pool().submit(self._read_segs_local, i, segs): i
                    for i in local}
            for fut in as_completed(futs):
                data = fut.result()
                if data is not None:
                    results[futs[fut]] = data
                    if len(results) >= need:
                        break  # enough survivors: no wasted disk reads
            for fut in futs:
                fut.cancel()  # drop the stragglers not started
        self._bump("local_shard_reads", len(results) * len(segs))
        if len(results) < need and shard_reader is not None:
            short = need - len(results)
            remote = [i for i in universe
                      if i not in exclude and i not in results]
            # nearest first, when the reader ranks its peers: submission
            # order biases the first-k race; the ranking is advisory
            rank = getattr(shard_reader, "locality_rank", None)
            if rank is not None and len(remote) > 1:
                try:
                    remote.sort(key=lambda sid: (rank(sid), sid))
                except Exception:
                    pass

            def read_remote(sid: int) -> bytes | None:
                parts = []
                for off, size in segs:
                    data = shard_reader(sid, off, size)
                    if data is None or len(data) != size:
                        return None
                    parts.append(data)
                return b"".join(parts)

            # a throwaway pool: a stuck peer stalls this read at worst,
            # never the shared pread pool
            rpool = ThreadPoolExecutor(max_workers=min(8, len(remote) or 1))
            try:
                futs = {rpool.submit(read_remote, i): i for i in remote}
                for fut in as_completed(futs):
                    data = None if fut.exception() else fut.result()
                    if data is not None:
                        results[futs[fut]] = data
                        self._bump("remote_shard_reads", len(segs))
                        short -= 1
                        if short <= 0:
                            break
            finally:
                # no wait for stragglers: one blackholed peer must not
                # hold the read past the k that answered
                rpool.shutdown(wait=False, cancel_futures=True)
        if len(results) < floor:
            raise IOError(
                f"ec volume {self.base}: only {len(results)} shards "
                f"readable, need {floor} to reconstruct "
                f"shard(s) {sorted(exclude)}")
        return {sid: np.frombuffer(results[sid], dtype=np.uint8)
                for sid in sorted(results)[:need]}

    def _basis(self, wanted: list[int],
               shard_reader: ShardReader | None) -> list[int] | None:
        """The codec's survivor basis for `wanted`, assuming every other
        shard present (as the reference does); None for RS, which reads
        the first k readable, and, without a reader, when a basis shard
        is absent from the local disk, which no restricted read can get
        past."""
        if self.spec.family == "rs":
            return None
        basis = self.codec.basis(
            sorted(set(range(self.spec.n)) - set(wanted)), wanted)
        if shard_reader is None and any(s not in self.shards for s in basis):
            return None
        return list(basis)

    def _reconstruct_ranges(self, ranges: list[tuple[int, int, int]],
                            shard_reader: ShardReader | None = None,
                            use_cache: bool = True) -> list[bytes]:
        """Rebuild several (shard_id, offset, size) ranges in ONE batched
        codec dispatch: each survivor's slices concatenate into a single
        row, the decode runs once over the whole concatenation (for every
        wanted shard), and the rebuilt rows split back per range.  With
        `use_cache`, ranges in the LRU are served from it and the rebuilt
        ones go into it."""
        out: list[bytes | None] = [None] * len(ranges)
        todo: list[int] = []
        for i, key in enumerate(ranges):
            data = self._cache_get(key) if use_cache else None
            if data is not None:
                out[i] = data
                self._bump("reconstruct_cache_hits")
            else:
                todo.append(i)
        if not todo:
            return out  # type: ignore[return-value]
        wanted = sorted({ranges[i][0] for i in todo})
        segs = [ranges[i][1:] for i in todo]
        # MSR works on byte-interleaved alpha blocks: widen each segment
        # to alpha boundaries, slice the lead back off after the decode
        # (alpha = 1 for rs/lrc: no-op)
        a = self.spec.alpha
        leads = [off % a for off, _ in segs]
        gsegs = [(off - lead, -(-(lead + size) // a) * a)
                 for (off, size), lead in zip(segs, leads)]
        # the codec's basis: an LRC single loss reads one local group, MSR
        # any k whole files.  When it cannot be read, retry unrestricted;
        # one survivor beyond k keeps every LRC pattern within its
        # tolerance decodable
        basis = self._basis(wanted, shard_reader)
        rows = None
        seg_bytes = sum(size for _, size in gsegs)
        flow = pipeline.flow("ec_read")
        with trace.span("ec.gather_survivors", shards_lost=len(wanted),
                        segs=len(gsegs)), \
                flow.stage("gather_survivors",
                           nbytes=self.spec.k * seg_bytes):
            if basis is not None:
                try:
                    rows = self._gather_survivors(set(wanted), gsegs,
                                                  shard_reader, want=basis)
                except IOError:
                    pass
            if rows is None:
                rows = self._gather_survivors(
                    set(wanted), gsegs, shard_reader,
                    need=self.spec.k + (self.spec.family == "lrc"))
        with trace.span("ec.reconstruct_batch", intervals=len(todo),
                        shards=len(wanted), bytes=seg_bytes), \
                flow.stage("reconstruct", nbytes=seg_bytes):
            rebuilt = ec_files._reconstruct_batch(self.codec, rows, wanted)
        self._bump("reconstruct_batches")
        self._bump("reconstruct_intervals", len(todo))
        if heat.ambient_is_data():
            # a read that reconstructed, under foreground traffic; weight
            # 0: the serving path's read record counts the request itself
            heat.record("volume", self.vid, 0, "degraded", weight=0.0)
        pos = 0
        for i, lead, (_, gsize) in zip(todo, leads, gsegs):
            sid, off, size = ranges[i]
            data = rebuilt[sid][pos + lead:pos + lead + size].tobytes()
            pos += gsize
            out[i] = data
            if use_cache:
                self._cache_put((sid, off, size), data)
        return out  # type: ignore[return-value]

    def _read_ranges(self, plan: list[tuple[int, int, int]],
                     shard_reader: ShardReader | None = None) -> list[bytes]:
        """The batched engine: coalesce adjacent per-shard ranges, serve
        them from the LRU, the local disks (concurrently) and the peers
        (hedged), and repair everything still missing in one
        reconstruction dispatch."""
        with trace.span("ec.coalesce", intervals=len(plan)) as csp:
            per_shard: dict[int, list[tuple[int, int, int]]] = {}
            for i, (sid, off, size) in enumerate(plan):
                per_shard.setdefault(sid, []).append((off, size, i))
            reads: list[list] = []  # [sid, off, size, [(idx, rel, sz)..]]
            for sid, lst in per_shard.items():
                lst.sort()
                cur: list | None = None
                for off, size, idx in lst:
                    if cur is not None and cur[1] + cur[2] == off:
                        cur[3].append((idx, cur[2], size))
                        cur[2] += size
                    else:
                        cur = [sid, off, size, [(idx, 0, size)]]
                        reads.append(cur)
            csp.set(reads=len(reads))
        if len(plan) > len(reads):
            self._bump("intervals_coalesced", len(plan) - len(reads))

        blobs: dict[int, bytes] = {}  # read index -> bytes
        failed: list[int] = []
        # the reconstructed-range LRU first: a hot degraded needle skips
        # shard I/O entirely
        probe: list[int] = []
        for ri, (sid, off, size, _) in enumerate(reads):
            data = self._cache_get((sid, off, size))
            if data is not None:
                blobs[ri] = data
                self._bump("reconstruct_cache_hits")
            else:
                probe.append(ri)
        flow = pipeline.flow("ec_read")
        with trace.span("ec.local_pread", reads=len(probe)) as lsp, \
                flow.stage("local_pread",
                           nbytes=sum(reads[ri][2] for ri in probe)):
            if len(probe) == 1:
                ri = probe[0]
                data = self._read_local(*reads[ri][:3])
                if data is not None:
                    blobs[ri] = data
                    self._bump("local_shard_reads")
                else:
                    failed.append(ri)
            elif probe:
                futs = {_read_pool().submit(self._read_local,
                                            *reads[ri][:3]): ri
                        for ri in probe}
                for fut in as_completed(futs):
                    ri = futs[fut]
                    data = fut.result()
                    if data is not None:
                        blobs[ri] = data
                        self._bump("local_shard_reads")
                    else:
                        failed.append(ri)
            lsp.set(missed=len(failed))
        # remote fetch of what the local disks missed, on a throwaway
        # pool, hedged: after the hedge delay the ranges still in flight
        # go to reconstruction from other survivors.  Only completions
        # that beat the cutoff teach the latency tracker; abandoned ones
        # would teach it that slow is normal and switch hedging off
        pending: dict = {}  # abandoned primary future -> read index
        if failed and shard_reader is not None:
            still: list[int] = []
            hedge_s = resilience.hedge_delay_s()

            def timed_fetch(sid: int, off: int, size: int):
                t0 = time.perf_counter()
                return shard_reader(sid, off, size), \
                    time.perf_counter() - t0

            def collect(fut, ri) -> None:
                res = None if fut.exception() else fut.result()
                data = res[0] if res else None
                if data is not None and len(data) == reads[ri][2]:
                    blobs[ri] = data
                    self._bump("remote_shard_reads")
                    if hedge_s is not None:
                        # with hedging off there is no cutoff, and a slow
                        # peer's latencies would raise the delay toward
                        # exactly the latency it exists to cut
                        resilience.SHARD_FETCH.observe(res[1])
                else:
                    still.append(ri)

            with trace.span("ec.remote_fetch", reads=len(failed),
                            hedge_ms=None if hedge_s is None else
                            round(hedge_s * 1000.0, 1)) as rsp, \
                    flow.stage("remote_fetch",
                               nbytes=sum(reads[ri][2] for ri in failed)):
                rpool = ThreadPoolExecutor(max_workers=min(8, len(failed)))
                futs = {rpool.submit(timed_fetch, *reads[ri][:3]): ri
                        for ri in failed}
                try:
                    if hedge_s is None:
                        for fut in as_completed(futs):
                            collect(fut, futs[fut])
                    else:
                        done, not_done = _futures_wait(set(futs),
                                                       timeout=hedge_s)
                        for fut in done:
                            collect(fut, futs[fut])
                        if not_done:
                            metrics.HEDGE_TOTAL.labels("fired").inc()
                            for fut in not_done:
                                pending[fut] = futs[fut]
                                still.append(futs[fut])
                finally:
                    # primaries left in flight by the hedge are not
                    # cancelled: reconstruction may find too few
                    # survivors and need whichever of them answers
                    rpool.shutdown(wait=False, cancel_futures=not pending)
                rsp.set(missed=len(still))
            failed = still
        # one batched reconstruction of every range still missing
        if failed:
            failed.sort()
            try:
                rebuilt = self._reconstruct_ranges(
                    [tuple(reads[ri][:3]) for ri in failed], shard_reader)
            except IOError:
                if not pending:
                    raise
                # the hedge lost its bet: the abandoned primaries are the
                # only source left; wait them out (deadline-bounded) and
                # reconstruct whatever still misses
                metrics.HEDGE_TOTAL.labels("primary_rescued").inc()
                try:
                    for fut in as_completed(
                            list(pending),
                            timeout=resilience.clamp_timeout(30.0)):
                        ri = pending[fut]
                        res = None if fut.exception() else fut.result()
                        data = res[0] if res else None
                        if data is not None and len(data) == reads[ri][2]:
                            blobs[ri] = data
                            self._bump("remote_shard_reads")
                except _FutTimeout:
                    pass
                failed = [ri for ri in failed if ri not in blobs]
                rebuilt = self._reconstruct_ranges(
                    [tuple(reads[ri][:3]) for ri in failed],
                    shard_reader) if failed else []
            else:
                if pending:
                    metrics.HEDGE_TOTAL.labels("hedge_won").inc()
            for ri, data in zip(failed, rebuilt):
                blobs[ri] = data
        parts: list[bytes] = [b""] * len(plan)
        for ri, (_, _, _, members) in enumerate(reads):
            for idx, rel, size in members:
                parts[idx] = blobs[ri][rel:rel + size]
        return parts

    def read_needle(self, needle_id: int,
                    shard_reader: ShardReader | None = None,
                    mode: str | None = None,
                    skip_shards: frozenset | None = None) -> ndl.Needle:
        """Full needle read: locate -> plan all intervals -> shard reads
        and one-shot reconstruction -> parse (CRC checked).  `mode` (else
        WEEDTPU_EC_READ): "batched" (default) or "serial".

        `skip_shards` withholds those shards from both the local files
        and the reader, forcing the read through reconstruction (the
        canary's deliberate degraded read).  It reads through a shallow
        view sharing this volume's files, index and stats, with an LRU of
        its own: a hit would skip the decode the probe exists to run, and
        its results must not displace real entries."""
        if skip_shards:
            skip = frozenset(skip_shards)
            view = copy.copy(self)
            view.shards = {s: f for s, f in self.shards.items()
                           if s not in skip}
            view._recon_cache = OrderedDict()
            view._recon_cache_bytes = 0
            view._recon_lock = threading.Lock()
            inner = shard_reader

            def skipping_reader(sid: int, off: int, size: int):
                if sid in skip or inner is None:
                    return None
                return inner(sid, off, size)

            rank = getattr(inner, "locality_rank", None)
            if rank is not None:
                skipping_reader.locality_rank = rank
            return view.read_needle(needle_id, skipping_reader, mode)
        mode = read_mode(mode)
        with trace.span("ec.plan", needle=f"{needle_id:x}") as psp:
            dat_offset, size = self.find_needle(needle_id)
            length = t.actual_size(size, self.version)
            plan = []
            for iv in layout.locate_data(self.large_block, self.small_block,
                                         self.dat_size, dat_offset, length,
                                         data_shards=self.spec.k):
                sid, off = iv.to_shard_id_and_offset(self.large_block,
                                                     self.small_block)
                plan.append((sid, off, iv.size))
            psp.set(intervals=len(plan), bytes=length)
        if mode == "serial":
            parts = [self.read_interval(sid, off, size, shard_reader)
                     for sid, off, size in plan]
        else:
            parts = self._read_ranges(plan, shard_reader)
        n = ndl.Needle.from_record(b"".join(parts), self.version)
        if n.id != needle_id:
            raise IOError(f"ec read returned needle {n.id:x}, wanted {needle_id:x}")
        return n

    def shard_ids(self) -> list[int]:
        return sorted(self.shards)

    def close(self) -> None:
        self._ecx.close()
        for f in self.shards.values():
            f.close()
