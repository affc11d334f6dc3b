"""In-RAM needle map: needleId -> (offset, size) per volume, plus the
bookkeeping metrics the master heartbeat needs.

Counterpart of `seaweedfs_tpu/storage/needle_map.py` (reference:
weed/storage/needle_map/compact_map.go, needle_map_metric.go,
needle_map_sorted_file.go), with its three kinds:

  NeedleMap           dict-backed, fastest puts, ~100+ B/needle — small
                      volumes and tests
  CompactNeedleMap    memory-bounded default: sorted numpy columns
                      (16 B/needle) + a dict overflow merged in bulk — the
                      numpy analogue of the reference's sectioned CompactMap
  SortedFileNeedleMap read-only binary search over a sorted `.sdx` sidecar
                      for sealed volumes

All kinds share the same surface: put/get/delete/drop, len/items,
file_count/deleted_count/deleted_bytes/maximum_key, content_size,
attach_idx/flush.
"""

from __future__ import annotations

import os
from typing import BinaryIO, Iterator

import numpy as np

from seaweedfs_tpu_torch.stats import metrics
from seaweedfs_tpu_torch.storage import idx, types as t


def _count_drop(kind: str, n: int = 1) -> None:
    """Integrity-repair drops were silently swallowed; they are now a
    /metrics counter so an operator can see a volume shedding entries
    (weedtpu_needle_map_integrity_drops_total{kind=...})."""
    if n > 0:
        metrics.NEEDLE_MAP_DROPS.labels(kind).inc(n)


def _max_tombstoned(offs: np.ndarray, sizes: np.ndarray) -> int:
    """The largest offset among tombstone entries that carry one (a
    delete's entry points at the deleted record; an integrity drop's and
    a decode's .ecj entries carry 0)."""
    dead = offs[(sizes < 0) & (offs > 0)]
    return int(dead.max()) if len(dead) else 0


class NeedleMap:
    """needleId -> (offset_units, size) with live/deleted accounting
    (metric semantics follow weed/storage/needle_map_metric.go)."""

    def __init__(self) -> None:
        self._m: dict[int, tuple[int, int]] = {}
        self.file_count = 0
        self.deleted_count = 0
        self.deleted_bytes = 0
        self.maximum_key = 0
        # offset units of the furthest record a tombstone entry of the
        # loaded .idx log points at (Volume's boot walk starts past it)
        self.max_tombstoned = 0
        self._idx_file: BinaryIO | None = None

    # -- core ----------------------------------------------------------

    def put(self, needle_id: int, offset_units: int, size: int) -> None:
        old = self._m.get(needle_id)
        if old is not None and t.size_is_valid(old[1]):
            self.deleted_count += 1
            self.deleted_bytes += old[1]
        self._m[needle_id] = (offset_units, size)
        self.file_count += 1
        self.maximum_key = max(self.maximum_key, needle_id)
        if self._idx_file is not None:
            self._idx_file.write(idx.pack_entry(needle_id, offset_units, size))

    def get(self, needle_id: int) -> tuple[int, int] | None:
        v = self._m.get(needle_id)
        if v is None or not t.size_is_valid(v[1]):
            return None
        return v

    def delete(self, needle_id: int) -> int:
        """Tombstone the entry; returns the freed byte count (0 if absent)."""
        old = self._m.get(needle_id)
        if old is None or not t.size_is_valid(old[1]):
            return 0
        self._m[needle_id] = (old[0], t.TOMBSTONE_FILE_SIZE)
        self.deleted_count += 1
        self.deleted_bytes += old[1]
        if self._idx_file is not None:
            self._idx_file.write(
                idx.pack_entry(needle_id, old[0], t.TOMBSTONE_FILE_SIZE))
        return old[1]

    def drop(self, needle_id: int) -> None:
        """Remove an entry without tombstone accounting (integrity repair
        of torn writes: the data never existed, so it isn't 'deleted')."""
        if self._m.pop(needle_id, None) is not None:
            _count_drop("integrity_repair")

    def __len__(self) -> int:
        return sum(1 for v in self._m.values() if t.size_is_valid(v[1]))

    def items(self) -> Iterator[tuple[int, tuple[int, int]]]:
        return iter(self._m.items())

    @property
    def content_size(self) -> int:
        return sum(v[1] for v in self._m.values() if t.size_is_valid(v[1]))

    # -- persistence -----------------------------------------------------

    def attach_idx(self, f: BinaryIO) -> None:
        """Subsequent put/delete calls append entries to this .idx file."""
        self._idx_file = f

    def flush(self) -> None:
        if self._idx_file is not None:
            self._idx_file.flush()
            os.fsync(self._idx_file.fileno())

    @classmethod
    def load_from_idx(cls, path: str) -> "NeedleMap":
        nm = cls()
        if not os.path.exists(path):
            return nm
        with open(path, "rb") as f:
            data = f.read()
        ids, offs, sizes = idx.read_columns(data)
        nm.max_tombstoned = _max_tombstoned(offs, sizes)
        for nid, off, size in zip(ids.tolist(), offs.tolist(), sizes.tolist()):
            if t.size_is_valid(size):
                nm.put(nid, off, size)
            else:  # tombstone entry replayed from the log
                old = nm._m.get(nid)
                if old is not None and t.size_is_valid(old[1]):
                    nm.deleted_count += 1
                    nm.deleted_bytes += old[1]
                nm._m[nid] = (old[0] if old is not None else off, size)
        return nm


class CompactNeedleMap:
    """Memory-bounded needle map: three sorted numpy columns (ids u64,
    offsets u32, sizes i32 — 16 B/needle vs ~100+ B for a Python dict) plus
    a dict overflow for recent mutations, bulk-merged into the base when it
    grows past MERGE_THRESHOLD.

    The numpy re-idiom of the reference's sectioned CompactMap
    (weed/storage/needle_map/compact_map.go:18-50): where Go keeps
    fixed-size sections of sorted entries with per-section overflow, one
    flat sorted base + vectorized merge gives the same bound with
    searchsorted lookups.

    Internally synchronized: unlike the dict kind, whose get is one
    GIL-atomic dict lookup, lookups here are multi-step against arrays that
    _merge() swaps out, and Volume's hot read paths call nm.get() without
    the volume lock."""

    MERGE_THRESHOLD = 65536

    def __init__(self) -> None:
        import threading
        self._ids = np.empty(0, dtype=np.uint64)   # sorted ascending
        self._offs = np.empty(0, dtype=np.uint32)  # .idx offsets are u32
        self._sizes = np.empty(0, dtype=np.int32)  # TOMBSTONE for deleted
        # nid -> (off, size), or None for entries dropped by integrity repair
        self._overflow: dict[int, tuple[int, int] | None] = {}
        self._mu = threading.Lock()
        self.file_count = 0
        self.deleted_count = 0
        self.deleted_bytes = 0
        self.maximum_key = 0
        self.max_tombstoned = 0  # as NeedleMap's
        self._live = 0
        self._live_bytes = 0
        self._idx_file: BinaryIO | None = None

    # -- core ----------------------------------------------------------

    def _base_get(self, needle_id: int) -> tuple[int, int] | None:
        i = int(np.searchsorted(self._ids, np.uint64(needle_id)))
        if i < len(self._ids) and int(self._ids[i]) == needle_id:
            return int(self._offs[i]), int(self._sizes[i])
        return None

    def _raw_get(self, needle_id: int) -> tuple[int, int] | None:
        """Entry incl. tombstones; None if absent or dropped. Caller holds
        self._mu."""
        if needle_id in self._overflow:
            return self._overflow[needle_id]
        return self._base_get(needle_id)

    def put(self, needle_id: int, offset_units: int, size: int) -> None:
        with self._mu:
            old = self._raw_get(needle_id)
            if old is not None and t.size_is_valid(old[1]):
                self.deleted_count += 1
                self.deleted_bytes += old[1]
                self._live -= 1
                self._live_bytes -= old[1]
            self._overflow[needle_id] = (offset_units, size)
            self.file_count += 1
            if t.size_is_valid(size):
                self._live += 1
                self._live_bytes += size
            self.maximum_key = max(self.maximum_key, needle_id)
            if self._idx_file is not None:
                self._idx_file.write(
                    idx.pack_entry(needle_id, offset_units, size))
            if len(self._overflow) >= self.MERGE_THRESHOLD:
                self._merge()

    def get(self, needle_id: int) -> tuple[int, int] | None:
        with self._mu:
            v = self._raw_get(needle_id)
        if v is None or not t.size_is_valid(v[1]):
            return None
        return v

    def delete(self, needle_id: int) -> int:
        with self._mu:
            old = self._raw_get(needle_id)
            if old is None or not t.size_is_valid(old[1]):
                return 0
            self._overflow[needle_id] = (old[0], t.TOMBSTONE_FILE_SIZE)
            self.deleted_count += 1
            self.deleted_bytes += old[1]
            self._live -= 1
            self._live_bytes -= old[1]
            if self._idx_file is not None:
                self._idx_file.write(
                    idx.pack_entry(needle_id, old[0], t.TOMBSTONE_FILE_SIZE))
            if len(self._overflow) >= self.MERGE_THRESHOLD:
                self._merge()
            return old[1]

    def drop(self, needle_id: int) -> None:
        with self._mu:
            old = self._raw_get(needle_id)
            if old is None:
                return
            if t.size_is_valid(old[1]):
                self._live -= 1
                self._live_bytes -= old[1]
            self._overflow[needle_id] = None
        _count_drop("integrity_repair")

    def _merge(self) -> None:
        """Fold the overflow dict into the sorted base columns in one
        vectorized pass; dropped (None) entries vanish. Caller holds
        self._mu."""
        if not self._overflow:
            return
        ov = sorted(self._overflow.items())
        ov_ids = np.array([k for k, _ in ov], dtype=np.uint64)
        keep = ~np.isin(self._ids, ov_ids, assume_unique=True)
        live = [(k, v) for k, v in ov if v is not None]
        self._ids = np.concatenate(
            [self._ids[keep], np.array([k for k, _ in live], np.uint64)])
        self._offs = np.concatenate(
            [self._offs[keep], np.array([v[0] for _, v in live], np.uint32)])
        self._sizes = np.concatenate(
            [self._sizes[keep], np.array([v[1] for _, v in live], np.int32)])
        order = np.argsort(self._ids, kind="stable")
        self._ids = self._ids[order]
        self._offs = self._offs[order]
        self._sizes = self._sizes[order]
        self._overflow = {}

    def __len__(self) -> int:
        return self._live

    def items(self) -> Iterator[tuple[int, tuple[int, int]]]:
        # snapshot under the lock, yield outside it: scans (vacuum, fsck)
        # must not block writers for their whole duration, and the arrays
        # are replaced — never mutated — so the snapshot stays consistent
        with self._mu:
            ids, offs, sizes = self._ids, self._offs, self._sizes
            ov = dict(self._overflow)
        for i in range(len(ids)):
            nid = int(ids[i])
            if nid not in ov:
                yield nid, (int(offs[i]), int(sizes[i]))
        for nid, v in ov.items():
            if v is not None:
                yield nid, v

    @property
    def content_size(self) -> int:
        return self._live_bytes

    # -- persistence -----------------------------------------------------

    def attach_idx(self, f: BinaryIO) -> None:
        self._idx_file = f

    def flush(self) -> None:
        if self._idx_file is not None:
            self._idx_file.flush()
            os.fsync(self._idx_file.fileno())

    @classmethod
    def load_from_idx(cls, path: str) -> "CompactNeedleMap":
        """Vectorized .idx replay with a bounded memory profile: the file is
        read in 16MB slices into preallocated 16B/entry columns, then split
        by a running-maximum test — entries whose id exceeds every earlier
        id are already sorted AND unique (needle ids are assigned ascending,
        so this is nearly the whole file), while the out-of-order remainder
        (overwrites and tombstones of older ids) forms a small table that is
        stable-sorted, deduped latest-wins, and applied as in-place
        overrides/inserts. Peak RSS stays ~1.5x the steady 16B/needle
        instead of the several-x transients a whole-file np.unique costs."""
        nm = cls()
        if not os.path.exists(path):
            return nm
        n_total = os.path.getsize(path) // t.NEEDLE_MAP_ENTRY_SIZE
        if n_total == 0:
            return nm
        # one chunked pass: in-order entries (id above every earlier id —
        # already sorted and unique) land directly in the preallocated base
        # columns; the out-of-order remainder is collected per chunk. Peak
        # RSS is the 16B/entry base + per-chunk transients.
        base_ids = np.empty(n_total, np.uint64)
        base_offs = np.empty(n_total, np.uint32)
        base_sizes = np.empty(n_total, np.int32)
        out_chunks: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        w = 0
        prev_max = 0
        total_valid = 0
        with open(path, "rb") as f:
            while True:
                chunk = f.read(16 * 1024 * 1024)  # multiple of the 16B entry
                if not chunk:
                    break
                a, b, c = idx.read_columns(chunk)
                if len(a) == 0:  # torn trailing partial entry
                    break
                v = c > 0  # vectorized t.size_is_valid
                nm.file_count += int(v.sum())
                total_valid += int(c[v].astype(np.int64).sum())
                if v.any():
                    nm.maximum_key = max(nm.maximum_key, int(a[v].max()))
                nm.max_tombstoned = max(nm.max_tombstoned,
                                        _max_tombstoned(b, c))
                racc = np.maximum.accumulate(a)
                thresh = np.empty_like(racc)
                thresh[0] = prev_max
                np.maximum(racc[:-1], np.uint64(prev_max), out=thresh[1:])
                ino = a > thresh  # strictly above all earlier ids in the file
                prev_max = max(prev_max, int(racc[-1]))
                k = int(ino.sum())
                base_ids[w:w + k] = a[ino]
                base_offs[w:w + k] = b[ino]
                base_sizes[w:w + k] = c[ino]
                w += k
                if k < len(a):
                    om = ~ino
                    out_chunks.append((a[om], b[om], c[om]))
        base_ids = base_ids[:w]
        base_offs = base_offs[:w]
        base_sizes = base_sizes[:w]

        if out_chunks:
            out_ids = np.concatenate([x[0] for x in out_chunks])
            out_offs = np.concatenate([x[1] for x in out_chunks])
            out_sizes = np.concatenate([x[2] for x in out_chunks])
            del out_chunks
            order = np.argsort(out_ids, kind="stable")
            out_ids = out_ids[order]
            out_offs = out_offs[order]
            out_sizes = out_sizes[order]
            del order
            keep = np.empty(len(out_ids), bool)
            keep[:-1] = out_ids[:-1] != out_ids[1:]  # last of each run wins
            keep[-1] = True
            out_ids = out_ids[keep]
            out_offs = out_offs[keep]
            out_sizes = out_sizes[keep]
            del keep
            ins = np.searchsorted(base_ids, out_ids)
            hit = (ins < len(base_ids)) & (
                base_ids[np.minimum(ins, len(base_ids) - 1)] == out_ids)
            base_offs[ins[hit]] = out_offs[hit]      # in-place overrides
            base_sizes[ins[hit]] = out_sizes[hit]
            new = ~hit
            if new.any():  # out-of-order first appearances (rare)
                base_ids = np.insert(base_ids, ins[new], out_ids[new])
                base_offs = np.insert(base_offs, ins[new], out_offs[new])
                base_sizes = np.insert(base_sizes, ins[new], out_sizes[new])

        nm._ids, nm._offs, nm._sizes = base_ids, base_offs, base_sizes
        live = nm._sizes > 0
        nm._live = int(live.sum())
        nm._live_bytes = int(nm._sizes[live].astype(np.int64).sum())
        nm.deleted_count = nm.file_count - nm._live
        nm.deleted_bytes = total_valid - nm._live_bytes
        return nm


class SortedFileNeedleMap:
    """Read-only, low-memory needle map: binary search over a sorted `.sdx`
    sidecar instead of an in-RAM table (reference:
    weed/storage/needle_map_sorted_file.go).  Built from the `.idx` log
    (latest entry wins, tombstones dropped) the first time a volume is
    opened with needle_map_kind="sorted_file", rebuilt when the .idx is
    newer than the .sdx.

    Exposes the read-side NeedleMap surface (get/len/items/metrics);
    put/delete raise — the kind is for sealed volumes, like the reference.
    """

    ENTRY = t.NEEDLE_MAP_ENTRY_SIZE  # 16 bytes, same layout as .idx

    def __init__(self, sdx_path: str):
        self.sdx_path = sdx_path
        self._fd = os.open(sdx_path, os.O_RDONLY)
        self._size = os.path.getsize(sdx_path)
        self._n = self._size // self.ENTRY
        self.file_count = self._n
        self.deleted_count = 0
        self.deleted_bytes = 0
        self.maximum_key = 0
        if self._n:
            nid, _, _ = self._entry_at(self._n - 1)
            self.maximum_key = nid

    @classmethod
    def build(cls, idx_path: str, sdx_path: str) -> None:
        """Compact the .idx log into a sorted .sdx (live entries only);
        discarded entries (tombstoned / superseded latest state) are
        counted on /metrics rather than silently swallowed."""
        nm = NeedleMap.load_from_idx(idx_path)
        entries = sorted((nid, v) for nid, v in nm._m.items()
                         if t.size_is_valid(v[1]))
        _count_drop("sdx_rebuild", len(nm._m) - len(entries))
        tmp = sdx_path + ".tmp"
        with open(tmp, "wb") as f:
            for nid, (off, size) in entries:
                f.write(idx.pack_entry(nid, off, size))
        os.replace(tmp, sdx_path)

    @classmethod
    def open_for(cls, idx_path: str, sdx_path: str) -> "SortedFileNeedleMap":
        if not os.path.exists(sdx_path) or (
                os.path.exists(idx_path) and
                os.path.getmtime(idx_path) > os.path.getmtime(sdx_path)):
            cls.build(idx_path, sdx_path)
        return cls(sdx_path)

    def _entry_at(self, i: int) -> tuple[int, int, int]:
        # pread: no shared file-position state, safe for concurrent readers
        return idx.unpack_entry(
            os.pread(self._fd, self.ENTRY, i * self.ENTRY))

    def get(self, needle_id: int) -> tuple[int, int] | None:
        lo, hi = 0, self._n - 1
        while lo <= hi:
            mid = (lo + hi) // 2
            nid, off, size = self._entry_at(mid)
            if nid == needle_id:
                return (off, size) if t.size_is_valid(size) else None
            if nid < needle_id:
                lo = mid + 1
            else:
                hi = mid - 1
        return None

    def put(self, needle_id: int, offset_units: int, size: int) -> None:
        raise PermissionError("sorted-file needle map is read-only")

    def delete(self, needle_id: int) -> int:
        raise PermissionError("sorted-file needle map is read-only")

    def drop(self, needle_id: int) -> None:
        raise PermissionError("sorted-file needle map is read-only")

    def __len__(self) -> int:
        return self._n

    def items(self) -> Iterator[tuple[int, tuple[int, int]]]:
        for i in range(self._n):
            nid, off, size = self._entry_at(i)
            yield nid, (off, size)

    @property
    def content_size(self) -> int:
        return sum(v[1] for _, v in self.items())

    def attach_idx(self, f) -> None:
        pass  # read-only; nothing to append

    def flush(self) -> None:
        pass

    def close(self) -> None:
        try:
            os.close(self._fd)
        except OSError:
            pass


def load_needle_map(kind: str, idx_path: str):
    """Writable-kind factory: 'compact' (memory-bounded default) or
    'memory' (dict). 'sorted_file' is opened by Volume directly — it needs
    the .sdx path and forces read-only."""
    if kind == "memory":
        return NeedleMap.load_from_idx(idx_path)
    if kind == "compact":
        return CompactNeedleMap.load_from_idx(idx_path)
    raise ValueError(f"unknown needle_map_kind {kind!r}")
