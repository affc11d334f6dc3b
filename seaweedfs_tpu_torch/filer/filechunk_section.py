"""Sectioned chunk organization + read-pattern detection for huge files.

Counterpart of `seaweedfs_tpu/filer/filechunk_section.py`, whole.

Reference: weed/filer/filechunk_section.go (64MiB FileChunkSection with
lazily-resolved visible intervals), filechunk_group.go (ChunkGroup
bucketing a file's chunks into sections), reader_pattern.go (sequential/
random read-mode counter).

Without this layer every ranged read re-resolves the FULL chunk list —
O(total chunks) per read; a multi-GB file written in 2MB chunks carries
thousands of entries.  A ChunkGroup buckets the list once, then a read of
[offset, offset+size) resolves (and caches) only the 64MiB sections it
touches.
"""

from __future__ import annotations

import threading

from seaweedfs_tpu_torch.filer.filechunks import (
    ChunkView, FileChunk, VisibleInterval, non_overlapping_visible_intervals,
    view_from_visibles)

SECTION_SIZE = 64 * 1024 * 1024  # filechunk_section.go SectionSize


class ChunkGroup:
    """Immutable view over one entry's resolved chunk list.  Build once
    per (entry, version); ask it for read views per request."""

    def __init__(self, chunks: list[FileChunk],
                 section_size: int = SECTION_SIZE):
        self.section_size = section_size
        self.sections: dict[int, list[FileChunk]] = {}
        self._resolved: dict[int, list[VisibleInterval]] = {}
        self._lock = threading.Lock()
        size = 0
        for c in chunks:
            size = max(size, c.offset + c.size)
            lo = c.offset // section_size
            hi = (c.offset + c.size - 1) // section_size if c.size else lo
            for si in range(lo, hi + 1):
                self.sections.setdefault(si, []).append(c)
        self.file_size = size

    def _section_visibles(self, si: int) -> list[VisibleInterval]:
        with self._lock:
            vis = self._resolved.get(si)
            if vis is None:
                # resolve only this section's bucket, clipped to its
                # window (a chunk spanning sections appears in several
                # buckets; clipping keeps each section's view disjoint)
                vis = [v for v in non_overlapping_visible_intervals(
                           self.sections.get(si, []))
                       if v.stop > si * self.section_size
                       and v.start < (si + 1) * self.section_size]
                self._resolved[si] = vis
            return vis

    def read_views(self, offset: int, size: int) -> list[ChunkView]:
        """Blob reads for [offset, offset+size) — resolves only the
        touched sections."""
        if size <= 0 or not self.sections:
            return []
        stop = min(offset + size, self.file_size)
        if stop <= offset:
            return []
        out: list[ChunkView] = []
        first = offset // self.section_size
        last = (stop - 1) // self.section_size
        for si in range(first, last + 1):
            s_lo = max(offset, si * self.section_size)
            s_hi = min(stop, (si + 1) * self.section_size)
            out.extend(view_from_visibles(self._section_visibles(si),
                                          s_lo, s_hi - s_lo))
        return out

    @property
    def resolved_sections(self) -> int:
        with self._lock:
            return len(self._resolved)


MODE_CHANGE_LIMIT = 3  # reader_pattern.go ModeChangeLimit


class ReaderPattern:
    """Sequential-vs-random read detector (reader_pattern.go): each read
    that starts exactly where the previous one stopped votes sequential,
    anything else votes random; the counter saturates at +/-3.  Sequential
    readers benefit from whole-chunk caching (the next read wants the rest
    of the chunk); random readers should not evict the cache with bytes
    nobody will revisit."""

    def __init__(self):
        self._counter = 0
        # None until the first read: the first observation is a BASELINE,
        # not a randomness vote — a reader resuming mid-file (or a fresh
        # per-connection pattern key) must not disable caching with its
        # very first read
        self._last_stop: int | None = None
        self._lock = threading.Lock()

    def monitor_read(self, offset: int, size: int) -> None:
        with self._lock:
            sequential = self._last_stop is None or \
                offset == self._last_stop
            self._last_stop = offset + size
            if sequential:
                if self._counter < MODE_CHANGE_LIMIT:
                    self._counter += 1
            elif self._counter > -MODE_CHANGE_LIMIT:
                self._counter -= 1

    @property
    def is_random(self) -> bool:
        with self._lock:
            return self._counter < 0
