"""Chunk interval resolution: overlapping chunk lists -> visible intervals.

Counterpart of `seaweedfs_tpu/filer/filechunks.py`, whole.

A file is an append-ordered list of FileChunk refs; random-offset writes
produce overlapping chunks where the later `mtime` wins (MVCC-ish — the
reference resolves this in weed/filer/filechunks.go
NonOverlappingVisibleIntervals / ViewFromVisibleIntervals and
weed/filer/interval_list.go). This module re-derives those semantics as
pure functions over sorted interval lists.
"""

from __future__ import annotations

from dataclasses import dataclass

from seaweedfs_tpu_torch.filer.entry import FileChunk


@dataclass
class VisibleInterval:
    """A byte range [start, stop) of the logical file served by one chunk.
    `chunk_offset` is where `start` falls inside that chunk's data."""

    start: int
    stop: int
    fid: str
    mtime: int
    chunk_offset: int
    chunk_size: int
    cipher_key: bytes = b""
    is_compressed: bool = False


@dataclass
class ChunkView:
    """One blob read needed to serve part of a file range
    (reference: filechunks.go ChunkView)."""

    fid: str
    offset_in_chunk: int   # where to start reading inside the chunk blob
    size: int              # bytes to read
    logic_offset: int      # where those bytes land in the file
    chunk_size: int
    cipher_key: bytes = b""
    is_compressed: bool = False


def non_overlapping_visible_intervals(
        chunks: list[FileChunk]) -> list[VisibleInterval]:
    """Resolve an overlapping chunk list into a sorted, disjoint list of
    visible intervals. Later mtime wins; ties broken by list order (later
    entry wins, matching append order)."""
    visibles: list[VisibleInterval] = []
    # stable sort by mtime; equal-mtime chunks keep append order so the
    # later append shadows the earlier one
    for c in sorted(chunks, key=lambda c: c.mtime):
        visibles = _merge_into_visibles(visibles, c)
    return visibles


def _merge_into_visibles(visibles: list[VisibleInterval],
                         chunk: FileChunk) -> list[VisibleInterval]:
    new = VisibleInterval(
        start=chunk.offset, stop=chunk.offset + chunk.size, fid=chunk.fid,
        mtime=chunk.mtime, chunk_offset=0, chunk_size=chunk.size,
        cipher_key=chunk.cipher_key, is_compressed=chunk.is_compressed)

    # fast path: append at the end
    if not visibles or visibles[-1].stop <= new.start:
        visibles.append(new)
        return visibles

    out: list[VisibleInterval] = []
    for v in visibles:
        if v.stop <= new.start or v.start >= new.stop:
            out.append(v)  # no overlap — keep whole
            continue
        # the newer chunk shadows the overlap; keep the remainders
        if v.start < new.start:
            out.append(VisibleInterval(
                start=v.start, stop=new.start, fid=v.fid, mtime=v.mtime,
                chunk_offset=v.chunk_offset, chunk_size=v.chunk_size,
                cipher_key=v.cipher_key, is_compressed=v.is_compressed))
        if v.stop > new.stop:
            out.append(VisibleInterval(
                start=new.stop, stop=v.stop, fid=v.fid, mtime=v.mtime,
                chunk_offset=v.chunk_offset + (new.stop - v.start),
                chunk_size=v.chunk_size,
                cipher_key=v.cipher_key, is_compressed=v.is_compressed))
    out.append(new)
    out.sort(key=lambda v: v.start)
    return out


def total_size(chunks: list[FileChunk]) -> int:
    return max((c.offset + c.size for c in chunks), default=0)


def file_size_from_visibles(visibles: list[VisibleInterval]) -> int:
    return visibles[-1].stop if visibles else 0


def view_from_chunks(chunks: list[FileChunk], offset: int,
                     size: int) -> list[ChunkView]:
    """The blob reads needed to serve file range [offset, offset+size).
    Gaps (sparse ranges never written) are simply absent from the result;
    the streamer zero-fills them (reference: filer/stream.go)."""
    return view_from_visibles(
        non_overlapping_visible_intervals(chunks), offset, size)


def view_from_visibles(visibles: list[VisibleInterval], offset: int,
                       size: int) -> list[ChunkView]:
    views: list[ChunkView] = []
    stop = offset + size
    for v in visibles:
        if v.stop <= offset or v.start >= stop:
            continue
        lo = max(v.start, offset)
        hi = min(v.stop, stop)
        views.append(ChunkView(
            fid=v.fid,
            offset_in_chunk=v.chunk_offset + (lo - v.start),
            size=hi - lo,
            logic_offset=lo,
            chunk_size=v.chunk_size,
            cipher_key=v.cipher_key,
            is_compressed=v.is_compressed))
    return views


def compact_chunks(chunks: list[FileChunk]
                   ) -> tuple[list[FileChunk], list[FileChunk]]:
    """Split a chunk list into (still-visible, fully-shadowed garbage)
    (reference: filechunks.go CompactFileChunks). Garbage fids can be
    deleted from the blob store."""
    visibles = non_overlapping_visible_intervals(chunks)
    live_fids = {v.fid for v in visibles}
    compacted = [c for c in chunks if c.fid in live_fids]
    garbage = [c for c in chunks if c.fid not in live_fids]
    return compacted, garbage


def minus_chunks(as_chunks: list[FileChunk],
                 bs_chunks: list[FileChunk]) -> list[FileChunk]:
    """Chunks in `as_chunks` not present in `bs_chunks` by fid
    (reference: filechunks.go MinusChunks) — the delta to garbage-collect
    after an entry update."""
    b_fids = {c.fid for c in bs_chunks}
    return [c for c in as_chunks if c.fid not in b_fids]
