"""Chunk manifests: batch many chunk refs into a stored blob.

Counterpart of `seaweedfs_tpu/filer/filechunk_manifest.py`, whole; the
manifest payload is byte-equal to the reference's.

Huge files would otherwise carry 100k+ chunk refs in their metadata row;
the reference batches every 10,000 refs into a "chunk of chunks" blob
stored in the blob store itself and resolved recursively at read
(weed/filer/filechunk_manifest.go: ManifestBatch=10000,
ResolveChunkManifest:52, maybeManifestize:215). Same contract here with a
JSON manifest payload.
"""

from __future__ import annotations

import json
from typing import Callable

from seaweedfs_tpu_torch.filer.entry import FileChunk

MANIFEST_BATCH = 10000

SaveFunc = Callable[[bytes], FileChunk]   # bytes -> stored chunk ref
ReadFunc = Callable[[str], bytes]         # fid -> chunk bytes


def has_chunk_manifest(chunks: list[FileChunk]) -> bool:
    return any(c.is_chunk_manifest for c in chunks)


def maybe_manifestize(save: SaveFunc, chunks: list[FileChunk],
                      batch: int = MANIFEST_BATCH) -> list[FileChunk]:
    """If the ref list is long, replace runs of `batch` non-manifest chunks
    with manifest chunks. Idempotent; already-manifest refs pass through."""
    if len(chunks) <= batch:
        return chunks
    plain = [c for c in chunks if not c.is_chunk_manifest]
    out = [c for c in chunks if c.is_chunk_manifest]
    for i in range(0, len(plain), batch):
        group = plain[i:i + batch]
        if len(group) < batch:
            out.extend(group)
            break
        out.append(_manifestize(save, group))
    out.sort(key=lambda c: c.offset)
    return out


def manifest_payload(group: list[FileChunk]) -> bytes:
    """The stored manifest blob for a group of chunk refs."""
    return json.dumps({"chunks": [c.to_dict() for c in group]},
                      separators=(",", ":")).encode()


def manifest_ref(stored: FileChunk, group: list[FileChunk]) -> FileChunk:
    """The chunk ref that replaces `group`, pointing at the stored
    manifest blob."""
    start = min(c.offset for c in group)
    stop = max(c.offset + c.size for c in group)
    return FileChunk(fid=stored.fid, offset=start, size=stop - start,
                     mtime=max(c.mtime for c in group), etag=stored.etag,
                     is_chunk_manifest=True)


def _manifestize(save: SaveFunc, group: list[FileChunk]) -> FileChunk:
    return manifest_ref(save(manifest_payload(group)), group)


def resolve_chunk_manifest(read: ReadFunc, chunks: list[FileChunk],
                           include_manifests: bool = False) -> list[FileChunk]:
    """Recursively expand manifest refs into the full flat chunk list
    (reference: ResolveChunkManifest). With `include_manifests` the manifest
    refs themselves are kept in the output too — deletion needs every fid at
    every nesting level, not just the leaves."""
    out: list[FileChunk] = []
    for c in chunks:
        if not c.is_chunk_manifest:
            out.append(c)
            continue
        if include_manifests:
            out.append(c)
        payload = json.loads(read(c.fid))
        nested = [FileChunk.from_dict(d) for d in payload["chunks"]]
        out.extend(resolve_chunk_manifest(read, nested, include_manifests))
    return out
