"""Counterpart of `seaweedfs_tpu/filer/filer_deletion.py`, whole, over the
port's `WeedClient`.

Async chunk-deletion pipeline: deleted entries' fids are queued and
batch-deleted from the volume servers in the background (reference:
weed/filer/filer_deletion.go + operation/delete_content.go BatchDelete).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import defaultdict

from seaweedfs_tpu_torch.filer.entry import FileChunk

log = logging.getLogger("filer.deletion")


class DeletionQueue:
    """Thread-backed queue; drains every `interval` seconds, groups fids by
    volume, and issues one delete per fid via the client (the reference
    batches per volume server with BatchDelete — grouping by volume keeps
    lookups amortised the same way)."""

    def __init__(self, client, interval: float = 1.0,
                 resolve_manifest=None):
        self.client = client
        self.interval = interval
        self.resolve_manifest = resolve_manifest
        self._pending: list[FileChunk] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.deleted_count = 0
        self.error_count = 0

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self, drain: bool = True) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(5)
        if drain:
            self._drain()

    def enqueue_chunks(self, chunks: list[FileChunk]) -> None:
        """Cheap and non-blocking — manifest refs are expanded later in the
        worker thread (they need blob reads, which must not run on the
        caller's event loop)."""
        with self._lock:
            self._pending.extend(chunks)

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self._drain()

    def _drain(self) -> None:
        with self._lock:
            batch, self._pending = self._pending, []
        if not batch:
            return
        fids: list[str] = []
        for c in batch:
            resolved = False
            if c.is_chunk_manifest and self.resolve_manifest:
                try:
                    # resolver returns every nesting level including `c`
                    # itself, so intermediate manifest blobs get deleted too
                    fids.extend(sub.fid for sub in self.resolve_manifest([c]))
                    resolved = True
                except Exception as e:
                    log.warning("manifest resolve for delete: %s", e)
            if not resolved:
                fids.append(c.fid)
        by_volume: dict[int, list[str]] = defaultdict(list)
        for fid in fids:
            try:
                vid = int(fid.partition(",")[0])
            except ValueError:
                continue
            by_volume[vid].append(fid)
        for vid, fids in by_volume.items():
            for fid in fids:
                try:
                    self.client.delete(fid)
                    self.deleted_count += 1
                except Exception as e:
                    self.error_count += 1
                    log.debug("delete %s: %s", fid, e)

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    def wait_empty(self, timeout: float = 10.0) -> bool:
        deadline = time.time() + timeout
        while time.time() < deadline:
            if self.pending_count() == 0:
                return True
            time.sleep(0.05)
        return False
