"""Filer: the metadata brain — entries over a FilerStore, with parent-dir
maintenance, recursive delete, subtree rename, and a replayable meta event
log.

Capability parity with the reference Filer (weed/filer/filer.go:37-55
CreateEntry/FindEntry/DeleteEntry, filer_grpc_server_rename.go subtree
move, filer_notify.go NotifyUpdateEvent + log_buffer). Events are JSON
records appended to an in-memory ring plus an optional on-disk JSONL log,
each with a monotonically increasing ns timestamp usable as a resume
offset — the same contract filer.sync relies on in the reference.

Counterpart of `seaweedfs_tpu/filer/filer.py`, cut to what the port
calls: the event format (`MetaEvent.to_dict`, `signatures` included) and
the log file are the reference's, so a log written by either package
replays in the other.  What only the filer server and filer.sync set
comes with them: the `signatures` keywords of the mutations, and the
log's listeners, `head_ts` and `backlog_count`.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Callable, Iterator

from seaweedfs_tpu_torch.filer import filechunks
from seaweedfs_tpu_torch.filer.entry import (Entry, FileChunk, join_path,
                                             new_directory_entry,
                                             parent_directories, split_path,
                                             ttl_expired)
from seaweedfs_tpu_torch.filer.filerstore import (FilerStore,
                                                  FilerStoreWrapper,
                                                  NotFound)


class MetaEvent:
    """One metadata mutation: create / update / delete / rename leg.

    `signatures` carries the origin markers used by filer.sync loop
    prevention (reference: filer_pb SubscribeMetadata signatures,
    filer/meta_aggregator.go) — a sync writer stamps its peer signature on
    the replicated write, and skips events already stamped with its own."""

    __slots__ = ("ts_ns", "directory", "old_entry", "new_entry",
                 "new_parent", "signatures")

    def __init__(self, ts_ns: int, directory: str,
                 old_entry: Entry | None, new_entry: Entry | None,
                 new_parent: str = "", signatures: list[int] | None = None):
        self.ts_ns = ts_ns
        self.directory = directory
        self.old_entry = old_entry
        self.new_entry = new_entry
        self.new_parent = new_parent
        self.signatures = signatures or []

    def to_dict(self) -> dict:
        return {
            "ts_ns": self.ts_ns,
            "directory": self.directory,
            "old_entry": self.old_entry.to_dict() if self.old_entry else None,
            "new_entry": self.new_entry.to_dict() if self.new_entry else None,
            "new_parent": self.new_parent,
            "signatures": self.signatures,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "MetaEvent":
        return cls(
            ts_ns=d["ts_ns"], directory=d["directory"],
            old_entry=Entry.from_dict(d["old_entry"]) if d.get("old_entry") else None,
            new_entry=Entry.from_dict(d["new_entry"]) if d.get("new_entry") else None,
            new_parent=d.get("new_parent", ""),
            signatures=d.get("signatures") or [])


def event_matches_prefix(ev: "MetaEvent", prefix: str) -> bool:
    """Prefix filter that also matches the OLD side of a rename, so a move
    out of the synced subtree still delivers the deletion leg."""
    if dir_has_prefix(ev.directory, prefix):
        return True
    if ev.old_entry is not None and \
            dir_has_prefix(ev.old_entry.directory, prefix):
        return True
    return False


def dir_has_prefix(directory: str, prefix: str) -> bool:
    """Path-component-aware prefix match: /topics matches /topics and
    /topics/sub but NOT /topics2."""
    prefix = prefix.rstrip("/")
    if not prefix:
        return True
    return directory == prefix or directory.startswith(prefix + "/")


class MetaLog:
    """In-memory ring of recent events + optional JSONL persistence,
    replayable from a ts_ns offset (reference: weed/util/log_buffer +
    filer_notify_append.go writing /topics/.system/log)."""

    def __init__(self, path: str | None = None, ring_size: int = 8192):
        self.path = path
        self.ring: deque[MetaEvent] = deque(maxlen=ring_size)
        self._lock = threading.Lock()
        self._last_ts = 0
        self._file = open(path, "a", encoding="utf-8") if path else None

    def next_ts(self) -> int:
        with self._lock:
            ts = time.time_ns()
            if ts <= self._last_ts:
                ts = self._last_ts + 1
            self._last_ts = ts
            return ts

    def append(self, ev: MetaEvent) -> None:
        with self._lock:
            self.ring.append(ev)
            if self._file:
                self._file.write(json.dumps(ev.to_dict(),
                                            separators=(",", ":")) + "\n")
                self._file.flush()

    def replay(self, since_ts_ns: int = 0,
               prefix: str = "/") -> Iterator[MetaEvent]:
        """Events after the offset, oldest first: on-disk log first (if the
        ring has rolled past the offset), then the ring."""
        ring_events = list(self.ring)
        ring_min = ring_events[0].ts_ns if ring_events else None
        if self.path and os.path.exists(self.path) and (
                ring_min is None or since_ts_ns < ring_min - 1):
            with open(self.path, encoding="utf-8") as f:
                for line in f:
                    if not line.strip():
                        continue
                    ev = MetaEvent.from_dict(json.loads(line))
                    if ev.ts_ns <= since_ts_ns:
                        continue
                    if ring_min is not None and ev.ts_ns >= ring_min:
                        break
                    if event_matches_prefix(ev, prefix):
                        yield ev
        for ev in ring_events:
            if ev.ts_ns <= since_ts_ns:
                continue
            if event_matches_prefix(ev, prefix):
                yield ev

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None


class Filer:
    def __init__(self, store: FilerStore, meta_log_path: str | None = None,
                 on_delete_chunks: Callable[[list[FileChunk]], None] | None = None):
        self.store = FilerStoreWrapper(store)
        self.meta_log = MetaLog(meta_log_path)
        self.on_delete_chunks = on_delete_chunks or (lambda chunks: None)
        self.store.on_orphan_chunks = lambda chunks: \
            self.on_delete_chunks(chunks)
        self._lock = threading.RLock()

    # -- events --------------------------------------------------------

    def _notify(self, old: Entry | None, new: Entry | None,
                new_parent: str = "") -> None:
        directory = (new or old).directory if (new or old) else "/"
        self.meta_log.append(MetaEvent(
            self.meta_log.next_ts(), directory, old, new, new_parent))

    # -- core CRUD -----------------------------------------------------

    def create_entry(self, entry: Entry, o_excl: bool = False,
                     mkdirs: bool = True) -> Entry:
        """Insert or replace an entry; creates missing parent directories
        (reference: filer.go CreateEntry + ensureParentDirectoryEntry)."""
        with self._lock:
            if mkdirs:
                for d in parent_directories(entry.full_path):
                    self._ensure_directory(d)
            old = None
            try:
                old = self.store.find_entry(entry.full_path)
            except NotFound:
                pass
            if old is not None:
                if o_excl:
                    raise FileExistsError(entry.full_path)
                if old.is_directory and not entry.is_directory:
                    raise IsADirectoryError(entry.full_path)
            if not entry.attr.crtime:
                entry.attr.crtime = old.attr.crtime if old else time.time()
            if not entry.attr.mtime:
                entry.attr.mtime = time.time()
            self.store.insert_entry(entry)
            # garbage-collect chunks replaced by the new version — UNLESS
            # the old row belonged to a hardlink group this write leaves:
            # siblings still reference those chunks (the wrapper already
            # decremented the group and orphaned them if this was the last
            # name)
            left_group = old is not None and old.hard_link_id and \
                old.hard_link_id != entry.hard_link_id
            if old is not None and old.chunks and not left_group:
                garbage = filechunks.minus_chunks(old.chunks, entry.chunks)
                if garbage:
                    self.on_delete_chunks(garbage)
            self._notify(old, entry)
            return entry

    def _ensure_directory(self, dir_path: str) -> None:
        if dir_path == "/":
            return
        try:
            e = self.store.find_entry(dir_path)
            if not e.is_directory:
                raise NotADirectoryError(dir_path)
            return
        except NotFound:
            pass
        d = new_directory_entry(dir_path)
        self.store.insert_entry(d)
        self._notify(None, d)

    def find_entry(self, full_path: str) -> Entry:
        full_path = full_path.rstrip("/") or "/"
        if full_path == "/":
            return new_directory_entry("/")
        entry = self.store.find_entry(full_path)
        if ttl_expired(entry):
            self.delete_entry(full_path, recursive=False,
                              ignore_recursive_error=True)
            raise NotFound(full_path)
        return entry

    def exists(self, full_path: str) -> bool:
        try:
            self.find_entry(full_path)
            return True
        except NotFound:
            return False

    def update_entry(self, entry: Entry, touch: bool = True) -> Entry:
        with self._lock:
            old = None
            try:
                old = self.store.find_entry(entry.full_path)
            except NotFound:
                pass
            if touch:
                entry.attr.mtime = time.time()
            self.store.update_entry(entry)
            self._notify(old, entry)
            return entry

    def list_entries(self, dir_path: str, start_from: str = "",
                     include_start: bool = False, limit: int = 1024,
                     prefix: str = "") -> list[Entry]:
        """TTL'd-out entries (bucket lifecycle expiry) are invisible; the
        rows are reaped lazily by find_entry, like the reference's filer
        TTL handling.  Pages REFILL after filtering — a short page means
        end-of-directory to every pagination consumer, so expired rows
        must never shorten one."""
        out: list[Entry] = []
        cursor, inc = start_from, include_start
        while len(out) < limit:
            want = limit - len(out)
            page = self.store.list_directory_entries(
                dir_path, cursor, inc, want, prefix)
            out.extend(e for e in page if not ttl_expired(e))
            if len(page) < want:
                break  # store exhausted
            cursor, inc = page[-1].name, False
        return out

    def iter_entries(self, dir_path: str, prefix: str = "",
                     batch: int = 1024) -> Iterator[Entry]:
        start, include = "", True
        while True:
            page = self.list_entries(dir_path, start, include, batch, prefix)
            if not page:
                return
            yield from page
            if len(page) < batch:
                return
            start, include = page[-1].name, False

    def subtree_digest(self, prefix: str = "/") -> tuple[str, int]:
        """Deterministic content digest of a subtree: sha256 over the
        sorted (path, kind, size, md5) lines of every entry under
        `prefix`.  Chunk fids and mtimes are deliberately excluded —
        each region places data in its own volumes, so only
        path+size+content can (and must) agree.  Two filers whose
        digests match hold byte-identical trees, which is exactly the
        convergence proof the geo divergence auditor publishes.
        Best-effort snapshot: concurrent writers can race the walk, the
        auditor re-probes."""
        import hashlib
        lines: list[str] = []
        root = prefix.rstrip("/") or "/"

        def walk(dir_path: str) -> None:
            for e in self.iter_entries(dir_path):
                if e.is_directory:
                    lines.append(f"{e.full_path}\x00dir")
                    walk(e.full_path)
                else:
                    lines.append(f"{e.full_path}\x00file\x00{e.size()}"
                                 f"\x00{e.attr.md5}")

        try:
            root_entry = self.find_entry(root)
        except NotFound:
            root_entry = None
        if root_entry is None:
            pass  # empty subtree digests to the empty-tree constant
        elif root_entry.is_directory:
            walk(root)
        else:
            lines.append(f"{root_entry.full_path}\x00file"
                         f"\x00{root_entry.size()}\x00{root_entry.attr.md5}")
        lines.sort()
        digest = hashlib.sha256("\n".join(lines).encode()).hexdigest()
        return digest, len(lines)

    def delete_entry(self, full_path: str, recursive: bool = False,
                     ignore_recursive_error: bool = False,
                     delete_chunks: bool = True) -> None:
        """Delete one entry; directories require recursive=True when
        non-empty. Collected chunk fids flow to on_delete_chunks
        (reference: filer_delete_entry.go)."""
        full_path = full_path.rstrip("/") or "/"
        with self._lock:
            entry = self.store.find_entry(full_path)
            chunks: list[FileChunk] = []
            if entry.is_directory:
                children = self.list_entries(full_path, limit=2)
                if children and not recursive and not ignore_recursive_error:
                    raise OSError(f"directory {full_path} not empty")
                self._collect_subtree(full_path, chunks)
                self.store.delete_folder_children(full_path)
                self.store.delete_entry(full_path, hard_link_id="")
            elif entry.hard_link_id:
                # removing one NAME of a hardlinked file: its chunks become
                # garbage only when the last name goes (the wrapper hands
                # them back at counter zero)
                chunks.extend(self.store.delete_entry(
                    full_path, hard_link_id=entry.hard_link_id))
            else:
                chunks.extend(entry.chunks)
                self.store.delete_entry(full_path, hard_link_id="")
            if delete_chunks and chunks:
                self.on_delete_chunks(chunks)
            self._notify(entry, None)

    def _collect_subtree(self, dir_path: str,
                         chunks: list[FileChunk]) -> None:
        for e in self.iter_entries(dir_path):
            if e.is_directory:
                self._collect_subtree(e.full_path, chunks)
                self._notify(e, None)
            else:
                if e.hard_link_id:
                    # bulk folder wipe skips per-row deletes, so decrement
                    # each linked child here; chunks orphan at zero
                    _, garbage = self.store.delete_hard_link(e.hard_link_id)
                    chunks.extend(garbage)
                else:
                    chunks.extend(e.chunks)
                self._notify(e, None)

    # -- hardlinks (filer_hardlink.go + weedfs_link.go semantics) -------

    def link_entry(self, old_path: str, new_path: str) -> Entry:
        """Create `new_path` as an additional name for the file at
        `old_path`.  First link converts the file to hardlink mode: its
        attrs+chunks move into a store-KV blob keyed by a fresh random
        hard_link_id and every name's row just points there."""
        import secrets
        old_path = old_path.rstrip("/") or "/"
        new_path = new_path.rstrip("/") or "/"
        with self._lock:
            entry = self.store.find_entry(old_path)
            if entry.is_directory:
                raise IsADirectoryError(old_path)
            if self.exists(new_path):
                raise FileExistsError(new_path)
            # parents first: a NotADirectoryError here must not leave the
            # group over-counted
            for d in parent_directories(new_path):
                self._ensure_directory(d)
            before = Entry.from_dict(entry.to_dict())
            if not entry.hard_link_id:
                entry.hard_link_id = secrets.token_hex(16)
                entry.hard_link_counter = 1
            entry.hard_link_counter += 1
            self.store.update_entry(entry)  # rewrites row + shared blob
            self._notify(before, entry)
            # POSIX link(2): the file's mtime is untouched (only ctime
            # changes) — the new name carries the same attrs verbatim
            link = Entry.from_dict(entry.to_dict())
            link.full_path = new_path
            self.store.insert_entry(link)
            self._notify(None, link)
            return link

    # -- rename (atomic within this filer) -----------------------------

    def rename_entry(self, old_path: str, new_path: str) -> Entry:
        """Move an entry (and its subtree) — the reference does this as a
        store transaction in filer_grpc_server_rename.go; here the filer
        lock serialises it."""
        old_path = old_path.rstrip("/") or "/"
        new_path = new_path.rstrip("/") or "/"
        if new_path == old_path or new_path.startswith(old_path + "/"):
            raise OSError(f"cannot move {old_path} into itself")
        with self._lock:
            entry = self.store.find_entry(old_path)
            if self.exists(new_path):
                target = self.store.find_entry(new_path)
                if target.is_directory:
                    new_path = join_path(new_path, entry.name)
                    if self.exists(new_path):
                        raise FileExistsError(new_path)
                elif entry.is_directory:
                    raise NotADirectoryError(new_path)
            for d in parent_directories(new_path):
                self._ensure_directory(d)
            moved = self._move_subtree(entry, new_path)
            return moved

    def _move_subtree(self, entry: Entry, new_path: str) -> Entry:
        new_entry = Entry.from_dict(entry.to_dict())
        new_entry.full_path = new_path
        self.store.insert_entry(new_entry)
        if entry.is_directory:
            for child in list(self.iter_entries(entry.full_path)):
                self._move_subtree(child, join_path(new_path, child.name))
        # rename moves a name, it does not remove one: the hardlink
        # counter must not decrement
        self.store.delete_entry(entry.full_path, keep_hard_link=True)
        self._notify(entry, new_entry, new_parent=split_path(new_path)[0])
        return new_entry
