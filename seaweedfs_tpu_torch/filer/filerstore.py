"""FilerStore SPI: the pluggable metadata backend interface.

Counterpart of `seaweedfs_tpu/filer/filerstore.py`, whole.

Mirrors the reference's 8-method plugin contract
(weed/filer/filerstore.go:21-45: Insert/Update/Find/Delete entry,
DeleteFolderChildren, ListDirectoryEntries, KV get/put/delete, Begin/
Commit/Rollback) plus the wrapper that layers counters over any store
(filerstore_wrapper.go). Store drivers register in STORES by name and are
selected by config — the analogue of the reference's blank-import
registration (weed/command/imports.go:17-36).
"""

from __future__ import annotations

import abc
import threading
from collections import defaultdict

from seaweedfs_tpu_torch.filer.entry import Entry, split_path


class StoreError(Exception):
    pass


class NotFound(StoreError):
    pass


class FilerStore(abc.ABC):
    """Metadata backend contract. Paths are absolute ('/a/b/c'); the root
    directory '/' always implicitly exists. Listing returns entries sorted
    by name."""

    name = "abstract"

    @abc.abstractmethod
    def insert_entry(self, entry: Entry) -> None: ...

    @abc.abstractmethod
    def update_entry(self, entry: Entry) -> None: ...

    @abc.abstractmethod
    def find_entry(self, full_path: str) -> Entry: ...  # raises NotFound

    @abc.abstractmethod
    def delete_entry(self, full_path: str) -> None: ...

    @abc.abstractmethod
    def delete_folder_children(self, full_path: str) -> None: ...

    @abc.abstractmethod
    def list_directory_entries(self, dir_path: str, start_from: str = "",
                               include_start: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]: ...

    # -- generic KV (used for filer.conf, iam, sync offsets) -----------

    @abc.abstractmethod
    def kv_put(self, key: bytes, value: bytes) -> None: ...

    @abc.abstractmethod
    def kv_get(self, key: bytes) -> bytes: ...  # raises NotFound

    @abc.abstractmethod
    def kv_delete(self, key: bytes) -> None: ...

    # -- lifecycle / tx (default no-op, like most reference stores) ----

    def initialize(self, **options) -> None:
        pass

    def shutdown(self) -> None:
        pass

    def begin_transaction(self):
        return None

    def commit_transaction(self, tx) -> None:
        pass

    def rollback_transaction(self, tx) -> None:
        pass


HARDLINK_KV_PREFIX = b"hardlink/"


class FilerStoreWrapper(FilerStore):
    """Pass-through wrapper adding op counters and hardlink indirection
    (reference: filerstore_wrapper.go + filerstore_hardlink.go).

    Hardlinked entries keep only (path, hard_link_id, counter) in their
    directory row; the canonical attrs + chunks live in one store-KV blob
    keyed by the hard_link_id.  Every find/list overlays that blob, every
    insert/update of a linked entry rewrites it, and deletes decrement the
    shared counter — dropping the blob (and releasing the chunks to the
    caller for deletion) when the last name goes away."""

    name = "wrapper"

    def __init__(self, actual: FilerStore):
        self.actual = actual
        self.counters: dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()
        # chunks orphaned by an implicit hardlink release (a row re-pointed
        # away from its group by insert/update) flow here; the Filer wires
        # it to its deletion pipeline
        self.on_orphan_chunks = None

    def _count(self, op: str) -> None:
        with self._lock:
            self.counters[op] += 1

    # -- hardlink indirection (filerstore_hardlink.go) -----------------

    @staticmethod
    def _hl_key(hard_link_id: str) -> bytes:
        return HARDLINK_KV_PREFIX + hard_link_id.encode()

    def _set_hard_link(self, entry: Entry) -> None:
        import json
        self.actual.kv_put(self._hl_key(entry.hard_link_id),
                           json.dumps(entry.to_dict()).encode())

    def maybe_read_hard_link(self, entry: Entry) -> Entry:
        """Overlay the canonical attrs/chunks/counter from the hardlink
        blob; the row's own copies may be stale siblings' views."""
        if not entry.hard_link_id:
            return entry
        import json
        try:
            blob = self.actual.kv_get(self._hl_key(entry.hard_link_id))
        except NotFound:
            return entry  # orphaned id: serve the row as-is
        src = Entry.from_dict(json.loads(blob))
        entry.attr = src.attr
        entry.chunks = src.chunks
        entry.extended = src.extended
        entry.hard_link_counter = src.hard_link_counter
        return entry

    def _handle_update_to_hardlinks(self, entry: Entry) -> None:
        """Before writing a row: persist the shared blob, and if the row
        previously pointed at a DIFFERENT hardlink id, release that one
        (reference: handleUpdateToHardLinks)."""
        if entry.is_directory:
            return
        if entry.hard_link_id:
            self._set_hard_link(entry)
        try:
            existing = self.actual.find_entry(entry.full_path)
        except NotFound:
            return
        if existing.hard_link_id and \
                existing.hard_link_id != entry.hard_link_id:
            _, garbage = self.delete_hard_link(existing.hard_link_id)
            if garbage and self.on_orphan_chunks is not None:
                self.on_orphan_chunks(garbage)

    def delete_hard_link(self, hard_link_id: str
                         ) -> tuple[int, list]:
        """Decrement the shared counter; -> (remaining, orphaned_chunks).
        orphaned_chunks is non-empty only when the count hit zero — unlike
        the reference (which leaks them, filerstore_hardlink.go:80-107)
        the chunks of the last name are handed back for deletion."""
        import json
        key = self._hl_key(hard_link_id)
        try:
            blob = self.actual.kv_get(key)
        except NotFound:
            return 0, []
        entry = Entry.from_dict(json.loads(blob))
        entry.hard_link_counter -= 1
        if entry.hard_link_counter <= 0:
            self.actual.kv_delete(key)
            return 0, entry.chunks
        self.actual.kv_put(key, json.dumps(entry.to_dict()).encode())
        return entry.hard_link_counter, []

    # -- CRUD ----------------------------------------------------------

    def insert_entry(self, entry: Entry) -> None:
        self._count("insert")
        self._handle_update_to_hardlinks(entry)
        self.actual.insert_entry(entry)

    def update_entry(self, entry: Entry) -> None:
        self._count("update")
        self._handle_update_to_hardlinks(entry)
        self.actual.update_entry(entry)

    def find_entry(self, full_path: str) -> Entry:
        self._count("find")
        return self.maybe_read_hard_link(self.actual.find_entry(full_path))

    _UNKNOWN = object()  # sentinel: caller didn't look the entry up

    def delete_entry(self, full_path: str, keep_hard_link: bool = False,
                     hard_link_id=_UNKNOWN) -> list:
        """Delete a row; -> chunks orphaned by a last-name hardlink removal
        (empty otherwise).  keep_hard_link skips the decrement — rename
        moves a name, it does not remove one.  Callers that already hold
        the entry pass its hard_link_id ("" for plain entries) to avoid a
        second store lookup per delete."""
        self._count("delete")
        garbage: list = []
        if not keep_hard_link:
            hl = hard_link_id
            if hl is self._UNKNOWN:
                try:
                    existing = self.actual.find_entry(full_path)
                    hl = "" if existing.is_directory else \
                        existing.hard_link_id
                except NotFound:
                    hl = ""
            if hl:
                _, garbage = self.delete_hard_link(hl)
        self.actual.delete_entry(full_path)
        return garbage

    def delete_folder_children(self, full_path: str) -> None:
        self._count("delete_folder_children")
        self.actual.delete_folder_children(full_path)

    def list_directory_entries(self, dir_path: str, start_from: str = "",
                               include_start: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]:
        self._count("list")
        out = self.actual.list_directory_entries(
            dir_path, start_from, include_start, limit, prefix)
        for e in out:
            if e.hard_link_id:
                self.maybe_read_hard_link(e)
        return out

    def kv_put(self, key: bytes, value: bytes) -> None:
        self.actual.kv_put(key, value)

    def kv_get(self, key: bytes) -> bytes:
        return self.actual.kv_get(key)

    def kv_delete(self, key: bytes) -> None:
        self.actual.kv_delete(key)

    def shutdown(self) -> None:
        self.actual.shutdown()


class MemoryStore(FilerStore):
    """In-RAM store: dict of directory -> {name: Entry blob}. The test /
    ephemeral-filer store (plays the role of the reference's leveldb default
    for unit tests)."""

    name = "memory"

    def __init__(self):
        self._dirs: dict[str, dict[str, bytes]] = defaultdict(dict)
        self._kv: dict[bytes, bytes] = {}
        self._lock = threading.RLock()

    def insert_entry(self, entry: Entry) -> None:
        d, n = split_path(entry.full_path)
        with self._lock:
            self._dirs[d][n] = entry.encode()

    update_entry = insert_entry

    def iter_all_entries(self):
        """Snapshot iterator over every entry (LogStore compaction)."""
        with self._lock:
            blobs = [b for d in self._dirs.values() for b in d.values()]
        for blob in blobs:
            yield Entry.decode(blob)

    def iter_kv(self):
        with self._lock:
            return list(self._kv.items())

    def count_entries(self) -> int:
        with self._lock:
            return sum(len(d) for d in self._dirs.values())

    def find_entry(self, full_path: str) -> Entry:
        d, n = split_path(full_path)
        with self._lock:
            blob = self._dirs.get(d, {}).get(n)
        if blob is None:
            raise NotFound(full_path)
        return Entry.decode(blob)

    def delete_entry(self, full_path: str) -> None:
        d, n = split_path(full_path)
        with self._lock:
            self._dirs.get(d, {}).pop(n, None)

    def delete_folder_children(self, full_path: str) -> None:
        full_path = full_path.rstrip("/") or "/"
        with self._lock:
            pref = full_path if full_path.endswith("/") else full_path + "/"
            for d in [k for k in self._dirs if k == full_path or
                      k.startswith(pref)]:
                del self._dirs[d]

    def list_directory_entries(self, dir_path: str, start_from: str = "",
                               include_start: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]:
        dir_path = dir_path.rstrip("/") or "/"
        with self._lock:
            names = sorted(self._dirs.get(dir_path, {}))
            out = []
            for n in names:
                if prefix and not n.startswith(prefix):
                    continue
                if start_from:
                    if n < start_from or (n == start_from and not include_start):
                        continue
                out.append(Entry.decode(self._dirs[dir_path][n]))
                if len(out) >= limit:
                    break
            return out

    def kv_put(self, key: bytes, value: bytes) -> None:
        with self._lock:
            self._kv[key] = value

    def kv_get(self, key: bytes) -> bytes:
        with self._lock:
            if key not in self._kv:
                raise NotFound(key)
            return self._kv[key]

    def kv_delete(self, key: bytes) -> None:
        with self._lock:
            self._kv.pop(key, None)


STORES: dict[str, type] = {
    "memory": MemoryStore,
    # "sqlite"/"postgres"/"mysql" register from abstract_sql.py,
    # "logstore"/"redis" from stores_extra.py
}


def make_store(kind: str, **options) -> FilerStore:
    try:
        cls = STORES[kind]
    except KeyError:
        raise StoreError(
            f"unknown filer store {kind!r}; have {sorted(STORES)}") from None
    return cls(**options)
