"""Additional filer store drivers.

Counterpart of `seaweedfs_tpu/filer/stores_extra.py`, whole: the same
LogStore files, so a directory written by either package replays in
the other.

Reference: the 20+ one-directory-per-backend stores under weed/filer/
(leveldb2/, redis2/, mysql2/, cassandra/, ...), registered by blank
import and chosen by the enabled block in filer.toml.  This module adds:

  - LogStore: an embedded log-structured store (LevelDB-class role:
    single-writer local persistence with an in-memory index, JSONL WAL +
    snapshot compaction) — no external dependency.
  - RedisStore / MongoStore / EtcdStore: registered only when their client
    packages import (like the reference's build-tag-gated drivers).
  - CassandraStore (wide-column, directory partitions + dirlist index) and
    TikvStore (ordered KV, <dir>\x00<name> keys): injectable clients —
    SDK-gated in production, fully matrix-tested through in-memory fakes.
  - ElasticStore: pure-REST Elasticsearch driver (no SDK), injectable
    transport.

Every driver implements the same 8-method FilerStore SPI
(weed/filer/filerstore.go:21-45)."""

from __future__ import annotations

import json
import os
import threading

from seaweedfs_tpu_torch.filer.entry import Entry
from seaweedfs_tpu_torch.filer.filerstore import (STORES, FilerStore,
                                                  MemoryStore, NotFound)


class LogStore(FilerStore):
    """In-memory maps + append-only JSONL WAL, snapshot-compacted when the
    WAL outgrows the live set (the LSM idea at its smallest)."""

    name = "logstore"
    COMPACT_RATIO = 4  # compact when wal lines > live entries * ratio

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self._mem = MemoryStore()
        self._lock = threading.Lock()
        self.wal_path = os.path.join(directory, "wal.jsonl")
        self.snap_path = os.path.join(directory, "snapshot.jsonl")
        self._wal_lines = 0
        self._replay()
        self._wal = open(self.wal_path, "a", encoding="utf-8")

    # -- persistence ----------------------------------------------------

    def _replay(self) -> None:
        for path in (self.snap_path, self.wal_path):
            if not os.path.exists(path):
                continue
            with open(path, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue  # torn tail
                    self._apply(rec)
                    if path == self.wal_path:
                        self._wal_lines += 1

    def _apply(self, rec: dict) -> None:
        op = rec.get("op")
        try:
            if op == "put":
                self._mem.insert_entry(Entry.from_dict(rec["entry"]))
            elif op == "del":
                self._mem.delete_entry(rec["path"])
            elif op == "delkids":
                self._mem.delete_folder_children(rec["path"])
            elif op == "kvput":
                self._mem.kv_put(bytes.fromhex(rec["k"]),
                                 bytes.fromhex(rec["v"]))
            elif op == "kvdel":
                self._mem.kv_delete(bytes.fromhex(rec["k"]))
        except NotFound:
            pass

    def _log(self, rec: dict) -> None:
        self._wal.write(json.dumps(rec, separators=(",", ":")) + "\n")
        self._wal.flush()
        self._wal_lines += 1
        if self._wal_lines > self.COMPACT_RATIO * max(
                64, self._mem.count_entries()):
            self._compact()

    def _compact(self) -> None:
        tmp = self.snap_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            for e in self._mem.iter_all_entries():
                f.write(json.dumps({"op": "put", "entry": e.to_dict()},
                                   separators=(",", ":")) + "\n")
            for k, v in self._mem.iter_kv():
                f.write(json.dumps({"op": "kvput", "k": k.hex(),
                                    "v": v.hex()},
                                   separators=(",", ":")) + "\n")
        os.replace(tmp, self.snap_path)
        self._wal.close()
        with open(self.wal_path, "w"):
            pass
        self._wal = open(self.wal_path, "a", encoding="utf-8")
        self._wal_lines = 0

    # -- SPI ------------------------------------------------------------

    def insert_entry(self, entry: Entry) -> None:
        with self._lock:
            self._mem.insert_entry(entry)
            self._log({"op": "put", "entry": entry.to_dict()})

    def update_entry(self, entry: Entry) -> None:
        with self._lock:
            self._mem.update_entry(entry)
            self._log({"op": "put", "entry": entry.to_dict()})

    def find_entry(self, full_path: str) -> Entry:
        with self._lock:
            return self._mem.find_entry(full_path)

    def delete_entry(self, full_path: str) -> None:
        with self._lock:
            self._mem.delete_entry(full_path)
            self._log({"op": "del", "path": full_path})

    def delete_folder_children(self, full_path: str) -> None:
        with self._lock:
            self._mem.delete_folder_children(full_path)
            self._log({"op": "delkids", "path": full_path})

    def list_directory_entries(self, dir_path: str, start_from: str = "",
                               include_start: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]:
        with self._lock:
            return self._mem.list_directory_entries(
                dir_path, start_from, include_start, limit, prefix)

    def kv_put(self, key: bytes, value: bytes) -> None:
        with self._lock:
            self._mem.kv_put(key, value)
            self._log({"op": "kvput", "k": key.hex(), "v": value.hex()})

    def kv_get(self, key: bytes) -> bytes:
        with self._lock:
            return self._mem.kv_get(key)

    def kv_delete(self, key: bytes) -> None:
        with self._lock:
            self._mem.kv_delete(key)
            self._log({"op": "kvdel", "k": key.hex()})

    def shutdown(self) -> None:
        with self._lock:
            self._wal.close()


STORES["logstore"] = LogStore


try:  # pragma: no cover - depends on environment
    import redis as _redis  # noqa: F401

    class RedisStore(FilerStore):
        """Entries + directory sets in Redis (reference: weed/filer/redis2).
        Key layout: 'e:<path>' -> entry json; 'd:<dir>' -> sorted-set of
        child names; 'kv:<key>' -> bytes."""

        name = "redis"

        def __init__(self, host: str = "127.0.0.1", port: int = 6379,
                     db: int = 0, password: str | None = None):
            self.r = _redis.Redis(host=host, port=port, db=db,
                                  password=password)

        def insert_entry(self, entry: Entry) -> None:
            self.r.set(b"e:" + entry.full_path.encode(),
                       json.dumps(entry.to_dict()).encode())
            if entry.full_path != "/":
                d = entry.full_path.rsplit("/", 1)[0] or "/"
                self.r.zadd(b"d:" + d.encode(), {entry.name.encode(): 0})

        update_entry = insert_entry

        def find_entry(self, full_path: str) -> Entry:
            raw = self.r.get(b"e:" + full_path.encode())
            if raw is None:
                raise NotFound(full_path)
            return Entry.from_dict(json.loads(raw))

        def delete_entry(self, full_path: str) -> None:
            self.r.delete(b"e:" + full_path.encode())
            d = full_path.rsplit("/", 1)[0] or "/"
            name = full_path.rsplit("/", 1)[-1]
            self.r.zrem(b"d:" + d.encode(), name.encode())

        def delete_folder_children(self, full_path: str) -> None:
            for e in self.list_directory_entries(full_path, limit=1 << 30):
                if e.is_directory:
                    self.delete_folder_children(e.full_path)
                self.delete_entry(e.full_path)

        def list_directory_entries(self, dir_path: str, start_from: str = "",
                                   include_start: bool = False,
                                   limit: int = 1024,
                                   prefix: str = "") -> list[Entry]:
            d = dir_path.rstrip("/") or "/"
            names = [n.decode() for n in self.r.zrange(
                b"d:" + d.encode(), 0, -1)]
            names.sort()
            out = []
            for name in names:
                if prefix and not name.startswith(prefix):
                    continue
                if start_from:
                    if name < start_from or \
                            (name == start_from and not include_start):
                        continue
                try:
                    out.append(self.find_entry(
                        dir_path.rstrip("/") + "/" + name))
                except NotFound:
                    continue
                if len(out) >= limit:
                    break
            return out

        def kv_put(self, key: bytes, value: bytes) -> None:
            self.r.set(b"kv:" + key, value)

        def kv_get(self, key: bytes) -> bytes:
            raw = self.r.get(b"kv:" + key)
            if raw is None:
                raise NotFound(key.decode(errors="replace"))
            return raw

        def kv_delete(self, key: bytes) -> None:
            self.r.delete(b"kv:" + key)

    STORES["redis"] = RedisStore
except ImportError:
    pass


try:  # pragma: no cover - depends on environment
    import pymongo as _pymongo  # noqa: F401

    class MongoStore(FilerStore):
        """Entries in a MongoDB collection keyed (directory, name)
        (reference: weed/filer/mongodb/mongodb_store.go)."""

        name = "mongodb"

        def __init__(self, uri: str = "mongodb://127.0.0.1:27017",
                     database: str = "seaweedfs"):
            client = _pymongo.MongoClient(uri)
            db = client[database]
            self.files = db["filemeta"]
            self.kv = db["kv"]
            self.files.create_index([("directory", 1), ("name", 1)],
                                    unique=True)

        @staticmethod
        def _split(full_path: str) -> tuple[str, str]:
            from seaweedfs_tpu_torch.filer.entry import split_path
            return split_path(full_path)

        def insert_entry(self, entry: Entry) -> None:
            d, n = self._split(entry.full_path)
            self.files.replace_one(
                {"directory": d, "name": n},
                {"directory": d, "name": n,
                 "meta": json.dumps(entry.to_dict())},
                upsert=True)

        update_entry = insert_entry

        def find_entry(self, full_path: str) -> Entry:
            d, n = self._split(full_path)
            doc = self.files.find_one({"directory": d, "name": n})
            if doc is None:
                raise NotFound(full_path)
            return Entry.from_dict(json.loads(doc["meta"]))

        def delete_entry(self, full_path: str) -> None:
            d, n = self._split(full_path)
            self.files.delete_one({"directory": d, "name": n})

        def delete_folder_children(self, full_path: str) -> None:
            full_path = full_path.rstrip("/") or "/"
            pref = full_path if full_path.endswith("/") else full_path + "/"
            import re
            self.files.delete_many({"$or": [
                {"directory": full_path},
                {"directory": {"$regex": "^" + re.escape(pref)}}]})

        def list_directory_entries(self, dir_path: str, start_from: str = "",
                                   include_start: bool = False,
                                   limit: int = 1024,
                                   prefix: str = "") -> list[Entry]:
            d = dir_path.rstrip("/") or "/"
            q: dict = {"directory": d}
            cmp = "$gte" if include_start else "$gt"
            if start_from:
                q["name"] = {cmp: start_from}
            if prefix:
                import re
                q.setdefault("name", {})
                if isinstance(q["name"], dict):
                    q["name"]["$regex"] = "^" + re.escape(prefix)
            cur = self.files.find(q).sort("name", 1).limit(limit)
            return [Entry.from_dict(json.loads(doc["meta"])) for doc in cur]

        def kv_put(self, key: bytes, value: bytes) -> None:
            self.kv.replace_one({"_id": key.hex()},
                                {"_id": key.hex(), "v": value.hex()},
                                upsert=True)

        def kv_get(self, key: bytes) -> bytes:
            doc = self.kv.find_one({"_id": key.hex()})
            if doc is None:
                raise NotFound(key.decode(errors="replace"))
            return bytes.fromhex(doc["v"])

        def kv_delete(self, key: bytes) -> None:
            self.kv.delete_one({"_id": key.hex()})

    STORES["mongodb"] = MongoStore
except ImportError:
    pass


try:  # pragma: no cover - depends on environment
    import etcd3 as _etcd3  # noqa: F401

    class EtcdStore(FilerStore):
        """Entries as etcd keys under a prefix (reference:
        weed/filer/etcd/etcd_store.go). Key layout mirrors the reference:
        'e<dir>/<name>' so directory listings are prefix range reads."""

        name = "etcd"

        def __init__(self, host: str = "127.0.0.1", port: int = 2379,
                     key_prefix: str = "seaweedfs."):
            self.c = _etcd3.client(host=host, port=port)
            self.prefix = key_prefix

        def _ek(self, full_path: str) -> str:
            from seaweedfs_tpu_torch.filer.entry import split_path
            d, n = split_path(full_path)
            return f"{self.prefix}e{d.rstrip('/')}/{n}"

        def insert_entry(self, entry: Entry) -> None:
            self.c.put(self._ek(entry.full_path),
                       json.dumps(entry.to_dict()))

        update_entry = insert_entry

        def find_entry(self, full_path: str) -> Entry:
            raw, _ = self.c.get(self._ek(full_path))
            if raw is None:
                raise NotFound(full_path)
            return Entry.from_dict(json.loads(raw))

        def delete_entry(self, full_path: str) -> None:
            self.c.delete(self._ek(full_path))

        def delete_folder_children(self, full_path: str) -> None:
            d = full_path.rstrip("/") or ""
            self.c.delete_prefix(f"{self.prefix}e{d}/")

        def list_directory_entries(self, dir_path: str, start_from: str = "",
                                   include_start: bool = False,
                                   limit: int = 1024,
                                   prefix: str = "") -> list[Entry]:
            # python-etcd3 exposes no server-side limit on range reads, so
            # pagination filters client-side with an early break; very
            # large directories belong on a store with server-side paging
            # (the SQL family or mongodb)
            d = dir_path.rstrip("/") or ""
            out = []
            for raw, md in self.c.get_prefix(f"{self.prefix}e{d}/",
                                             sort_order="ascend"):
                key = md.key.decode()
                name = key.rsplit("/", 1)[-1]
                if "/" in key[len(f"{self.prefix}e{d}/"):]:
                    continue  # deeper than one level
                if prefix and not name.startswith(prefix):
                    continue
                if start_from and (name < start_from or
                                   (name == start_from and
                                    not include_start)):
                    continue
                out.append(Entry.from_dict(json.loads(raw)))
                if len(out) >= limit:
                    break
            return out

        def kv_put(self, key: bytes, value: bytes) -> None:
            self.c.put(f"{self.prefix}kv{key.hex()}", value)

        def kv_get(self, key: bytes) -> bytes:
            raw, _ = self.c.get(f"{self.prefix}kv{key.hex()}")
            if raw is None:
                raise NotFound(key.decode(errors="replace"))
            return raw

        def kv_delete(self, key: bytes) -> None:
            self.c.delete(f"{self.prefix}kv{key.hex()}")

    STORES["etcd"] = EtcdStore
except ImportError:
    pass


class CassandraStore(FilerStore):
    """Wide-column store: one partition per directory, children as
    clustering rows (reference: weed/filer/cassandra/cassandra_store.go —
    table filemeta(directory, name, meta) PRIMARY KEY ((directory), name)).

    The session is injectable: production wires a cassandra-driver
    Session (registration below is gated on that SDK, like the
    reference's build-tag-gated drivers); tests drive the identical CQL
    through an in-memory fake, so the SPI semantics are covered even
    where no cluster exists."""

    name = "cassandra"

    CREATE = (
        "CREATE TABLE IF NOT EXISTS filemeta (directory text, name text,"
        " meta blob, PRIMARY KEY ((directory), name))",
        "CREATE TABLE IF NOT EXISTS kv (key blob PRIMARY KEY, value blob)",
        # directory registry: partitions can't be range-scanned, so
        # subtree deletes find their directories through this ordered
        # single-partition index
        "CREATE TABLE IF NOT EXISTS dirlist (bucket int, directory text,"
        " PRIMARY KEY ((bucket), directory))",
    )

    def __init__(self, hosts: list[str] | None = None,
                 keyspace: str = "seaweedfs", username: str = "",
                 password: str = "", session=None):
        if session is None:  # pragma: no cover - needs a live cluster
            from cassandra.cluster import Cluster
            from cassandra.auth import PlainTextAuthProvider
            auth = PlainTextAuthProvider(username, password) \
                if username else None
            cluster = Cluster(hosts or ["127.0.0.1"], auth_provider=auth)
            session = cluster.connect(keyspace)
        self.s = session
        for ddl in self.CREATE:
            self.s.execute(ddl)

    @staticmethod
    def _dir_name(full_path: str) -> tuple[str, str]:
        d, _, n = full_path.rpartition("/")
        return d or "/", n

    def insert_entry(self, entry: Entry) -> None:
        d, n = self._dir_name(entry.full_path)
        self.s.execute(
            "INSERT INTO filemeta (directory, name, meta) VALUES "
            "(%s, %s, %s)",
            (d, n, json.dumps(entry.to_dict()).encode()))
        self.s.execute(
            "INSERT INTO dirlist (bucket, directory) VALUES (0, %s)", (d,))

    update_entry = insert_entry

    def find_entry(self, full_path: str) -> Entry:
        d, n = self._dir_name(full_path)
        rows = list(self.s.execute(
            "SELECT meta FROM filemeta WHERE directory=%s AND name=%s",
            (d, n)))
        if not rows:
            raise NotFound(full_path)
        return Entry.from_dict(json.loads(bytes(rows[0][0])))

    def delete_entry(self, full_path: str) -> None:
        d, n = self._dir_name(full_path)
        self.s.execute(
            "DELETE FROM filemeta WHERE directory=%s AND name=%s", (d, n))

    def delete_folder_children(self, full_path: str) -> None:
        """Drop the whole subtree, including children whose intermediate
        directories have no entry row of their own: the dirlist index
        names every directory partition under the prefix.  `base + '0'`
        is the byte after '/', so '/topaz' never matches a '/top'
        delete."""
        base = full_path.rstrip("/") or "/"
        rows = self.s.execute(
            "SELECT directory FROM dirlist WHERE bucket=0 AND "
            "directory>=%s AND directory<%s", (base, base + "0"))
        for (d,) in list(rows):
            if d != base and not d.startswith(base + "/"):
                continue
            self.s.execute("DELETE FROM filemeta WHERE directory=%s", (d,))
            self.s.execute(
                "DELETE FROM dirlist WHERE bucket=0 AND directory=%s",
                (d,))

    def list_directory_entries(self, dir_path: str, start_from: str = "",
                               include_start: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]:
        d = dir_path.rstrip("/") or "/"
        if start_from:
            op = ">=" if include_start else ">"
            rows = self.s.execute(
                f"SELECT meta FROM filemeta WHERE directory=%s AND "
                f"name{op}%s", (d, start_from))
        else:
            rows = self.s.execute(
                "SELECT meta FROM filemeta WHERE directory=%s", (d,))
        out = []
        for row in rows:  # rows come back clustering-ordered by name
            e = Entry.from_dict(json.loads(bytes(row[0])))
            if prefix and not e.name.startswith(prefix):
                continue
            out.append(e)
            if len(out) >= limit:
                break
        return out

    def kv_put(self, key: bytes, value: bytes) -> None:
        self.s.execute("INSERT INTO kv (key, value) VALUES (%s, %s)",
                       (key, value))

    def kv_get(self, key: bytes) -> bytes:
        rows = list(self.s.execute(
            "SELECT value FROM kv WHERE key=%s", (key,)))
        if not rows:
            raise NotFound(key.decode(errors="replace"))
        return bytes(rows[0][0])

    def kv_delete(self, key: bytes) -> None:
        self.s.execute("DELETE FROM kv WHERE key=%s", (key,))


try:  # pragma: no cover - depends on environment
    import cassandra  # noqa: F401
    STORES["cassandra"] = CassandraStore
except ImportError:
    pass


ENTRY_SEP = b"\x00"      # sorts before every printable byte: a directory's
KV_PREFIX = b"kv\x01"    # children scan contiguously, subdirs don't mix


class TikvStore(FilerStore):
    """Ordered-KV store over a TiKV RawKV-style client (reference:
    weed/filer/tikv/tikv_store.go).  Entry key = <dir>\\x00<name>, so one
    prefix scan lists a directory in name order.

    The client is injectable (put/get/delete/scan(start, end, limit) over
    byte keys): production wires tikv_client.RawClient (registration
    gated on that SDK); tests run the matrix on an in-memory ordered
    fake."""

    name = "tikv"

    def __init__(self, pd_addrs: list[str] | None = None, client=None):
        if client is None:  # pragma: no cover - needs a live cluster
            from tikv_client import RawClient
            client = RawClient.connect(pd_addrs or ["127.0.0.1:2379"])
        self.c = client

    @staticmethod
    def _ekey(full_path: str) -> bytes:
        d, _, n = full_path.rpartition("/")
        return (d or "/").encode() + ENTRY_SEP + n.encode()

    def insert_entry(self, entry: Entry) -> None:
        self.c.put(self._ekey(entry.full_path),
                   json.dumps(entry.to_dict()).encode())

    update_entry = insert_entry

    def find_entry(self, full_path: str) -> Entry:
        raw = self.c.get(self._ekey(full_path))
        if raw is None:
            raise NotFound(full_path)
        return Entry.from_dict(json.loads(raw))

    def delete_entry(self, full_path: str) -> None:
        self.c.delete(self._ekey(full_path))

    def delete_folder_children(self, full_path: str) -> None:
        """Two range deletes cover the whole subtree even when
        intermediate directories have no entry row: the directory's own
        children ('<dir>\\x00...') and every nested directory's
        ('<dir>/...\\x00...', bounded by '<dir>0' — the byte after '/' —
        so '/topaz' never matches a '/top' delete)."""
        base = (full_path.rstrip("/") or "/").encode()
        for start, end in ((base + ENTRY_SEP, base + ENTRY_SEP + b"\xff" * 8),
                           (base + b"/", base + b"0")):
            while True:
                batch = self.c.scan(start, end, 1024)
                if not batch:
                    break
                for k, _ in batch:
                    self.c.delete(k)
                start = batch[-1][0] + b"\x00"

    def list_directory_entries(self, dir_path: str, start_from: str = "",
                               include_start: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]:
        d = (dir_path.rstrip("/") or "/").encode()
        start = d + ENTRY_SEP + start_from.encode() if start_from \
            else d + ENTRY_SEP
        end = d + ENTRY_SEP + b"\xff" * 8
        out: list[Entry] = []
        skip_first_eq = bool(start_from) and not include_start
        while len(out) < limit:
            batch = self.c.scan(start, end, min(1024, limit - len(out) + 1))
            if not batch:
                break
            for k, v in batch:
                if skip_first_eq and k == d + ENTRY_SEP + start_from.encode():
                    continue
                e = Entry.from_dict(json.loads(v))
                if prefix and not e.name.startswith(prefix):
                    continue
                out.append(e)
                if len(out) >= limit:
                    break
            last_k = batch[-1][0]
            if len(batch) < min(1024, limit - len(out) + 1) or \
                    last_k >= end:
                break
            start = last_k + b"\x00"
            skip_first_eq = False
        return out

    def kv_put(self, key: bytes, value: bytes) -> None:
        self.c.put(KV_PREFIX + key, value)

    def kv_get(self, key: bytes) -> bytes:
        raw = self.c.get(KV_PREFIX + key)
        if raw is None:
            raise NotFound(key.decode(errors="replace"))
        return raw

    def kv_delete(self, key: bytes) -> None:
        self.c.delete(KV_PREFIX + key)


try:  # pragma: no cover - depends on environment
    import tikv_client  # noqa: F401
    STORES["tikv"] = TikvStore
except ImportError:
    pass


class ElasticStore(FilerStore):
    """Document store over the Elasticsearch REST API (reference:
    weed/filer/elastic/v7/elastic_store.go — entries as docs id'd by the
    url-safe full path, kv in a dedicated index).  Pure HTTP JSON: no SDK.

    `transport(method, path, body_dict|None) -> (status, json_dict)` is
    injectable; the default speaks urllib to the server.  Search-after
    pagination orders listings by the `name` keyword field."""

    name = "elastic"
    INDEX = "seaweedfs_filemeta"
    KV_INDEX = "seaweedfs_kv"
    MAX_PAGE = 10000  # ES index.max_result_window default

    def __init__(self, url: str = "http://127.0.0.1:9200", transport=None):
        self.url = url.rstrip("/")
        self._t = transport or self._http
        for index in (self.INDEX, self.KV_INDEX):
            self._t("PUT", f"/{index}", {"mappings": {"properties": {
                "directory": {"type": "keyword"},
                "name": {"type": "keyword"}}}})

    def _http(self, method: str, path: str, body=None):
        import urllib.error
        import urllib.request
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            self.url + path, data=data, method=method,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.status, json.loads(r.read() or b"{}")
        except urllib.error.HTTPError as e:
            try:
                return e.code, json.loads(e.read() or b"{}")
            except ValueError:
                return e.code, {}

    @staticmethod
    def _id(full_path: str) -> str:
        import base64
        return base64.urlsafe_b64encode(full_path.encode()).decode()

    def insert_entry(self, entry: Entry) -> None:
        d, _, n = entry.full_path.rpartition("/")
        st, _ = self._t(
            "PUT", f"/{self.INDEX}/_doc/{self._id(entry.full_path)}"
            "?refresh=true",
            {"directory": d or "/", "name": n,
             "meta": json.dumps(entry.to_dict())})
        if st >= 300:
            raise OSError(f"elastic insert: HTTP {st}")

    update_entry = insert_entry

    def find_entry(self, full_path: str) -> Entry:
        st, doc = self._t(
            "GET", f"/{self.INDEX}/_doc/{self._id(full_path)}", None)
        if st == 404 or (st < 300 and not doc.get("found")):
            raise NotFound(full_path)
        if st >= 300:
            # a 5xx/429 is a store outage, NOT data absence — NotFound
            # here would let writers recreate/overwrite live entries
            raise OSError(f"elastic get: HTTP {st}")
        return Entry.from_dict(json.loads(doc["_source"]["meta"]))

    def delete_entry(self, full_path: str) -> None:
        self._t("DELETE",
                f"/{self.INDEX}/_doc/{self._id(full_path)}?refresh=true",
                None)

    def delete_folder_children(self, full_path: str) -> None:
        base = full_path.rstrip("/") or "/"
        # root: every directory string starts with "/" — a "//" prefix
        # would miss all nested descendants
        pref = base if base.endswith("/") else base + "/"
        self._t("POST", f"/{self.INDEX}/_delete_by_query?refresh=true", {
            "query": {"bool": {"should": [
                {"term": {"directory": base}},
                {"prefix": {"directory": pref}},
            ]}}})

    def list_directory_entries(self, dir_path: str, start_from: str = "",
                               include_start: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]:
        """Pages with name-range cursors in MAX_PAGE steps — a single
        _search above index.max_result_window (10k) is a 400 from ES."""
        d = dir_path.rstrip("/") or "/"
        out: list[Entry] = []
        cursor, inclusive = start_from, include_start
        while len(out) < limit:
            want = min(limit - len(out), self.MAX_PAGE)
            query: dict = {"bool": {"filter": [
                {"term": {"directory": d}}]}}
            if prefix:
                query["bool"]["filter"].append(
                    {"prefix": {"name": prefix}})
            if cursor:
                op = "gte" if inclusive else "gt"
                query["bool"]["filter"].append(
                    {"range": {"name": {op: cursor}}})
            st, res = self._t("POST", f"/{self.INDEX}/_search", {
                "query": query, "size": want,
                "sort": [{"name": "asc"}]})
            if st >= 300:
                raise OSError(f"elastic search: HTTP {st}")
            hits = res.get("hits", {}).get("hits", [])
            out.extend(Entry.from_dict(json.loads(h["_source"]["meta"]))
                       for h in hits)
            if len(hits) < want:
                break
            cursor, inclusive = out[-1].name, False
        return out

    def kv_put(self, key: bytes, value: bytes) -> None:
        import base64
        self._t("PUT",
                f"/{self.KV_INDEX}/_doc/{self._id(key.decode('latin-1'))}"
                "?refresh=true",
                {"value": base64.b64encode(value).decode()})

    def kv_get(self, key: bytes) -> bytes:
        import base64
        st, doc = self._t(
            "GET",
            f"/{self.KV_INDEX}/_doc/{self._id(key.decode('latin-1'))}",
            None)
        if st == 404 or (st < 300 and not doc.get("found")):
            raise NotFound(key.decode(errors="replace"))
        if st >= 300:
            raise OSError(f"elastic kv get: HTTP {st}")
        return base64.b64decode(doc["_source"]["value"])

    def kv_delete(self, key: bytes) -> None:
        self._t("DELETE",
                f"/{self.KV_INDEX}/_doc/{self._id(key.decode('latin-1'))}"
                "?refresh=true", None)


STORES["elastic"] = ElasticStore  # REST-only: no SDK gate needed


class HbaseStore(FilerStore):
    """Wide-column store over the HBase REST gateway ("Stargate") wire
    protocol (reference: weed/filer/hbase/hbase_store.go over the Thrift
    client — same row model: ordered row key `<dir>\\x00<name>`, one
    column family).  Cells travel base64-coded in JSON; range listings use
    the stateful scanner resource (POST .../scanner -> Location, GET for
    batches, DELETE to close).

    `transport(method, path, body_dict|None) -> (status, body_dict,
    headers_dict)` is injectable; the default speaks urllib to the REST
    gateway, so the driver tests offline against a protocol-faithful
    fake."""

    name = "hbase"
    TABLE = "seaweedfs"
    COL = "f:m"  # family:qualifier for the meta blob

    def __init__(self, url: str = "http://127.0.0.1:8080", transport=None):
        self.url = url.rstrip("/")
        self._t = transport or self._http

    def _http(self, method: str, path: str, body=None):
        import urllib.error
        import urllib.request
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            self.url + path, data=data, method=method,
            headers={"Content-Type": "application/json",
                     "Accept": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                raw = r.read()
                return (r.status, json.loads(raw) if raw else {},
                        dict(r.headers))
        except urllib.error.HTTPError as e:
            return e.code, {}, dict(e.headers)

    @staticmethod
    def _b64(b: bytes) -> str:
        import base64
        return base64.b64encode(b).decode()

    @staticmethod
    def _unb64(s: str) -> bytes:
        import base64
        return base64.b64decode(s)

    @staticmethod
    def _ekey(full_path: str) -> bytes:
        d, _, n = full_path.rpartition("/")
        return (d or "/").encode() + ENTRY_SEP + n.encode()

    @staticmethod
    def _row_url(row: bytes) -> str:
        # the REST gateway takes the LITERAL row key in the URL path
        # (binary bytes percent-encoded); base64 belongs only in the JSON
        # cell bodies — a base64 URL row would write one key and read
        # another on a real Stargate
        import urllib.parse
        return urllib.parse.quote_from_bytes(row, safe="")

    def _put(self, row: bytes, value: bytes) -> None:
        st, _, _ = self._t(
            "PUT", f"/{self.TABLE}/{self._row_url(row)}",
            {"Row": [{"key": self._b64(row), "Cell": [
                {"column": self._b64(self.COL.encode()),
                 "$": self._b64(value)}]}]})
        if st >= 300:
            raise OSError(f"hbase put: HTTP {st}")

    def _get(self, row: bytes) -> bytes | None:
        st, doc, _ = self._t(
            "GET", f"/{self.TABLE}/{self._row_url(row)}/{self.COL}", None)
        if st == 404:
            return None
        if st >= 300:
            raise OSError(f"hbase get: HTTP {st}")
        cells = doc.get("Row", [{}])[0].get("Cell", [])
        return self._unb64(cells[0]["$"]) if cells else None

    def _delete(self, row: bytes) -> None:
        st, _, _ = self._t(
            "DELETE", f"/{self.TABLE}/{self._row_url(row)}", None)
        if st >= 300 and st != 404:
            raise OSError(f"hbase delete: HTTP {st}")

    def _scan(self, start: bytes, end: bytes, limit: int):
        """-> ordered [(row_key, value)] via the scanner resource."""
        st, _, hdrs = self._t(
            "POST", f"/{self.TABLE}/scanner",
            {"startRow": self._b64(start), "endRow": self._b64(end),
             "batch": min(limit, 1024)})
        loc = next((v for k, v in hdrs.items()
                    if k.lower() == "location"), None)
        if st >= 300 or not loc:
            raise OSError(f"hbase scanner: HTTP {st}")
        scanner = loc[len(self.url):] if loc.startswith(self.url) else loc
        out: list[tuple[bytes, bytes]] = []
        try:
            while len(out) < limit:
                st, doc, _ = self._t("GET", scanner, None)
                if st == 204 or st == 404:
                    break
                if st >= 300:
                    raise OSError(f"hbase scan: HTTP {st}")
                for rowdoc in doc.get("Row", []):
                    cells = rowdoc.get("Cell", [])
                    if cells:
                        out.append((self._unb64(rowdoc["key"]),
                                    self._unb64(cells[0]["$"])))
                    if len(out) >= limit:
                        break
        finally:
            self._t("DELETE", scanner, None)
        return out

    def insert_entry(self, entry: Entry) -> None:
        self._put(self._ekey(entry.full_path),
                  json.dumps(entry.to_dict()).encode())

    update_entry = insert_entry

    def find_entry(self, full_path: str) -> Entry:
        raw = self._get(self._ekey(full_path))
        if raw is None:
            raise NotFound(full_path)
        return Entry.from_dict(json.loads(raw))

    def delete_entry(self, full_path: str) -> None:
        self._delete(self._ekey(full_path))

    def delete_folder_children(self, full_path: str) -> None:
        # same two-range subtree cover as TikvStore (see its docstring)
        base = (full_path.rstrip("/") or "/").encode()
        for start, end in ((base + ENTRY_SEP, base + ENTRY_SEP + b"\xff" * 8),
                           (base + b"/", base + b"0")):
            while True:
                batch = self._scan(start, end, 1024)
                if not batch:
                    break
                for k, _ in batch:
                    self._delete(k)
                start = batch[-1][0] + b"\x00"

    def list_directory_entries(self, dir_path: str, start_from: str = "",
                               include_start: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]:
        d = (dir_path.rstrip("/") or "/").encode()
        start = d + ENTRY_SEP + start_from.encode() if start_from \
            else d + ENTRY_SEP
        end = d + ENTRY_SEP + b"\xff" * 8
        out: list[Entry] = []
        skip_eq = bool(start_from) and not include_start
        while len(out) < limit:
            batch = self._scan(start, end, limit - len(out) + 1)
            if not batch:
                break
            for k, v in batch:
                if skip_eq and k == d + ENTRY_SEP + start_from.encode():
                    continue
                e = Entry.from_dict(json.loads(v))
                if prefix and not e.name.startswith(prefix):
                    continue
                out.append(e)
                if len(out) >= limit:
                    break
            start = batch[-1][0] + b"\x00"
            skip_eq = False
            if len(batch) < limit - len(out) + 1 and len(out) < limit:
                break
        return out

    def kv_put(self, key: bytes, value: bytes) -> None:
        self._put(KV_PREFIX + key, value)

    def kv_get(self, key: bytes) -> bytes:
        raw = self._get(KV_PREFIX + key)
        if raw is None:
            raise NotFound(key.decode(errors="replace"))
        return raw

    def kv_delete(self, key: bytes) -> None:
        self._delete(KV_PREFIX + key)


STORES["hbase"] = HbaseStore  # REST gateway: no SDK gate needed


class ArangodbStore(FilerStore):
    """Document store over the ArangoDB HTTP API (reference:
    weed/filer/arangodb/arangodb_store.go — entries as documents keyed by
    the url-safe full path, listings/subtree deletes via AQL cursors).

    `transport(method, path, body_dict|None) -> (status, body_dict)` is
    injectable like ElasticStore's."""

    name = "arangodb"
    COLL = "seaweedfs_filemeta"
    KV_COLL = "seaweedfs_kv"

    def __init__(self, url: str = "http://127.0.0.1:8529",
                 database: str = "_system", transport=None):
        self.url = url.rstrip("/")
        self.db = f"/_db/{database}"
        self._t = transport or self._http
        for coll in (self.COLL, self.KV_COLL):
            self._t("POST", f"{self.db}/_api/collection", {"name": coll})

    def _http(self, method: str, path: str, body=None):
        import urllib.error
        import urllib.request
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            self.url + path, data=data, method=method,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.status, json.loads(r.read() or b"{}")
        except urllib.error.HTTPError as e:
            try:
                return e.code, json.loads(e.read() or b"{}")
            except ValueError:
                return e.code, {}

    @staticmethod
    def _key(s: str) -> str:
        import base64
        return base64.urlsafe_b64encode(s.encode()).decode().rstrip("=")

    def _aql(self, query: str, bind: dict) -> list:
        st, res = self._t("POST", f"{self.db}/_api/cursor",
                          {"query": query, "bindVars": bind,
                           "batchSize": 1000})
        if st >= 300:
            raise OSError(f"arangodb aql: HTTP {st} {res.get('errorMessage')}")
        out = list(res.get("result", []))
        while res.get("hasMore"):
            st, res = self._t("PUT",
                              f"{self.db}/_api/cursor/{res['id']}", None)
            if st >= 300:
                raise OSError(f"arangodb cursor: HTTP {st}")
            out.extend(res.get("result", []))
        return out

    def insert_entry(self, entry: Entry) -> None:
        d, _, n = entry.full_path.rpartition("/")
        st, res = self._t(
            "POST", f"{self.db}/_api/document/{self.COLL}?overwrite=true",
            {"_key": self._key(entry.full_path), "directory": d or "/",
             "name": n, "meta": json.dumps(entry.to_dict())})
        if st >= 300:
            raise OSError(f"arangodb insert: HTTP {st}")

    update_entry = insert_entry

    def find_entry(self, full_path: str) -> Entry:
        st, doc = self._t(
            "GET",
            f"{self.db}/_api/document/{self.COLL}/{self._key(full_path)}",
            None)
        if st == 404:
            raise NotFound(full_path)
        if st >= 300:
            raise OSError(f"arangodb get: HTTP {st}")
        return Entry.from_dict(json.loads(doc["meta"]))

    def delete_entry(self, full_path: str) -> None:
        self._t("DELETE",
                f"{self.db}/_api/document/{self.COLL}/{self._key(full_path)}",
                None)

    def delete_folder_children(self, full_path: str) -> None:
        base = full_path.rstrip("/") or "/"
        pref = base if base.endswith("/") else base + "/"
        self._aql(
            f"FOR doc IN {self.COLL} "
            "FILTER doc.directory == @base OR "
            "STARTS_WITH(doc.directory, @pref) "
            f"REMOVE doc IN {self.COLL}",
            {"base": base, "pref": pref})

    def list_directory_entries(self, dir_path: str, start_from: str = "",
                               include_start: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]:
        d = dir_path.rstrip("/") or "/"
        filters = ["doc.directory == @dir"]
        bind: dict = {"dir": d, "limit": limit}
        if start_from:
            filters.append("doc.name >= @start" if include_start
                           else "doc.name > @start")
            bind["start"] = start_from
        if prefix:
            filters.append("STARTS_WITH(doc.name, @prefix)")
            bind["prefix"] = prefix
        rows = self._aql(
            f"FOR doc IN {self.COLL} FILTER {' AND '.join(filters)} "
            "SORT doc.name ASC LIMIT @limit RETURN doc.meta", bind)
        return [Entry.from_dict(json.loads(m)) for m in rows]

    def kv_put(self, key: bytes, value: bytes) -> None:
        import base64
        st, _ = self._t(
            "POST", f"{self.db}/_api/document/{self.KV_COLL}?overwrite=true",
            {"_key": self._key(key.decode("latin-1")),
             "value": base64.b64encode(value).decode()})
        if st >= 300:
            raise OSError(f"arangodb kv put: HTTP {st}")

    def kv_get(self, key: bytes) -> bytes:
        import base64
        st, doc = self._t(
            "GET", f"{self.db}/_api/document/{self.KV_COLL}/"
            f"{self._key(key.decode('latin-1'))}", None)
        if st == 404:
            raise NotFound(key.decode(errors="replace"))
        if st >= 300:
            raise OSError(f"arangodb kv get: HTTP {st}")
        return base64.b64decode(doc["value"])

    def kv_delete(self, key: bytes) -> None:
        self._t("DELETE", f"{self.db}/_api/document/{self.KV_COLL}/"
                f"{self._key(key.decode('latin-1'))}", None)


STORES["arangodb"] = ArangodbStore  # REST-only: no SDK gate needed


class YdbStore(FilerStore):
    """Row store over YDB's table service (reference:
    weed/filer/ydb/ydb_store.go — YQL with DECLAREd parameters, PK
    (directory, name); YDB primary keys are globally ordered, so subtree
    deletes are plain PK range scans — no side index like Cassandra's
    dirlist is needed).

    `session.execute(yql, params) -> rows` is injectable: production
    wires a ydb-sdk session (registration gated on that SDK); tests run
    the matrix on a statement-faithful fake."""

    name = "ydb"

    CREATE = (
        "CREATE TABLE IF NOT EXISTS filemeta (directory Utf8, name Utf8,"
        " meta String, PRIMARY KEY (directory, name))",
        "CREATE TABLE IF NOT EXISTS kv (k String, v String,"
        " PRIMARY KEY (k))",
    )

    def __init__(self, endpoint: str = "grpc://127.0.0.1:2136",
                 database: str = "/local", session=None):
        if session is None:  # pragma: no cover - needs a live cluster
            session = _YdbPoolSession(endpoint, database)
        self.s = session
        for ddl in self.CREATE:
            self.s.execute(ddl, {})

    @staticmethod
    def _dir_name(full_path: str) -> tuple[str, str]:
        d, _, n = full_path.rpartition("/")
        return d or "/", n

    def insert_entry(self, entry: Entry) -> None:
        d, n = self._dir_name(entry.full_path)
        self.s.execute(
            "DECLARE $dir AS Utf8; DECLARE $name AS Utf8; "
            "DECLARE $meta AS String; "
            "UPSERT INTO filemeta (directory, name, meta) "
            "VALUES ($dir, $name, $meta)",
            {"$dir": d, "$name": n,
             "$meta": json.dumps(entry.to_dict()).encode()})

    update_entry = insert_entry

    def find_entry(self, full_path: str) -> Entry:
        d, n = self._dir_name(full_path)
        rows = self.s.execute(
            "DECLARE $dir AS Utf8; DECLARE $name AS Utf8; "
            "SELECT meta FROM filemeta "
            "WHERE directory = $dir AND name = $name",
            {"$dir": d, "$name": n})
        if not rows:
            raise NotFound(full_path)
        return Entry.from_dict(json.loads(bytes(rows[0][0])))

    def delete_entry(self, full_path: str) -> None:
        d, n = self._dir_name(full_path)
        self.s.execute(
            "DECLARE $dir AS Utf8; DECLARE $name AS Utf8; "
            "DELETE FROM filemeta WHERE directory = $dir AND name = $name",
            {"$dir": d, "$name": n})

    def delete_folder_children(self, full_path: str) -> None:
        base = full_path.rstrip("/") or "/"
        # '0' is the byte after '/': bounds the subtree without matching
        # sibling prefixes ('/topaz' for a '/top' delete)
        self.s.execute(
            "DECLARE $base AS Utf8; DECLARE $lo AS Utf8; "
            "DECLARE $hi AS Utf8; "
            "DELETE FROM filemeta WHERE directory = $base OR "
            "(directory >= $lo AND directory < $hi)",
            {"$base": base, "$lo": base + "/", "$hi": base + "0"})

    def list_directory_entries(self, dir_path: str, start_from: str = "",
                               include_start: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]:
        """Pages with name cursors until `limit` PREFIX MATCHES are
        collected or the directory is exhausted — filtering a single
        limit+1 page client-side would return bogus empty results for a
        sparse prefix in a large directory."""
        d = dir_path.rstrip("/") or "/"
        out: list[Entry] = []
        cursor, inclusive = start_from, include_start
        page = max(limit + 1, 256)
        while len(out) < limit:
            if cursor:
                op = ">=" if inclusive else ">"
                rows = self.s.execute(
                    "DECLARE $dir AS Utf8; DECLARE $start AS Utf8; "
                    "DECLARE $limit AS Uint64; "
                    f"SELECT meta FROM filemeta WHERE directory = $dir AND "
                    f"name {op} $start ORDER BY name LIMIT $limit",
                    {"$dir": d, "$start": cursor, "$limit": page})
            else:
                rows = self.s.execute(
                    "DECLARE $dir AS Utf8; DECLARE $limit AS Uint64; "
                    "SELECT meta FROM filemeta WHERE directory = $dir "
                    "ORDER BY name LIMIT $limit",
                    {"$dir": d, "$limit": page})
            rows = list(rows)
            for row in rows:
                e = Entry.from_dict(json.loads(bytes(row[0])))
                if not prefix or e.name.startswith(prefix):
                    out.append(e)
                    if len(out) >= limit:
                        break
                cursor, inclusive = e.name, False
            else:
                if len(rows) < page:
                    break
                continue
            break
        return out

    def kv_put(self, key: bytes, value: bytes) -> None:
        self.s.execute(
            "DECLARE $k AS String; DECLARE $v AS String; "
            "UPSERT INTO kv (k, v) VALUES ($k, $v)",
            {"$k": key, "$v": value})

    def kv_get(self, key: bytes) -> bytes:
        rows = self.s.execute(
            "DECLARE $k AS String; SELECT v FROM kv WHERE k = $k",
            {"$k": key})
        if not rows:
            raise NotFound(key.decode(errors="replace"))
        return bytes(rows[0][0])

    def kv_delete(self, key: bytes) -> None:
        self.s.execute(
            "DECLARE $k AS String; DELETE FROM kv WHERE k = $k",
            {"$k": key})


class _YdbPoolSession:  # pragma: no cover - needs a live cluster
    """Adapter giving a ydb SessionPool the two-method execute() surface
    YdbStore drives (the injectable-session seam stays SDK-free)."""

    def __init__(self, endpoint: str, database: str):
        import ydb
        driver = ydb.Driver(endpoint=endpoint, database=database)
        driver.wait(timeout=15)
        self.pool = ydb.SessionPool(driver)

    def execute(self, q: str, params: dict):
        def run(session):
            prepared = session.prepare(q)
            result = session.transaction().execute(
                prepared, params, commit_tx=True)
            if not result:
                return []
            return [tuple(row[c] for c in row) for row in result[0].rows]
        return self.pool.retry_operation_sync(run)


try:  # pragma: no cover - depends on environment
    import ydb  # noqa: F401
    STORES["ydb"] = YdbStore
except ImportError:
    pass
