"""Dialect-parameterized SQL filer store layer.

Counterpart of `seaweedfs_tpu/filer/abstract_sql.py`, whole: the same
schema and the same dirhash, so an SQLite file written by either package
reads in the other.

The reference funnels every SQL-family driver (mysql/mysql2/postgres/
postgres2/sqlite) through one shared implementation parameterized by an
SqlGenerator (weed/filer/abstract_sql/abstract_sql_store.go); here the
same role is played by `SqlDialect` + `AbstractSqlStore`: the nine
FilerStore SPI methods are written once against the schema

    filemeta(dirhash BIGINT, name, directory, meta BLOB,
             PRIMARY KEY (dirhash, name))
    kv(key BLOB PRIMARY KEY, value BLOB)

and a dialect supplies the connection factory, DDL, upsert statement, and
parameter style. Statements are authored in qmark style (?) and translated
to %s for "format"-style drivers (postgres/mysql).

Concrete dialects: SqliteDialect (stdlib), PostgresDialect (psycopg or
psycopg2), MysqlDialect (pymysql or MySQLdb) — the network ones register
in STORES only when their client package imports, the same gating as the
redis driver (stores_extra.py).
"""

from __future__ import annotations

import threading

from seaweedfs_tpu_torch.filer.entry import Entry, split_path
from seaweedfs_tpu_torch.filer.filerstore import (STORES, FilerStore,
                                                  NotFound)


def _like_escape(s: str) -> str:
    return (s.replace("\\", r"\\").replace("%", r"\%").replace("_", r"\_"))


class SqlDialect:
    """Connection + SQL-flavor provider for AbstractSqlStore."""

    name = "abstract"
    paramstyle = "qmark"  # "qmark" (?) or "format" (%s)

    def connect(self):  # -> DB-API 2.0 connection
        raise NotImplementedError

    def create_tables(self, conn) -> None:
        raise NotImplementedError

    # upsert statements in qmark style; translated when paramstyle=format
    upsert_entry_sql = (
        "INSERT INTO filemeta (dirhash,name,directory,meta) "
        "VALUES (?,?,?,?) "
        "ON CONFLICT (dirhash,name) DO UPDATE SET "
        "directory=excluded.directory, meta=excluded.meta")
    upsert_kv_sql = (
        "INSERT INTO kv (key,value) VALUES (?,?) "
        "ON CONFLICT (key) DO UPDATE SET value=excluded.value")


class AbstractSqlStore(FilerStore):
    """The shared SQL implementation of the FilerStore SPI; one thread-local
    DB-API connection per thread (sqlite requires it, the network drivers
    get connection affinity for free)."""

    def __init__(self, dialect: SqlDialect):
        self.dialect = dialect
        self._local = threading.local()
        conn = self._conn()
        dialect.create_tables(conn)
        conn.commit()

    # -- plumbing --------------------------------------------------------

    def _conn(self):
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = self.dialect.connect()
            self._local.conn = conn
        return conn

    def _sql(self, q: str) -> str:
        if self.dialect.paramstyle == "format":
            return q.replace("?", "%s")
        return q

    def _exec(self, q: str, params=()):
        conn = self._conn()
        cur = conn.cursor()
        cur.execute(self._sql(q), params)
        if getattr(self._local, "tx", None) is None:
            conn.commit()
        return cur

    def _query(self, q: str, params=()) -> list:
        """SELECT helper: fetch everything, then end the implicit read
        transaction — a network driver (mysql REPEATABLE READ, postgres)
        would otherwise pin this thread's connection to an ever-stale
        snapshot / idle-in-transaction session."""
        conn = self._conn()
        cur = conn.cursor()
        cur.execute(self._sql(q), params)
        rows = cur.fetchall()
        if getattr(self._local, "tx", None) is None:
            conn.commit()
        return rows

    @staticmethod
    def _dirhash(directory: str) -> int:
        """Stable signed 64-bit dir hash (reference: util.HashStringToLong),
        the sharding key of the (dirhash, name) primary index."""
        import hashlib
        h = hashlib.md5(directory.encode()).digest()
        return int.from_bytes(h[:8], "big", signed=True)

    # -- entries ---------------------------------------------------------

    def insert_entry(self, entry: Entry) -> None:
        d, n = split_path(entry.full_path)
        self._exec(self.dialect.upsert_entry_sql,
                   (self._dirhash(d), n, d, entry.encode()))

    update_entry = insert_entry

    def find_entry(self, full_path: str) -> Entry:
        d, n = split_path(full_path)
        rows = self._query(
            "SELECT meta FROM filemeta WHERE dirhash=? AND name=?",
            (self._dirhash(d), n))
        if not rows:
            raise NotFound(full_path)
        return Entry.decode(bytes(rows[0][0]))

    def delete_entry(self, full_path: str) -> None:
        d, n = split_path(full_path)
        self._exec("DELETE FROM filemeta WHERE dirhash=? AND name=?",
                   (self._dirhash(d), n))

    def delete_folder_children(self, full_path: str) -> None:
        full_path = full_path.rstrip("/") or "/"
        pref = full_path if full_path.endswith("/") else full_path + "/"
        self._exec(
            r"DELETE FROM filemeta WHERE directory=? "
            r"OR directory LIKE ? ESCAPE '\'",
            (full_path, _like_escape(pref) + "%"))

    def list_directory_entries(self, dir_path: str, start_from: str = "",
                               include_start: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]:
        dir_path = dir_path.rstrip("/") or "/"
        cmp = ">=" if include_start else ">"
        sql = "SELECT meta FROM filemeta WHERE dirhash=? AND directory=?"
        params: list = [self._dirhash(dir_path), dir_path]
        if start_from:
            sql += f" AND name {cmp} ?"
            params.append(start_from)
        if prefix:
            sql += r" AND name LIKE ? ESCAPE '\'"
            params.append(_like_escape(prefix) + "%")
        sql += " ORDER BY name LIMIT ?"
        params.append(limit)
        rows = self._query(sql, params)
        return [Entry.decode(bytes(row[0])) for row in rows]

    # -- kv --------------------------------------------------------------

    def kv_put(self, key: bytes, value: bytes) -> None:
        self._exec(self.dialect.upsert_kv_sql, (key, value))

    def kv_get(self, key: bytes) -> bytes:
        rows = self._query("SELECT value FROM kv WHERE key=?", (key,))
        if not rows:
            raise NotFound(key)
        return bytes(rows[0][0])

    def kv_delete(self, key: bytes) -> None:
        self._exec("DELETE FROM kv WHERE key=?", (key,))

    # -- transactions ----------------------------------------------------

    def begin_transaction(self):
        self._local.tx = True
        return self._conn()

    def commit_transaction(self, tx) -> None:
        self._local.tx = None
        self._conn().commit()

    def rollback_transaction(self, tx) -> None:
        self._local.tx = None
        self._conn().rollback()

    def shutdown(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None


# -- dialects ------------------------------------------------------------

class SqliteDialect(SqlDialect):
    name = "sqlite"
    paramstyle = "qmark"

    def __init__(self, path: str):
        self.path = path

    def connect(self):
        import sqlite3
        conn = sqlite3.connect(self.path, timeout=30.0)
        conn.execute("PRAGMA journal_mode=WAL")
        conn.execute("PRAGMA synchronous=NORMAL")
        return conn

    def create_tables(self, conn) -> None:
        conn.executescript("""
            CREATE TABLE IF NOT EXISTS filemeta (
                dirhash INTEGER NOT NULL,
                name TEXT NOT NULL,
                directory TEXT NOT NULL,
                meta BLOB,
                PRIMARY KEY (dirhash, name)
            );
            CREATE INDEX IF NOT EXISTS idx_dir ON filemeta (directory);
            CREATE TABLE IF NOT EXISTS kv (
                key BLOB PRIMARY KEY,
                value BLOB
            );
        """)


class PostgresDialect(SqlDialect):
    name = "postgres"
    paramstyle = "format"
    # postgres spells the conflict-row alias the same way (excluded)

    def __init__(self, host="127.0.0.1", port=5432, user="postgres",
                 password="", dbname="seaweedfs", sslmode="prefer"):
        self.kw = dict(host=host, port=port, user=user,
                       password=password, dbname=dbname, sslmode=sslmode)

    def connect(self):
        try:
            import psycopg
            return psycopg.connect(**self.kw)
        except ImportError:
            import psycopg2
            return psycopg2.connect(**self.kw)

    def create_tables(self, conn) -> None:
        cur = conn.cursor()
        cur.execute("""
            CREATE TABLE IF NOT EXISTS filemeta (
                dirhash BIGINT NOT NULL,
                name TEXT NOT NULL,
                directory TEXT NOT NULL,
                meta BYTEA,
                PRIMARY KEY (dirhash, name)
            )""")
        cur.execute(
            "CREATE INDEX IF NOT EXISTS idx_dir ON filemeta (directory)")
        cur.execute("""
            CREATE TABLE IF NOT EXISTS kv (
                key BYTEA PRIMARY KEY,
                value BYTEA
            )""")


class MysqlDialect(SqlDialect):
    name = "mysql"
    paramstyle = "format"
    upsert_entry_sql = (
        "INSERT INTO filemeta (dirhash,name,directory,meta) "
        "VALUES (?,?,?,?) "
        "ON DUPLICATE KEY UPDATE directory=VALUES(directory), "
        "meta=VALUES(meta)")
    upsert_kv_sql = (
        "INSERT INTO kv (`key`,value) VALUES (?,?) "
        "ON DUPLICATE KEY UPDATE value=VALUES(value)")

    def __init__(self, host="127.0.0.1", port=3306, user="root",
                 password="", database="seaweedfs"):
        self.kw = dict(host=host, port=port, user=user,
                       password=password, database=database)

    def connect(self):
        try:
            import pymysql
            return pymysql.connect(**self.kw)
        except ImportError:
            import MySQLdb
            kw = dict(self.kw)
            kw["db"] = kw.pop("database")
            return MySQLdb.connect(**kw)

    def create_tables(self, conn) -> None:
        cur = conn.cursor()
        cur.execute("""
            CREATE TABLE IF NOT EXISTS filemeta (
                dirhash BIGINT NOT NULL,
                name VARCHAR(766) NOT NULL,
                directory TEXT NOT NULL,
                meta LONGBLOB,
                PRIMARY KEY (dirhash, name)
            )""")
        cur.execute("""
            CREATE TABLE IF NOT EXISTS kv (
                `key` VARBINARY(1024) PRIMARY KEY,
                value LONGBLOB
            )""")

    # mysql kv table quotes `key`; rewrite the shared statements
    def _fix(self, q: str) -> str:
        return q.replace("kv (key,", "kv (`key`,").replace(
            "WHERE key=", "WHERE `key`=")


class SqliteStore(AbstractSqlStore):
    """Embedded persistent store: the abstract layer over stdlib sqlite3 —
    the reference's sqlite driver rides its abstract_sql layer the same
    way (weed/filer/sqlite/)."""

    name = "sqlite"

    def __init__(self, path: str):
        self.path = path
        super().__init__(SqliteDialect(path))


class PostgresStore(AbstractSqlStore):
    """`postgres` filer store (reference: weed/filer/postgres2/); requires
    psycopg or psycopg2 at runtime."""

    name = "postgres"

    def __init__(self, **options):
        super().__init__(PostgresDialect(**options))


class MysqlStore(AbstractSqlStore):
    """`mysql` filer store (reference: weed/filer/mysql2/); requires
    pymysql or MySQLdb at runtime."""

    name = "mysql"

    def __init__(self, **options):
        super().__init__(MysqlDialect(**options))

    def _sql(self, q: str) -> str:
        q = self.dialect._fix(q)
        return super()._sql(q)


STORES["sqlite"] = SqliteStore


def _gated_register() -> None:
    """Register the network SQL drivers only when their client package is
    importable — the analogue of the reference's build-tag/blank-import
    driver gating (weed/command/imports.go)."""
    try:
        import psycopg  # noqa: F401
        STORES["postgres"] = PostgresStore
    except ImportError:
        try:
            import psycopg2  # noqa: F401
            STORES["postgres"] = PostgresStore
        except ImportError:
            pass
    try:
        import pymysql  # noqa: F401
        STORES["mysql"] = MysqlStore
    except ImportError:
        try:
            import MySQLdb  # noqa: F401
            STORES["mysql"] = MysqlStore
        except ImportError:
            pass


_gated_register()
