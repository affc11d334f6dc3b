"""Twins of tests/test_filer.py for the port's filer
(`seaweedfs_tpu_torch/filer/`), over the same ten store kinds and the
same fakes, then the two packages side by side: chunk lists drawn from a
seed give equal visible intervals and views, manifests equal bytes, one
scripted sequence of operations on both filers an equal subtree digest
and equal meta-log events, and store files written by either package
read in the other."""

import stat
import time

import numpy as np
import pytest

from seaweedfs_tpu_torch.filer import (Entry, FileChunk, Filer, MemoryStore,
                                       NotFound, SqliteStore)
from seaweedfs_tpu_torch.filer import abstract_sql
from seaweedfs_tpu_torch.filer import filechunks as fc
from seaweedfs_tpu_torch.filer import filechunk_manifest as fcm
from seaweedfs_tpu_torch.filer.entry import (Attr, new_directory_entry,
                                             split_path)
from tests.test_filer import (FakeArangoTransport, FakeCqlSession,
                              FakeElasticTransport, FakeHbaseRest,
                              FakeRawKV, FakeYdbSession, _FormatConnShim)


# ---------------------------------------------------------------- chunks

def _c(fid, offset, size, mtime):
    return FileChunk(fid=fid, offset=offset, size=size, mtime=mtime)


def test_visible_intervals_sequential():
    chunks = [_c("1,a", 0, 100, 1), _c("1,b", 100, 100, 2)]
    v = fc.non_overlapping_visible_intervals(chunks)
    assert [(x.start, x.stop, x.fid) for x in v] == \
        [(0, 100, "1,a"), (100, 200, "1,b")]


def test_visible_intervals_full_overwrite():
    chunks = [_c("1,a", 0, 100, 1), _c("1,b", 0, 100, 2)]
    v = fc.non_overlapping_visible_intervals(chunks)
    assert [(x.start, x.stop, x.fid) for x in v] == [(0, 100, "1,b")]


def test_visible_intervals_partial_overwrite_middle():
    # old covers [0,300); new covers [100,200) later -> old splits
    chunks = [_c("1,a", 0, 300, 1), _c("1,b", 100, 100, 2)]
    v = fc.non_overlapping_visible_intervals(chunks)
    assert [(x.start, x.stop, x.fid, x.chunk_offset) for x in v] == [
        (0, 100, "1,a", 0), (100, 200, "1,b", 0), (200, 300, "1,a", 200)]


def test_visible_intervals_newer_loses_to_newest():
    chunks = [_c("1,a", 0, 100, 1), _c("1,b", 50, 100, 2),
              _c("1,c", 25, 50, 3)]
    v = fc.non_overlapping_visible_intervals(chunks)
    assert [(x.start, x.stop, x.fid) for x in v] == [
        (0, 25, "1,a"), (25, 75, "1,c"), (75, 150, "1,b")]


def test_view_from_chunks_range_and_gap():
    chunks = [_c("1,a", 0, 100, 1), _c("1,b", 200, 100, 2)]  # hole [100,200)
    views = fc.view_from_chunks(chunks, 50, 200)
    assert [(w.fid, w.offset_in_chunk, w.size, w.logic_offset)
            for w in views] == [("1,a", 50, 50, 50), ("1,b", 0, 50, 200)]


def test_compact_and_minus_chunks():
    chunks = [_c("1,a", 0, 100, 1), _c("1,b", 0, 100, 2)]
    live, garbage = fc.compact_chunks(chunks)
    assert [c.fid for c in live] == ["1,b"]
    assert [c.fid for c in garbage] == ["1,a"]
    delta = fc.minus_chunks(chunks, [chunks[1]])
    assert [c.fid for c in delta] == ["1,a"]


def test_equal_mtime_later_append_wins():
    chunks = [_c("1,a", 0, 100, 5), _c("1,b", 0, 100, 5)]
    v = fc.non_overlapping_visible_intervals(chunks)
    assert [x.fid for x in v] == ["1,b"]


# ---------------------------------------------------------------- stores

class FormatDialect(abstract_sql.SqliteDialect):
    """The reference test's second dialect, over the port's SqliteDialect:
    the shared SQL layer in the %s parameter style, run on sqlite through
    the reference test's shim."""

    name = "format-shim"
    paramstyle = "format"

    def connect(self):
        return _FormatConnShim(super().connect())

    def create_tables(self, conn):
        super().create_tables(conn._conn)


@pytest.fixture(params=["memory", "sqlite", "logstore", "sql-format",
                        "cassandra-fake", "tikv-fake", "elastic-fake",
                        "hbase-fake", "arangodb-fake", "ydb-fake"])
def store(request, tmp_path):
    if request.param == "memory":
        yield MemoryStore()
    elif request.param == "logstore":
        from seaweedfs_tpu_torch.filer.stores_extra import LogStore
        s = LogStore(str(tmp_path / "logstore"))
        yield s
        s.shutdown()
    elif request.param == "sql-format":
        s = abstract_sql.AbstractSqlStore(FormatDialect(str(tmp_path / "f.db")))
        yield s
        s.shutdown()
    elif request.param == "cassandra-fake":
        from seaweedfs_tpu_torch.filer.stores_extra import CassandraStore
        yield CassandraStore(session=FakeCqlSession())
    elif request.param == "tikv-fake":
        from seaweedfs_tpu_torch.filer.stores_extra import TikvStore
        yield TikvStore(client=FakeRawKV())
    elif request.param == "elastic-fake":
        from seaweedfs_tpu_torch.filer.stores_extra import ElasticStore
        yield ElasticStore(transport=FakeElasticTransport())
    elif request.param == "hbase-fake":
        from seaweedfs_tpu_torch.filer.stores_extra import HbaseStore
        yield HbaseStore(transport=FakeHbaseRest())
    elif request.param == "arangodb-fake":
        from seaweedfs_tpu_torch.filer.stores_extra import ArangodbStore
        yield ArangodbStore(transport=FakeArangoTransport())
    elif request.param == "ydb-fake":
        from seaweedfs_tpu_torch.filer.stores_extra import YdbStore
        yield YdbStore(session=FakeYdbSession())
    else:
        s = SqliteStore(str(tmp_path / "filer.db"))
        yield s
        s.shutdown()


def _entry(path, size=0, mode=0o660):
    e = Entry(full_path=path, attr=Attr(mtime=time.time(), crtime=time.time(),
                                        mode=mode, file_size=size))
    return e


def test_store_crud(store):
    e = _entry("/dir/hello.txt", size=5)
    e.chunks = [_c("3,aabb", 0, 5, 1)]
    e.extended["x-meta"] = "v"
    store.insert_entry(e)
    got = store.find_entry("/dir/hello.txt")
    assert got.full_path == "/dir/hello.txt"
    assert got.chunks[0].fid == "3,aabb"
    assert got.extended == {"x-meta": "v"}
    with pytest.raises(NotFound):
        store.find_entry("/dir/none")
    store.delete_entry("/dir/hello.txt")
    with pytest.raises(NotFound):
        store.find_entry("/dir/hello.txt")


def test_store_listing_pagination_prefix(store):
    for name in ["a", "ab", "b", "ba", "c"]:
        store.insert_entry(_entry(f"/d/{name}"))
    alles = store.list_directory_entries("/d")
    assert [e.name for e in alles] == ["a", "ab", "b", "ba", "c"]
    page = store.list_directory_entries("/d", start_from="ab",
                                        include_start=False, limit=2)
    assert [e.name for e in page] == ["b", "ba"]
    pref = store.list_directory_entries("/d", prefix="b")
    assert [e.name for e in pref] == ["b", "ba"]
    # prefix with SQL wildcard chars must be literal
    store.insert_entry(_entry("/d/x%y"))
    store.insert_entry(_entry("/d/x_y"))
    assert [e.name for e in store.list_directory_entries("/d", prefix="x%")] \
        == ["x%y"]


def test_store_delete_folder_children(store):
    for p in ["/top/f1", "/top/sub/f2", "/top/sub/deep/f3", "/other/f4"]:
        store.insert_entry(_entry(p))
    store.delete_folder_children("/top")
    assert store.list_directory_entries("/top") == []
    assert store.list_directory_entries("/top/sub") == []
    assert [e.name for e in store.list_directory_entries("/other")] == ["f4"]


def test_store_kv(store):
    store.kv_put(b"k", b"v1")
    assert store.kv_get(b"k") == b"v1"
    store.kv_put(b"k", b"v2")
    assert store.kv_get(b"k") == b"v2"
    store.kv_delete(b"k")
    with pytest.raises(NotFound):
        store.kv_get(b"k")


def test_sqlite_store_persistence(tmp_path):
    path = str(tmp_path / "p.db")
    s = SqliteStore(path)
    s.insert_entry(_entry("/a/b.txt", size=7))
    s.shutdown()
    s2 = SqliteStore(path)
    assert s2.find_entry("/a/b.txt").attr.file_size == 7
    s2.shutdown()


# ---------------------------------------------------------------- filer

@pytest.fixture()
def filer():
    deleted: list[FileChunk] = []
    f = Filer(MemoryStore(), on_delete_chunks=deleted.extend)
    f._test_deleted = deleted
    return f


def test_filer_create_makes_parents(filer):
    filer.create_entry(_entry("/a/b/c/file.txt"))
    for d in ["/a", "/a/b", "/a/b/c"]:
        assert filer.find_entry(d).is_directory
    kids = filer.list_entries("/a/b/c")
    assert [e.name for e in kids] == ["file.txt"]


def test_filer_delete_recursive_collects_chunks(filer):
    e1 = _entry("/x/f1")
    e1.chunks = [_c("1,a", 0, 10, 1)]
    e2 = _entry("/x/sub/f2")
    e2.chunks = [_c("2,b", 0, 10, 1)]
    filer.create_entry(e1)
    filer.create_entry(e2)
    with pytest.raises(OSError):
        filer.delete_entry("/x")
    filer.delete_entry("/x", recursive=True)
    assert not filer.exists("/x")
    assert sorted(c.fid for c in filer._test_deleted) == ["1,a", "2,b"]


def test_filer_overwrite_gc_old_chunks(filer):
    e = _entry("/f.txt")
    e.chunks = [_c("1,a", 0, 10, 1)]
    filer.create_entry(e)
    e2 = _entry("/f.txt")
    e2.chunks = [_c("1,b", 0, 20, 2)]
    filer.create_entry(e2)
    assert [c.fid for c in filer._test_deleted] == ["1,a"]


def test_filer_o_excl(filer):
    filer.create_entry(_entry("/only.txt"))
    with pytest.raises(FileExistsError):
        filer.create_entry(_entry("/only.txt"), o_excl=True)


def test_filer_rename_file_and_subtree(filer):
    fe = _entry("/src/d/f.txt")
    fe.chunks = [_c("9,z", 0, 4, 1)]
    filer.create_entry(fe)
    filer.create_entry(_entry("/src/d/g.txt"))
    filer.rename_entry("/src/d", "/dst")
    assert not filer.exists("/src/d")
    assert filer.find_entry("/dst").is_directory
    got = filer.find_entry("/dst/f.txt")
    assert got.chunks[0].fid == "9,z"
    assert filer.exists("/dst/g.txt")
    # rename file INTO an existing directory
    filer.rename_entry("/dst/f.txt", "/src")
    assert filer.exists("/src/f.txt")


def test_filer_meta_log_replay(filer):
    t0 = time.time_ns()
    filer.create_entry(_entry("/ev/one"))
    filer.delete_entry("/ev/one")
    events = list(filer.meta_log.replay(since_ts_ns=t0))
    # create /ev dir, create file, delete file
    kinds = [("create" if ev.old_entry is None else
              "delete" if ev.new_entry is None else "update")
             for ev in events]
    assert kinds == ["create", "create", "delete"]
    # offsets resume correctly
    mid = events[1].ts_ns
    tail = list(filer.meta_log.replay(since_ts_ns=mid))
    assert len(tail) == 1 and tail[0].new_entry is None


def test_meta_log_file_persistence(tmp_path):
    log_path = str(tmp_path / "meta.jsonl")
    f = Filer(MemoryStore(), meta_log_path=log_path)
    f.create_entry(_entry("/p/file"))
    f.meta_log.ring.clear()  # simulate ring rollover
    events = list(f.meta_log.replay(since_ts_ns=0))
    assert [e.new_entry.full_path for e in events] == ["/p", "/p/file"]


def test_ttl_expiry(filer):
    e = _entry("/ttl.txt")
    e.attr.ttl_sec = 1
    e.attr.crtime = time.time() - 10
    filer.create_entry(e)
    with pytest.raises(NotFound):
        filer.find_entry("/ttl.txt")


# ------------------------------------------------------------- manifest

def test_manifestize_roundtrip():
    blobs = {}

    def save(payload: bytes) -> FileChunk:
        fid = f"7,m{len(blobs)}"
        blobs[fid] = payload
        return FileChunk(fid=fid, offset=0, size=len(payload), etag="e")

    chunks = [_c(f"1,{i:x}", i * 10, 10, i) for i in range(25)]
    out = fcm.maybe_manifestize(save, chunks, batch=10)
    manifests = [c for c in out if c.is_chunk_manifest]
    assert len(manifests) == 2 and len(out) == 7
    assert manifests[0].offset == 0 and manifests[0].size == 100
    resolved = fcm.resolve_chunk_manifest(lambda fid: blobs[fid], out)
    assert sorted(c.fid for c in resolved) == \
        sorted(c.fid for c in chunks)
    # resolved views reproduce the file byte-for-byte ranges
    v = fc.non_overlapping_visible_intervals(resolved)
    assert v[0].start == 0 and v[-1].stop == 250


def test_split_path_edges():
    assert split_path("/") == ("/", "")
    assert split_path("/a") == ("/", "a")
    assert split_path("/a/b/") == ("/a", "b")


def test_directory_entry_mode():
    d = new_directory_entry("/d")
    assert d.is_directory and stat.S_ISDIR(d.attr.mode)


def test_rename_into_own_subtree_rejected(filer):
    filer.create_entry(_entry("/tree/sub/f.txt"))
    with pytest.raises(OSError):
        filer.rename_entry("/tree", "/tree/sub/moved")
    with pytest.raises(OSError):
        filer.rename_entry("/tree", "/tree")
    # store intact
    assert filer.exists("/tree/sub/f.txt")


def test_meta_log_prefix_component_boundary(filer):
    from seaweedfs_tpu_torch.filer.filer import dir_has_prefix
    assert dir_has_prefix("/topics/a", "/topics")
    assert dir_has_prefix("/topics", "/topics")
    assert not dir_has_prefix("/topics2", "/topics")
    assert dir_has_prefix("/anything", "/")
    t0 = time.time_ns()
    filer.create_entry(_entry("/topics/in"))
    filer.create_entry(_entry("/topics2/out"))
    evs = list(filer.meta_log.replay(since_ts_ns=t0, prefix="/topics"))
    dirs = {e.directory for e in evs}
    assert "/topics2" not in dirs and "/" not in dirs


def test_delete_ignore_recursive_error(filer):
    filer.create_entry(_entry("/ig/a.txt"))
    filer.delete_entry("/ig", recursive=False, ignore_recursive_error=True)
    assert not filer.exists("/ig")


def test_logstore_persistence_and_compaction(tmp_path):
    """LogStore WAL replay + snapshot compaction (reference role: the
    embedded leveldb-class store)."""
    from seaweedfs_tpu_torch.filer.stores_extra import LogStore
    d = str(tmp_path / "ls")
    s = LogStore(d)
    for i in range(10):
        s.insert_entry(_entry(f"/docs/f{i}.txt", size=i))
    s.delete_entry("/docs/f0.txt")
    s.kv_put(b"offset", b"\x01\x02")
    s.shutdown()
    # replay from disk
    s2 = LogStore(d)
    assert s2.find_entry("/docs/f5.txt").attr.file_size == 5
    with pytest.raises(NotFound):
        s2.find_entry("/docs/f0.txt")
    assert s2.kv_get(b"offset") == b"\x01\x02"
    # force compaction: lots of overwrites of one entry
    s2.COMPACT_RATIO = 1
    for _ in range(200):
        s2.update_entry(_entry("/docs/f1.txt", size=99))
    assert s2._wal_lines < 200  # compaction reset the WAL
    s2.shutdown()
    s3 = LogStore(d)
    assert s3.find_entry("/docs/f1.txt").attr.file_size == 99
    assert len(s3.list_directory_entries("/docs")) == 9
    s3.shutdown()


# ------------------------------------------------------------- hardlinks

def test_hardlink_create_and_read_via_both_names(filer):
    e = _entry("/hl/orig.txt", size=10)
    e.chunks = [_c("5,a", 0, 10, 1)]
    filer.create_entry(e)
    link = filer.link_entry("/hl/orig.txt", "/hl/link.txt")
    assert link.hard_link_id and link.hard_link_counter == 2
    for p in ("/hl/orig.txt", "/hl/link.txt"):
        got = filer.find_entry(p)
        assert [c.fid for c in got.chunks] == ["5,a"]
        assert got.hard_link_counter == 2
    # listing overlays the shared blob too
    by_name = {x.name: x for x in filer.list_entries("/hl")}
    assert [c.fid for c in by_name["link.txt"].chunks] == ["5,a"]


def test_hardlink_unlink_one_keeps_chunks(filer):
    e = _entry("/hl2/f", size=4)
    e.chunks = [_c("6,b", 0, 4, 1)]
    filer.create_entry(e)
    filer.link_entry("/hl2/f", "/hl2/g")
    filer.delete_entry("/hl2/f")
    assert filer._test_deleted == []          # other name still holds them
    got = filer.find_entry("/hl2/g")
    assert [c.fid for c in got.chunks] == ["6,b"]
    assert got.hard_link_counter == 1
    filer.delete_entry("/hl2/g")              # last name: chunks orphan
    assert [c.fid for c in filer._test_deleted] == ["6,b"]


def test_hardlink_write_via_one_name_visible_via_other(filer):
    e = _entry("/hl3/a", size=4)
    e.chunks = [_c("7,c", 0, 4, 1)]
    filer.create_entry(e)
    filer.link_entry("/hl3/a", "/hl3/b")
    # update content through one name: canonical blob changes for both
    ent = filer.find_entry("/hl3/b")
    ent.chunks = [_c("7,d", 0, 8, 2)]
    ent.attr.file_size = 8
    filer.update_entry(ent)
    got = filer.find_entry("/hl3/a")
    assert [c.fid for c in got.chunks] == ["7,d"]
    assert got.size() == 8


def test_hardlink_rename_does_not_decrement(filer):
    e = _entry("/hl4/x", size=2)
    e.chunks = [_c("8,e", 0, 2, 1)]
    filer.create_entry(e)
    filer.link_entry("/hl4/x", "/hl4/y")
    filer.rename_entry("/hl4/y", "/hl4/z")
    got = filer.find_entry("/hl4/z")
    assert got.hard_link_counter == 2
    assert [c.fid for c in got.chunks] == ["8,e"]
    filer.delete_entry("/hl4/x")
    filer.delete_entry("/hl4/z")
    assert [c.fid for c in filer._test_deleted] == ["8,e"]


def test_hardlink_recursive_dir_delete_decrements(filer):
    e = _entry("/hl5/in/f", size=3)
    e.chunks = [_c("9,f", 0, 3, 1)]
    filer.create_entry(e)
    filer.link_entry("/hl5/in/f", "/hl5/out")   # one name outside the dir
    filer.delete_entry("/hl5/in", recursive=True)
    assert filer._test_deleted == []            # /hl5/out still holds it
    assert [c.fid for c in filer.find_entry("/hl5/out").chunks] == ["9,f"]
    filer.delete_entry("/hl5/out")
    assert [c.fid for c in filer._test_deleted] == ["9,f"]


def test_hardlink_overwrite_one_name_leaves_group(filer):
    e = _entry("/hl6/p", size=4)
    e.chunks = [_c("10,g", 0, 4, 1)]
    filer.create_entry(e)
    filer.link_entry("/hl6/p", "/hl6/q")
    # full overwrite of one name with a plain entry: that name leaves the
    # link group (counter drops), the other keeps the old content
    e2 = _entry("/hl6/p", size=6)
    e2.chunks = [_c("10,h", 0, 6, 2)]
    filer.create_entry(e2)
    assert filer.find_entry("/hl6/p").hard_link_id == ""
    # the group's chunks are still referenced by /hl6/q: the overwrite
    # must NOT garbage-collect them
    assert filer._test_deleted == []
    q = filer.find_entry("/hl6/q")
    assert [c.fid for c in q.chunks] == ["10,g"]
    assert q.hard_link_counter == 1
    # overwriting the LAST name orphans the group's chunks
    e3 = _entry("/hl6/q", size=1)
    e3.chunks = [_c("10,i", 0, 1, 3)]
    filer.create_entry(e3)
    assert [c.fid for c in filer._test_deleted] == ["10,g"]


def test_hardlink_onto_file_parent_fails_cleanly(filer):
    e = _entry("/hl7/f", size=2)
    e.chunks = [_c("11,j", 0, 2, 1)]
    filer.create_entry(e)
    filer.create_entry(_entry("/hl7/plainfile"))
    with pytest.raises(NotADirectoryError):
        filer.link_entry("/hl7/f", "/hl7/plainfile/x")
    # the failed link must not leave the group over-counted
    got = filer.find_entry("/hl7/f")
    assert got.hard_link_counter in (0, 1) and \
        (not got.hard_link_id or got.hard_link_counter == 1)
    filer.delete_entry("/hl7/f")
    assert [c.fid for c in filer._test_deleted] == ["11,j"]


# ----------------------------------------------- sections / read pattern

def test_chunk_group_sections_resolve_lazily():
    from seaweedfs_tpu_torch.filer.filechunk_section import ChunkGroup
    sec = 1000  # tiny sections for the test
    # 10 sections of data, one chunk per 500 bytes, plus one spanning a
    # section boundary with a newer overwrite
    chunks = [_c(f"1,{i}", i * 500, 500, 1) for i in range(20)]
    chunks.append(_c("1,x", 950, 100, 2))     # spans sections 0-1, newer
    g = ChunkGroup(chunks, section_size=sec)
    assert g.file_size == 10000
    # a read inside section 3 resolves ONLY that section
    views = g.read_views(3200, 100)
    assert [v.fid for v in views] == ["1,6"]
    assert g.resolved_sections == 1
    # boundary-spanning read resolves two sections; the newer chunk wins
    views = g.read_views(900, 200)
    assert g.resolved_sections == 3
    # the spanning chunk splits at the section boundary (two views of the
    # same blob; the chunk cache absorbs the second fetch) but coverage
    # and the winning chunk are exact
    got = [(v.fid, v.logic_offset, v.size) for v in views]
    assert got == [("1,1", 900, 50), ("1,x", 950, 50),
                   ("1,x", 1000, 50), ("1,2", 1050, 50)]

    def coverage(views):
        m = {}
        for v in views:
            for i in range(v.size):
                m[v.logic_offset + i] = (v.fid, v.offset_in_chunk + i)
        return m

    # bytes served match a full non-sectioned resolution exactly
    assert coverage(fc.view_from_chunks(chunks, 0, 10000)) == \
        coverage(g.read_views(0, 10000))


def test_chunk_group_sparse_and_bounds():
    from seaweedfs_tpu_torch.filer.filechunk_section import ChunkGroup
    g = ChunkGroup([_c("1,a", 100, 50, 1), _c("1,b", 5000, 50, 1)],
                   section_size=1000)
    # gap between chunks: views absent (streamer zero-fills)
    vs = g.read_views(0, 6000)
    assert [(v.fid, v.logic_offset) for v in vs] == [("1,a", 100),
                                                     ("1,b", 5000)]
    assert g.read_views(200, 0) == []
    assert g.read_views(10000, 50) == []      # past EOF
    assert ChunkGroup([]).read_views(0, 100) == []


def test_reader_pattern_mode_switching():
    from seaweedfs_tpu_torch.filer.filechunk_section import ReaderPattern
    rp = ReaderPattern()
    assert not rp.is_random  # neutral start serves caches
    rp.monitor_read(0, 100)      # first read from 0 counts sequential
    for i in range(1, 5):
        rp.monitor_read(i * 100, 100)
    assert not rp.is_random
    # a burst of scattered reads flips to random (saturating at -3)
    for off in (9000, 42, 7777, 123, 8080):
        rp.monitor_read(off, 10)
    assert rp.is_random
    # sustained sequential reading flips back
    rp.monitor_read(8090, 10)
    for i in range(5):
        rp.monitor_read(8100 + i * 10, 10)
    assert not rp.is_random


# ------------------------------------------ the port beside the reference

import seaweedfs_tpu.filer as ref_filer  # noqa: E402
from seaweedfs_tpu.filer import filechunk_manifest as ref_fcm  # noqa: E402
from seaweedfs_tpu.filer import filechunks as ref_fc  # noqa: E402
from seaweedfs_tpu.filer import stores_extra as ref_stores  # noqa: E402
from seaweedfs_tpu_torch.filer import stores_extra  # noqa: E402

PKGS = {"port": (FileChunk, Entry, Attr), "ref": (
    ref_filer.FileChunk, ref_filer.Entry, ref_filer.Attr)}


def _draw_chunks(seed: int, cls=FileChunk, n: int = 40) -> list:
    """Overlapping chunk refs with random offsets, sizes and mtimes (ties
    included), the same for both packages' classes."""
    rng = np.random.default_rng(seed)
    offs = rng.integers(0, 4000, n)
    sizes = rng.integers(0, 900, n)
    mtimes = rng.integers(0, n // 2, n)
    keys = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    return [cls(fid=f"{1 + i % 5},{i:x}{int(offs[i]):x}",
                offset=int(offs[i]), size=int(sizes[i]),
                mtime=int(mtimes[i]), etag=f"e{i}",
                cipher_key=bytes(keys[i]) if i % 3 == 0 else b"",
                is_compressed=bool(i % 4 == 1)) for i in range(n)]


@pytest.mark.parametrize("seed", range(8))
def test_visible_intervals_and_views_equal_reference(seed):
    port, ref = _draw_chunks(seed), _draw_chunks(seed, ref_fc.FileChunk)
    vis = fc.non_overlapping_visible_intervals(port)
    assert [v.__dict__ for v in vis] == \
        [v.__dict__ for v in ref_fc.non_overlapping_visible_intervals(ref)]
    rng = np.random.default_rng(seed + 100)
    for off, size in rng.integers(0, 5000, (16, 2)).tolist() + [[0, 6000]]:
        assert [w.__dict__ for w in fc.view_from_chunks(port, off, size)] \
            == [w.__dict__ for w in ref_fc.view_from_chunks(ref, off, size)]
    live, garbage = fc.compact_chunks(port)
    rlive, rgarbage = ref_fc.compact_chunks(ref)
    assert [c.fid for c in live] == [c.fid for c in rlive]
    assert [c.fid for c in garbage] == [c.fid for c in rgarbage]
    half = port[: len(port) // 2]
    assert [c.fid for c in fc.minus_chunks(port, half)] == \
        [c.fid for c in ref_fc.minus_chunks(ref, ref[: len(ref) // 2])]


@pytest.mark.parametrize("seed", range(3))
def test_chunk_group_views_equal_reference_resolution(seed):
    from seaweedfs_tpu_torch.filer.filechunk_section import ChunkGroup
    port, ref = _draw_chunks(seed), _draw_chunks(seed, ref_fc.FileChunk)
    g = ChunkGroup(port, section_size=700)
    rng = np.random.default_rng(seed + 200)
    for off, size in rng.integers(0, 5000, (16, 2)).tolist():
        def coverage(views):
            return {v.logic_offset + i: (v.fid, v.offset_in_chunk + i)
                    for v in views for i in range(v.size)}
        assert coverage(g.read_views(off, size)) == \
            coverage(ref_fc.view_from_chunks(ref, off, size))


@pytest.mark.parametrize("batch", [3, 10, 16])
def test_manifest_payload_and_refs_equal_reference(batch):
    port, ref = _draw_chunks(5, n=50), _draw_chunks(5, ref_fc.FileChunk,
                                                    n=50)
    assert fcm.manifest_payload(port) == ref_fcm.manifest_payload(ref)
    blobs: dict = {}

    def saver(cls):
        def save(payload: bytes):
            fid = f"9,{len(blobs):x}"
            blobs[fid] = payload
            return cls(fid=fid, offset=0, size=len(payload), etag="m")
        return save
    out = fcm.maybe_manifestize(saver(FileChunk), port, batch=batch)
    port_blobs = dict(blobs)
    blobs.clear()
    rout = ref_fcm.maybe_manifestize(saver(ref_fc.FileChunk), ref,
                                     batch=batch)
    assert port_blobs == blobs
    assert [c.to_dict() for c in out] == [c.to_dict() for c in rout]
    got = fcm.resolve_chunk_manifest(blobs.__getitem__, out,
                                     include_manifests=True)
    want = ref_fcm.resolve_chunk_manifest(blobs.__getitem__, rout,
                                          include_manifests=True)
    assert [c.to_dict() for c in got] == [c.to_dict() for c in want]


def _script(pkg: str, f) -> None:
    """One sequence of mutations, the same on either package's filer."""
    fchunk, entry, attr = PKGS[pkg]

    def mk(path, chunks=(), size=0, md5=""):
        return entry(full_path=path, attr=attr(mode=0o644, file_size=size,
                                               md5=md5),
                     chunks=[fchunk(fid=fid, offset=o, size=s, mtime=m)
                             for fid, o, s, m in chunks])
    f.create_entry(mk("/s/a/one", [("1,a", 0, 10, 1)], 10, "m1"))
    f.create_entry(mk("/s/a/two", [("1,b", 0, 5, 1), ("1,c", 5, 5, 2)], 10))
    f.create_entry(mk("/s/b/deep/three", [("2,d", 0, 7, 1)], 7, "m3"))
    f.create_entry(mk("/s/a/one", [("1,e", 0, 12, 3)], 12, "m1b"))
    f.link_entry("/s/a/two", "/s/b/two-link")
    got = f.find_entry("/s/b/two-link")
    got.chunks = [fchunk(fid="3,f", offset=0, size=20, mtime=4)]
    got.attr.file_size = 20
    f.update_entry(got)
    f.rename_entry("/s/b", "/s/c")
    f.delete_entry("/s/a/two")
    f.create_entry(mk("/s/d/gone", [("4,g", 0, 3, 1)], 3))
    f.delete_entry("/s/d", recursive=True)


def _masked(ev: dict) -> dict:
    """An event's dict with what differs by clock or by draw masked: the
    timestamp, the entries' times and the hard link's random id."""
    ev = dict(ev, ts_ns=0)
    for side in ("old_entry", "new_entry"):
        if ev[side]:
            e = dict(ev[side], attr=dict(ev[side]["attr"], mtime=0,
                                         crtime=0))
            if "hard_link_id" in e:
                e["hard_link_id"] = "id"
            ev[side] = e
    return ev


def test_scripted_filer_equals_reference(tmp_path):
    """The same operations on both filers: equal digests, listings, chunk
    garbage and meta-log events; each package replays the other's log."""
    runs = {}
    for pkg, mod in (("port", None), ("ref", ref_filer)):
        deleted: list = []
        store = MemoryStore() if mod is None else mod.MemoryStore()
        log_path = str(tmp_path / f"{pkg}.jsonl")
        f = (Filer if mod is None else mod.Filer)(
            store, meta_log_path=log_path, on_delete_chunks=deleted.extend)
        _script(pkg, f)
        runs[pkg] = {
            "digest": f.subtree_digest("/s"),
            "events": [_masked(ev.to_dict()) for ev in f.meta_log.replay()],
            "deleted": sorted(c.fid for c in deleted),
            "tree": sorted((e.full_path, e.hard_link_counter,
                            [c.fid for c in e.chunks])
                           for d in ("/s", "/s/a", "/s/c", "/s/c/deep")
                           for e in f.list_entries(d)),
            "log": log_path}
        f.meta_log.close()
    port, ref = runs["port"], runs["ref"]
    assert port["digest"] == ref["digest"] and port["digest"][1] == 6
    assert port["events"] == ref["events"] and len(port["events"]) > 10
    assert port["deleted"] == ref["deleted"] == ["1,a", "4,g"]
    assert port["tree"] == ref["tree"]
    # each package's MetaLog replays the other's file
    from seaweedfs_tpu.filer.filer import MetaLog as RefMetaLog
    from seaweedfs_tpu_torch.filer.filer import MetaLog
    theirs = [_masked(ev.to_dict()) for ev in
              MetaLog(ref["log"]).replay(prefix="/s/c")]
    mine = [_masked(ev.to_dict()) for ev in
            RefMetaLog(port["log"]).replay(prefix="/s/c")]
    assert theirs == mine and theirs


def _fill(store, entry_cls, attr_cls, chunk_cls) -> None:
    for i in range(12):
        store.insert_entry(entry_cls(
            full_path=f"/x/{'sub/' if i % 3 else ''}f{i}",
            attr=attr_cls(mtime=1.5, crtime=1.0, mode=0o600, file_size=i),
            chunks=[chunk_cls(fid=f"3,{i:x}", offset=0, size=i, mtime=i,
                              cipher_key=bytes([i]) * 32)],
            extended={"k": str(i)}))
    store.delete_entry("/x/f0")
    store.kv_put(b"hardlink/abc", b"\x00\x01")


def _listing(store) -> list:
    return [e.to_dict() for d in ("/x", "/x/sub")
            for e in store.list_directory_entries(d)]


@pytest.mark.parametrize("kind", ["logstore", "sqlite"])
@pytest.mark.parametrize("writer", ["port", "ref"])
def test_store_files_cross_packages(tmp_path, kind, writer):
    """A LogStore directory or an SQLite file written by one package reads
    the same in the other."""
    path = str(tmp_path / ("ls" if kind == "logstore" else "f.db"))
    port_cls = stores_extra.LogStore if kind == "logstore" else SqliteStore
    ref_cls = ref_stores.LogStore if kind == "logstore" \
        else ref_filer.SqliteStore
    w, r = (port_cls, ref_cls) if writer == "port" else (ref_cls, port_cls)
    classes = PKGS["port" if writer == "port" else "ref"]
    s = w(path)
    _fill(s, *classes[1:], classes[0])
    want = _listing(s)
    s.shutdown()
    s2 = r(path)
    assert _listing(s2) == want and len(want) == 11
    assert s2.kv_get(b"hardlink/abc") == b"\x00\x01"
    with pytest.raises(Exception, match="f0"):
        s2.find_entry("/x/f0")
    s2.shutdown()


class _FakeClient:
    """A WeedClient stand-in that records deletes; fids on volume 13
    fail."""

    def __init__(self):
        self.deleted: list[str] = []

    def delete(self, fid: str) -> None:
        if fid.startswith("13,"):
            raise RuntimeError("volume server down")
        self.deleted.append(fid)


def test_deletion_queue_equals_reference():
    """Both queues free the same fids in the same order, manifests
    expanded at every level, and count the same failures."""
    from seaweedfs_tpu.filer.filer_deletion import (
        DeletionQueue as RefQueue)
    from seaweedfs_tpu_torch.filer.filer_deletion import DeletionQueue
    got = {}
    for name, queue_cls, chunk_cls, m in (
            ("port", DeletionQueue, FileChunk, fcm),
            ("ref", RefQueue, ref_fc.FileChunk, ref_fcm)):
        blobs: dict = {}

        def save(payload: bytes, chunk_cls=chunk_cls, blobs=blobs):
            fid = f"7,{len(blobs):x}"
            blobs[fid] = payload
            return chunk_cls(fid=fid, offset=0, size=len(payload))
        inner = [chunk_cls(fid=f"{2 + i % 3},{i:x}", offset=i * 4, size=4,
                           mtime=i) for i in range(12)]
        refs = m.maybe_manifestize(save, inner, batch=4)
        client = _FakeClient()
        q = queue_cls(client, interval=3600, resolve_manifest=lambda cs, m=m,
                      blobs=blobs: m.resolve_chunk_manifest(
                          blobs.__getitem__, cs, include_manifests=True))
        q.start()
        q.enqueue_chunks(refs + [chunk_cls(fid="13,ff", offset=0, size=1),
                                 chunk_cls(fid="bad", offset=0, size=1)])
        q.stop(drain=True)
        assert q.pending_count() == 0 and q.wait_empty(0.1)
        got[name] = (client.deleted, q.deleted_count, q.error_count)
    assert got["port"] == got["ref"]
    assert got["port"][1] == 15 and got["port"][2] == 1


def test_filer_conf_equals_reference():
    from seaweedfs_tpu.filer import filer_conf as ref_conf
    from seaweedfs_tpu_torch.filer import filer_conf
    confs = []
    for mod, store in ((filer_conf, MemoryStore()),
                       (ref_conf, ref_filer.MemoryStore())):
        assert mod.load_filer_conf(store).rules == []
        conf = mod.FilerConf()
        conf.upsert(mod.PathConf(location_prefix="/buckets/",
                                 collection="b", replication="001"))
        conf.upsert(mod.PathConf(location_prefix="/buckets/hot/",
                                 disk_type="ssd", fsync=True))
        conf.upsert(mod.PathConf(location_prefix="/tmp/", ttl="1d"))
        conf.delete_prefix("/tmp/")
        mod.save_filer_conf(store, conf)
        back = mod.load_filer_conf(store)
        confs.append((back.to_json(),
                      back.match("/buckets/hot/x").disk_type,
                      back.match("/buckets/a").collection,
                      back.match("/other").location_prefix))
    assert confs[0] == confs[1]
    assert confs[0][1:] == ("ssd", "b", "/")


# -------------------- ROADMAP fault 3.11: a freed chunk on an EC volume

def _ec_holders_after_delete(tmp_path, pkg: str) -> dict:
    """Three servers of `pkg`'s cluster; a volume of six needles in a
    collection EC-encoded and spread by `pkg`'s shell; one needle deleted
    through `pkg`'s client, as the filer's deletion queue deletes a freed
    chunk.  -> {holder url: HTTP status of a GET of the needle there}."""
    import io
    import urllib.error
    import urllib.request
    if pkg == "port":
        from seaweedfs_tpu_torch.client import WeedClient
        from seaweedfs_tpu_torch.shell import commands
        from tests.test_torch_master_cluster import Cluster
    else:
        from seaweedfs_tpu.client import WeedClient
        from seaweedfs_tpu.shell import commands
        from tests.test_cluster import Cluster
    tmp_path.mkdir()
    c = Cluster(tmp_path, n_volume_servers=3).start()
    client = None
    try:
        c.wait_heartbeats()
        client = WeedClient(c.master.url)
        rng = np.random.default_rng(311)
        blobs = [rng.bytes(3000 + 500 * i) for i in range(6)]
        fids = [client.upload(b, collection="c311") for b in blobs]
        vid = int(fids[0].split(",")[0])
        time.sleep(0.7)
        env = commands.CommandEnv(c.master.url)
        for line in ("lock", f"ec.encode -volumeId {vid} -collection c311",
                     "unlock"):
            commands.run_command(env, line, io.StringIO())
        deadline = time.time() + 10
        while time.time() < deadline and \
                len(env.ec_shard_locations(vid)) < 14:
            time.sleep(0.1)
        holders = sorted({u for urls in env.ec_shard_locations(vid).values()
                          for u in urls})
        assert len(holders) == 3, holders
        client.delete(fids[2])
        statuses = {}
        for url in holders:
            try:
                with urllib.request.urlopen(f"http://{url}/{fids[2]}",
                                            timeout=30) as r:
                    statuses[url] = r.status
            except urllib.error.HTTPError as e:
                statuses[url] = e.code
        # the needles left stay readable
        assert [client.download(f) for f in fids[3:]] == blobs[3:]
        return statuses
    finally:
        if client is not None:
            client.close()
        c.stop()


def test_freed_chunk_on_an_ec_volume_is_gone_on_every_holder_unlike_the_reference(
        tmp_path):
    """ROADMAP fault 3.11: the reference tombstones a needle deleted on
    an EC volume in the .ecx of the one holder that took the DELETE, so
    the other holders still serve it; the port's holder tombstones it in
    every holder's .ecx, as the reference's Go store does."""
    ref = _ec_holders_after_delete(tmp_path / "ref", "ref")
    port = _ec_holders_after_delete(tmp_path / "port", "port")
    assert sorted(ref.values()).count(404) == 1 and 200 in ref.values()
    assert set(port.values()) == {404}
