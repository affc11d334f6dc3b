"""The PyTorch/CUDA port's volume engine held against the JAX package: the
file id, the three needle-map kinds, the rest of `Volume` (vacuum, paged
and meta reads, scan, catch-up, placement, the remote tier), and the
backends.  Each test runs one scenario through both packages in the same
process and compares what they return and the bytes they leave on disk.
Inputs come from seeded numpy generators; every needle carries a fixed
append time, and tombstones take theirs from a pinned `time.time_ns`, so
two runs write the same bytes.
"""

import json
import os
import shutil
import struct
import time
from types import SimpleNamespace

import numpy as np
import pytest

from seaweedfs_tpu.storage import backend as ref_backend
from seaweedfs_tpu.storage import idx as ref_idx
from seaweedfs_tpu.storage import needle as ref_needle
from seaweedfs_tpu.storage import needle_map as ref_nm
from seaweedfs_tpu.storage import types as ref_types
from seaweedfs_tpu.storage import volume as ref_volume

from seaweedfs_tpu_torch import remote_storage
from seaweedfs_tpu_torch.storage import backend, idx, needle, needle_map, \
    types, volume

from conftest import reference_fixture

REF = SimpleNamespace(name="ref", Volume=ref_volume.Volume,
                      Needle=ref_needle.Needle, t=ref_types, idx=ref_idx,
                      nm=ref_nm, backend=ref_backend, crc32c=ref_needle.crc32c)
PORT = SimpleNamespace(name="port", Volume=volume.Volume,
                       Needle=needle.Needle, t=types, idx=idx, nm=needle_map,
                       backend=backend, crc32c=needle.crc32c)
PKGS = [REF, PORT]
DIRECTIONS = [(REF, PORT), (PORT, REF)]
KINDS = ["compact", "memory"]
T0 = 1_650_000_000_000_000_000


@pytest.fixture(autouse=True)
def _pinned_tombstone_time(monkeypatch):
    monkeypatch.setattr(time, "time_ns", lambda: T0 - 1)


def _dirs(tmp_path, *names):
    out = []
    for n in names:
        (tmp_path / n).mkdir(parents=True, exist_ok=True)
        out.append(str(tmp_path / n))
    return out


def _same_files(a, b, names):
    for name in names:
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        assert open(pa, "rb").read() == open(pb, "rb").read(), name


def _put(p, vol, nid, data, cookie=0x11223344, **kw):
    n = p.Needle(cookie=cookie, id=nid, data=data, append_at_ns=T0 + nid,
                 **kw)
    vol.append_needle(n)
    return n


def _blobs(seed, count, lo=1, hi=3000):
    g = np.random.default_rng(seed)
    return {i: (int(g.integers(0, 2**32)),
                g.bytes(int(g.integers(lo, hi))))
            for i in range(1, count + 1)}


# ---- types, idx and the needle maps -------------------------------------

def test_file_id_roundtrip():
    for p in PKGS:
        fid = p.t.FileId(3, 0x1234, 0xDEADBEEF)
        assert str(fid) == "3,1234deadbeef"
        assert p.t.FileId.parse(str(fid)) == fid
        fid2 = p.t.FileId(1, 0xFFFFFFFFFFFFFFFF, 1)
        assert p.t.FileId.parse(str(fid2)) == fid2
        with pytest.raises(ValueError):
            p.t.FileId.parse("3,12")
    g = np.random.default_rng(5)
    for _ in range(200):
        vid, key, cookie = (int(g.integers(0, 2**31)),
                            int(g.integers(0, 2**63)) >> int(g.integers(0, 63)),
                            int(g.integers(0, 2**32)))
        s = str(types.FileId(vid, key, cookie))
        assert s == str(ref_types.FileId(vid, key, cookie))
        got = types.FileId.parse(s)
        assert (got.volume_id, got.key, got.cookie) == (vid, key, cookie)


def test_ttl_and_replica_placement():
    for p in PKGS:
        ttl = p.t.TTL.parse("3d")
        assert ttl.to_bytes() == bytes([3, 3])
        assert p.t.TTL.from_bytes(ttl.to_bytes()) == ttl
        assert str(ttl) == "3d"
        assert not p.t.TTL.parse("")
        rp = p.t.ReplicaPlacement.parse("012")
        assert rp.to_byte() == 12 and rp.copy_count == 4
        assert p.t.ReplicaPlacement.from_byte(12) == rp
    for s in ("", "5m", "7", "2h", "1w", "3M", "9y"):
        assert types.TTL.parse(s).to_bytes() == ref_types.TTL.parse(s).to_bytes()


def test_idx_unpack_and_walk_equal_reference(tmp_path):
    g = np.random.default_rng(3)
    entries = [(int(g.integers(0, 2**63)), int(g.integers(0, 2**32)),
                int(g.integers(-1, 2**31))) for _ in range(5000)]
    raw = b"".join(idx.pack_entry(*e) for e in entries)
    assert idx.unpack_entry(raw[:16]) == ref_idx.unpack_entry(raw[:16])
    path = tmp_path / "w.idx"
    path.write_bytes(raw + b"\x01\x02")  # a torn trailing entry
    with open(path, "rb") as f:
        mine = list(idx.walk(f))
    with open(path, "rb") as f:
        assert mine == list(ref_idx.walk(f)) == entries


def _map_ops(p, tmp_path, tag):
    """The reference test's mixed sequence on `p`'s dict map: returns the
    map and its .idx bytes."""
    nm = p.nm.NeedleMap()
    path = tmp_path / f"{p.name}-{tag}.idx"
    with open(path, "wb") as f:
        nm.attach_idx(f)
        nm.put(1, 10, 100)
        nm.put(2, 20, 200)
        nm.delete(1)
        nm.put(3, 30, 300)
    return nm, path


def test_needle_map_accounting(tmp_path):
    seen = []
    for p in PKGS:
        nm, path = _map_ops(p, tmp_path, "acct")
        nm2 = p.nm.NeedleMap.load_from_idx(str(path))
        seen.append((nm.get(1), nm.get(2), len(nm), nm.deleted_count,
                     nm.deleted_bytes, nm.content_size, nm2.get(1), nm2.get(2),
                     nm2.get(3), nm2.deleted_count, nm2.deleted_bytes,
                     path.read_bytes()))
    assert seen[0] == seen[1]
    assert seen[1][:5] == (None, (20, 200), 2, 1, 100)


def _mixed_ops(maps, seed=42):
    """Drive every map in `maps` through one random put/delete/drop
    sequence; returns what each delete freed."""
    rng = np.random.default_rng(seed)
    freed = []
    for i, nid in enumerate(rng.integers(1, 200, 600).tolist()):
        op = i % 5
        if op < 3:
            sz = int(rng.integers(1, 1000))
            for m in maps:
                m.put(nid, i, sz)
        elif op == 3:
            freed.append([m.delete(nid) for m in maps])
        else:
            for m in maps:
                m.drop(nid)
    return freed


def _state(m):
    return ([m.get(i) for i in range(1, 201)], len(m), m.file_count,
            m.deleted_count, m.deleted_bytes, m.maximum_key, m.content_size,
            dict(m.items()))


def test_compact_needle_map_parity_with_dict_kind(tmp_path):
    """The port's compact map agrees with the port's dict map and with the
    reference's compact map on every operation and metric, across
    overwrites, tombstones, drops and forced merges; their .idx logs are
    byte-equal and replay to the same state in either kind."""
    maps = [needle_map.NeedleMap(), needle_map.CompactNeedleMap(),
            ref_nm.CompactNeedleMap()]
    maps[1].MERGE_THRESHOLD = maps[2].MERGE_THRESHOLD = 32
    files = [open(tmp_path / f"{i}.idx", "wb") for i in range(3)]
    for m, f in zip(maps, files):
        m.attach_idx(f)
    freed = _mixed_ops(maps)
    for f in files:
        f.close()
    assert all(len(set(row)) == 1 for row in freed)
    states = [_state(m) for m in maps]
    assert states[0] == states[1] == states[2]
    logs = [(tmp_path / f"{i}.idx").read_bytes() for i in range(3)]
    assert logs[0] == logs[1] == logs[2]
    path = str(tmp_path / "0.idx")
    replays = [needle_map.NeedleMap.load_from_idx(path),
               needle_map.CompactNeedleMap.load_from_idx(path),
               ref_nm.CompactNeedleMap.load_from_idx(path)]
    got = [([m.get(i) for i in range(1, 201)], m.deleted_bytes, m.file_count)
           for m in replays]
    assert got[0] == got[1] == got[2]


def test_compact_needle_map_vectorized_load(tmp_path):
    path = str(tmp_path / "v.idx")
    with open(path, "wb") as f:
        f.write(idx.pack_entry(5, 1, 100))
        f.write(idx.pack_entry(7, 2, 200))
        f.write(idx.pack_entry(5, 3, 150))   # overwrite
        f.write(idx.pack_entry(7, 2, -1))    # tombstone
        f.write(idx.pack_entry(9, 4, 300))
    seen = []
    for p in PKGS:
        nm = p.nm.CompactNeedleMap.load_from_idx(path)
        seen.append((nm.get(5), nm.get(7), nm.get(9), len(nm), nm.file_count,
                     nm.deleted_count, nm.deleted_bytes, nm.content_size,
                     nm.maximum_key))
    assert seen[0] == seen[1] == ((3, 150), None, (4, 300), 2, 4, 2, 300,
                                  450, 9)


def test_compact_needle_map_chunked_load_equals_reference(tmp_path,
                                                          monkeypatch):
    """A log larger than one 16 MB read chunk, with out-of-order ids,
    overwrites and tombstones spread over it, loads to the reference's
    columns and counters."""
    g = np.random.default_rng(9)
    n = 1_200_000
    ids = np.arange(1, n + 1, dtype=np.uint64)
    late = g.choice(n, 50_000, replace=False)
    ids = np.concatenate([ids, ids[late]])
    sizes = g.integers(1, 5000, len(ids)).astype(np.int32)
    sizes[g.choice(len(ids), 20_000, replace=False)] = -1
    arr = np.zeros((len(ids), 16), np.uint8)
    arr[:, :8] = ids.astype(">u8").view(np.uint8).reshape(-1, 8)
    arr[:, 8:12] = np.arange(len(ids), dtype=">u4").view(
        np.uint8).reshape(-1, 4)
    arr[:, 12:] = sizes.astype(">i4").view(np.uint8).reshape(-1, 4)
    path = str(tmp_path / "big.idx")
    arr.tofile(path)
    mine = needle_map.CompactNeedleMap.load_from_idx(path)
    ref = ref_nm.CompactNeedleMap.load_from_idx(path)
    for a, b in ((mine._ids, ref._ids), (mine._offs, ref._offs),
                 (mine._sizes, ref._sizes)):
        assert np.array_equal(a, b)
    assert (len(mine), mine.file_count, mine.deleted_count,
            mine.deleted_bytes, mine.maximum_key, mine.content_size) == \
        (len(ref), ref.file_count, ref.deleted_count, ref.deleted_bytes,
         ref.maximum_key, ref.content_size)
    offs = np.arange(len(ids))
    assert mine.max_tombstoned == offs[(sizes < 0) & (offs > 0)].max()


def test_load_needle_map_kinds():
    assert isinstance(needle_map.load_needle_map("memory", "/nonexistent"),
                      needle_map.NeedleMap)
    assert isinstance(needle_map.load_needle_map("compact", "/nonexistent"),
                      needle_map.CompactNeedleMap)
    for p in PKGS:
        with pytest.raises(ValueError, match="unknown needle_map_kind"):
            p.nm.load_needle_map("leveldb", "/nonexistent")


# ---- volume -------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_volume_overwrite_same_id(tmp_path, kind):
    dirs = _dirs(tmp_path, "ref", "port")
    for p, d in zip(PKGS, dirs):
        v = p.Volume(d, "", 2, needle_map_kind=kind)
        _put(p, v, 1, b"old")
        _put(p, v, 1, b"new contents")
        assert v.read_needle(1).data == b"new contents"
        v.close()
        v2 = p.Volume(d, "", 2, needle_map_kind=kind)
        assert v2.read_needle(1).data == b"new contents"
        assert (v2.nm.deleted_count, v2.nm.file_count) == (1, 2)
        v2.close()
    _same_files(*dirs, ["2.dat", "2.idx"])


def _vacuum(p, d, kind):
    v = p.Volume(d, "c", 3, needle_map_kind=kind)
    for i in range(1, 11):
        _put(p, v, i, bytes([i]) * 1000)
    for i in range(1, 6):
        v.delete_needle(i)
    out = [v.garbage_ratio(), v.data_size(), v.super_block.compaction_revision]
    v.compact()
    out += [v.data_size(), v.super_block.compaction_revision,
            [v.read_needle(i).data for i in range(6, 11)],
            [v.has_needle(i) for i in range(1, 6)], v.info()]
    v.close()
    v2 = p.Volume(d, "c", 3, needle_map_kind=kind)
    out.append(v2.read_needle(10).data)
    v2.close()
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_volume_vacuum(tmp_path, kind):
    dirs = _dirs(tmp_path, "ref", "port")
    ref, mine = (_vacuum(p, d, kind) for p, d in zip(PKGS, dirs))
    assert ref[:7] == mine[:7] and ref[8] == mine[8]
    assert vars(ref[7]) == vars(mine[7])
    assert mine[0] > 0.3 and mine[3] < mine[1] and mine[4] == mine[2] + 1
    assert mine[6] == [False] * 5
    _same_files(*dirs, ["c_3.dat", "c_3.idx"])


def test_volume_drops_idx_entry_past_dat_end(tmp_path):
    dirs = _dirs(tmp_path, "ref", "port")
    for p, d in zip(PKGS, dirs):
        v = p.Volume(d, "", 5)
        _put(p, v, 1, b"a" * 100)
        v.close()
        with open(os.path.join(d, "5.idx"), "ab") as f:
            f.write(idx.pack_entry(2, 1 << 20, 100))  # points past EOF
        v2 = p.Volume(d, "", 5)
        assert v2.read_needle(1).data == b"a" * 100
        assert not v2.has_needle(2)
        v2.close()
    _same_files(*dirs, ["5.dat", "5.idx"])


def test_volume_drop_counts_integrity_repair(tmp_path):
    from seaweedfs_tpu_torch.stats import metrics
    c = metrics.NEEDLE_MAP_DROPS.labels("integrity_repair")
    before = c.value
    v = volume.Volume(str(tmp_path), "", 5)
    _put(PORT, v, 1, b"a" * 100)
    v.close()
    with open(tmp_path / "5.idx", "ab") as f:
        f.write(idx.pack_entry(2, 1 << 20, 100))
    volume.Volume(str(tmp_path), "", 5).close()
    assert c.value == before + 1


def test_readonly_volume_rejects_writes(tmp_path):
    for p, d in zip(PKGS, _dirs(tmp_path, "ref", "port")):
        v = p.Volume(d, "", 6)
        _put(p, v, 1, b"x")
        v.read_only = True
        with pytest.raises(PermissionError):
            _put(p, v, 2, b"y")
        with pytest.raises(PermissionError):
            v.delete_needle(1)
        v.close()


def _sorted_file(p, d):
    v = p.Volume(d, "", 11)
    payloads = {}
    for i in range(1, 30):
        data = bytes([i]) * (i * 10)
        v.append_needle(p.Needle(id=i * 7, cookie=i, data=data,
                                 append_at_ns=T0 + i))
        payloads[i * 7] = (i, data)
    v.delete_needle(7, 1)
    v.close()
    v2 = p.Volume(d, "", 11, needle_map_kind="sorted_file")
    assert v2.read_only and os.path.exists(os.path.join(d, "11.sdx"))
    got = {}
    for nid, (cookie, data) in payloads.items():
        got[nid] = v2.nm.get(nid)
        if nid != 7:
            assert v2.read_needle(nid, cookie).data == data
    assert got[7] is None and v2.nm.get(99999) is None
    with pytest.raises(PermissionError):
        v2.append_needle(p.Needle(id=1000, cookie=1, data=b"x"))
    with pytest.raises(PermissionError):
        v2.compact()
    out = (got, len(v2.nm), v2.nm.maximum_key, v2.nm.content_size,
           list(v2.nm.items()))
    v2.close()
    return out


def test_sorted_file_needle_map(tmp_path):
    dirs = _dirs(tmp_path, "ref", "port")
    assert _sorted_file(REF, dirs[0]) == _sorted_file(PORT, dirs[1])
    _same_files(*dirs, ["11.dat", "11.idx", "11.sdx"])


def test_sorted_file_rebuilds_sdx_when_idx_is_newer(tmp_path):
    """An .sdx older than its .idx is rebuilt at mount (tombstones and
    superseded entries dropped and counted), to the reference's bytes."""
    from seaweedfs_tpu_torch.stats import metrics
    dirs = _dirs(tmp_path, "ref", "port")
    c = metrics.NEEDLE_MAP_DROPS.labels("sdx_rebuild")
    for p, d in zip(PKGS, dirs):
        _sorted_file(p, d)
        v = p.Volume(d, "", 11)
        _put(p, v, 500, b"late")
        v.delete_needle(14)
        v.close()
        sdx = os.path.join(d, "11.sdx")
        os.utime(sdx, (1, 1))
        before = c.value
        v = p.Volume(d, "", 11, needle_map_kind="sorted_file")
        assert v.read_needle(500).data == b"late" and not v.has_needle(14)
        v.close()
        if p is PORT:
            assert c.value == before + 2  # needles 7 and 14
    _same_files(*dirs, ["11.sdx"])


def _meta_page(p, d, now):
    v = p.Volume(d, "", 21)
    data = bytes(range(256)) * 1200
    v.append_needle(p.Needle(id=5, cookie=9, data=data, name=b"doc.bin",
                             mime=b"application/pdf", last_modified=now,
                             append_at_ns=T0))
    meta = v.read_needle_meta(5, 9)
    with pytest.raises(PermissionError):
        v.read_needle_meta(5, 1234)
    with pytest.raises(KeyError):
        v.read_needle_page(6, 0, 1)
    out = [(meta.size, meta.name, meta.mime, meta.last_modified,
            meta.checksum, meta.cookie, meta.flags),
           v.read_needle_page(5, 1000, 50, 9),
           v.read_needle_page(5, len(data) - 10, 100, 9),
           v.read_needle_page(5, len(data) + 10, 100, 9)]
    assert meta.checksum == p.crc32c(data)
    v.close()
    sub = os.path.join(d, "sub")
    os.makedirs(sub)
    v2 = p.Volume(sub, "", 22, ttl="1m")
    v2.append_needle(p.Needle(id=1, cookie=1, data=b"z" * 1000,
                              last_modified=now - 3600, append_at_ns=T0))
    with pytest.raises(KeyError, match="expired"):
        v2.read_needle_meta(1, 1)
    v2.close()
    return out


def test_read_needle_meta_and_page(tmp_path):
    now = int(time.time())
    dirs = _dirs(tmp_path, "ref", "port")
    ref, mine = (_meta_page(p, d, now) for p, d in zip(PKGS, dirs))
    assert ref == mine
    data = bytes(range(256)) * 1200
    assert mine[1] == data[1000:1050] and mine[2] == data[-10:]
    assert mine[3] == b""
    _same_files(*dirs, ["21.dat", "21.idx", "sub/22.dat"])


@pytest.mark.parametrize("kind", KINDS)
def test_volume_roundtrip_compact_kind(tmp_path, kind):
    """Write, read, delete, compact and reload on each writable kind."""
    dirs = _dirs(tmp_path, "ref", "port")
    for p, d in zip(PKGS, dirs):
        v = p.Volume(d, "", 31, needle_map_kind=kind)
        _put(p, v, 1, b"a" * 100)
        _put(p, v, 2, b"b" * 200)
        assert v.read_needle(1).data == b"a" * 100
        v.delete_needle(1)
        assert v.has_needle(1) is False and v.max_file_key() == 2
        v.compact()
        assert v.read_needle(2).data == b"b" * 200 and not v.has_needle(1)
        v.close()
        v2 = p.Volume(d, "", 31, needle_map_kind=kind)
        assert v2.read_needle(2).data == b"b" * 200
        v2.close()
    _same_files(*dirs, ["31.dat", "31.idx"])


def test_default_needle_map_is_compact(tmp_path):
    v = volume.Volume(str(tmp_path), "", 1)
    assert isinstance(v.nm, needle_map.CompactNeedleMap)
    assert v.needle_map_kind == "compact" and v.backend_kind == "disk"
    v.close()


def _scan_info(p, d):
    v = p.Volume(d, "", 8, replica_placement="001", ttl="3d")
    for nid, (cookie, data) in _blobs(8, 40).items():
        _put(p, v, nid, data, cookie=cookie, name=b"f%d" % nid)
    v.delete_needle(3)
    v.delete_needle(30)
    _put(p, v, 3, b"again")
    scanned = [(off, n.id, n.cookie, n.size, n.data, n.name, n.append_at_ns)
               for off, n in v.scan(verify_checksum=True)]
    v.set_replica_placement(p.t.ReplicaPlacement.parse("010"))
    info = vars(v.info())
    v.close()
    v2 = p.Volume(d, "", 8)
    placement = str(v2.super_block.replica_placement)
    v2.close()
    return scanned, info, placement


def test_scan_info_and_replica_placement_equal_reference(tmp_path):
    dirs = _dirs(tmp_path, "ref", "port")
    ref, mine = (_scan_info(p, d) for p, d in zip(PKGS, dirs))
    assert ref == mine
    assert len(mine[0]) == 43 and mine[2] == "010"
    assert mine[1]["replica_placement"] == "010" and mine[1]["ttl"] == "3d"
    _same_files(*dirs, ["8.dat", "8.idx"])


def test_apply_catch_up_equals_reference(tmp_path):
    """A replica catches up from its source's .dat tail and .idx, in
    either package, to the source's bytes; a stale base size refuses."""
    src, *dirs = _dirs(tmp_path, "src", "ref", "port")
    v = volume.Volume(src, "", 4)
    blobs = _blobs(4, 30)
    for nid, (cookie, data) in list(blobs.items())[:10]:
        _put(PORT, v, nid, data, cookie=cookie)
    v.close()
    for d in dirs:
        for ext in (".dat", ".idx"):
            shutil.copy(os.path.join(src, "4" + ext), d)
    base = os.path.getsize(os.path.join(src, "4.dat"))
    v = volume.Volume(src, "", 4)
    for nid, (cookie, data) in list(blobs.items())[10:]:
        _put(PORT, v, nid, data, cookie=cookie)
    v.delete_needle(2)
    v.close()
    tail = tmp_path / "4.cptail"
    with open(os.path.join(src, "4.dat"), "rb") as f:
        f.seek(base)
        tail.write_bytes(f.read())
    idx_raw = open(os.path.join(src, "4.idx"), "rb").read()
    for p, d in zip(PKGS, dirs):
        v = p.Volume(d, "", 4)
        with pytest.raises(RuntimeError, match="catch-up"):
            v.apply_catch_up(base - 8, str(tail), idx_raw)
        assert v.apply_catch_up(base, str(tail), idx_raw) == \
            tail.stat().st_size
        assert v.read_needle(30).data == blobs[30][1]
        assert not v.has_needle(2)
        v.close()
        _same_files(src, d, ["4.dat", "4.idx"])


@pytest.mark.skipif(
    reference_fixture("weed/storage/erasure_coding/1.dat") is None,
    reason="reference mount absent")
def test_reference_volume_1_parses(tmp_path):
    for p, d in zip(PKGS, _dirs(tmp_path, "ref", "port")):
        for ext in (".dat", ".idx"):
            shutil.copy(reference_fixture(
                f"weed/storage/erasure_coding/1{ext}"), d)
            os.chmod(os.path.join(d, "1" + ext), 0o644)
        v = p.Volume(d, "", 1)
        assert v.version == p.t.VERSION3
        live = [nid for nid, (_, size) in v.nm.items()
                if p.t.size_is_valid(size)]
        assert live and len(live) == len(v.nm)
        for nid in live:
            assert v.read_needle(nid).id == nid  # verifies CRC32C
        v.close()


@pytest.mark.skipif(reference_fixture("weed/storage/needle/43.dat") is None,
                    reason="reference mount absent")
def test_reference_volume_43_scan(tmp_path):
    seen = []
    for p, d in zip(PKGS, _dirs(tmp_path, "ref", "port")):
        shutil.copy(reference_fixture("weed/storage/needle/43.dat"), d)
        os.chmod(os.path.join(d, "43.dat"), 0o644)
        v = p.Volume(d, "", 43)
        seen.append([(off, n.id, n.size)
                     for off, n in v.scan(verify_checksum=True)])
        v.close()
    assert seen[0] and seen[0] == seen[1]


# ---- files cross packages -----------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("writer,reader", DIRECTIONS,
                         ids=["ref-to-port", "port-to-ref"])
def test_compacted_volume_crosses_packages(tmp_path, kind, writer, reader):
    """A volume written and compacted by one package mounts and reads in
    the other; the other package compacting the same pre-vacuum files
    writes the same .dat/.idx bytes."""
    w_dir, r_dir = _dirs(tmp_path, "w", "r")
    blobs = _blobs(17, 60, 1, 9000)
    v = writer.Volume(w_dir, "col", 9, needle_map_kind=kind)
    for nid, (cookie, data) in blobs.items():
        _put(writer, v, nid, data, cookie=cookie)
    for nid in range(1, 61, 3):
        v.delete_needle(nid)
    _put(writer, v, 4, b"overwritten")
    v.close()
    for ext in (".dat", ".idx"):
        shutil.copy(os.path.join(w_dir, "col_9" + ext), r_dir)
    v = writer.Volume(w_dir, "col", 9, needle_map_kind=kind)
    v.compact()
    v.close()
    v = reader.Volume(r_dir, "col", 9, needle_map_kind=kind)
    v.compact()
    v.close()
    _same_files(w_dir, r_dir, ["col_9.dat", "col_9.idx"])
    v = reader.Volume(w_dir, "col", 9, needle_map_kind=kind)
    assert v.super_block.compaction_revision == 1
    for nid, (cookie, data) in blobs.items():
        if nid == 4:
            assert v.read_needle(nid).data == b"overwritten"
        elif nid % 3 == 1:
            with pytest.raises(KeyError):
                v.read_needle(nid)
        else:
            n = v.read_needle(nid, cookie)
            assert n.data == data and n.append_at_ns == T0 + nid
    v.close()


@pytest.mark.parametrize("mover,reader", DIRECTIONS,
                         ids=["ref-to-port", "port-to-ref"])
def test_tier_marker_crosses_packages(tmp_path, mover, reader):
    """A volume tiered out by one package mounts from its .tier marker in
    the other, reads through the remote, and comes back byte-equal."""
    hot, cold = _dirs(tmp_path, "hot", "cold")
    blobs = _blobs(23, 12, 100, 4000)
    v = mover.Volume(hot, "", 5)
    for nid, (cookie, data) in blobs.items():
        _put(mover, v, nid, data, cookie=cookie)
    v.close()
    before = open(os.path.join(hot, "5.dat"), "rb").read()
    v = mover.Volume(hot, "", 5)
    v.tier_move("local", {"directory": cold})
    v.close()
    marker = json.load(open(os.path.join(hot, "5.tier")))
    assert marker == {"kind": "local", "options": {"directory": cold},
                      "key": "default/5.dat", "size": len(before)}
    v = reader.Volume(hot, "", 5)
    assert v.backend_kind == "remote" and v.read_only
    for nid, (cookie, data) in blobs.items():
        assert v.read_needle(nid, cookie).data == data
    v.tier_download()
    assert not os.path.exists(os.path.join(hot, "5.tier"))
    assert open(os.path.join(cold, "default", "5.dat"), "rb").read() == \
        before
    _put(reader, v, 99, b"writable again")
    v.close()
    assert open(os.path.join(hot, "5.dat"), "rb").read()[:len(before)] == \
        before


def test_tier_move_writes_the_reference_marker(tmp_path):
    dirs = _dirs(tmp_path, "ref", "port")
    for p, d in zip(PKGS, dirs):
        v = p.Volume(d, "c", 5)
        _put(p, v, 1, b"x" * 300)
        v.tier_move("local", {"directory": os.path.join(d, "cold")},
                    key="k/5.dat")
        v.tier_move("local", {})  # a tiered volume stays where it is
        with pytest.raises(PermissionError):
            v.compact()
        with pytest.raises(PermissionError):
            v.set_replica_placement(p.t.ReplicaPlacement.parse("001"))
        v.close()
    markers = [json.load(open(os.path.join(d, "c_5.tier"))) for d in dirs]
    for m, d in zip(markers, dirs):
        m["options"]["directory"] = os.path.relpath(
            m["options"]["directory"], d)
    assert markers[0] == markers[1]
    assert list(markers[1]) == ["kind", "options", "key", "size"]
    _same_files(*[os.path.join(d, "cold", "k") for d in dirs], ["5.dat"])


# ---- backends and the remote tier ---------------------------------------

@pytest.mark.parametrize("kind", ["disk", "mmap"])
def test_backend_file_roundtrip(tmp_path, kind):
    seen = []
    for p in PKGS:
        b = p.backend.open_backend(str(tmp_path / f"{p.name}.{kind}"), kind)
        out = [b.size(), b.append(b"hello"), b.append(b" world")]
        b.flush()
        out += [b.read_at(0, 11), b.read_at(6, 5), b.size(),
                bytes(b.pread(6, 5))]
        b.truncate(5)
        out += [b.size(), b.read_at(0, 10)]
        b.close()
        seen.append(out)
    assert seen[0] == seen[1] == [0, 0, 5, b"hello world", b"world", 11,
                                  b"world", 5, b"hello"]
    with pytest.raises(ValueError, match="unknown backend"):
        backend.open_backend(str(tmp_path / "x"), "s3")


def test_mmap_pread_raises_on_a_stale_window(tmp_path):
    """The lock-free read refuses past its mapping, and read_at remaps;
    a volume's read falls back to the locked read and sees the bytes."""
    b = backend.MmapFile(str(tmp_path / "m"))
    with pytest.raises(OSError, match="no mapping"):
        b.pread(0, 1)
    b.append(b"abc")
    b.flush()
    assert b.read_at(0, 3) == b"abc"
    b.append(b"def")
    b.flush()
    with pytest.raises(OSError, match="past mmap window"):
        b.pread(3, 3)
    assert b.read_at(3, 3) == b"def" and bytes(b.pread(3, 3)) == b"def"
    b.close()
    v = volume.Volume(str(tmp_path), "", 3, backend="mmap")
    _put(PORT, v, 1, b"first")
    assert v.read_needle(1).data == b"first"
    _put(PORT, v, 2, b"second")  # past the window the first read mapped
    assert v.read_needle(2).data == b"second"
    v.close()


def test_volume_on_mmap_backend(tmp_path):
    dirs = _dirs(tmp_path, "ref", "port")
    for p, d in zip(PKGS, dirs):
        v = p.Volume(d, "", 3, backend="mmap")
        v.append_needle(p.Needle(id=1, cookie=9, data=b"mmap-data",
                                 name=b"m", append_at_ns=T0))
        assert v.read_needle(1, 9).data == b"mmap-data"
        v.close()
        v2 = p.Volume(d, "", 3, backend="mmap")
        assert v2.backend_kind == "mmap"
        assert v2.read_needle(1).data == b"mmap-data"
        v2.close()
    _same_files(*dirs, ["3.dat", "3.idx"])


def test_tier_move_and_reload(tmp_path):
    for p in PKGS:
        hot, cold = _dirs(tmp_path, f"{p.name}/hot", f"{p.name}/cold")
        v = p.Volume(hot, "", 5)
        payloads = {i: os.urandom(1000) for i in range(1, 6)}
        for i, data in payloads.items():
            v.append_needle(p.Needle(id=i, cookie=i, data=data))
        v.tier_move("local", {"directory": cold})
        assert not os.path.exists(v.dat_path)
        assert os.path.exists(v.tier_path)
        assert type(v._dat).__name__ == "RemoteFile"
        for i, data in payloads.items():
            assert v.read_needle(i).data == data
        with pytest.raises(PermissionError):
            v.append_needle(p.Needle(id=99, cookie=1, data=b"x"))
        v.close()
        v2 = p.Volume(hot, "", 5)
        assert v2.backend_kind == "remote" and v2.read_only
        for i, data in payloads.items():
            assert v2.read_needle(i).data == data
        v2.close()


def test_local_remote_client_equals_reference(tmp_path):
    from seaweedfs_tpu import remote_storage as ref_remote
    seen = []
    for mod in (ref_remote, remote_storage):
        r = mod.make_remote("local", directory=str(tmp_path / mod.__name__))
        r.write_file("a/b.bin", b"0123456789")
        src = tmp_path / "src.bin"
        src.write_bytes(b"x" * 100)
        r.upload_file("a/c/d.bin", str(src))
        out = [r.read_file("a/b.bin"), r.read_range("a/b.bin", 3, 4),
               r.read_range("a/c/d.bin", 98, 10),
               [(e.key, e.size, e.is_directory) for e in r.traverse()]]
        r.delete_file("a/b.bin")
        r.delete_file("a/b.bin")  # absent: no error
        out.append([e.key for e in r.traverse("a")])
        seen.append(out)
    assert seen[0] == seen[1]


def test_make_remote_has_local_only():
    """Since the replication slice `make_remote` knows every kind the
    reference's does (`local`, `s3`, `gcs`, `azure`; the name is the
    pin's from when it knew `local` only), with the same classes' names,
    and refuses any other kind as the reference does."""
    from seaweedfs_tpu import remote_storage as ref_remote_storage
    assert sorted(remote_storage.REMOTES) == \
        sorted(ref_remote_storage.REMOTES) == ["azure", "gcs", "local", "s3"]
    for kind, cls in remote_storage.REMOTES.items():
        assert cls.__name__ == ref_remote_storage.REMOTES[kind].__name__
        assert cls.name == kind
    for kind in ("b2", "hdfs"):
        with pytest.raises(ValueError, match=f"unknown remote '{kind}'"):
            remote_storage.make_remote(kind)


def test_torn_needle_meta_tail_raises():
    n = needle.Needle(id=1)
    n.parse_meta_tail(b"")
    with pytest.raises(ValueError, match="truncated needle meta tail"):
        n.parse_meta_tail(bytes([needle.FLAG_HAS_NAME]))  # no name length
    rec = needle.Needle(id=2, cookie=3, data=b"payload", name=b"n.txt",
                        mime=b"text/plain", last_modified=1_700_000_000,
                        append_at_ns=T0).to_bytes()
    (size,) = struct.unpack(">i", rec[12:16])
    (dsize,) = struct.unpack(">I", rec[16:20])
    tail = rec[20 + dsize:16 + size]
    a, b = needle.Needle(id=2), ref_needle.Needle(id=2)
    a.parse_meta_tail(tail)
    b.parse_meta_tail(tail)
    assert (a.flags, a.name, a.mime, a.last_modified) == \
        (b.flags, b.name, b.mime, b.last_modified) == \
        (b.flags, b"n.txt", b"text/plain", 1_700_000_000)
