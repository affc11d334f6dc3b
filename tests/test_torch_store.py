"""The PyTorch/CUDA port's storage node without a server, held against the
JAX package: `Store` and `DiskLocation` (boot, crash leftovers, lookup,
blob ops, the heartbeat), and the way back from an EC volume to a normal
one (`write_dat_file`, `write_idx_from_ecx`), with shard sets crossing
the packages in both directions.  The port runs on the CPU
(`device="cpu"`, the plain version of the kernel); the reference runs its
numpy codec.  Comparisons are exact bytes.
"""

import os
import shutil
import time

import numpy as np
import pytest
import torch

from seaweedfs_tpu.storage import needle as ref_needle
from seaweedfs_tpu.storage import store as ref_store
from seaweedfs_tpu.storage.ec import ec_files as ref_ec
from seaweedfs_tpu.storage.ec import ec_volume as ref_ecv
from seaweedfs_tpu.storage.volume import Volume as RefVolume

from seaweedfs_tpu_torch.ops import gf_cuda
from seaweedfs_tpu_torch.storage import idx, needle, needle_map, store
from seaweedfs_tpu_torch.storage.ec import ec_files, ec_volume, layout
from seaweedfs_tpu_torch.storage.volume import Volume

LARGE, SMALL = 10000, 100  # tests/test_ec.py's block sizes
T0 = 1_650_000_000_000_000_000
LEFTOVERS = ["1.cpd", "1.cpx", "2.cptail", "c_3.dat.unc", "c_3.idx.unc"]


@pytest.fixture(autouse=True)
def _pinned_tombstone_time(monkeypatch):
    monkeypatch.setattr(time, "time_ns", lambda: T0 - 1)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture
def ref_codec(monkeypatch):
    """Run `fn` with the reference's numpy codec selected: the knob is
    the reference's, and the port raises on it, so it is set only around
    the reference's calls."""
    def run(fn, *a, **kw):
        with monkeypatch.context() as mp:
            mp.setenv("WEEDTPU_EC_CODEC", "numpy")
            return fn(*a, **kw)
    return run


def _blobs(seed, count, lo=1, hi=6000):
    g = np.random.default_rng(seed)
    return {i: (int(g.integers(0, 2**32)), g.bytes(int(g.integers(lo, hi))))
            for i in range(1, count + 1)}


def _write(volume_cls, needle_mod, d, vid, blobs, collection=""):
    os.makedirs(d, exist_ok=True)
    v = volume_cls(d, collection, vid)
    for nid, (cookie, data) in blobs.items():
        v.append_needle(needle_mod.Needle(cookie=cookie, id=nid, data=data,
                                          append_at_ns=T0 + nid))
    v.close()
    return os.path.join(d, f"{collection}_{vid}" if collection else str(vid))


def _encode_port(base, **kw):
    ec_files.write_ec_files(base, device="cpu", **kw)
    ec_files.write_sorted_ecx(base + ".idx")


def _encode_ref(base, **kw):
    ref_ec.write_ec_files(base, **kw)
    ref_ec.write_sorted_ecx(base + ".idx")


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _node(d):
    """A directory as one node holds it: volume 1 normal (with deletes and
    an overwrite), volume 2 in collection "pics" EC-encoded by the port
    (default blocks), volume 3 tiny and normal."""
    os.makedirs(d, exist_ok=True)
    _write(Volume, needle, d, 1, _blobs(1, 30))
    v = Volume(d, "", 1)
    v.delete_needle(4)
    v.delete_needle(9)
    v.append_needle(needle.Needle(cookie=7, id=4, data=b"again",
                                  append_at_ns=T0))
    v.close()
    base = _write(Volume, needle, d, 2, _blobs(2, 40), collection="pics")
    _encode_port(base)
    os.remove(base + ".dat")
    os.remove(base + ".idx")
    os.remove(base + layout.to_ext(6))  # one shard elsewhere
    _write(Volume, needle, d, 3, _blobs(3, 2))
    return d


# ---- the port's own rules -----------------------------------------------

def test_store_needs_the_card(tmp_path, no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        store.Store([str(tmp_path / "a")])
    s = store.Store([str(tmp_path / "a")], device="cpu")
    assert s.device.type == "cpu"
    s.close()


def test_store_boot_over_shards_needs_the_card(tmp_path, no_card):
    """EC volumes mount eagerly, so a location holding a shard set builds
    its codec at boot and raises without a card."""
    d = _node(str(tmp_path / "n"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        store.DiskLocation(d)
    s = store.Store([d], device="cpu")
    assert s.get_ec_volume(2).device.type == "cpu"
    s.close()


def test_store_read_needle_takes_no_shard_reader(tmp_path):
    s = store.Store([str(tmp_path / "n")], device="cpu")
    s.allocate_volume(1)
    with pytest.raises(TypeError):
        s.read_needle(1, 1, shard_reader=lambda *a: b"")
    s.close()


# ---- boot, lookup and the heartbeat -------------------------------------

def _plant(d):
    os.makedirs(d, exist_ok=True)
    for name in LEFTOVERS:
        with open(os.path.join(d, name), "wb") as f:
            f.write(b"garbage")
    _write(Volume, needle, d, 7, _blobs(7, 3))
    with open(os.path.join(d, "7.staging"), "w"):
        pass
    _write(Volume, needle, d, 8, _blobs(8, 3))
    with open(os.path.join(d, "notes.dat"), "wb") as f:
        f.write(b"not a volume")


def test_disk_location_removes_the_reference_leftovers(tmp_path):
    a, b = str(tmp_path / "ref"), str(tmp_path / "port")
    _plant(a)
    _plant(b)
    ref = ref_store.DiskLocation(a)
    mine = store.DiskLocation(b, device="cpu")
    assert sorted(os.listdir(a)) == sorted(os.listdir(b)) == \
        ["8.dat", "8.idx", "notes.dat"]
    assert sorted(ref.volumes) == sorted(mine.volumes) == [8]
    assert mine.collections == ref.collections == {8: ""}
    for loc in (ref, mine):
        for v in loc.volumes.values():
            v.close()


def _heartbeat(store_mod, dirs, **kw):
    s = store_mod.Store(dirs, max_volumes=5, public_url="n1:8080", **kw)
    try:
        return s.collect_heartbeat()
    finally:
        s.close()


def test_heartbeat_equals_reference(tmp_path):
    """One directory holding a normal and an EC volume (and a second,
    empty one): the port's heartbeat equals the reference's dict."""
    d = _node(str(tmp_path / "n"))
    dirs = [d, str(tmp_path / "empty")]
    ref = _heartbeat(ref_store, dirs)
    mine = _heartbeat(store, dirs, device="cpu")
    assert mine == ref
    ec = mine["ec_shards"]
    assert [(e["id"], e["collection"], e["codec"]) for e in ec] == \
        [(2, "pics", "rs_10_4")]
    assert ec[0]["shard_ids"] == [i for i in range(14) if i != 6]
    assert ec[0]["shard_size"] == os.path.getsize(
        os.path.join(d, "pics_2.ec00"))
    assert mine["max_volume_count"] == 10 and mine["max_file_key"] == 30
    vols = {v["id"]: v for v in mine["volumes"]}
    assert (vols[1]["delete_count"], vols[1]["file_count"]) == (2, 31)


def test_store_routes_blob_ops_as_reference(tmp_path, ref_codec):
    """The same calls on both stores, over copies of one node: the same
    answers, the same refusals and the same files."""
    src = _node(str(tmp_path / "src"))
    dirs = [str(tmp_path / n) for n in ("ref", "port")]
    for d in dirs:
        shutil.copytree(src, os.path.join(d, "a"))
    blobs2 = _blobs(2, 40)
    seen = []
    for store_mod, needle_mod, d, kw in (
            (ref_store, ref_needle, dirs[0], {}),
            (store, needle, dirs[1], {"device": "cpu"})):
        call = ref_codec if store_mod is ref_store else \
            (lambda fn, *a, **k: fn(*a, **k))
        s = call(store_mod.Store, [os.path.join(d, "a"),
                                        os.path.join(d, "b")],
                      max_volumes=2, **kw)
        out = []
        assert s.location_of(1) is s.locations[0]
        assert s.location_of(2) is s.locations[0]
        v = s.allocate_volume(5, "c", replica_placement="010")
        assert s.location_of(5) is s.locations[1]
        with pytest.raises(FileExistsError):
            s.allocate_volume(5)
        s.allocate_volume(6)
        with pytest.raises(OSError, match="no free volume slots"):
            s.allocate_volume(9)
        out.append(s.write_needle(5, needle_mod.Needle(
            cookie=3, id=11, data=b"x" * 70_000, append_at_ns=T0)))
        out.append(s.write_needle(5, needle_mod.Needle(
            cookie=3, id=12, data=b"small", append_at_ns=T0)))
        with pytest.raises(KeyError):
            s.write_needle(42, needle_mod.Needle(id=1, data=b"x"))
        out.append(s.read_needle(5, 12, cookie=3).data)
        with pytest.raises(PermissionError):
            s.read_needle(5, 12, cookie=4)
        out.append(s.read_needle_inline(5, 12).data)
        out.append(s.read_needle_inline(5, 11))  # past 64 KiB: None
        out.append(s.read_needle_inline(5, 13))  # absent: None
        out.append(s.read_needle_inline(2, 1))   # EC volume: None
        out.append(s.read_needle_inline(42, 1))  # no volume: None
        call(lambda: out.append(
            [(n.cookie, n.data) for n in (s.read_needle(2, i)
                                          for i in (1, 17, 40))]))
        with pytest.raises(PermissionError):
            call(s.read_needle, 2, 17, cookie=blobs2[17][0] ^ 1)
        out.append(s.delete_needle(1, 5))
        out.append(s.delete_needle(2, 17))
        with pytest.raises(KeyError):
            call(s.read_needle, 2, 17)
        with pytest.raises(KeyError):
            s.delete_needle(42, 1)
        with pytest.raises(KeyError):
            s.read_needle(42, 1)
        out.append(v.info().replica_placement)
        s.delete_volume(6)
        assert s.get_volume(6) is None
        s.allocate_volume(9)  # the slot is free again
        out.append(s.collect_heartbeat())
        s.close()
        seen.append(out)
    for hb in (seen[0][-1], seen[1][-1]):
        for v in hb["volumes"]:
            v.pop("modified_at")  # the write time of each copy
    assert seen[0] == seen[1]
    assert seen[1][0] == 70_005 and seen[1][2] == b"small"
    for name in ("a/1.dat", "a/1.idx", "b/c_5.dat", "b/c_5.idx",
                 "a/pics_2.ecx", "a/pics_2.ecj"):
        assert _bytes(os.path.join(dirs[0], name)) == \
            _bytes(os.path.join(dirs[1], name)), name
    assert not os.path.exists(os.path.join(dirs[1], "b", "6.dat"))


def test_store_serves_volumes_on_mmap(tmp_path, monkeypatch):
    """Allocated and booted volumes ride the mmap backend, the
    reference's default; the port reads no WEEDTPU_VOLUME_BACKEND."""
    monkeypatch.setenv("WEEDTPU_VOLUME_BACKEND", "disk")
    d = str(tmp_path / "n")
    s = store.Store([d], device="cpu")
    assert s.allocate_volume(1).backend_kind == "mmap"
    s.close()
    s = store.Store([d], device="cpu")
    assert s.get_volume(1).backend_kind == "mmap"
    s.close()
    ref = ref_store.Store([d])
    assert ref.get_volume(1).backend_kind == "disk"
    ref.close()


def test_tiered_volume_mounts_at_boot_unlike_the_reference(tmp_path):
    """A volume tiered out leaves only its .tier marker and .idx.  The
    reference's boot looks for .dat files and leaves it out of service
    and out of the heartbeat (ROADMAP fault 3.6); the port's store
    mounts it from the marker, reads through the remote, reports it
    read-only, brings it back with tier_download, and deleting it takes
    the marker too."""
    hot, cold = str(tmp_path / "hot"), str(tmp_path / "cold")
    blobs = _blobs(4, 5)
    _write(Volume, needle, hot, 4, blobs, collection="c")
    v = Volume(hot, "c", 4)
    v.tier_move("local", {"directory": cold})
    v.close()
    ref = ref_store.Store([hot])
    assert ref.get_volume(4) is None  # the fault
    assert ref.collect_heartbeat()["volumes"] == []
    ref.close()
    mine = store.Store([hot], device="cpu")
    v = mine.get_volume(4)
    assert v.backend_kind == "remote" and v.collection == "c"
    for nid, (cookie, data) in blobs.items():
        assert mine.read_needle(4, nid, cookie).data == data
    with pytest.raises(PermissionError):
        mine.write_needle(4, needle.Needle(id=9, data=b"x"))
    (hb,) = mine.collect_heartbeat()["volumes"]
    assert (hb["id"], hb["collection"], hb["read_only"], hb["file_count"]) \
        == (4, "c", True, 5)
    v.tier_download()
    mine.write_needle(4, needle.Needle(id=9, data=b"x"))
    mine.close()
    mine = store.Store([hot], device="cpu")
    assert mine.get_volume(4).backend_kind == "mmap"
    mine.get_volume(4).tier_move("local", {"directory": cold})
    mine.delete_volume(4)
    assert os.listdir(hot) == []
    mine.close()
    assert store.Store([hot], device="cpu").get_volume(4) is None


# ---- decode back to a volume --------------------------------------------

@pytest.fixture
def small_volume(tmp_path):
    blobs = _blobs(77, 80)
    base = _write(Volume, needle, str(tmp_path), 7, blobs)
    return base, blobs


def test_ec_decode_back_to_volume(small_volume):
    base, blobs = small_volume
    golden = _bytes(base + ".dat")
    _encode_port(base, large_block=LARGE, small_block=SMALL)
    dat_size = ec_files.find_dat_file_size(base)
    assert dat_size == len(golden) == ref_ec.find_dat_file_size(base)
    os.remove(base + ".dat")
    os.remove(base + ".idx")
    ec_files.write_dat_file(base, dat_size, LARGE, SMALL)
    ec_files.write_idx_from_ecx(base + ".ecx")
    assert _bytes(base + ".dat") == golden
    assert ec_files.volume_codec_tag(base) == ref_ec.volume_codec_tag(base) \
        == "rs_10_4"
    v = Volume(os.path.dirname(base), "", 7)
    for nid, (cookie, data) in blobs.items():
        assert v.read_needle(nid, cookie).data == data
    v.close()


def _lose_and_delete(base, deleted, lost, ev_cls, **kw):
    """Tombstone `deleted` through an EC volume (the .ecx in place and the
    .ecj journal), then lose the `lost` shard files."""
    ev = ev_cls(base, LARGE, SMALL, **kw)
    for nid in deleted:
        ev.delete_needle(nid)
    ev.close()
    for i in lost:
        os.remove(base + layout.to_ext(i))


def _decode(pkg, base, ref_codec):
    """handle_ec_to_volume's order: rebuild any missing data shard, the
    .dat size from the .vif, the .dat, then the .idx with the .ecj's
    tombstones."""
    ecf = ec_files if pkg == "port" else ref_ec
    missing = [i for i in range(10)
               if not os.path.exists(base + layout.to_ext(i))]
    if missing:
        if pkg == "port":
            ec_files.rebuild_ec_files(base, batch_size=3000, device="cpu")
        else:
            ref_codec(ref_ec.rebuild_ec_files, base, batch_size=3000)
    dat_size = ecf.find_dat_file_size(base)
    ecf.write_dat_file(base, dat_size, LARGE, SMALL)
    ecf.write_idx_from_ecx(base + ".ecx")


@pytest.mark.parametrize("encoder,decoder", [("ref", "port"), ("port", "ref")],
                         ids=["ref-to-port", "port-to-ref"])
def test_decode_crosses_packages(tmp_path, ref_codec, encoder, decoder):
    """A shard set encoded (and partly deleted from) by one package,
    with data shards lost, decodes in the other to the same .dat and
    .idx as in its own; the deleted needles stay deleted."""
    blobs = _blobs(55, 90, 1, 9000)
    src = str(tmp_path / "src")
    if encoder == "ref":
        base = _write(RefVolume, ref_needle, src, 3, blobs, "c")
        ref_codec(_encode_ref, base, large_block=LARGE, small_block=SMALL)
    else:
        base = _write(Volume, needle, src, 3, blobs, "c")
        _encode_port(base, large_block=LARGE, small_block=SMALL)
    golden = _bytes(base + ".dat")
    os.remove(base + ".dat")
    os.remove(base + ".idx")
    deleted = [5, 6, 40, 88]
    if encoder == "ref":
        ref_codec(_lose_and_delete, base, deleted, [1, 4, 11], ref_ecv.EcVolume)
    else:
        _lose_and_delete(base, deleted, [1, 4, 11], ec_volume.EcVolume,
                         device="cpu")
    assert len(ec_files.read_ecj(base + ".ecj")) == 4
    out = {}
    for pkg in (encoder, decoder):
        d = str(tmp_path / f"decoded-by-{pkg}")
        shutil.copytree(src, d)
        b = os.path.join(d, "c_3")
        _decode(pkg, b, ref_codec)
        out[pkg] = b
    for ext in (".dat", ".idx") + tuple(layout.to_ext(i) for i in (1, 4)):
        assert _bytes(out["ref"] + ext) == _bytes(out["port"] + ext), ext
    assert _bytes(out[decoder] + ".dat") == golden
    for vol_cls, pkg in ((Volume, decoder), (RefVolume, decoder)):
        v = vol_cls(os.path.dirname(out[pkg]), "c", 3)
        for nid, (cookie, data) in blobs.items():
            if nid in deleted:
                with pytest.raises(KeyError):
                    v.read_needle(nid)
            else:
                assert v.read_needle(nid, cookie).data == data
        v.close()


def test_write_idx_from_ecx_equals_reference(tmp_path):
    """Tombstones in the .ecx and in the .ecj journal, ids out of order
    in the journal: the same .idx bytes, to another path too."""
    g = np.random.default_rng(12)
    ids = np.sort(g.choice(1 << 40, 500, replace=False))
    with open(tmp_path / "9.ecx", "wb") as f:
        for nid in ids.tolist():
            size = -1 if nid % 7 == 0 else int(g.integers(1, 1 << 20))
            f.write(idx.pack_entry(nid, int(g.integers(0, 1 << 32)), size))
    with open(tmp_path / "9.ecj", "wb") as f:
        for nid in g.permutation(ids)[:40].tolist():
            f.write(int(nid).to_bytes(8, "big"))
    ecx = str(tmp_path / "9.ecx")
    ec_files.write_idx_from_ecx(ecx)
    ref_ec.write_idx_from_ecx(ecx, str(tmp_path / "ref.idx"))
    ec_files.write_idx_from_ecx(ecx, str(tmp_path / "port.idx"))
    assert _bytes(tmp_path / "9.idx") == _bytes(tmp_path / "ref.idx") == \
        _bytes(tmp_path / "port.idx")
    assert len(_bytes(tmp_path / "9.idx")) == 540 * 16


@pytest.mark.parametrize("dat_size", [1, SMALL * 10, LARGE * 10 + 1,
                                      LARGE * 25 + 12345])
def test_write_dat_file_equals_reference(tmp_path, dat_size):
    """Shard files of random bytes interleave back into the same .dat, in
    large rows and small."""
    g = np.random.default_rng(dat_size)
    shard_size = layout.shard_file_size(dat_size, LARGE, SMALL)
    shards = [g.bytes(shard_size) for _ in range(10)]
    bases = [str(tmp_path / d / "5") for d in ("ref", "port")]
    for base in bases:
        os.makedirs(os.path.dirname(base))
        for i, data in enumerate(shards):
            with open(base + layout.to_ext(i), "wb") as f:
                f.write(data)
    ref_ec.write_dat_file(bases[0], dat_size, LARGE, SMALL)
    ec_files.write_dat_file(bases[1], dat_size, LARGE, SMALL)
    got = _bytes(bases[1] + ".dat")
    assert len(got) == dat_size and got == _bytes(bases[0] + ".dat")


# ---- the slice as a whole -----------------------------------------------

def test_store_volume_lifecycle_equals_reference(tmp_path, ref_codec,
                                                 monkeypatch):
    """One node's whole volume lifecycle through the port's store, as
    chip_smoke.py drives it on the card, at a small size: boot over crash
    leftovers, small objects across a reboot and a sorted-file reopen,
    vacuum, encode and mount, degraded reads, deletes on the EC volume,
    decode back to a volume, and the remote tier out and back.  The
    compacted and the decoded files equal the reference's, made from the
    same inputs."""
    from seaweedfs_tpu_torch.storage.backend import RemoteFile
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    blobs = _blobs(14, 120, 1, 30_000)
    base = _write(Volume, needle, a, 1, blobs)
    twin = str(tmp_path / "ref")
    shutil.copytree(a, twin)
    for name in LEFTOVERS:
        open(os.path.join(a, name), "wb").close()
    _write(Volume, needle, a, 7, _blobs(7, 2))
    open(os.path.join(a, "7.staging"), "w").close()

    # 1 boot
    s = store.Store([a, b], device="cpu")
    assert sorted(os.listdir(a)) == ["1.dat", "1.idx"]
    for nid, (cookie, data) in blobs.items():
        assert s.read_needle(1, nid, cookie).data == data
        n = s.read_needle_inline(1, nid, cookie)
        assert n is None or n.data == data

    # 2 small objects, over two merges of the compact map
    monkeypatch.setattr(needle_map.CompactNeedleMap, "MERGE_THRESHOLD", 64)
    v2 = s.allocate_volume(2)
    assert s.location_of(2).directory == b
    small = _blobs(2, 150, 1024, 1025)
    for nid, (cookie, data) in small.items():
        s.write_needle(2, needle.Needle(cookie=cookie, id=nid, data=data,
                                        append_at_ns=T0 + nid))
    assert len(v2.nm._overflow) == 150 - 128
    s.close()
    s = store.Store([a, b], device="cpu")
    for nid in (1, 64, 65, 128, 150):
        assert s.read_needle(2, nid).data == small[nid][1]
    sf = Volume(b, "", 2, needle_map_kind="sorted_file")
    assert sf.read_needle(65).data == small[65][1]
    with pytest.raises(PermissionError):
        sf.append_needle(needle.Needle(id=999, data=b"x"))
    sf.close()

    # 3 vacuum
    gone = list(range(4, 121, 4))
    for nid in gone:
        s.delete_needle(1, nid)
    v = s.get_volume(1)
    assert v.garbage_ratio() > 0
    v.compact()
    assert v.super_block.compaction_revision == 1
    rv = RefVolume(twin, "", 1)
    for nid in gone:
        rv.delete_needle(nid)
    rv.compact()
    rv.close()
    for ext in (".dat", ".idx"):
        assert _bytes(base + ext) == _bytes(os.path.join(twin, "1" + ext))
    compacted = _bytes(base + ".dat")
    s.close()

    # 4 encode and mount
    _encode_port(base)
    ref_codec(_encode_ref, os.path.join(twin, "1"))
    os.remove(base + ".dat")
    os.remove(base + ".idx")
    s = store.Store([a, b], device="cpu")
    ev = s.get_ec_volume(1)
    assert s.get_volume(1) is None and ev is not None
    (hb,) = s.collect_heartbeat()["ec_shards"]
    assert hb["shard_ids"] == list(range(14)) and hb["codec"] == "rs_10_4"
    assert hb["shard_size"] == os.path.getsize(base + ".ec05")
    s.close()

    # 5 degraded
    for i in (0, 3, 10, 12):
        os.remove(base + layout.to_ext(i))
    s = store.Store([a, b], device="cpu")
    ev = s.get_ec_volume(1)
    live = [nid for nid in blobs if nid not in gone]
    for nid in live:
        assert s.read_needle(1, nid, blobs[nid][0]).data == blobs[nid][1]
    assert ev.read_stats["reconstruct_batches"] > 0
    more = live[::7][:16]
    for nid in more:
        s.delete_needle(1, nid)
    s.close()
    ref_codec(_lose_and_delete, os.path.join(twin, "1"), more,
              (0, 3, 10, 12), ref_ecv.EcVolume)

    # 6 decode, in handle_ec_to_volume's order; then the shard set goes
    ec_files.rebuild_ec_files(base, device="cpu")
    ec_files.write_dat_file(base, ec_files.find_dat_file_size(base))
    ec_files.write_idx_from_ecx(base + ".ecx")
    twin_base = os.path.join(twin, "1")
    ref_codec(ref_ec.rebuild_ec_files, twin_base)
    ref_ec.write_dat_file(twin_base, ref_ec.find_dat_file_size(twin_base))
    ref_ec.write_idx_from_ecx(twin_base + ".ecx")
    assert _bytes(base + ".dat") == compacted
    for ext in (".dat", ".idx"):
        assert _bytes(base + ext) == _bytes(twin_base + ext)
    for ext in [layout.to_ext(i) for i in range(14)] + [".ecx", ".ecj",
                                                        ".vif"]:
        os.remove(base + ext)
    s = store.Store([a, b], device="cpu")
    assert s.get_ec_volume(1) is None
    for nid, (cookie, data) in blobs.items():
        if nid in gone or nid in more:
            with pytest.raises(KeyError):
                s.read_needle(1, nid)
        else:
            assert s.read_needle(1, nid, cookie).data == data

    # 7 tier out and back
    kept = [nid for nid in live if nid not in more]
    v = s.get_volume(1)
    v.tier_move("local", {"directory": str(tmp_path / "cold")})
    assert isinstance(v._dat, RemoteFile)
    assert s.read_needle(1, kept[-1]).data == blobs[kept[-1]][1]
    with pytest.raises(PermissionError):
        s.write_needle(1, needle.Needle(id=999, data=b"x"))
    s.close()
    v = Volume(a, "", 1)
    assert v.backend_kind == "remote"
    assert v.read_needle(kept[0]).data == blobs[kept[0]][1]
    v.tier_download()
    assert v.backend_kind == "disk" and _bytes(base + ".dat") == compacted
    v.close()


# ---- faults of the reference -----------------------------------------------

def test_decoded_volume_keeps_a_deleted_last_needle_deleted(tmp_path,
                                                            ref_codec):
    """ROADMAP fault 3.7: a needle deleted on the EC volume keeps its
    record in the decoded .dat with no tombstone record after it.  When
    it is the volume's last record, the reference's boot walk starts
    after the last LIVE record and re-indexes it: the needle comes back.
    The port's walk starts past every record a tombstone entry points
    at, so it stays deleted; both packages decode the same files."""
    blobs = _blobs(31, 12, 100, 900)
    base = _write(Volume, needle, str(tmp_path), 1, blobs)
    _encode_port(base, large_block=LARGE, small_block=SMALL)
    os.remove(base + ".dat")
    os.remove(base + ".idx")
    _lose_and_delete(base, [12, 3], [], ec_volume.EcVolume, device="cpu")
    ec_files.write_dat_file(base, ec_files.find_dat_file_size(base),
                            LARGE, SMALL)
    ec_files.write_idx_from_ecx(base + ".ecx")
    decoded = {ext: _bytes(base + ext) for ext in (".dat", ".idx")}
    twin = str(tmp_path / "twin")
    os.makedirs(twin)
    for ext, data in decoded.items():
        with open(os.path.join(twin, "1" + ext), "wb") as f:
            f.write(data)
    for kind in ("compact", "memory"):
        v = Volume(str(tmp_path), "", 1, needle_map_kind=kind)
        for nid in (3, 12):
            with pytest.raises(KeyError):
                v.read_needle(nid)
        assert v.read_needle(11).data == blobs[11][1]
        assert len(v.nm) == 10
        v.close()
    assert _bytes(base + ".idx") == decoded[".idx"]  # nothing re-indexed
    ref = RefVolume(twin, "", 1)
    assert ref.read_needle(12).data == blobs[12][1]  # the fault
    with pytest.raises(KeyError):
        ref.read_needle(3)
    ref.close()


def test_reboot_after_deleting_the_last_needle(tmp_path):
    """The same walk on a normal volume whose last record is a delete:
    the reference re-indexes the deleted needle and deletes it again on
    every boot, two .idx entries and +1 to both counters each time; the
    port indexes the tombstone record once, at the first boot, and its
    counters stay."""
    seen = {}
    for name, vol_cls, needle_mod in (("ref", RefVolume, ref_needle),
                                      ("port", Volume, needle)):
        d = str(tmp_path / name)
        _write(vol_cls, needle_mod, d, 1, _blobs(5, 3))
        v = vol_cls(d, "", 1)
        v.delete_needle(3)
        v.close()
        rows = []
        for _ in range(3):
            v = vol_cls(d, "", 1)
            rows.append((os.path.getsize(os.path.join(d, "1.idx")),
                         v.nm.file_count, v.nm.deleted_count,
                         v.has_needle(3)))
            v.close()
        seen[name] = rows
    assert seen["ref"] == [(96, 4, 2, False), (128, 5, 3, False),
                           (160, 6, 4, False)]
    assert seen["port"] == [(80, 3, 1, False)] * 3


@pytest.mark.parametrize("kind", ["compact", "memory"])
def test_boot_parses_the_idx_once(tmp_path, monkeypatch, kind):
    """The walk past tombstoned records takes the furthest one from the
    needle map's own load: a boot of a volume whose last records are
    deletes parses the .idx log once, as the load's slices."""
    d = str(tmp_path)
    _write(Volume, needle, d, 1, _blobs(5, 40))
    v = Volume(d, "", 1)
    v.delete_needle(40)
    v.delete_needle(7)
    v.close()
    Volume(d, "", 1).close()  # indexes the two tombstone records
    idx_path = os.path.join(d, "1.idx")
    size = os.path.getsize(idx_path)
    _, offs, sizes = idx.read_columns(_bytes(idx_path))
    last_tomb = int(offs[-1])
    assert sizes[-1] < 0 and last_tomb == int(offs[sizes < 0].max())
    parsed = []
    real = idx.read_columns
    monkeypatch.setattr(idx, "read_columns",
                        lambda data: parsed.append(len(data)) or real(data))
    v = Volume(d, "", 1, needle_map_kind=kind)
    assert sum(parsed) == size == os.path.getsize(idx_path)
    assert v.nm.max_tombstoned == last_tomb
    assert not v.has_needle(40) and not v.has_needle(7)
    v.close()
