"""The port's volume server, in process on the CPU, held to the
reference.

Each test runs port `VolumeServer`s (`device="cpu"`) and, where a master
is needed, the reference `MasterServer` on an asyncio loop in a thread,
with real sockets; the test body drives them over HTTP as a client
would.  Files that both packages write are compared byte for byte: the
shard sets the server encodes and rebuilds against the reference's
`write_ec_files` and `rebuild_ec_files` on the same input.
"""

import asyncio
import hashlib
import io
import json
import os
import pathlib
import shutil
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from seaweedfs_tpu import images as ref_images
from seaweedfs_tpu import pb as ref_pb
from seaweedfs_tpu.ops import gf as ref_gf
from seaweedfs_tpu.storage.ec import ec_files as ref_ec_files

from seaweedfs_tpu_torch import pb
from seaweedfs_tpu_torch.ops import dispatch, fleet_convert
from seaweedfs_tpu_torch.server import volume_server as vsmod
from seaweedfs_tpu_torch.stats import metrics
from seaweedfs_tpu_torch.storage.ec import ec_files

REPO = pathlib.Path(__file__).resolve().parent.parent
SHARDS = [f".ec{i:02d}" for i in range(14)]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Harness:
    """A loop thread; the reference master (`master=True`; the port's
    with `master="port"`) or a stand-in that takes heartbeats
    (`_stub_master`), and `n` port volume servers on it."""

    def __init__(self, tmp_path, n=1, master=True, master_app=None):
        if not master and master_app is None:
            master_app = _stub_master([])
        self.tmp = tmp_path
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        self.master = None
        self._stub = None
        if master_app is not None:
            from aiohttp import web
            self._stub = web.AppRunner(master_app)
            port = free_port()
            self.submit(self._stub.setup())
            self.submit(web.TCPSite(self._stub, "127.0.0.1", port).start())
            self.master_url = f"127.0.0.1:{port}"
        else:
            from seaweedfs_tpu.server.master import MasterServer
            if master == "port":
                from seaweedfs_tpu_torch.server.master import MasterServer
            self.master = MasterServer("127.0.0.1", free_port())
            self.submit(self.master.start())
            self.master_url = self.master.url
        self.vs = []
        for i in range(n):
            d = tmp_path / f"vs{i}"
            d.mkdir()
            v = vsmod.VolumeServer([str(d)], self.master_url, "127.0.0.1",
                                   free_port(), heartbeat_interval=0.2,
                                   device="cpu")
            self.submit(v.start())
            self.vs.append(v)

    def submit(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(60)

    def dir(self, i=0):
        return self.tmp / f"vs{i}"

    def call(self, i, path, body=None, method=None, data=None,
             headers=None):
        """(status, headers, body bytes) of one request to server i."""
        hdrs = dict(headers or {})
        if body is not None:
            data = json.dumps(body).encode()
            hdrs.setdefault("Content-Type", "application/json")
        req = urllib.request.Request(
            f"http://{self.vs[i].url}{path}", data=data, headers=hdrs,
            method=method or ("POST" if data is not None else "GET"))
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, r.headers, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.headers, e.read()

    def json(self, i, path, body=None, method=None):
        st, _, raw = self.call(i, path, body, method)
        return st, json.loads(raw) if raw else {}

    def stop(self):
        for v in self.vs:
            self.submit(v.stop())
        if self.master is not None:
            self.submit(self.master.stop())
        if self._stub is not None:
            self.submit(self._stub.cleanup())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(5)
        self.loop.close()


@pytest.fixture
def harness(tmp_path):
    hs = []

    def make(**kw):
        d = tmp_path / f"h{len(hs)}"
        d.mkdir()
        hs.append(Harness(d, **kw))
        return hs[-1]

    yield make
    for h in hs:
        h.stop()


def fid(vid, key, cookie=0x1234ABCD):
    return f"{vid},{key:x}{cookie:08x}"


def put_blobs(h, i, vid, n, seed, lo=1000, hi=60_000):
    rng = np.random.default_rng(seed)
    out = {}
    for k in range(1, n + 1):
        data = rng.integers(0, 256, int(rng.integers(lo, hi)),
                            dtype=np.uint8).tobytes()
        st, _, _ = h.call(i, "/" + fid(vid, k), data=data, method="PUT")
        assert st == 201
        out[fid(vid, k)] = data
    return out


def sha(path) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


# ---- the device ---------------------------------------------------------

def test_volume_server_needs_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vsmod.VolumeServer([str(tmp_path)], "127.0.0.1:1")


def test_every_codec_runs_on_the_servers_device(harness, monkeypatch):
    """The encode, the rebuilds (plain and reduced), every mounted EC
    volume, the helper's partial, the recode and its remount, the
    scrubber's windows and the fleet conversion get the server's device,
    never their own default."""
    h = harness()
    seen = []
    for mod, name in ((ec_files, "write_ec_files"),
                      (ec_files, "rebuild_ec_files"),
                      (ec_files, "rebuild_ec_reduced"),
                      (vsmod.ecv, "EcVolume"),
                      (fleet_convert, "convert_volumes")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **kw):
            seen.append((_name, kw.get("device")))
            return _real(*a, **kw)
        monkeypatch.setattr(mod, name, spy)
    for name in ("apply_matrix", "parity_mismatch"):
        real = getattr(dispatch, name)

        def on_codec(codec, *a, _real=real, _name=name, **kw):
            seen.append((_name, codec.device))
            return _real(codec, *a, **kw)
        monkeypatch.setattr(dispatch, name, on_codec)
    assert h.json(0, "/admin/assign_volume", {"volume": 3})[0] == 200
    put_blobs(h, 0, 3, 12, seed=1)
    assert h.json(0, "/admin/ec/generate", {"volume": 3})[0] == 200
    os.remove(h.dir() / "3.ec02")
    assert h.json(0, "/admin/ec/rebuild", {"volume": 3})[0] == 200
    assert h.json(0, "/admin/ec/mount", {"volume": 3})[0] == 200
    assert h.json(0, "/admin/volume/delete", {"volume": 3})[0] == 200
    os.remove(h.dir() / "3.ec04")
    assert h.json(0, "/admin/ec/to_volume", {"volume": 3})[0] == 200
    assert h.call(0, "/admin/ec/partial", {
        "volume": 3, "shards": [0, 1], "offset": 0, "size": 4096,
        "coeff": [[1, 2]]})[0] == 200
    os.remove(h.dir() / "3.ec05")
    assert h.json(0, "/admin/ec/rebuild", {
        "volume": 3, "reduced": {"lost": [5], "groups": []}})[0] == 200
    assert h.json(0, "/admin/ec/recode",
                  {"volume": 3, "codec": "lrc_10_2_2"})[0] == 200
    assert h.json(0, "/admin/scrub", {})[0] == 200
    assert h.json(0, "/admin/assign_volume", {"volume": 6})[0] == 200
    put_blobs(h, 0, 6, 5, seed=2)
    assert h.json(0, "/admin/ec/fleet_convert", {"volumes": [6]})[0] == 200
    names = [n for n, _ in seen]
    assert names[:5] == ["write_ec_files", "rebuild_ec_files", "EcVolume",
                         "rebuild_ec_files", "apply_matrix"], names
    assert names[5] == "rebuild_ec_reduced" and \
        set(names[6:names.index("write_ec_files", 6)]) == {"apply_matrix"}
    assert names[names.index("write_ec_files", 6):] == \
        ["write_ec_files", "EcVolume"] + \
        ["parity_mismatch"] * names.count("parity_mismatch") + \
        ["convert_volumes"], names
    assert names.count("parity_mismatch") == 1  # one 1 MiB window
    assert all(d == torch.device("cpu") for _, d in seen), seen


# ---- the blob path ------------------------------------------------------

def test_blob_write_read_range_head_delete(harness):
    h = harness(master=False)
    assert h.json(0, "/admin/assign_volume", {"volume": 5})[0] == 200
    # idempotent
    assert h.json(0, "/admin/assign_volume", {"volume": 5})[0] == 200
    data = bytes(range(256)) * 40
    st, _, raw = h.call(0, "/" + fid(5, 1), data=data, method="PUT",
                        headers={"Content-Type": "application/x-test",
                                 "X-File-Name": "a.bin"})
    assert st == 201
    reply = json.loads(raw)
    assert reply["name"] == "a.bin" and reply["size"] == len(data)
    st, hd, body = h.call(0, "/" + fid(5, 1))
    assert (st, body) == (200, data)
    assert hd["Content-Type"] == "application/x-test"
    assert hd["Content-Disposition"] == 'inline; filename="a.bin"'
    assert hd["Etag"] == f'"{reply["eTag"]}"'
    st, hd, body = h.call(0, "/" + fid(5, 1), method="HEAD")
    assert (st, body) == (200, b"")
    st, hd, body = h.call(0, "/" + fid(5, 1),
                          headers={"Range": "bytes=100-199"})
    assert (st, body) == (206, data[100:200])
    assert hd["Content-Range"] == f"bytes 100-199/{len(data)}"
    st, hd, _ = h.call(0, "/" + fid(5, 1),
                       headers={"Range": f"bytes={len(data)}-"})
    assert st == 416 and hd["Content-Range"] == f"bytes */{len(data)}"
    # multipart upload: name and mime from the part
    boundary = "xyzzy"
    mp = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\";"
          f" filename=\"m.txt\"\r\nContent-Type: text/plain\r\n\r\n"
          ).encode() + b"multipart body" + f"\r\n--{boundary}--\r\n".encode()
    st, _, raw = h.call(0, "/" + fid(5, 2), data=mp, method="POST",
                        headers={"Content-Type":
                                 f"multipart/form-data; boundary={boundary}"})
    assert st == 201 and json.loads(raw)["name"] == "m.txt"
    st, hd, body = h.call(0, "/" + fid(5, 2))
    assert body == b"multipart body"
    assert hd["Content-Type"].startswith("text/plain")
    # wrong cookie, unknown volume, malformed fid
    assert h.call(0, "/" + fid(5, 1, cookie=1))[0] == 404
    assert h.call(0, "/" + fid(9, 1))[0] == 404
    assert h.call(0, "/5,12")[0] == 400
    assert h.call(0, "/" + fid(9, 1), data=b"x", method="PUT")[0] == 404
    # delete, then gone
    st, _, raw = h.call(0, "/" + fid(5, 1), method="DELETE")
    assert st == 200 and json.loads(raw)["size"] > 0
    assert h.call(0, "/" + fid(5, 1))[0] == 404
    # a read-only volume refuses writes with 409
    assert h.json(0, "/admin/volume/readonly", {"volume": 5})[0] == 200
    assert h.call(0, "/" + fid(5, 3), data=b"x", method="PUT")[0] == 409


def test_paged_range_read_equals_whole_read(harness):
    h = harness(master=False)
    h.json(0, "/admin/assign_volume", {"volume": 6})
    blob = np.random.default_rng(17).integers(
        0, 256, 1 << 20, dtype=np.uint8).tobytes()
    assert h.call(0, "/" + fid(6, 1), data=blob, method="PUT")[0] == 201
    for rng, want in (("bytes=500000-500099", blob[500000:500100]),
                      ("bytes=1048000-", blob[1048000:]),
                      ("bytes=-10", blob[-10:])):
        st, hd, body = h.call(0, "/" + fid(6, 1), headers={"Range": rng})
        assert (st, body) == (206, want), rng
    assert h.call(0, "/" + fid(6, 1))[2] == blob


def test_image_resize_equals_reference(harness):
    PIL = pytest.importorskip("PIL.Image")
    img = PIL.new("RGB", (40, 20), (200, 10, 30))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    png = buf.getvalue()
    h = harness(master=False)
    h.json(0, "/admin/assign_volume", {"volume": 8})
    h.call(0, "/" + fid(8, 1), data=png, method="PUT",
           headers={"Content-Type": "image/png"})
    for q, (w, hh, mode) in (("?width=10", (10, 0, "")),
                             ("?width=10&height=10&mode=fill",
                              (10, 10, "fill")),
                             ("?height=5&mode=fit", (0, 5, "fit"))):
        st, _, body = h.call(0, "/" + fid(8, 1) + q)
        assert st == 200
        assert body == ref_images.resized(png, "image/png", w, hh, mode), q
    assert h.call(0, "/" + fid(8, 1) + "?width=bad")[2] == png


# ---- EC admin -----------------------------------------------------------

def test_generate_equals_reference_and_reads_through(harness, monkeypatch):
    """/admin/ec/generate writes the reference's shard set of the same
    .dat byte for byte; mounted, every blob reads back whole and with
    four shards gone; /admin/ec/to_volume decodes the .dat back."""
    h = harness()
    h.json(0, "/admin/assign_volume", {"volume": 4})
    blobs = put_blobs(h, 0, 4, 40, seed=2)
    st, prog = h.json(0, "/admin/ec/progress?volumeId=4")
    assert st == 404
    h.json(0, "/admin/volume/readonly", {"volume": 4})
    st, r = h.json(0, "/admin/ec/generate", {"volume": 4})
    assert (st, r) == (200, {"shards": list(range(14)), "codec": "rs_10_4"})
    st, prog = h.json(0, "/admin/ec/progress?volumeId=4")
    assert prog["state"] == "done" and prog["bytes_done"] == prog["total"]
    assert prog["stages"]["mode"]
    d = h.dir()
    ref = h.tmp / "ref"
    ref.mkdir()
    for ext in (".dat", ".idx"):
        shutil.copyfile(d / f"4{ext}", ref / f"4{ext}")
    with monkeypatch.context() as mp:
        mp.setenv("WEEDTPU_EC_CODEC", "numpy")
        ref_ec_files.write_ec_files(str(ref / "4"))
        ref_ec_files.write_sorted_ecx(str(ref / "4.idx"))
    for ext in SHARDS + [".ecx", ".vif"]:
        assert sha(d / f"4{ext}") == sha(ref / f"4{ext}"), ext
    dat = (d / "4.dat").read_bytes()
    st, r = h.json(0, "/admin/ec/mount", {"volume": 4})
    assert r == {"shards": list(range(14))}
    assert h.json(0, "/admin/volume/delete", {"volume": 4})[0] == 200
    for f, data in blobs.items():
        assert h.call(0, "/" + f)[2] == data
    assert h.json(0, "/admin/ec/delete_shards",
                  {"volume": 4, "shards": [0, 3, 10, 12]})[0] == 200
    ev = h.vs[0].store.get_ec_volume(4)
    before = ev.read_stats_snapshot()["reconstruct_batches"]
    for f, data in blobs.items():
        assert h.call(0, "/" + f)[2] == data, f
    assert ev.read_stats_snapshot()["reconstruct_batches"] > before
    assert h.json(0, "/admin/ec/unmount", {"volume": 4})[0] == 200
    assert h.json(0, "/admin/ec/to_volume", {"volume": 4})[0] == 200
    assert (d / "4.dat").read_bytes() == dat
    for f, data in blobs.items():
        assert h.call(0, "/" + f)[2] == data


def test_rebuild_reduced_equals_reference(harness, monkeypatch):
    """A rebuild with `reduced` (the reference master's repair plan)
    rebuilds the lost
    shard from A's survivors and B's partials through B's
    /admin/ec/partial: the shard is the encode's, and the answer, byte
    ledger included, equals the reference's rebuild_ec_reduced over the
    same files with the same helper."""
    h = harness(n=2, master=False)
    a, b = h.vs
    h.json(0, "/admin/assign_volume", {"volume": 2})
    blobs = put_blobs(h, 0, 2, 24, seed=3)
    h.json(0, "/admin/ec/generate", {"volume": 2})
    held = [10, 11, 12, 13]
    assert h.json(1, "/admin/ec/copy", {"volume": 2, "source": a.url,
                                        "shards": held})[0] == 200
    assert h.json(1, "/admin/ec/mount", {"volume": 2})[1] == \
        {"shards": held}
    want = (h.dir(0) / "2.ec03").read_bytes()
    assert h.json(0, "/admin/ec/delete_shards",
                  {"volume": 2, "shards": held + [3]})[0] == 200
    ref = h.tmp / "ref"
    ref.mkdir()
    for ext in [f".ec{i:02d}" for i in range(10) if i != 3] + \
            [".ecx", ".vif"]:
        shutil.copyfile(h.dir(0) / f"2{ext}", ref / f"2{ext}")
    size = len(want)
    groups = [{"node": b.url, "shards": held, "locality": 1}]
    st, r = h.json(0, "/admin/ec/rebuild",
                   {"volume": 2, "codec": "rs_10_4",
                    "reduced": {"lost": [3], "groups": groups,
                                "shard_size": size}})
    assert st == 200, r
    assert (h.dir(0) / "2.ec03").read_bytes() == want
    assert r["helper_bytes"] == {b.url: size}
    assert a._ec_jobs[2]["kind"] == "rebuild_reduced"
    assert a._ec_jobs[2]["bytes_done"] == a._ec_jobs[2]["total"]

    def fetch(group, sids, coeff, off, n):
        rows = np.stack([np.fromfile(h.dir(1) / f"2.ec{s:02d}",
                                     np.uint8)[off:off + n] for s in sids])
        return ref_gf.gf_matmul(coeff, rows).tobytes()

    with monkeypatch.context() as mp:
        mp.setenv("WEEDTPU_EC_CODEC", "numpy")
        ref_r = ref_ec_files.rebuild_ec_reduced(
            str(ref / "2"), [3], [dict(g, shard_size=size) for g in groups],
            fetch, codec_tag="rs_10_4")
    assert r == json.loads(json.dumps(ref_r))
    assert (ref / "2.ec03").read_bytes() == want
    assert h.json(0, "/admin/ec/mount", {"volume": 2})[0] == 200
    for f, data in blobs.items():
        assert h.call(0, "/" + f)[2] == data


@pytest.mark.parametrize("tag", ["lrc_10_2_2", "rs_10_4"])
def test_rebuild_codec_tag_wins_over_vif_as_reference(harness, monkeypatch,
                                                      tag):
    """The caller's codec tag wins over the `.vif`, in the reference's
    rebuild and the port's: an RS shard set rebuilt under lrc_10_2_2
    decodes with LRC's matrix, and both packages write the same
    (wrong) bytes."""
    h = harness(master=False)
    h.json(0, "/admin/assign_volume", {"volume": 7})
    put_blobs(h, 0, 7, 20, seed=4)
    h.json(0, "/admin/ec/generate", {"volume": 7})
    d = h.dir()
    want = (d / "7.ec03").read_bytes()
    ref = h.tmp / "ref"
    shutil.copytree(d, ref)
    os.remove(d / "7.ec03")
    os.remove(ref / "7.ec03")
    assert json.loads((d / "7.vif").read_text())["codec"] == "rs_10_4"
    st, r = h.json(0, "/admin/ec/rebuild", {"volume": 7, "codec": tag})
    assert (st, r) == (200, {"rebuilt": [3]})
    with monkeypatch.context() as mp:
        mp.setenv("WEEDTPU_EC_CODEC", "numpy")
        assert ref_ec_files.rebuild_ec_files(str(ref / "7"),
                                              codec_tag=tag) == [3]
    got = (d / "7.ec03").read_bytes()
    assert got == (ref / "7.ec03").read_bytes()
    assert (got == want) == (tag == "rs_10_4")
    # the function itself, as the handler calls it
    os.remove(d / "7.ec03")
    assert ec_files.rebuild_ec_files(str(d / "7"), device="cpu",
                                     codec_tag=tag) == [3]
    assert (d / "7.ec03").read_bytes() == got


def test_copy_mount_and_remote_degraded_reads(harness):
    """Two port servers behind the reference master: shards copied from
    A to B through A's /admin/file, split between them; A reads every
    blob, fetching B's shards through B's /admin/ec/shard_read, and
    reconstructs once its own data shards are gone."""
    h = harness(n=2)
    a, b = h.vs
    h.json(0, "/admin/assign_volume", {"volume": 9})
    blobs = put_blobs(h, 0, 9, 30, seed=5)
    h.json(0, "/admin/volume/readonly", {"volume": 9})
    h.json(0, "/admin/ec/generate", {"volume": 9})
    moved = list(range(7, 14))
    assert h.json(1, "/admin/ec/copy",
                  {"volume": 9, "source": a.url, "shards": moved,
                   "copy_ecx": True})[0] == 200
    for i in moved + [None]:
        ext = ".ecx" if i is None else f".ec{i:02d}"
        assert (h.dir(1) / f"9{ext}").read_bytes() == \
            (h.dir(0) / f"9{ext}").read_bytes()
    assert h.json(1, "/admin/ec/mount", {"volume": 9})[1] == \
        {"shards": moved}
    assert h.json(0, "/admin/ec/delete_shards",
                  {"volume": 9, "shards": moved})[0] == 200
    assert h.json(0, "/admin/ec/mount", {"volume": 9})[1] == \
        {"shards": list(range(7))}
    assert h.json(0, "/admin/volume/delete", {"volume": 9})[0] == 200
    # B serves a shard range it holds, and 404s one it does not
    st, _, raw = h.call(1, "/admin/ec/shard_read?volume=9&shard=8"
                           "&offset=0&size=100")
    assert st == 200 and raw == (h.dir(1) / "9.ec08").read_bytes()[:100]
    assert h.call(1, "/admin/ec/shard_read?volume=9&shard=1&offset=0"
                     "&size=100")[0] == 404
    # the beats reached the master: the split is in its EC map
    locs = h.master.topo.to_dict()
    ev = a.store.get_ec_volume(9)
    for f, data in blobs.items():
        assert h.call(0, "/" + f)[2] == data, f
    assert h.json(0, "/admin/ec/delete_shards",
                  {"volume": 9, "shards": [0, 3]})[0] == 200
    for f, data in blobs.items():
        assert h.call(0, "/" + f)[2] == data, f
    stats = ev.read_stats_snapshot()
    assert stats["remote_shard_reads"] > 0, stats
    assert stats["reconstruct_batches"] > 0, stats
    assert locs["nodes"]


def test_file_pull_guards(harness):
    h = harness(master=False)
    h.json(0, "/admin/assign_volume", {"volume": 1})
    h.call(0, "/" + fid(1, 1), data=b"abc", method="PUT")
    assert h.call(0, "/admin/file?name=../x.dat")[0] == 400
    assert h.call(0, "/admin/file?name=1.txt")[0] == 400
    assert h.call(0, "/admin/file?name=2.dat")[0] == 404
    st, _, body = h.call(0, "/admin/file?name=1.dat")
    assert st == 200 and body == (h.dir() / "1.dat").read_bytes()


# ---- volume admin -------------------------------------------------------

def test_volume_admin_routes(harness):
    h = harness(master=False)
    v = h.vs[0]
    h.json(0, "/admin/assign_volume", {"volume": 11})
    h.call(0, "/" + fid(11, 1), data=b"a" * 3000, method="PUT")
    h.call(0, "/" + fid(11, 2), data=b"b" * 3000, method="PUT")
    h.call(0, "/" + fid(11, 1), method="DELETE")
    st, r = h.json(0, "/admin/volume/configure_replication",
                   {"volume": 11, "replication": "001"})
    assert (st, r) == (200, {"replication": "001"})
    assert h.json(0, "/admin/volume/configure_replication",
                  {"volume": 11, "replication": "9x"})[0] == 400
    assert h.json(0, "/admin/volume/configure_replication",
                  {"volume": 12})[0] == 404
    st, r = h.json(0, "/admin/volume/vacuum", {"volume": 11})
    assert st == 200 and r["garbage_ratio"] > 0
    assert h.call(0, "/" + fid(11, 2))[2] == b"b" * 3000
    assert h.json(0, "/admin/volume/unmount", {"volume": 11})[0] == 200
    assert h.call(0, "/" + fid(11, 2))[0] == 404
    assert h.json(0, "/admin/volume/unmount", {"volume": 11})[0] == 404
    assert h.json(0, "/admin/volume/mount", {"volume": 11})[0] == 200
    assert h.call(0, "/" + fid(11, 2))[2] == b"b" * 3000
    assert h.json(0, "/admin/volume/mount", {"volume": 12})[0] == 404
    st, status = h.json(0, "/status")
    assert status == json.loads(json.dumps(v.store.collect_heartbeat()))
    assert status["volumes"][0]["replica_placement"] == "001"
    st, _, page = h.call(0, "/")
    assert st == 200 and b"weedtpu volume server" in page
    assert h.json(0, "/admin/leave", {})[1] == {"ok": True}
    assert v._hb_task is None and v._left


def test_ui_lists_ec_shards(harness):
    h = harness(master=False)
    h.json(0, "/admin/assign_volume", {"volume": 13})
    put_blobs(h, 0, 13, 3, seed=6)
    h.json(0, "/admin/ec/generate", {"volume": 13})
    h.json(0, "/admin/ec/mount", {"volume": 13})
    page = h.call(0, "/")[2].decode()
    assert " ".join(str(i) for i in range(14)) in page


def test_route_table_equals_reference(tmp_path, monkeypatch):
    """Every (method, path) of the reference volume server's route table
    (seaweedfs_tpu/server/volume_server.py:136-181) is a route of the
    port's, and the port has no other."""
    from seaweedfs_tpu.server.volume_server import VolumeServer as RefVS

    def table(app):
        return sorted({(r.method, r.resource.canonical)
                       for r in app.router.routes()})
    port = vsmod.VolumeServer([str(tmp_path / "p")], "127.0.0.1:1",
                              device="cpu")
    with monkeypatch.context() as m:
        m.setenv("WEEDTPU_EC_CODEC", "numpy")
        ref = RefVS([str(tmp_path / "r")], "127.0.0.1:1")
    try:
        got, want = table(port.app), table(ref.app)
        assert got == want
        assert ("POST", "/admin/volume/move") in got
        assert ("GET", "/debug/pprof") in got and ("GET", "/heat") in got
    finally:
        port.store.close()
        ref.store.close()


def test_metrics_count_blob_requests(harness):
    h = harness(master=False)
    h.json(0, "/admin/assign_volume", {"volume": 14})

    def counts():
        c = metrics.VOLUME_REQUEST_COUNTER
        return {t: c.labels(t).value for t in ("read", "write", "delete")}

    before = counts()
    for k in range(1, 4):
        h.call(0, "/" + fid(14, k), data=b"x" * k, method="PUT")
    for k in range(1, 4):
        h.call(0, "/" + fid(14, k))
    h.call(0, "/" + fid(14, 1), method="HEAD")
    h.call(0, "/" + fid(14, 2), method="DELETE")
    after = counts()
    assert {k: after[k] - before[k] for k in after} == \
        {"read": 4, "write": 3, "delete": 1}
    st, hd, text = h.call(0, "/metrics")
    assert st == 200 and hd["Content-Type"].startswith("text/plain")
    for name in ("weedtpu_volume_request_total",
                 "weedtpu_volume_request_seconds_bucket",
                 "weedtpu_http_requests_total", "weedtpu_disk_bytes",
                 "weedtpu_volume_size_bytes", "weedtpu_volumes"):
        assert name.encode() in text, name
    st, hd, text = h.call(0, "/metrics", headers={
        "Accept": "application/openmetrics-text"})
    assert hd["Content-Type"].startswith("application/openmetrics-text")
    assert text.endswith(b"# EOF\n")


# ---- heartbeats ---------------------------------------------------------

def _stub_master(beats: list, pb_status: int = 200):
    """A master stand-in: records each beat as (content type, dict)."""
    from aiohttp import web

    async def heartbeat(req):
        raw = await req.read()
        ctype = req.headers.get("Content-Type", "")
        if ctype == ref_pb.CONTENT_TYPE:
            if pb_status != 200:
                return web.json_response({"error": "json only"},
                                         status=pb_status)
            beats.append((ctype, ref_pb.heartbeat_from_bytes(raw), raw))
        else:
            beats.append((ctype, json.loads(raw), raw))
        return web.json_response({"volume_size_limit": 123456})

    app = web.Application()
    app.add_routes([web.post("/heartbeat", heartbeat)])
    return app


def test_heartbeat_rides_protobuf_equal_to_reference_bytes(harness):
    beats: list = []
    h = harness(master_app=_stub_master(beats))
    v = h.vs[0]
    h.json(0, "/admin/assign_volume", {"volume": 21})
    h.json(0, "/admin/volume/readonly", {"volume": 21})
    assert v._wire_pb is True and v.volume_size_limit == 123456
    ctype, beat, raw = beats[-1]
    assert ctype == pb.CONTENT_TYPE
    assert beat["id"] == v.url and beat["volumes"][0]["id"] == 21
    # the bytes on the wire are the reference's framing of that beat
    assert raw == ref_pb.heartbeat_to_bytes(beat)
    assert raw == pb.heartbeat_to_bytes(beat)


def test_heartbeat_415_latches_json(harness):
    beats: list = []
    h = harness(master_app=_stub_master(beats, pb_status=415))
    v = h.vs[0]
    assert v._wire_pb is False
    h.json(0, "/admin/assign_volume", {"volume": 22})
    h.json(0, "/admin/volume/readonly", {"volume": 22})
    assert beats and all(c == "application/json" for c, _, _ in beats)
    assert beats[-1][1]["volumes"][0]["id"] == 22


def test_wire_json_when_forced(harness, monkeypatch):
    monkeypatch.setenv("WEEDTPU_WIRE", "json")
    beats: list = []
    h = harness(master_app=_stub_master(beats))
    assert h.vs[0]._wire_pb is False
    assert beats and beats[0][0] == "application/json"


# ---- one-write responses ------------------------------------------------

def test_small_reads_go_out_in_one_write(harness):
    h = harness(master=False)
    h.json(0, "/admin/assign_volume", {"volume": 23})
    h.call(0, "/" + fid(23, 1), data=b"one write", method="PUT")
    before = dict(vsmod.ONE_SHOT)
    assert h.call(0, "/" + fid(23, 1))[2] == b"one write"
    assert vsmod.ONE_SHOT["one_write"] == before["one_write"] + 1
    assert vsmod.ONE_SHOT["stock"] == before["stock"]


# ---- the trace middleware -----------------------------------------------

def test_middleware_equals_reference():
    """The port's middleware and the reference's, each on an app of its
    own, on the same requests: the in-flight registry during a handler,
    the root span continuing the caller's trace, the request counter,
    and the deadline's 504."""
    from aiohttp import web
    from seaweedfs_tpu.stats import metrics as ref_metrics
    from seaweedfs_tpu.stats import trace as ref_trace
    from seaweedfs_tpu_torch.stats import trace

    loop = asyncio.new_event_loop()
    loop_thread = threading.Thread(target=loop.run_forever, daemon=True)
    loop_thread.start()

    def run(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(60)

    def app_for(mod):
        async def fast(req):
            return web.json_response({"inflight": [
                {k: r[k] for k in ("method", "path", "trace_id")}
                for r in mod.inflight()]})

        async def slow(req):
            await asyncio.sleep(2)
            return web.json_response({})

        app = web.Application(middlewares=[mod.aiohttp_middleware("volume")])
        app.add_routes([web.get("/fast", fast), web.get("/slow", slow)])
        return app

    runners, urls = [], []
    for mod in (trace, ref_trace):
        r = web.AppRunner(app_for(mod))
        run(r.setup())
        port = free_port()
        run(web.TCPSite(r, "127.0.0.1", port).start())
        runners.append(r)
        urls.append(f"http://127.0.0.1:{port}")
    tid, parent = "ab" * 16, "cd" * 8
    got = []
    try:
        for mod, reg, url in ((trace, metrics.REGISTRY, urls[0]),
                              (ref_trace, ref_metrics.REGISTRY, urls[1])):
            mod.reset_ring()
            c = reg.counter("weedtpu_http_requests_total", "",
                            ("server", "op", "class"))
            ok0 = c.labels("volume", "read", "2xx").value
            late0 = c.labels("volume", "read", "5xx").value
            req = urllib.request.Request(
                url + "/fast?x=1",
                headers={mod.TRACE_HEADER: f"{tid}-{parent}-1"})
            with urllib.request.urlopen(req, timeout=30) as r:
                body = json.loads(r.read())
            req = urllib.request.Request(
                url + "/slow", headers={"X-Weedtpu-Deadline": "200"})
            t0 = time.perf_counter()
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(req, timeout=30)
            waited = time.perf_counter() - t0
            err = json.loads(ei.value.read())
            spans = [{k: s.get(k) for k in ("name", "trace", "parent",
                                             "attrs")}
                     for s in mod.ring_snapshot()]
            got.append({"inflight": body["inflight"], "code": ei.value.code,
                        "err": err, "fast_span": spans[0],
                        "ok": c.labels("volume", "read", "2xx").value - ok0,
                        "late": c.labels("volume", "read", "5xx").value
                        - late0, "quick": waited < 1.5})
    finally:
        for r in runners:
            run(r.cleanup())
        loop.call_soon_threadsafe(loop.stop)
        loop_thread.join(5)
        loop.close()
    assert got[0] == got[1]
    assert got[0]["inflight"] == [{"method": "GET", "path": "/fast?x=1",
                                   "trace_id": tid}]
    assert got[0]["fast_span"]["parent"] == parent
    assert (got[0]["code"], got[0]["ok"], got[0]["late"]) == (504, 1, 1)
    assert got[0]["quick"]


def test_trace_config_forwards_headers_as_reference():
    """A hop made inside a request handler through a session that mounts
    `aiohttp_trace_config` carries the caller's trace (under a send span),
    its traffic class and tenant, the caller's role and the remaining
    deadline, as the reference's does."""
    from aiohttp import ClientSession, web
    from seaweedfs_tpu.stats import trace as ref_trace
    from seaweedfs_tpu.utils import http as ref_http
    from seaweedfs_tpu_torch.stats import trace
    from seaweedfs_tpu_torch.utils import http

    loop = asyncio.new_event_loop()
    loop_thread = threading.Thread(target=loop.run_forever, daemon=True)
    loop_thread.start()

    def run(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(60)

    async def echo(req):
        return web.json_response({k: v for k, v in req.headers.items()
                                  if k.lower().startswith("x-weedtpu")})

    def front(mod, httpmod, back_url):
        async def hop(req):
            async with ClientSession(trace_configs=[
                    httpmod.aiohttp_trace_config("volume")]) as s:
                async with s.get(back_url + "/echo") as r:
                    return web.json_response(await r.json())
        app = web.Application(middlewares=[mod.aiohttp_middleware("volume")])
        app.add_routes([web.get("/hop", hop)])
        return app

    runners = []

    def serve(app):
        r = web.AppRunner(app)
        run(r.setup())
        port = free_port()
        run(web.TCPSite(r, "127.0.0.1", port).start())
        runners.append(r)
        return f"http://127.0.0.1:{port}"

    back = web.Application()
    back.add_routes([web.get("/echo", echo)])
    back_url = serve(back)
    tid = "ef" * 16
    got = []
    try:
        for mod, httpmod in ((trace, http), (ref_trace, ref_http)):
            url = serve(front(mod, httpmod, back_url))
            req = urllib.request.Request(url + "/hop", headers={
                mod.TRACE_HEADER: f"{tid}-{'12' * 8}-1",
                "X-Weedtpu-Class": "repair", "X-Weedtpu-Tenant": "acme",
                "X-Weedtpu-Deadline": "30000"})
            with urllib.request.urlopen(req, timeout=30) as r:
                seen = json.loads(r.read())
            t_id, span, sampled = seen.pop("X-Weedtpu-Trace").split("-")
            assert (t_id, sampled) == (tid, "1") and span != "12" * 8
            assert 0 < int(seen.pop("X-Weedtpu-Deadline")) <= 30000
            got.append(seen)
    finally:
        for r in runners:
            run(r.cleanup())
        loop.call_soon_threadsafe(loop.stop)
        loop_thread.join(5)
        loop.close()
    assert got[0] == got[1] == {"X-Weedtpu-Class": "repair",
                                "X-Weedtpu-Role": "volume",
                                "X-Weedtpu-Tenant": "acme"}


# ---- the maintenance routes need no JAX ---------------------------------

MAINTENANCE_WITHOUT_JAX = r"""
import asyncio, json, os, socket, sys, threading, urllib.request
from aiohttp import web
from seaweedfs_tpu_torch.server import volume_server as vsmod
d = sys.argv[1]
loop = asyncio.new_event_loop()
threading.Thread(target=loop.run_forever, daemon=True).start()
def run(coro):
    return asyncio.run_coroutine_threadsafe(coro, loop).result(120)
async def ok(req):
    await req.read()
    return web.json_response({})
app = web.Application()
app.add_routes([web.post("/heartbeat", ok),
                web.post("/maintenance/scrub_report", ok)])
runner = web.AppRunner(app)
run(runner.setup())
run(web.TCPSite(runner, "127.0.0.1", 0).start())
master = "127.0.0.1:%d" % runner.addresses[0][1]
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
vs = vsmod.VolumeServer([d], master, "127.0.0.1", port, device="cpu")
run(vs.start())
def call(path, body=None, data=None, method="POST"):
    if body is not None:
        data = json.dumps(body).encode()
    req = urllib.request.Request("http://%s%s" % (vs.url, path), data=data,
                                 method=method)
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.read()
call("/admin/assign_volume", {"volume": 1})
for k in range(1, 9):
    call("/1,%x1234abcd" % k, data=os.urandom(3000 * k), method="PUT")
fleet = json.loads(call("/admin/ec/fleet_convert", {"volumes": [1]}))
call("/admin/ec/mount", {"volume": 1})
scrubbed = json.loads(call("/admin/scrub", {}))
partial = call("/admin/ec/partial", {"volume": 1, "shards": [0, 11],
                                    "offset": 0, "size": 512,
                                    "coeff": [[3, 7]]})
net = json.loads(call("/admin/faults", {"faults": [
    {"action": "partition", "a": "volume", "b": "x"},
    {"action": "clear_net"}]}))
thawed = json.loads(call("/admin/volume/unconvert", {"volume": 1}))
rest = [len(call(p, method="GET")) > 0 for p in
        ("/heat", "/perf", "/debug/traces", "/debug/pprof?seconds=0.1",
         "/admin/volume/needles?volume=1")]
run(vs.stop())
run(runner.cleanup())
print(json.dumps({
    "fleet": fleet["converted"],
    "scrub": scrubbed["volumes"]["1"]["kind"],
    "partial": len(partial), "net": [a["ok"] for a in net["applied"]],
    "thawed": thawed["thawed"], "rest": rest,
    "jax": "jax" in sys.modules,
    "reference": [m for m in sys.modules
                  if m.split(".")[0] == "seaweedfs_tpu"]}))
"""


def test_maintenance_routes_leave_jax_unloaded(tmp_path):
    """A fleet conversion, a scrub, a partial, network faults, an
    unconvert and the telemetry routes through a port server in a fresh
    interpreter: neither jax nor the reference package gets imported."""
    import subprocess
    import sys
    env = dict(os.environ)
    env.pop("WEEDTPU_EC_CODEC", None)
    r = subprocess.run([sys.executable, "-c", MAINTENANCE_WITHOUT_JAX,
                        str(tmp_path)], cwd=str(REPO), env=env,
                       capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got == {"fleet": [1], "scrub": "ec", "partial": 512,
                   "net": [True, True], "thawed": True,
                   "rest": [True] * 5, "jax": False, "reference": []}
