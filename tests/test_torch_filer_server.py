"""The port's filer server (`seaweedfs_tpu_torch/server/filer_server.py`)
on port clusters: the port's master, port volume servers
(`device="cpu"`) and the port's `FilerServer`, in process on one asyncio
loop in a thread with real sockets, driven over HTTP like an external
client.

- Twins of tests/test_filer_server.py (all ten), of the filer tests of
  tests/test_read_engine.py (the two singleflight cases and the
  readahead case with its parametrisation), of
  tests/test_meta_aggregator.py and of the filer tests of
  tests/test_aux.py (the sealed and gzipped round trip, the chunk cache
  on reads).
- The shared flights strip their starter's deadline: a joiner does not
  inherit a budget that ran out (both packages, both tables).
- What came back with the server, held to the reference's on the same
  calls: the mutations' `signatures`, the meta log's listeners,
  `head_ts` and `backlog_count`, `total_size`, `file_size_from_visibles`,
  `has_chunk_manifest` and `parse_remote_spec`; a `local:` remote mount
  read through a placeholder entry.
- The CLI's `filer` as a subprocess: it serves a PUT and a GET and loads
  neither jax, torch nor the reference package.
- A filer with a live `/__meta__/subscribe` stream stops at once, not at
  the stream's next keepalive as the reference's does.
"""

import asyncio
import json
import os
import pathlib
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

from seaweedfs_tpu.server import filer_server as ref_filer_server
from seaweedfs_tpu.utils import resilience as ref_resilience

from seaweedfs_tpu_torch.client import WeedClient
from seaweedfs_tpu_torch.filer.entry import FileChunk
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.utils import resilience
from tests.test_torch_master_cluster import Cluster, free_port

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _quiet_cluster(monkeypatch):
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "0")
    monkeypatch.setenv("WEEDTPU_REPAIR_INTERVAL", "0")


class FilerCluster(Cluster):
    """The port's master, its volume servers and one port `FilerServer`
    (`filer_kw` its keywords) on the cluster's loop."""

    def __init__(self, tmp_path, filer_kw=None, **kw):
        super().__init__(tmp_path, **kw)
        self.filer_kw = {"chunk_size": 256 * 1024} \
            if filer_kw is None else filer_kw
        self.filer = None

    def start(self):
        super().start()
        self.filer = FilerServer(self.master.url, "127.0.0.1", free_port(),
                                 **self.filer_kw)
        self.submit(self.filer.start())
        return self

    def stop(self):
        self.submit(self.filer.stop())
        super().stop()


@pytest.fixture()
def fcluster(tmp_path):
    c = FilerCluster(tmp_path).start()
    c.wait_heartbeats()
    yield c
    c.stop()


def _req(url, data=None, method=None, headers=None):
    req = urllib.request.Request(f"http://{url}", data=data,
                                 method=method, headers=headers or {})
    return urllib.request.urlopen(req, timeout=30)


def _put(url, data, headers=None):
    with _req(url, data=data, method="PUT", headers=headers) as r:
        return json.loads(r.read() or b"{}")


def _get(url, headers=None):
    with _req(url, headers=headers) as r:
        return r.read()


# ---- twins of tests/test_filer_server.py -----------------------------------

def test_filer_small_file_roundtrip(fcluster):
    f = fcluster.filer.url
    out = _put(f"{f}/dir/hello.txt", b"hello filer",
               headers={"Content-Type": "text/plain"})
    assert out["size"] == 11
    assert _get(f"{f}/dir/hello.txt") == b"hello filer"
    with _req(f"{f}/dir/hello.txt") as r:
        assert r.headers["Content-Type"] == "text/plain"
        assert "ETag" in r.headers


def test_filer_multichunk_file_and_range(fcluster):
    f = fcluster.filer.url
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, 1_000_000, dtype=np.uint8).tobytes()
    _put(f"{f}/big.bin", data)
    entry = json.loads(_get(f"{f}/big.bin?metadata=true"))
    assert len(entry["chunks"]) == 4
    assert _get(f"{f}/big.bin") == data
    with _req(f"{f}/big.bin", headers={"Range": "bytes=262000-524399"}) as r:
        assert r.status == 206
        assert r.read() == data[262000:524400]
    with _req(f"{f}/big.bin", headers={"Range": "bytes=-100"}) as r:
        assert r.read() == data[-100:]
    with _req(f"{f}/big.bin", method="HEAD") as r:
        assert int(r.headers["Content-Length"]) == len(data)


def test_filer_listing_and_pagination(fcluster):
    f = fcluster.filer.url
    for i in range(7):
        _put(f"{f}/list/f{i:02d}.txt", b"x")
    listing = json.loads(_get(f"{f}/list/?limit=5"))
    assert [e["FullPath"] for e in listing["Entries"]] == \
        [f"/list/f{i:02d}.txt" for i in range(5)]
    assert listing["ShouldDisplayLoadMore"] is True
    page2 = json.loads(_get(
        f"{f}/list/?limit=5&lastFileName={listing['LastFileName']}"))
    assert len(page2["Entries"]) == 2
    assert page2["ShouldDisplayLoadMore"] is False


def test_filer_delete_and_recursive(fcluster):
    f = fcluster.filer.url
    _put(f"{f}/rm/a.txt", b"a")
    _put(f"{f}/rm/sub/b.txt", b"b")
    with pytest.raises(urllib.error.HTTPError) as ei:
        _req(f"{f}/rm/", method="DELETE").close()
    assert ei.value.code == 409
    _req(f"{f}/rm/?recursive=true", method="DELETE").close()
    with pytest.raises(urllib.error.HTTPError):
        _get(f"{f}/rm/a.txt")
    assert fcluster.filer.deletion.wait_empty(5)


def test_filer_rename(fcluster):
    f = fcluster.filer.url
    _put(f"{f}/mv/src/data.bin", bytes(range(100)))
    with _req(f"{f}/mv/dst?mv.from=/mv/src", data=b"",
              method="POST") as r:
        assert r.status == 200
    assert _get(f"{f}/mv/dst/data.bin") == bytes(range(100))
    with pytest.raises(urllib.error.HTTPError):
        _get(f"{f}/mv/src/data.bin")


def test_filer_extended_attrs_roundtrip(fcluster):
    f = fcluster.filer.url
    _put(f"{f}/x.txt", b"x", headers={"Seaweed-Owner": "alice"})
    with _req(f"{f}/x.txt") as r:
        assert r.headers["Seaweed-Owner"] == "alice"


def test_filer_overwrite_gcs_old_chunks(fcluster):
    f = fcluster.filer.url
    _put(f"{f}/ow.bin", b"version one")
    old = json.loads(_get(f"{f}/ow.bin?metadata=true"))
    _put(f"{f}/ow.bin", b"version two!")
    assert _get(f"{f}/ow.bin") == b"version two!"
    assert fcluster.filer.deletion.wait_empty(5)
    # the queue empties when its worker takes the batch, before the
    # delete lands: wait for the count too
    deadline = time.time() + 5
    while fcluster.filer.deletion.deleted_count < 1 and \
            time.time() < deadline:
        time.sleep(0.02)
    assert fcluster.filer.deletion.deleted_count == 1
    old_fid = old["chunks"][0]["fid"]
    with pytest.raises(RuntimeError):
        WeedClient(fcluster.master.url).download(old_fid)


def test_meta_subscribe_replay(fcluster):
    f = fcluster.filer.url
    t0 = time.time_ns()
    _put(f"{f}/sub/a.txt", b"a")
    _req(f"{f}/sub/a.txt", method="DELETE").close()
    raw = _get(f"{f}/__meta__/subscribe?since={t0}&live=false")
    events = [json.loads(line) for line in raw.splitlines() if line]
    paths = [(e["new_entry"] or e["old_entry"])["full_path"] for e in events]
    assert paths == ["/sub", "/sub/a.txt", "/sub/a.txt"]
    assert events[-1]["new_entry"] is None


def test_filer_conf_rules_applied(fcluster):
    f = fcluster.filer.url
    with _req(f"{f}/__admin__/filer_conf",
              data=json.dumps({"location_prefix": "/locked/",
                               "read_only": True}).encode(),
              method="POST",
              headers={"Content-Type": "application/json"}) as r:
        assert r.status == 200
    with pytest.raises(urllib.error.HTTPError) as ei:
        _put(f"{f}/locked/no.txt", b"denied")
    assert ei.value.code == 403


def test_empty_file(fcluster):
    f = fcluster.filer.url
    _put(f"{f}/empty.txt", b"")
    assert _get(f"{f}/empty.txt") == b""
    entry = json.loads(_get(f"{f}/empty.txt?metadata=true"))
    assert entry["chunks"] == []


# ---- twins of tests/test_read_engine.py's filer cases ----------------------

def _mk_filer():
    return FilerServer("127.0.0.1:0")


def test_singleflight_collapses_concurrent_fetches():
    fs = _mk_filer()
    calls = []

    async def fake_once(v, cache):
        calls.append(v.fid)
        await asyncio.sleep(0.02)
        return b"x" * 64

    fs._load_chunk_once = fake_once
    view = SimpleNamespace(fid="1,ab", cipher_key=b"", is_compressed=False)

    async def main():
        res = await asyncio.gather(
            *[fs._load_chunk_view(view, True) for _ in range(8)])
        assert all(r == b"x" * 64 for r in res)

    asyncio.run(main())
    assert len(calls) == 1, calls
    assert not fs._chunk_flight


def test_singleflight_does_not_cache_failures():
    fs = _mk_filer()
    state = {"n": 0}

    async def flaky_once(v, cache):
        state["n"] += 1
        if state["n"] == 1:
            raise IOError("upstream died")
        return b"ok"

    fs._load_chunk_once = flaky_once
    view = SimpleNamespace(fid="1,cd", cipher_key=b"", is_compressed=False)

    async def main():
        with pytest.raises(IOError):
            await fs._load_chunk_view(view, True)
        assert await fs._load_chunk_view(view, True) == b"ok"

    asyncio.run(main())
    assert state["n"] == 2


class _Sink:
    def __init__(self):
        self.buf = bytearray()

    async def write(self, b: bytes) -> None:
        self.buf += b


@pytest.mark.parametrize("depth", ["0", "3"])
def test_readahead_preserves_order_with_sparse_gaps(monkeypatch, depth):
    """Ranged reads over a sparse chunk list produce identical bytes
    through the serial loop and the readahead pipeline: in-order writes,
    zero-filled gaps, zero-filled tail."""
    fs = _mk_filer()
    data = {f"1,{i:02x}": bytes([65 + i]) * 1000 for i in range(5)}
    chunks = [
        FileChunk(fid="1,00", offset=0, size=1000, mtime=1),
        FileChunk(fid="1,01", offset=1000, size=1000, mtime=1),
        FileChunk(fid="1,02", offset=3000, size=1000, mtime=1),
        FileChunk(fid="1,03", offset=4500, size=1000, mtime=1),
    ]

    async def fake_fetch(fid, cache=True):
        await asyncio.sleep(0.001 * ((hash(fid) % 3) + 1))
        return data[fid]

    fs._fetch_chunk = fake_fetch
    monkeypatch.setenv("WEEDTPU_READAHEAD", depth)
    offset, length = 500, 5500
    expected = (data["1,00"][500:] + data["1,01"]
                + b"\x00" * 1000 + data["1,02"]
                + b"\x00" * 500 + data["1,03"]
                + b"\x00" * 500)
    sink = _Sink()
    asyncio.run(fs._stream_range(sink, chunks, offset, length))
    assert bytes(sink.buf) == expected


# ---- the shared flights strip their starter's deadline ----------------------

@pytest.mark.parametrize("table", ["view", "blob"])
@pytest.mark.parametrize("package", ["reference", "port"])
def test_joiner_does_not_inherit_a_spent_deadline(package, table):
    """A flight is shared by every concurrent demand of its chunk, so it
    runs without the deadline of the request that started it: a starter
    whose budget ran out does not hand its joiners a 504.  The fetch sees
    no deadline, both callers get the bytes, and the volume tier is asked
    once."""
    mod, res = (ref_filer_server, ref_resilience) \
        if package == "reference" else \
        (sys.modules[FilerServer.__module__], resilience)
    fs = mod.FilerServer("127.0.0.1:0")
    seen = []

    async def fetch(*_):
        seen.append(res.deadline())
        await asyncio.sleep(0.02)
        return b"ok"

    view = SimpleNamespace(fid="1,ef", cipher_key=b"", is_compressed=False)
    if table == "view":
        fs._load_chunk_once = fetch
        demand = lambda: fs._load_chunk_view(view, True)  # noqa: E731
    else:
        fs._fetch_chunk_direct = fetch
        demand = lambda: fs._fetch_chunk_stored(  # noqa: E731
            "1,ef", None, True)

    async def starter():
        tok = res.set_deadline(time.monotonic() - 1.0)
        try:
            return await demand()
        finally:
            res.reset_deadline(tok)

    async def joiner():
        await asyncio.sleep(0.005)
        return await demand()

    async def main():
        return await asyncio.gather(starter(), joiner())

    assert asyncio.run(main()) == [b"ok", b"ok"]
    assert seen == [None]
    assert fs.hot_stats["direct"] == (1 if table == "blob" else 0)


# ---- twin of tests/test_meta_aggregator.py ---------------------------------

def test_peer_events_merged_into_feed(tmp_path):
    c = Cluster(tmp_path, n_volume_servers=1).start()
    c.wait_heartbeats()
    fa = FilerServer(c.master.url, port=free_port(), aggregate_peers=True)
    fb = FilerServer(c.master.url, port=free_port(), aggregate_peers=True)
    c.submit(fa.start())
    c.submit(fb.start())
    try:
        deadline = time.time() + 30
        while time.time() < deadline:
            if fa._peer_tasks and fb._peer_tasks:
                break
            time.sleep(0.2)
        assert fa._peer_tasks and fb._peer_tasks, "aggregators not wired"
        got: list[dict] = []

        def consume():
            url = (f"http://{fa.url}/__meta__/subscribe?"
                   f"since={time.time_ns()}&live=true")
            with urllib.request.urlopen(url, timeout=30) as r:
                for raw in r:
                    line = raw.strip()
                    if not line:
                        continue
                    ev = json.loads(line)
                    got.append(ev)
                    if (ev.get("new_entry") or {}).get("full_path") \
                            == "/agg/x.txt":
                        return

        th = threading.Thread(target=consume, daemon=True)
        th.start()
        time.sleep(0.5)
        urllib.request.urlopen(urllib.request.Request(
            f"http://{fb.url}/agg/x.txt", data=b"via-b", method="POST"),
            timeout=15)
        th.join(20)
        assert got, "no aggregated event arrived on A's feed"
        paths = [(e.get("new_entry") or {}).get("full_path") for e in got]
        assert "/agg/x.txt" in paths
        ev = next(e for e in got
                  if (e.get("new_entry") or {}).get("full_path")
                  == "/agg/x.txt")
        assert ev.get("signatures"), ev
    finally:
        c.submit(fa.stop())
        c.submit(fb.stop())
        c.stop()


# ---- twins of tests/test_aux.py's filer cases -------------------------------

@pytest.fixture()
def filer_stack(tmp_path):
    c = FilerCluster(tmp_path, filer_kw={"encrypt_data": True},
                     n_volume_servers=1).start()
    c.wait_heartbeats()
    yield c, c.filer
    c.stop()


def _post(url, path, data, ctype="application/octet-stream"):
    req = urllib.request.Request(f"http://{url}{path}", data=data,
                                 method="POST",
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status


def _read(url, path, headers=None):
    req = urllib.request.Request(f"http://{url}{path}",
                                 headers=headers or {})
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.read()


def test_encrypted_compressed_roundtrip(filer_stack):
    """With encrypt_data on, chunks land sealed on the volume server but
    reads return plaintext; compressible text also gzips."""
    c, f = filer_stack
    text = (b"compress me " * 4000)
    assert _post(f.url, "/enc/t.txt", text, "text/plain") in (200, 201)
    assert _read(f.url, "/enc/t.txt") == text
    assert _read(f.url, "/enc/t.txt",
                 headers={"Range": "bytes=12-23"}) == text[12:24]
    meta = json.loads(_read(f.url, "/enc/t.txt?metadata=true"))
    ck = meta["chunks"][0]
    assert ck["cipher_key"] and ck.get("is_compressed")
    assert ck["size"] == len(text)
    blob = WeedClient(c.master.url).download(ck["fid"])
    assert text[:50] not in blob
    assert len(blob) < len(text)
    rnd = os.urandom(10000)
    _post(f.url, "/enc/b.bin", rnd)
    assert _read(f.url, "/enc/b.bin") == rnd
    meta = json.loads(_read(f.url, "/enc/b.bin?metadata=true"))
    assert meta["chunks"][0]["cipher_key"]
    assert not meta["chunks"][0].get("is_compressed")


def test_chunk_cache_on_filer_reads(filer_stack):
    c, f = filer_stack
    _post(f.url, "/cc/x.bin", b"cache me" * 100)
    assert _read(f.url, "/cc/x.bin") == b"cache me" * 100
    before = f.chunk_cache.hits
    assert _read(f.url, "/cc/x.bin") == b"cache me" * 100
    assert f.chunk_cache.hits > before


# ---- what came back with the filer server ------------------------------------

def test_restored_filer_calls_equal_the_reference(tmp_path):
    """The mutations' `signatures`, the meta log's listeners, `head_ts`
    and `backlog_count`, `total_size`, `file_size_from_visibles` and
    `has_chunk_manifest`, on the same calls in both packages: the same
    events (their `ts_ns` aside), counts and sizes."""
    from seaweedfs_tpu.filer import filechunk_manifest as ref_fcm
    from seaweedfs_tpu.filer import filechunks as ref_fc
    from seaweedfs_tpu.filer.entry import Entry as RefEntry
    from seaweedfs_tpu.filer.entry import FileChunk as RefChunk
    from seaweedfs_tpu.filer.filer import Filer as RefFiler
    from seaweedfs_tpu.filer.filerstore import MemoryStore as RefMemory

    from seaweedfs_tpu_torch.filer import filechunk_manifest as fcm
    from seaweedfs_tpu_torch.filer import filechunks as fc
    from seaweedfs_tpu_torch.filer.entry import Entry
    from seaweedfs_tpu_torch.filer.filer import Filer
    from seaweedfs_tpu_torch.filer.filerstore import MemoryStore

    rng = np.random.default_rng(9)
    raw = [{"fid": f"3,{i:x}", "offset": int(rng.integers(0, 5000)),
            "size": int(rng.integers(1, 3000)), "mtime": i,
            "is_chunk_manifest": bool(i == 4)} for i in range(1, 9)]
    seen = []
    for (filer_cls, store_cls, entry_cls, chunk_cls, chunks_mod,
         manifest_mod) in ((RefFiler, RefMemory, RefEntry, RefChunk, ref_fc,
                            ref_fcm),
                           (Filer, MemoryStore, Entry, FileChunk, fc, fcm)):
        chunks = [chunk_cls.from_dict(d) for d in raw]
        f = filer_cls(store_cls())
        heard = []
        f.meta_log.subscribe(heard.append)
        f.create_entry(entry_cls.from_dict(
            {"full_path": "/s/a/x", "chunks": raw[:3]}), signatures=[7])
        t_mid = f.meta_log.head_ts()
        f.link_entry("/s/a/x", "/s/b/y", signatures=[8, 9])
        f.meta_log.unsubscribe(heard.append)
        f.delete_entry("/s/b/y", signatures=[10])
        seen.append({
            "heard": [dict(e.to_dict(), ts_ns=0) for e in heard],
            "replayed": [dict(e.to_dict(), ts_ns=0)
                         for e in f.meta_log.replay(0)],
            "backlog": [f.meta_log.backlog_count(0),
                        f.meta_log.backlog_count(t_mid),
                        f.meta_log.backlog_count(0, "/s/b")],
            "head_after": f.meta_log.head_ts() > t_mid,
            "total": chunks_mod.total_size(chunks),
            "visible": chunks_mod.file_size_from_visibles(
                chunks_mod.non_overlapping_visible_intervals(chunks)),
            "empty": (chunks_mod.total_size([]),
                      chunks_mod.file_size_from_visibles([])),
            "manifest": (manifest_mod.has_chunk_manifest(chunks),
                         manifest_mod.has_chunk_manifest(chunks[:3]))})
    for d in seen:
        for e in d["heard"] + d["replayed"]:
            for side in ("old_entry", "new_entry"):
                if e[side]:
                    e[side]["attr"]["mtime"] = e[side]["attr"]["crtime"] = 0
                    e[side].pop("hard_link_id", None)
    assert seen[0] == seen[1]
    assert [e["signatures"] for e in seen[1]["heard"]] == \
        [[7], [7], [7], [8, 9], [8, 9], [8, 9]]
    assert seen[1]["manifest"] == (True, False)


@pytest.mark.parametrize("spec", [
    "local:/cold", "local:", "", "s3:endpoint=127.0.0.1:8333,bucket=tier,"
    "access_key=K,secret_key=S", "gcs:bucket=b,,project = p",
    "azure:account=a,key=k=v"])
def test_parse_remote_spec_equals_the_reference(spec):
    from seaweedfs_tpu import remote_storage as ref_remote

    from seaweedfs_tpu_torch import remote_storage
    assert remote_storage.parse_remote_spec(spec) == \
        ref_remote.parse_remote_spec(spec)


def test_remote_mount_reads_through_a_local_placeholder(fcluster, tmp_path):
    """/__admin__/remote_mounts maps a directory to `local:<dir>`; a
    chunkless placeholder entry under it (remote-placeholder, -key,
    -size) serves its bytes, whole and ranged, from that directory."""
    f = fcluster.filer.url
    bucket = tmp_path / "bucket"
    (bucket / "sub").mkdir(parents=True)
    body = np.random.default_rng(4).bytes(70_000)
    (bucket / "sub" / "obj.bin").write_bytes(body)
    with _req(f"{f}/__admin__/remote_mounts", method="POST",
              data=json.dumps({"set": {"/rm/": f"local:{bucket}"}}).encode(),
              headers={"Content-Type": "application/json"}) as r:
        assert json.loads(r.read()) == {"/rm": f"local:{bucket}"}
    assert json.loads(_get(f"{f}/__admin__/remote_mounts")) == \
        {"/rm": f"local:{bucket}"}
    entry = {"full_path": "/rm/sub/obj.bin", "attr": {"mode": 0o660},
             "extended": {"remote-placeholder": "true",
                          "remote-key": "sub/obj.bin",
                          "remote-size": str(len(body))}}
    with _req(f"{f}/__admin__/entry", method="POST",
              data=json.dumps({"entry": entry}).encode(),
              headers={"Content-Type": "application/json"}) as r:
        assert r.status == 201
    assert _get(f"{f}/rm/sub/obj.bin") == body
    with _req(f"{f}/rm/sub/obj.bin",
              headers={"Range": "bytes=65000-69999"}) as r:
        assert r.status == 206 and r.read() == body[65000:70000]


# ---- the CLI ----------------------------------------------------------------

SERVER_CHILD = r"""
import json, sys, threading
from seaweedfs_tpu_torch.__main__ import main
threading.Thread(target=main, args=(sys.argv[1:],), daemon=True).start()
sys.stdin.readline()  # the test's word to report and leave
print(json.dumps({"jax": "jax" in sys.modules,
                  "torch": "torch" in sys.modules,
                  "reference": sorted(m for m in sys.modules
                                      if m.split(".")[0] ==
                                      "seaweedfs_tpu")}), flush=True)
import os
os._exit(0)
"""


def test_filer_cli_serves_without_jax_or_torch(tmp_path):
    """`python -m seaweedfs_tpu_torch filer -dir D` against the port's
    master and a port volume server: a PUT of a three-chunk file and its
    GET come back equal, and the filer's process loads neither jax,
    torch nor the reference package."""
    c = Cluster(tmp_path, n_volume_servers=1).start()
    fport = free_port()
    log = open(tmp_path / "filer.log", "wb")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-c", SERVER_CHILD, "filer", "-master",
         c.master.url, "-port", str(fport), "-dir", str(tmp_path / "f"),
         "-maxMB", "1"], cwd=str(REPO), env=env, stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=log)
    try:
        c.wait_heartbeats()
        url = f"127.0.0.1:{fport}"
        deadline = time.time() + 60
        while True:
            try:
                _get(f"{url}/status")
                break
            except OSError:
                assert proc.poll() is None, \
                    (tmp_path / "filer.log").read_text()[-3000:]
                assert time.time() < deadline, "the filer never listened"
                time.sleep(0.1)
        data = np.random.default_rng(3).bytes(2_500_000)
        out = _put(f"{url}/cli/three.bin", data)
        assert out["size"] == len(data)
        assert len(json.loads(_get(
            f"{url}/cli/three.bin?metadata=true"))["chunks"]) == 3
        assert _get(f"{url}/cli/three.bin") == data
        assert (tmp_path / "f" / "filer.db").exists()
        out, _ = proc.communicate(b"\n", timeout=60)
        assert json.loads(out.decode().strip().splitlines()[-1]) == {
            "jax": False, "torch": False, "reference": []}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
        c.stop()


# ---- stopping with live subscribers -------------------------------------------

def test_stop_ends_live_subscriptions_at_once(fcluster):
    """A filer with a live /__meta__/subscribe stream (here a reader that
    never hangs up) stops at once: the handler ends on the stop rather
    than at its next 5 s keepalive, which the runner's cleanup would wait
    for (the reference's filer waits)."""
    f = fcluster.filer
    r = urllib.request.urlopen(
        f"http://{f.url}/__meta__/subscribe?prefix=/&live=true", timeout=30)
    try:
        deadline = time.time() + 5
        while not f._subscribers:
            assert time.time() < deadline, "the stream never subscribed"
            time.sleep(0.01)
        t0 = time.perf_counter()
        fcluster.submit(f.stop())
        assert time.perf_counter() - t0 < 1.0
        assert not f._subscribers
    finally:
        r.close()
    fcluster.submit(f.start())  # the fixture stops it again
