"""The port's filer server held to the reference's across packages.

- Same requests, same answers: one request script (a multi-chunk upload,
  an overwrite, a PATCH, a grow and a shrink by truncate, a move, a hard
  link, a directory of five files, deletes, an entry with a chunk
  manifest made through /__admin__/entry) runs against a reference stack
  (the reference's master, volume server and `FilerServer`) and a port
  stack (the port's master, a port volume server with `device="cpu"` and
  the port's `FilerServer`).  Every answer is equal: status codes,
  bodies, the listing JSON with its pagination, `?metadata=true` with
  and without `resolveManifest`, `ETag`, `Content-Range`,
  `Content-Length`, `Content-Type` and the `Seaweed-` headers, 416
  answers, /__meta__/digest and the replayed /__meta__/subscribe lines.
  Masked, because they differ by the write's time or the cluster's
  randomness: the fields `fid`, `mtime`, `crtime`, `Mtime`, `Crtime`,
  `ts_ns` and `hard_link_id` wherever they appear, the `Last-Modified`
  header, the `head_ts_ns` of /__meta__/digest, and the `Content-Length`
  of JSON answers (it moves with the masked fields' widths; their bodies
  are compared).
- Files cross: a filer data directory (its SQLite store and meta log)
  and the volume directories written by one package's stack, with
  sealed and gzipped chunks among them, are served by the other
  package's stack byte for byte, with the same digest and the same
  replayed meta log, both ways.
"""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from seaweedfs_tpu.client import WeedClient as RefClient
from seaweedfs_tpu.filer import filechunk_manifest as ref_fcm
from seaweedfs_tpu.filer.entry import FileChunk as RefFileChunk
from seaweedfs_tpu.server.filer_server import FilerServer as RefFilerServer

from seaweedfs_tpu_torch.client import WeedClient
from seaweedfs_tpu_torch.filer import filechunk_manifest as fcm
from seaweedfs_tpu_torch.filer.entry import FileChunk
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from tests.test_cluster import Cluster as RefCluster
from tests.test_torch_master_cluster import Cluster, free_port

MASKED_FIELDS = ("fid", "mtime", "crtime", "Mtime", "Crtime", "ts_ns",
                 "hard_link_id", "head_ts_ns")
HEADERS = ("ETag", "Content-Range", "Content-Length", "Content-Type",
           "Accept-Ranges")


@pytest.fixture(autouse=True)
def _quiet_cluster(monkeypatch):
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "0")
    monkeypatch.setenv("WEEDTPU_REPAIR_INTERVAL", "0")


PACKAGES = {
    "reference": (RefCluster, RefFilerServer, RefClient, ref_fcm,
                  RefFileChunk),
    "port": (Cluster, FilerServer, WeedClient, fcm, FileChunk),
}


class Stack:
    """One package's master, volume server and filer (sqlite store in
    `tmp/filer`, volumes in `tmp/vs0`)."""

    def __init__(self, package, tmp, **filer_kw):
        self.package = package
        tmp.mkdir(exist_ok=True)
        cluster_cls, filer_cls, self.client_cls, self.fcm, \
            self.chunk_cls = PACKAGES[package]
        self.cluster = cluster_cls(tmp, n_volume_servers=1).start()
        self.cluster.wait_heartbeats()
        self.filer = filer_cls(self.cluster.master.url, port=free_port(),
                               data_dir=str(tmp / "filer"), **filer_kw)
        self.cluster.submit(self.filer.start())

    def stop(self):
        self.cluster.submit(self.filer.stop())
        self.cluster.stop()


def _mask(obj):
    if isinstance(obj, dict):
        return {k: "<masked>" if k in MASKED_FIELDS else _mask(v)
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_mask(v) for v in obj]
    return obj


def _call(url, method="GET", data=None, headers=None):
    """(status, the compared headers, the body: parsed and masked JSON,
    else bytes) of one request."""
    req = urllib.request.Request(f"http://{url}", data=data, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            status, hdrs, raw = r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        status, hdrs, raw = e.code, e.headers, e.read()
    kept = {k: v for k, v in hdrs.items()
            if k in HEADERS or k.startswith("Seaweed-")}
    ctype = hdrs.get("Content-Type", "")
    if ctype.startswith(("application/json", "application/x-ndjson")):
        # its length moves with the masked fields' widths
        kept.pop("Content-Length", None)
    if ctype.startswith("application/json") and raw:
        return status, kept, _mask(json.loads(raw))
    if ctype.startswith("application/x-ndjson"):
        return status, kept, [_mask(json.loads(line))
                              for line in raw.splitlines() if line]
    return status, kept, raw


def _script(stack) -> list:
    """The request script against `stack`'s filer: every answer."""
    f = stack.filer.url
    rng = np.random.default_rng(21)
    first, second, patch = (rng.bytes(200_000), rng.bytes(150_000),
                            rng.bytes(30_000))
    t0 = time.time_ns()
    out = []

    def step(path, method="GET", data=None, headers=None):
        out.append((method, path.replace(str(t0), "{t0}"),
                    _call(f"{f}{path}", method, data, headers)))
        return out[-1][2]

    # writes
    step("/s/multi.bin", "PUT", first)
    step("/s/small.txt", "PUT", b"hello from the script " * 20,
         {"Content-Type": "text/plain", "Seaweed-Owner": "script"})
    step("/s/multi.bin", "PUT", second)  # the overwrite
    step("/s/multi.bin?offset=70000", "PUT", patch)
    step("/s/multi.bin?truncate=180000", "POST", b"")  # grow
    step("/s/small.txt?truncate=100", "POST", b"")  # shrink
    step("/s/moved.txt?mv.from=/s/small.txt", "POST", b"")
    step("/s/link.bin?link.from=/s/multi.bin", "POST", b"")
    step("/s/d/", "POST", b"")
    for i in range(5):
        step(f"/s/d/f{i}.txt", "PUT", bytes([65 + i]) * (100 * i + 1))
    step("/s/gone.bin", "PUT", b"to be deleted")
    step("/s/gone.bin", "DELETE")
    step("/s/d", "DELETE")  # not empty: 409
    step("/s/e/x.txt", "PUT", b"x")
    step("/s/e?recursive=true", "DELETE")
    step("/s/nothere.txt", "DELETE")
    # an entry whose chunks sit behind a manifest blob
    step("/s/man.bin", "PUT", rng.bytes(150_000))
    with urllib.request.urlopen(f"http://{f}/s/man.bin?metadata=true",
                                timeout=30) as r:
        entry = json.loads(r.read())
    chunks = [stack.chunk_cls.from_dict(c) for c in entry["chunks"]]
    client = stack.client_cls(stack.cluster.master.url)
    blob = stack.fcm.manifest_payload(chunks)
    # no etag: the blob's md5 would hash the fids it lists
    stored = stack.chunk_cls(fid=client.upload(blob), offset=0,
                             size=len(blob))
    entry["chunks"] = [stack.fcm.manifest_ref(stored, chunks).to_dict()]
    step("/__admin__/entry", "POST", json.dumps({"entry": entry}).encode(),
         {"Content-Type": "application/json"})

    # reads
    for path in ("/s/multi.bin", "/s/link.bin", "/s/moved.txt",
                 "/s/man.bin", "/s/d/f3.txt", "/s/nothere.txt"):
        step(path)
        step(path, "HEAD")
    for rng_ in ("bytes=1000-70999", "bytes=-100", "bytes=179990-",
                 "bytes=999999999-", "bytes=5-2"):
        step("/s/multi.bin", headers={"Range": rng_})
    step("/s/man.bin", headers={"Range": "bytes=65000-70000"})
    for path in ("/s/multi.bin", "/s/link.bin", "/s/man.bin", "/s/d"):
        step(f"{path}?metadata=true")
        step(f"{path}?metadata=true&resolveManifest=true")
    step("/s/?limit=2")
    step("/s/?limit=2&lastFileName=link.bin")
    step("/s/?limit=2&lastFileName=link.bin&includeLastFile=true")
    step("/s/d/?prefix=f")
    step("/s/d/?prefix=f&limit=3&lastFileName=f1.txt")
    step("/__meta__/digest?prefix=/s")
    step("/__meta__/digest?prefix=/s/d&digest=0")
    step(f"/__meta__/subscribe?since={t0}&live=false")
    step(f"/__meta__/subscribe?since={t0}&live=false&prefix=/s/d")
    client.close()
    return out


def test_same_requests_same_answers(tmp_path):
    answers = {}
    for package in ("reference", "port"):
        stack = Stack(package, tmp_path / package, chunk_size=64 * 1024)
        try:
            answers[package] = _script(stack)
        finally:
            stack.stop()
    ref, port = answers["reference"], answers["port"]
    assert [a[:2] for a in port] == [a[:2] for a in ref]
    for (method, path, want), (_, _, got) in zip(ref, port):
        assert got == want, (method, path)
    # the script reached what it names
    def first(method, path):
        return next(a for m, p, a in port if (m, p) == (method, path))
    assert first("GET", "/s/man.bin?metadata=true")[2]["chunks"][0][
        "is_chunk_manifest"] is True
    assert len(first("GET", "/s/man.bin?metadata=true&resolveManifest=true")
               [2]["chunks"]) == 3
    assert first("GET", "/s/multi.bin")[1]["Content-Length"] == "180000"
    assert first("GET", "/s/d?metadata=true")[0] == 200
    assert first("DELETE", "/s/d")[0] == 409
    assert first("GET", "/s/nothere.txt")[0] == 404
    ranged = [a for m, p, a in port if m == "GET" and p == "/s/multi.bin"]
    assert [a[0] for a in ranged] == [200, 206, 206, 206, 416, 416]
    assert len(first("GET", "/__meta__/subscribe?since={t0}&live=false")
               [2]) > 20


def _write_tree(stack) -> dict:
    """Files of every kind through `stack`'s filer: path -> bytes."""
    f = stack.filer.url
    rng = np.random.default_rng(5)
    files = {"/x/plain.bin": rng.bytes(300_000),
             "/x/text.txt": b"gzip me, I repeat myself " * 2000,
             "/x/sub/small.bin": rng.bytes(1000),
             "/x/empty.txt": b""}
    for path, data in files.items():
        ctype = "text/plain" if path.endswith(".txt") else \
            "application/octet-stream"
        st, _, _ = _call(f"{f}{path}", "PUT", data,
                         {"Content-Type": ctype})
        assert st == 201
    st, _, _ = _call(f"{f}/x/hard.bin?link.from=/x/plain.bin", "POST", b"")
    assert st == 200
    files["/x/hard.bin"] = files["/x/plain.bin"]
    return files


def _read_tree(stack, files) -> tuple:
    f = stack.filer.url
    for path, data in files.items():
        st, _, body = _call(f"{f}{path}")
        assert st == 200 and body == data, path
    digest = _call(f"{f}/__meta__/digest?prefix=/x")[2]
    raw = urllib.request.urlopen(
        f"http://{f}/__meta__/subscribe?since=0&live=false",
        timeout=30).read()
    return digest["digest"], digest["entries"], raw


@pytest.mark.parametrize("writer,reader", [("reference", "port"),
                                           ("port", "reference")])
def test_filer_and_volume_directories_cross(tmp_path, writer, reader):
    stack = Stack(writer, tmp_path, chunk_size=128 * 1024,
                  encrypt_data=True)
    try:
        files = _write_tree(stack)
        meta = _call(f"{stack.filer.url}/x/text.txt?metadata=true")[2]
        assert meta["chunks"][0].get("is_compressed")
        assert meta["chunks"][0].get("cipher_key")
        before = _read_tree(stack, files)
    finally:
        stack.stop()
    stack = Stack(reader, tmp_path, chunk_size=128 * 1024)
    try:
        after = _read_tree(stack, files)
    finally:
        stack.stop()
    assert after == before
    assert before[1] == len(files) + 1  # the files and /x/sub
