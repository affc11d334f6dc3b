"""The port's WebDAV gateway and FTP stub, held to the reference's:

- the four `tests/test_gateways.py::TestWebDav` twins over a port stack
  (the port's master, one port volume server with `device="cpu"`, the
  port's `FilerServer` and `WebDavServer`), each keeping its twin's name
  and body;
- **same requests, same answers**: one DAV request script against a
  reference stack and a port stack gives equal status codes, headers
  and bodies (the multistatus XML too).  Masked, as they differ by
  time: the `getlastmodified` and `creationdate` elements, the `Date`
  and `Last-Modified` headers and LOCK's time-stamped token;
- **trees cross**: a tree written through one package's gateway is read
  through the other package's filer, started over the same volume and
  filer directories, both ways;
- the FTP stub: `FtpServer.start` raises the reference's text, and the
  CLI's `ftp` exits 1 with it;
- the CLI's `webdav` and `server -webdav` in subprocesses: `webdav`
  loads neither jax, torch nor the reference package; `server` loads
  torch for its volume server, as it always has, and neither jax nor
  the reference package.
"""

from __future__ import annotations

import asyncio
import json
import os
import re
import subprocess
import sys
import time
import urllib.error
import urllib.request
import xml.etree.ElementTree as ET
from unittest import mock

import numpy as np
import pytest

from tests.test_torch_master_cluster import Cluster, free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# no scrubber and no repair loop in the stacks' servers, as in the other
# port cluster tests
QUIET_ENV = {"WEEDTPU_SCRUB_MBPS": "0", "WEEDTPU_REPAIR_INTERVAL": "0"}


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    """The port's master, one port volume server, filer and WebDAV
    gateway: (cluster, filer, dav)."""
    from seaweedfs_tpu_torch.server.filer_server import FilerServer
    from seaweedfs_tpu_torch.server.webdav_server import WebDavServer

    tmp = tmp_path_factory.mktemp("gw")
    with mock.patch.dict(os.environ, QUIET_ENV):
        c = Cluster(tmp, n_volume_servers=1).start()
        c.wait_heartbeats()
        filer = FilerServer(c.master.url, port=free_port(),
                            data_dir=str(tmp / "f"))
        c.submit(filer.start())
        dav = WebDavServer(filer.url, port=free_port())
        c.submit(dav.start())
    yield c, filer, dav
    c.submit(dav.stop())
    c.submit(filer.stop())
    c.stop()


def req(url, method="GET", data=None, headers=None):
    r = urllib.request.Request(url, data=data, method=method,
                               headers=headers or {})
    try:
        with urllib.request.urlopen(r, timeout=30) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


class TestWebDav:
    def test_options(self, stack):
        _, _, dav = stack
        st, _, hdrs = req(f"http://{dav.url}/", method="OPTIONS")
        assert st == 200 and "PROPFIND" in hdrs.get("Allow", "")
        assert hdrs.get("DAV") == "1, 2"

    def test_put_get_propfind_delete(self, stack):
        _, _, dav = stack
        base = f"http://{dav.url}"
        st, _, _ = req(f"{base}/dav/hello.txt", method="PUT",
                       data=b"dav body")
        assert st == 201
        st, body, _ = req(f"{base}/dav/hello.txt")
        assert st == 200 and body == b"dav body"
        # PROPFIND depth 1 on the dir
        st, body, _ = req(f"{base}/dav/", method="PROPFIND",
                          headers={"Depth": "1"})
        assert st == 207
        root = ET.fromstring(body)
        hrefs = [e.text for e in root.iter() if e.tag.endswith("href")]
        assert any("hello.txt" in h for h in hrefs)
        lengths = [e.text for e in root.iter()
                   if e.tag.endswith("getcontentlength")]
        assert "8" in lengths
        st, _, _ = req(f"{base}/dav/hello.txt", method="DELETE")
        assert st == 204
        st, _, _ = req(f"{base}/dav/hello.txt")
        assert st == 404

    def test_mkcol_move_copy(self, stack):
        _, _, dav = stack
        base = f"http://{dav.url}"
        assert req(f"{base}/mk/sub", method="MKCOL")[0] == 201
        req(f"{base}/mk/a.txt", method="PUT", data=b"x")
        st, _, _ = req(f"{base}/mk/a.txt", method="MOVE",
                       headers={"Destination": f"http://{dav.url}/mk/sub/b.txt"})
        assert st == 201
        assert req(f"{base}/mk/sub/b.txt")[1] == b"x"
        assert req(f"{base}/mk/a.txt")[0] == 404
        st, _, _ = req(f"{base}/mk/sub/b.txt", method="COPY",
                       headers={"Destination": f"http://{dav.url}/mk/c.txt"})
        assert st == 201
        assert req(f"{base}/mk/c.txt")[1] == b"x"
        assert req(f"{base}/mk/sub/b.txt")[1] == b"x"

    def test_lock_unlock(self, stack):
        _, _, dav = stack
        st, body, hdrs = req(f"http://{dav.url}/any.txt", method="LOCK",
                             data=b"<lockinfo/>")
        assert st == 200 and b"locktoken" in body.lower()
        assert req(f"http://{dav.url}/any.txt", method="UNLOCK")[0] == 204


# ---- same requests, same answers --------------------------------------------

def _servers(package):
    """(master, volume server, filer, WebDAV) classes of one package; the
    port's volume server on the CPU."""
    if package == "port":
        from seaweedfs_tpu_torch.server.filer_server import FilerServer
        from seaweedfs_tpu_torch.server.master import MasterServer
        from seaweedfs_tpu_torch.server.volume_server import VolumeServer
        from seaweedfs_tpu_torch.server.webdav_server import WebDavServer
        return (MasterServer, lambda *a, **k: VolumeServer(
            *a, device="cpu", **k), FilerServer, WebDavServer)
    from seaweedfs_tpu.server.filer_server import FilerServer
    from seaweedfs_tpu.server.master import MasterServer
    from seaweedfs_tpu.server.volume_server import VolumeServer
    from seaweedfs_tpu.server.webdav_server import WebDavServer
    return MasterServer, VolumeServer, FilerServer, WebDavServer


class DavStack:
    """One package's master, volume server, filer and WebDAV gateway over
    the volume directory `tmp/v` and the filer directory `tmp/f`, on the
    loop of a `Cluster` with no volume servers of its own."""

    def __init__(self, tmp, package, chunk_size=64 * 1024):
        master_cls, vs_cls, filer_cls, dav_cls = _servers(package)
        self.loop_owner = Cluster(tmp / f"loop-{package}",
                                  n_volume_servers=0)
        self.loop_owner.thread.start()
        run = self.run = self.loop_owner.submit
        (tmp / "v").mkdir(exist_ok=True)
        with mock.patch.dict(os.environ, QUIET_ENV):
            self.master = master_cls("127.0.0.1", free_port())
            self.vs = vs_cls([str(tmp / "v")], self.master.url,
                             port=free_port(), heartbeat_interval=0.2,
                             max_volumes=16)
            self.filer = filer_cls(self.master.url, port=free_port(),
                                   data_dir=str(tmp / "f"),
                                   chunk_size=chunk_size)
            self.dav = dav_cls(self.filer.url, port=free_port())
            run(self.master.start())
            run(self.vs.start())
            deadline = time.time() + 10
            while not self.master.topo.nodes:
                assert time.time() < deadline
                time.sleep(0.05)
            run(self.filer.start())
            run(self.dav.start())

    def stop(self):
        for srv in (self.dav, self.filer, self.vs, self.master):
            self.run(srv.stop())
        self.loop_owner.loop.call_soon_threadsafe(self.loop_owner.loop.stop)
        self.loop_owner.thread.join(5)


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    out = {p: DavStack(tmp_path_factory.mktemp(f"dav-{p}"), p)
           for p in ("reference", "port")}
    yield out
    for s in out.values():
        s.stop()


MASKED_PROPS = ("getlastmodified", "creationdate")
_MASK = re.compile(r"<(D:(?:%s))>[^<]*</\1>" % "|".join(MASKED_PROPS))
_TOKEN = re.compile(r"opaquelocktoken:weedtpu-[0-9a-f]+")
KEPT_HEADERS = ("DAV", "Allow", "MS-Author-Via", "Content-Type",
                "Content-Length", "Content-Range", "ETag", "Lock-Token")


def _record(resp):
    status, body, headers = resp
    kept = {h: _TOKEN.sub("opaquelocktoken:*", headers[h])
            for h in KEPT_HEADERS if h in headers}
    if body.startswith(b"<?xml") or body.startswith(b"<D:"):
        body = _TOKEN.sub("opaquelocktoken:*", _MASK.sub(
            lambda m: f"<{m.group(1)}>*</{m.group(1)}>", body.decode()))
    return status, body, kept


def _dav_script(host):
    """The request script through one gateway, as (step, status, body,
    headers) records."""
    base = f"http://{host}"
    big = np.random.default_rng(5).bytes(300_000)  # five 64 KiB chunks
    out = []

    def step(name, url, method="GET", data=None, headers=None):
        out.append((name,) + _record(req(base + url, method, data,
                                         headers)))

    def dest(path):
        return {"Destination": f"http://{host}{path}"}

    step("options", "/", "OPTIONS")
    step("mkcol", "/x", "MKCOL")
    step("mkcol-sub", "/x/sub", "MKCOL")
    step("put-text", "/x/a.txt", "PUT", b"alpha bytes",
         {"Content-Type": "text/plain"})
    step("put-big", "/x/sub/b.bin", "PUT", big)
    step("put-space", "/x/with%20space.txt", "PUT", b"spaced")
    step("get-text", "/x/a.txt")
    step("get-big", "/x/sub/b.bin")
    step("get-range", "/x/sub/b.bin", headers={"Range": "bytes=100-99999"})
    step("head-big", "/x/sub/b.bin", "HEAD")
    step("propfind-dir", "/x", "PROPFIND", headers={"Depth": "1"})
    step("propfind-dir0", "/x/sub", "PROPFIND", headers={"Depth": "0"})
    step("propfind-file", "/x/a.txt", "PROPFIND", headers={"Depth": "0"})
    step("propfind-space", "/x/with%20space.txt", "PROPFIND",
         headers={"Depth": "0"})
    step("move", "/x/a.txt", "MOVE", b"", dest("/x/sub/c.txt"))
    step("get-moved", "/x/sub/c.txt")
    step("get-gone", "/x/a.txt")
    step("copy", "/x/sub/c.txt", "COPY", b"", dest("/x/d.txt"))
    step("move-no-dest", "/x/d.txt", "MOVE", b"")
    step("propfind-after", "/x/sub", "PROPFIND", headers={"Depth": "1"})
    step("proppatch", "/x/d.txt", "PROPPATCH", b"<propertyupdate/>")
    step("lock", "/x/d.txt", "LOCK", b"<lockinfo/>")
    step("unlock", "/x/d.txt", "UNLOCK")
    step("unknown-verb", "/x/d.txt", "PATCH", b"z")
    step("delete", "/x/d.txt", "DELETE")
    step("delete-again", "/x/d.txt", "DELETE")
    step("propfind-missing", "/nope", "PROPFIND", headers={"Depth": "0"})
    step("delete-tree", "/x", "DELETE")
    step("propfind-tree-gone", "/x", "PROPFIND", headers={"Depth": "1"})
    return out


def test_same_dav_requests_same_answers(stacks):
    ref = _dav_script(stacks["reference"].dav.url)
    port = _dav_script(stacks["port"].dav.url)
    assert [r[0] for r in port] == [r[0] for r in ref]
    for a, b in zip(ref, port):
        assert a == b, a[0]
    # the script reached the filer's data path: a multistatus with the
    # chunked file's length
    listing = dict((r[0], r) for r in port)["propfind-after"]
    assert listing[1] == 207 and "<D:getcontentlength>300000<" in listing[2]


# ---- trees cross --------------------------------------------------------------

def _tree():
    rng = np.random.default_rng(17)
    return {"/t/readme.txt": b"written through one gateway",
            "/t/a/one.bin": rng.bytes(200_000),  # four 64 KiB chunks
            "/t/a/b/two.bin": rng.bytes(70_000),
            "/t/a/b/empty.txt": b"",
            "/t/c/three.bin": rng.bytes(1)}


@pytest.mark.parametrize("writer,reader", [("reference", "port"),
                                           ("port", "reference")])
def test_trees_cross_between_packages(tmp_path, writer, reader):
    """A tree made through `writer`'s gateway (MKCOL, PUT, MOVE, COPY,
    DELETE) reads byte for byte through `reader`'s filer and gateway
    over the same directories, and its listings are equal."""
    tree = _tree()
    w = DavStack(tmp_path, writer)
    try:
        base = f"http://{w.dav.url}"
        for d in ("/t", "/t/a", "/t/a/b", "/t/c"):
            assert req(base + d, "MKCOL")[0] == 201
        for path, data in tree.items():
            assert req(base + path, "PUT", data)[0] == 201
        assert req(base + "/t/readme.txt", "COPY", b"", {
            "Destination": f"http://{w.dav.url}/t/c/copied.txt"})[0] == 201
        assert req(base + "/t/c/three.bin", "MOVE", b"", {
            "Destination": f"http://{w.dav.url}/t/a/three.bin"})[0] == 201
        assert req(base + "/t/a/b/empty.txt", "DELETE")[0] == 204
        written = {"/t/readme.txt": tree["/t/readme.txt"],
                   "/t/a/one.bin": tree["/t/a/one.bin"],
                   "/t/a/b/two.bin": tree["/t/a/b/two.bin"],
                   "/t/c/copied.txt": tree["/t/readme.txt"],
                   "/t/a/three.bin": tree["/t/c/three.bin"]}
        listed = {d: _record(req(base + d, "PROPFIND", None,
                                 {"Depth": "1"}))
                  for d in ("/t", "/t/a", "/t/a/b", "/t/c")}
    finally:
        w.stop()
    r = DavStack(tmp_path, reader)
    try:
        for path, data in written.items():
            st, body, _ = req(f"http://{r.filer.url}{path}")
            assert st == 200 and body == data, path
            assert req(f"http://{r.dav.url}{path}")[1] == data, path
        for gone in ("/t/c/three.bin", "/t/a/b/empty.txt"):
            assert req(f"http://{r.filer.url}{gone}")[0] == 404
        for d, rec in listed.items():
            assert _record(req(f"http://{r.dav.url}{d}", "PROPFIND", None,
                               {"Depth": "1"})) == rec, d
    finally:
        r.stop()


# ---- the FTP stub -------------------------------------------------------------

def test_ftp_stub_raises_the_reference_text():
    from seaweedfs_tpu import ftpd as ref_ftpd
    from seaweedfs_tpu_torch import ftpd

    texts = []
    for mod in (ref_ftpd, ftpd):
        opt = mod.FtpServerOption("127.0.0.1:8888", port=free_port())
        assert (opt.host, opt.passive_port_start, opt.passive_port_stop) \
            == ("127.0.0.1", 30000, 30100)
        with pytest.raises(NotImplementedError) as ei:
            asyncio.run(mod.FtpServer(opt).start())
        texts.append(str(ei.value))
    assert texts[0] == texts[1]
    r = subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch", "ftp",
                        "-port", str(free_port())], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 1
    assert r.stderr.strip() == texts[0] and not r.stdout


# ---- the CLI ------------------------------------------------------------------

CLI_CHILD = r"""
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


def _child(args, tmp_path, name):
    log = open(tmp_path / f"{name}.log", "wb")
    env = dict(os.environ, PYTHONPATH=REPO, **QUIET_ENV)
    env.pop("WEEDTPU_EC_CODEC", None)
    proc = subprocess.Popen([sys.executable, "-c", CLI_CHILD, *args],
                            cwd=REPO, env=env, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=log)
    return proc, log


def _wait_listening(url, proc, log_path, path="/"):
    deadline = time.time() + 90
    while True:
        try:
            urllib.request.urlopen(f"http://{url}{path}", timeout=5).read()
            return
        except urllib.error.HTTPError:
            return  # it answered
        except OSError:
            assert proc.poll() is None, log_path.read_text()[-3000:]
            assert time.time() < deadline, f"{url} never listened"
            time.sleep(0.1)


def _report(proc) -> dict:
    out, _ = proc.communicate(b"\n", timeout=60)
    return json.loads(out.decode().strip().splitlines()[-1])


def test_cli_webdav_serves_without_jax_or_torch(stack, tmp_path):
    """`python -m seaweedfs_tpu_torch webdav -filer F -filer.path /cli`
    against the stack's port filer: a PUT through it lands under the
    prefix, and the gateway's process loads neither jax, torch nor the
    reference package."""
    _, filer, _ = stack
    port = free_port()
    proc, log = _child(["webdav", "-filer", filer.url, "-port", str(port),
                        "-filer.path", "/cli"], tmp_path, "webdav")
    try:
        url = f"127.0.0.1:{port}"
        _wait_listening(url, proc, tmp_path / "webdav.log")
        assert req(f"http://{url}/d", "MKCOL")[0] == 201
        assert req(f"http://{url}/d/f.txt", "PUT", b"via the cli")[0] == 201
        assert req(f"http://{filer.url}/cli/d/f.txt")[1] == b"via the cli"
        st, body, _ = req(f"http://{url}/d", "PROPFIND", None,
                          {"Depth": "1"})
        assert st == 207 and b"/d/f.txt" in body
        assert _report(proc) == {"jax": False, "torch": False,
                                 "reference": []}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def test_cli_server_webdav_implies_filer(tmp_path):
    """`server -webdav` starts a filer with the gateway (as `-s3` does):
    a file PUT through the gateway reads back through the filer.  The
    process loads neither jax nor the reference package; its volume
    server (`-device cpu`) loads torch."""
    ports = {k: free_port() for k in ("port", "volumePort", "filerPort",
                                      "webdavPort")}
    (tmp_path / "d").mkdir()
    args = ["server", "-dir", str(tmp_path / "d"), "-device", "cpu",
            "-webdav"]
    for k, v in ports.items():
        args += [f"-{k}", str(v)]
    proc, log = _child(args, tmp_path, "server")
    try:
        dav = f"127.0.0.1:{ports['webdavPort']}"
        _wait_listening(dav, proc, tmp_path / "server.log")
        deadline = time.time() + 60
        while True:  # the volume server's first beat reaches the master
            st, _, _ = req(f"http://{dav}/s.bin", "PUT", b"s" * 5000)
            if st == 201:
                break
            assert time.time() < deadline, st
            time.sleep(0.2)
        filer = f"127.0.0.1:{ports['filerPort']}"
        assert req(f"http://{filer}/s.bin")[1] == b"s" * 5000
        assert req(f"http://{dav}/s.bin")[1] == b"s" * 5000
        got = _report(proc)
        assert got["jax"] is False and got["reference"] == []
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


# ---- a repair local to one node ---------------------------------------------

def test_copy_of_a_collection_copies_its_members(stacks):
    """COPY of a collection through the port's gateway copies the
    subtree (RFC 4918 9.8.3, Depth infinity): the destination is a
    collection holding each member's bytes.  The reference's answers 201
    too, but makes the destination a file holding the filer's listing of
    the source."""
    views = {}
    for package, s in stacks.items():
        base = f"http://{s.dav.url}"
        for d in ("/cc", "/cc/src", "/cc/src/sub"):
            assert req(base + d, "MKCOL")[0] == 201
        assert req(base + "/cc/src/a.txt", "PUT", b"member a")[0] == 201
        assert req(base + "/cc/src/sub/b.bin", "PUT", b"b" * 70_000)[0] \
            == 201
        assert req(base + "/cc/src", "COPY", b"", {
            "Destination": f"http://{s.dav.url}/cc/dst"})[0] == 201
        st, body, _ = req(base + "/cc/dst", "PROPFIND", None,
                          {"Depth": "0"})
        views[package] = (st, b"<D:collection" in body,
                          req(base + "/cc/dst/a.txt")[1],
                          req(base + "/cc/dst/sub/b.bin")[1],
                          req(base + "/cc/src/a.txt")[1])
    assert views["port"] == (207, True, b"member a", b"b" * 70_000,
                             b"member a")
    st, is_collection, *_ = views["reference"]
    assert st == 207 and not is_collection
