"""The port's remote storage clients (`remote_storage.py`: `S3Remote`,
`GcsRemote`, `AzureRemote`) against the port's S3 gateway and the
reference tests' Azure endpoint, the volume tier and remote mounts over
S3 through the port's shell, and the clients across the packages.

- Twins of tests/test_backend_tier.py's
  `test_s3_remote_client_against_own_gateway`,
  `test_tier_move_and_remote_mount_via_s3`,
  `test_gcs_remote_speaks_s3_interop` and
  `test_azure_remote_sharedkey_wire_protocol`, on port stacks (the
  port's master, a port volume server with `device="cpu"`, the port's
  `FilerServer` and `S3ApiServer`), each keeping its name and checks.
- SigV4 and SharedKey requests byte-equal to the reference's on a fixed
  clock and key.
- The port's `S3Remote` against the reference's gateway, and the
  reference's against the port's, signed.
"""

import base64
import io
import json
import os
import time
import urllib.error
import urllib.request

import pytest

from tests.test_torch_master_cluster import Cluster, free_port


@pytest.fixture(autouse=True)
def _quiet_cluster(monkeypatch):
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "0")
    monkeypatch.setenv("WEEDTPU_REPAIR_INTERVAL", "0")


def _s3_stack(tmp_path, iam=None):
    """A port cluster with a port filer and a port S3 gateway over it
    (no identities: every request allowed, as the reference's stack)."""
    from seaweedfs_tpu_torch.s3.s3api_server import S3ApiServer
    from seaweedfs_tpu_torch.server.filer_server import FilerServer
    c = Cluster(tmp_path, n_volume_servers=1).start()
    c.wait_heartbeats()
    filer = FilerServer(c.master.url, port=free_port(),
                        data_dir=str(tmp_path / "filer"))
    c.submit(filer.start())
    kw = {} if iam is None else {"iam": iam}
    s3 = S3ApiServer(filer.url, port=free_port(), **kw)
    c.submit(s3.start())
    return c, filer, s3


def _stop(c, filer, s3):
    c.submit(s3.stop())
    c.submit(filer.stop())
    c.stop()


def _find_filer(env):
    deadline = time.time() + 10
    while time.time() < deadline:
        try:
            return env.find_filer()
        except RuntimeError:
            time.sleep(0.2)
    return env.find_filer()


# ---- twins of tests/test_backend_tier.py -----------------------------------

def test_s3_remote_client_against_own_gateway(tmp_path):
    """The port's SDK-free S3Remote against the port's gateway: CRUD,
    ranged read, paginated traverse."""
    from seaweedfs_tpu_torch.remote_storage import S3Remote
    c, filer, s3 = _s3_stack(tmp_path)
    try:
        urllib.request.urlopen(urllib.request.Request(
            f"http://{s3.url}/tier-bucket", method="PUT"), timeout=10)
        r = S3Remote(endpoint=s3.url, bucket="tier-bucket")
        r.write_file("a/x.bin", b"payload-x")
        r.write_file("a/y.bin", b"payload-y" * 100)
        r.write_file("z.bin", b"zzz")
        assert r.read_file("a/x.bin") == b"payload-x"
        assert r.read_range("a/y.bin", 9, 9) == b"payload-y"
        keys = {e.key: e.size for e in r.traverse()}
        assert keys == {"a/x.bin": 9, "a/y.bin": 900, "z.bin": 3}
        assert [e.key for e in r.traverse(prefix="a/")] == \
            ["a/x.bin", "a/y.bin"]
        r.delete_file("z.bin")
        assert "z.bin" not in {e.key for e in r.traverse()}
        r.delete_file("z.bin")  # idempotent
    finally:
        _stop(c, filer, s3)


def test_tier_move_and_remote_mount_via_s3(tmp_path):
    """volume.tier.move and remote.mount through the port's shell against
    the port's gateway as the remote."""
    from seaweedfs_tpu_torch.client import WeedClient
    from seaweedfs_tpu_torch.remote_storage import S3Remote
    from seaweedfs_tpu_torch.shell.commands import CommandEnv, run_command
    c, filer, s3 = _s3_stack(tmp_path)
    try:
        urllib.request.urlopen(urllib.request.Request(
            f"http://{s3.url}/cold", method="PUT"), timeout=10)
        client = WeedClient(c.master.url)
        fid = client.upload(b"frozen bytes", name="f.bin")
        vid = int(fid.split(",")[0])
        env = CommandEnv(c.master.url)
        _find_filer(env)
        env.acquire_lock()
        buf = io.StringIO()
        run_command(env, f"volume.tier.move -volumeId {vid} "
                         f"-dest s3:endpoint={s3.url},bucket=cold", buf)
        assert "tier s3" in buf.getvalue()
        # volume reads now ride the S3 remote; blob still served
        assert client.download(fid) == b"frozen bytes"
        # the .dat landed as an object in the bucket
        with urllib.request.urlopen(
                f"http://{s3.url}/cold?list-type=2", timeout=10) as resp:
            body = resp.read()
        assert b".dat" in body

        # remote.mount the same bucket through the S3 wire
        buf = io.StringIO()
        run_command(env, f"remote.mount -remote s3:endpoint={s3.url},"
                         f"bucket=cold -dir /s3r -cache true", buf)
        assert "object(s)" in buf.getvalue()
        listing = json.load(urllib.request.urlopen(
            f"http://{filer.url}/s3r/default/?limit=100", timeout=10))
        names = [e["FullPath"] for e in listing.get("Entries") or []]
        assert any(n.endswith(".dat") for n in names), names
        # cached content equals the tiered .dat object bytes
        r = S3Remote(endpoint=s3.url, bucket="cold")
        key = next(e.key for e in r.traverse() if e.key.endswith(".dat"))
        assert urllib.request.urlopen(
            f"http://{filer.url}/s3r/{key}", timeout=10).read() == \
            r.read_file(key)
        env.release_lock()
        client.close()
    finally:
        _stop(c, filer, s3)


def test_gcs_remote_speaks_s3_interop(tmp_path):
    """GcsRemote = the GCS XML-interop wire path, against the port's
    gateway standing in for storage.googleapis.com."""
    from seaweedfs_tpu_torch.remote_storage import GcsRemote, make_remote
    c, filer, s3 = _s3_stack(tmp_path)
    try:
        urllib.request.urlopen(urllib.request.Request(
            f"http://{s3.url}/gcs-bucket", method="PUT"), timeout=10)
        r = make_remote("gcs", bucket="gcs-bucket",
                        endpoint=f"http://{s3.url}")
        assert isinstance(r, GcsRemote)
        r.write_file("obj/one", b"gcs-bytes")
        assert r.read_file("obj/one") == b"gcs-bytes"
        assert r.read_range("obj/one", 4, 5) == b"bytes"
        assert [e.key for e in r.traverse()] == ["obj/one"]
        r.delete_file("obj/one")
        assert list(r.traverse()) == []
    finally:
        _stop(c, filer, s3)


def test_azure_remote_sharedkey_wire_protocol():
    """The port's AzureRemote, checked by the reference tests' fake Azure
    endpoint, which re-derives every SharedKey signature from the
    spec."""
    from seaweedfs_tpu_torch.remote_storage import make_remote
    from tests.test_backend_tier import _FakeAzure
    key = base64.b64encode(b"0123456789abcdef0123456789abcdef").decode()
    fake = _FakeAzure("acct", key)
    endpoint = fake.start()
    try:
        r = make_remote("azure", account="acct", container="cont",
                        account_key=key, endpoint=endpoint)
        r.write_file("empty.bin", b"")  # zero-byte blobs must carry
        assert r.read_file("empty.bin") == b""          # Content-Length
        r.delete_file("empty.bin")
        r.write_file("dir/a.bin", b"azure-payload")
        r.write_file("dir/b.bin", b"B" * 64)
        r.write_file("top.bin", b"t")
        assert r.read_file("dir/a.bin") == b"azure-payload"
        assert r.read_range("dir/a.bin", 6, 7) == b"payload"
        assert {e.key: e.size for e in r.traverse()} == {
            "dir/a.bin": 13, "dir/b.bin": 64, "top.bin": 1}
        assert [e.key for e in r.traverse(prefix="dir/")] == \
            ["dir/a.bin", "dir/b.bin"]
        assert all(e.mtime > 0 for e in r.traverse())
        r.delete_file("top.bin")
        assert "top.bin" not in {e.key for e in r.traverse()}
        r.delete_file("top.bin")  # 404 is idempotent
        # a wrong key is refused by the endpoint's own verifier
        bad = make_remote("azure", account="acct", container="cont",
                          account_key=base64.b64encode(b"x" * 32).decode(),
                          endpoint=endpoint)
        with pytest.raises(urllib.error.HTTPError) as ei:
            bad.read_file("dir/a.bin")
        assert ei.value.code == 403
        assert fake.seen_versions == {"2020-10-02"}
    finally:
        fake.stop()
        fake.httpd.server_close()


# ---- signatures on a fixed clock ---------------------------------------------

FIXED = time.struct_time((2026, 3, 14, 15, 9, 26, 5, 73, 0))


@pytest.mark.parametrize("method,key,query,payload", [
    ("GET", "", {"list-type": "2", "max-keys": "1000",
                 "prefix": "a b/"}, b""),
    ("PUT", "dir/x y.bin", {}, b"payload" * 99),
    ("GET", "k", {"continuation-token": "t/=+"}, b""),
    ("DELETE", "a/b/c", {}, b""),
])
def test_sigv4_headers_equal_the_references(method, key, query, payload,
                                            monkeypatch):
    """`S3Remote._sign` of both packages, same credentials, region and
    clock: the same header dicts, Authorization byte for byte; the
    unsigned client sends none."""
    from seaweedfs_tpu import remote_storage as ref_rs
    from seaweedfs_tpu_torch import remote_storage as rs
    monkeypatch.setattr(time, "gmtime", lambda *a: FIXED)
    got = []
    for mod in (rs, ref_rs):
        r = mod.S3Remote("127.0.0.1:8333", "bkt", access_key="AK",
                         secret_key="SK/+=", region="eu-west-1")
        path = f"/bkt/{key}" if key else "/bkt"
        got.append(r._sign(method, path, query, {"Range": "bytes=0-9"},
                           payload))
    assert got[0] == got[1]
    assert got[0]["x-amz-date"] == "20260314T150926Z"
    assert got[0]["Authorization"].startswith(
        "AWS4-HMAC-SHA256 Credential=AK/20260314/eu-west-1/s3/aws4_request")
    plain = rs.S3Remote("127.0.0.1:8333", "bkt")
    assert plain._sign(method, "/bkt", query, {}, payload) == {}


@pytest.mark.parametrize("method,key,query,headers,length", [
    ("GET", "", {"restype": "container", "comp": "list",
                 "maxresults": "1000", "prefix": "dir/"}, {}, 0),
    ("PUT", "dir/a.bin", {}, {"x-ms-blob-type": "BlockBlob",
                              "Content-Type": "application/octet-stream"},
     13),
    ("GET", "dir/a.bin", {}, {"x-ms-range": "bytes=6-12"}, 0),
    ("DELETE", "top.bin", {}, {}, 0),
])
def test_sharedkey_headers_equal_the_references(method, key, query, headers,
                                                length, monkeypatch):
    """`AzureRemote._sign` of both packages on the same account key and
    clock: the same headers, the SharedKey Authorization byte for
    byte."""
    from seaweedfs_tpu import remote_storage as ref_rs
    from seaweedfs_tpu_torch import remote_storage as rs
    monkeypatch.setattr(time, "gmtime", lambda *a: FIXED)
    acct_key = base64.b64encode(b"k" * 32).decode()
    got = []
    for mod in (rs, ref_rs):
        r = mod.AzureRemote("acct", "cont", acct_key,
                            endpoint="http://127.0.0.1:10000")
        path = f"/cont/{key}" if key else "/cont"
        got.append(r._sign(method, path, query, headers, length))
    assert got[0] == got[1]
    assert got[0]["x-ms-date"] == "Sat, 14 Mar 2026 15:09:26 GMT"
    assert got[0]["Authorization"].startswith("SharedKey acct:")


# ---- across the packages -----------------------------------------------------

def _ref_s3_stack(tmp_path, iam):
    from seaweedfs_tpu.s3.s3api_server import S3ApiServer
    from seaweedfs_tpu.server.filer_server import FilerServer
    from tests.test_cluster import Cluster as RefCluster
    c = RefCluster(tmp_path, n_volume_servers=1).start()
    c.wait_heartbeats()
    filer = FilerServer(c.master.url, port=free_port(),
                        data_dir=str(tmp_path / "rfiler"))
    c.submit(filer.start())
    s3 = S3ApiServer(filer.url, port=free_port(), iam=iam)
    c.submit(s3.start())
    return c, filer, s3


@pytest.mark.parametrize("client,gateway", [("port", "reference"),
                                            ("reference", "port")])
def test_s3_remote_against_the_other_packages_gateway(client, gateway,
                                                      tmp_path):
    """Each package's signed S3Remote against the other's gateway, which
    verifies its SigV4: bucket create, put, ranged read, list, delete,
    the account's bucket list; a wrong secret is refused (403)."""
    from seaweedfs_tpu import remote_storage as ref_rs
    from seaweedfs_tpu.s3 import auth as ref_auth
    from seaweedfs_tpu_torch import remote_storage as rs
    from seaweedfs_tpu_torch.s3 import auth
    mod = rs if client == "port" else ref_rs
    if gateway == "port":
        iam = auth.IdentityAccessManagement([auth.Identity(
            "admin", [auth.Credential("AKX", "SKX")], ["Admin"])])
        c, filer, s3 = _s3_stack(tmp_path, iam=iam)
    else:
        iam = ref_auth.IdentityAccessManagement([ref_auth.Identity(
            "admin", [ref_auth.Credential("AKX", "SKX")], ["Admin"])])
        c, filer, s3 = _ref_s3_stack(tmp_path, iam)
    try:
        r = mod.S3Remote(endpoint=s3.url, bucket="xbk", access_key="AKX",
                         secret_key="SKX")
        r.create_bucket()
        r.create_bucket()  # an existing bucket is no error
        r.write_file("d/one.bin", b"0123456789" * 100)
        r.write_file("two.bin", b"two")
        assert r.read_file("d/one.bin") == b"0123456789" * 100
        assert r.read_range("d/one.bin", 995, 5) == b"56789"
        assert {e.key: e.size for e in r.traverse()} == {
            "d/one.bin": 1000, "two.bin": 3}
        assert "xbk" in mod.S3Remote(endpoint=s3.url, bucket="",
                                    access_key="AKX",
                                    secret_key="SKX").list_buckets()
        r.delete_file("two.bin")
        r.delete_file("two.bin")
        assert [e.key for e in r.traverse()] == ["d/one.bin"]
        bad = mod.S3Remote(endpoint=s3.url, bucket="xbk", access_key="AKX",
                           secret_key="wrong")
        with pytest.raises(urllib.error.HTTPError) as ei:
            bad.read_file("d/one.bin")
        assert ei.value.code == 403
    finally:
        _stop(c, filer, s3)


# ---- ROADMAP fault 3.14: no volume lock across the network -----------------

def _probe_returns(fn, within: float = 0.5) -> bool:
    """Whether `fn()` returns within `within` seconds (its thread is left
    to finish)."""
    import threading
    done = threading.Event()
    th = threading.Thread(target=lambda: (fn(), done.set()), daemon=True)
    th.start()
    return done.wait(within)


@pytest.mark.parametrize("package", ["port", "reference"])
def test_tier_transfers_and_remote_reads_hold_no_volume_lock_unlike_the_reference(
        package, tmp_path, monkeypatch):
    """While a tier move uploads, a read goes through the remote tier or
    (the port's) a tier download downloads, the port's volume answers
    `info()` (the heartbeat's read, under the volume's lock) at once;
    the reference's holds the lock across the transfer, so `info()`
    waits for it.  A
    gateway over the same servers then deadlocks the reference's server
    loop (chip phase 28's tier step).  Both end with the same bytes."""
    import shutil
    import threading

    from seaweedfs_tpu.storage import needle as ref_needle
    from seaweedfs_tpu.storage import volume as ref_volume
    from seaweedfs_tpu_torch.storage import needle, volume
    vmod, nmod = (volume, needle) if package == "port" else \
        (ref_volume, ref_needle)
    free = package == "port"
    hot, cold = tmp_path / "hot", tmp_path / "cold"
    hot.mkdir()
    v = vmod.Volume(str(hot), "", 7)
    payload = {i: bytes([i]) * (1000 + i) for i in range(1, 6)}
    for i, data in payload.items():
        v.append_needle(nmod.Needle(id=i, cookie=i, data=data))
    with open(v.dat_path, "rb") as f:
        dat = f.read()
    gate, entered = threading.Event(), threading.Event()
    real_copy = shutil.copyfile

    def slow_copy(src, dst, *a, **k):
        entered.set()
        gate.wait(10)
        return real_copy(src, dst, *a, **k)
    # 1 the upload
    monkeypatch.setattr(shutil, "copyfile", slow_copy)
    mover = threading.Thread(target=v.tier_move,
                             args=("local", {"directory": str(cold)}))
    mover.start()
    assert entered.wait(5)
    assert _probe_returns(v.info) is free
    if free:  # sealed for the upload
        with pytest.raises(PermissionError):
            v.append_needle(nmod.Needle(id=9, cookie=9, data=b"late"))
    gate.set()
    mover.join(10)
    monkeypatch.setattr(shutil, "copyfile", real_copy)
    assert v.backend_kind == "remote" and not os.path.exists(v.dat_path)
    # 2 a read through the remote tier
    remote = v._dat.remote
    real_range = remote.read_range
    gate.clear()
    entered.clear()

    def slow_range(key, offset, size):
        entered.set()
        gate.wait(10)
        return real_range(key, offset, size)
    remote.read_range = slow_range
    got = []
    reader = threading.Thread(target=lambda: got.append(v.read_needle(3)))
    reader.start()
    assert entered.wait(5)
    assert _probe_returns(v.info) is free
    gate.set()
    reader.join(10)
    assert got[0].data == payload[3]
    # 3 the download, through a fresh client of the `.tier` marker's kind
    # (slowed on the port's class only: the reference's is not patched)
    gate.clear()
    entered.clear()
    if free:
        real_read_range = type(remote).read_range

        def slow_download(self, key, offset, size):
            entered.set()
            gate.wait(10)
            return real_read_range(self, key, offset, size)
        monkeypatch.setattr(type(remote), "read_range", slow_download)
    downloader = threading.Thread(target=v.tier_download)
    downloader.start()
    if free:
        assert entered.wait(5)
        assert _probe_returns(v.info)
    gate.set()
    downloader.join(10)
    with open(v.dat_path, "rb") as f:
        assert f.read() == dat
    for i, data in payload.items():
        assert v.read_needle(i).data == data
    v.close()


@pytest.mark.parametrize("interloper", [
    "compact", "catch_up", "placement", "mark_writable_then_write",
    "vacuum_handler", "changed_behind_the_guard"])
def test_tier_move_refuses_changes_during_its_upload(
        interloper, tmp_path, monkeypatch):
    """The port's upload runs without the volume's lock (3.14), so the
    volume is `tiering` until the switch: a compaction (the vacuum
    handler answers 409), a replica catch-up, a placement rewrite and
    `volume.mark -writable` (the readonly handler answers 409) refuse,
    and a write refuses even where the seal was cleared.  A change that
    got past the guard makes the switch abort: the local .dat stays, the
    uploaded copy goes, and nothing acknowledged is lost.  (The
    reference's lock makes each of these wait for its upload.)"""
    import asyncio
    import shutil
    import threading
    import types

    from seaweedfs_tpu_torch.server import volume_server as vsmod
    from seaweedfs_tpu_torch.storage import needle, types as st
    from seaweedfs_tpu_torch.storage import volume
    hot, cold = tmp_path / "hot", tmp_path / "cold"
    hot.mkdir()
    v = volume.Volume(str(hot), "", 7)
    payload = {i: bytes([i]) * (1000 + i) for i in range(1, 6)}
    for i, data in payload.items():
        v.append_needle(needle.Needle(id=i, cookie=i, data=data))
    v.delete_needle(5)
    v.close()
    vs = vsmod.VolumeServer([str(hot)], "127.0.0.1:1", device="cpu")
    v = vs.store.get_volume(7)
    gate, entered = threading.Event(), threading.Event()
    real_copy = shutil.copyfile

    def slow_copy(src, dst, *a, **k):
        entered.set()
        gate.wait(10)
        return real_copy(src, dst, *a, **k)

    def handler(fn, body):
        req = types.SimpleNamespace(json=lambda: asyncio.sleep(0, body))
        return asyncio.run(fn(req))
    monkeypatch.setattr(shutil, "copyfile", slow_copy)
    errors = []

    def move():
        try:
            v.tier_move("local", {"directory": str(cold)})
        except RuntimeError as e:
            errors.append(e)
    mover = threading.Thread(target=move)
    mover.start()
    try:
        assert entered.wait(5) and v.tiering
        if interloper == "compact":
            with pytest.raises(PermissionError, match="tier transfer"):
                v.compact()
        elif interloper == "catch_up":
            tail = tmp_path / "tail"
            tail.write_bytes(b"\0" * 8)
            with pytest.raises(PermissionError, match="tier transfer"):
                v.apply_catch_up(v._dat.size(), str(tail), b"")
        elif interloper == "placement":
            with pytest.raises(PermissionError, match="tier transfer"):
                v.set_replica_placement(st.ReplicaPlacement.parse("001"))
        elif interloper == "mark_writable_then_write":
            r = handler(vs.handle_volume_readonly,
                        {"volume": 7, "readonly": False})
            assert r.status == 409 and v.read_only
            v.read_only = False  # the seal cleared another way
            with pytest.raises(PermissionError):
                v.append_needle(needle.Needle(id=9, cookie=9, data=b"x"))
            with pytest.raises(PermissionError):
                v.delete_needle(1)
        elif interloper == "vacuum_handler":
            r = handler(vs.handle_vacuum, {"volume": 7})
            assert r.status == 409
        else:
            v.tiering = False
            v.compact()  # drops needle 5's record: the .dat shrinks
    finally:
        gate.set()
        mover.join(10)
        monkeypatch.setattr(shutil, "copyfile", real_copy)
    assert not v.tiering
    if interloper == "changed_behind_the_guard":
        assert len(errors) == 1 and "changed during" in str(errors[0])
        assert v.backend_kind != "remote" and os.path.exists(v.dat_path)
        assert not os.path.exists(v.tier_path)
        assert not [f for _, _, fs in os.walk(cold) for f in fs]
        assert not v.read_only
        v.append_needle(needle.Needle(id=9, cookie=9, data=b"late"))
        assert v.read_needle(9).data == b"late"
    else:
        assert not errors
        assert v.backend_kind == "remote" and not os.path.exists(v.dat_path)
        assert v.read_only
    for i in range(1, 5):
        assert v.read_needle(i).data == payload[i]
    vs.store.close()


# ---- ROADMAP fault 3.15: tier reads starve the server's pool ----------------

@pytest.mark.parametrize("package", ["port", "reference"])
def test_tier_reads_leave_the_default_pool_free_unlike_the_reference(
        package, tmp_path, monkeypatch):
    """A volume on a remote tier whose target reads this same server (a
    gateway over its filer, as chip phase 28's tier step has it): each
    read of the remote asks the server for a plain needle too big to be
    read on the loop.  With the loop's default pool at 2 threads and 4
    tier reads at once, the reference's tier reads hold both threads and
    the inner reads wait until their clients give up (1.5 s), where a
    gateway's read would fail.  The port reads the tier on a pool of its
    own, so every inner read is served."""
    import asyncio
    import concurrent.futures
    import threading

    from aiohttp import web

    from tests.test_torch_volume_server import _stub_master
    if package == "port":
        from seaweedfs_tpu_torch.server.volume_server import VolumeServer
        kw = {"device": "cpu"}
    else:
        from seaweedfs_tpu.server.volume_server import VolumeServer
        kw = {}
        monkeypatch.setenv("WEEDTPU_EC_CODEC", "numpy")
    loop = asyncio.new_event_loop()
    loop.set_default_executor(concurrent.futures.ThreadPoolExecutor(2))
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def submit(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(30)
    stub = web.AppRunner(_stub_master([]))
    submit(stub.setup())
    mport = free_port()
    submit(web.TCPSite(stub, "127.0.0.1", mport).start())
    (tmp_path / "vs").mkdir()
    vs = VolumeServer([str(tmp_path / "vs")], f"127.0.0.1:{mport}",
                      "127.0.0.1", free_port(), **kw)
    submit(vs.start())

    def call(path, data=None, body=None, timeout=20.0):
        if body is not None:
            data = json.dumps(body).encode()
        req = urllib.request.Request(f"http://{vs.url}{path}", data=data,
                                     method="POST" if data else "GET")
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()
    try:
        for vid in (7, 8):
            assert call("/admin/assign_volume", body={"volume": vid})[0] == 200
        blobs = {k: bytes([k]) * 4000 for k in range(1, 5)}
        for k, data in blobs.items():
            assert call(f"/7,{k:x}0000abcd", data=data)[0] == 201
        big = os.urandom(200_000)  # over the inline read's 64 KiB
        assert call("/8,10000abcd", data=big)[0] == 201
        st, _ = call("/admin/volume/tier_move", body={
            "volume": 7, "kind": "local",
            "options": {"directory": str(tmp_path / "cold")}})
        assert st == 200
        remote = vs.store.get_volume(7)._dat.remote
        real_range = remote.read_range
        inner = []

        def read_range(key, offset, size):
            try:
                st, got = call("/8,10000abcd", timeout=1.5)
                inner.append(st == 200 and got == big)
            except OSError:
                inner.append(False)  # the inner read timed out
            return real_range(key, offset, size)
        remote.read_range = read_range
        with concurrent.futures.ThreadPoolExecutor(4) as ex:
            got = list(ex.map(lambda k: call(f"/7,{k:x}0000abcd"),
                              blobs))
        assert got == [(200, blobs[k]) for k in blobs]
        assert len(inner) >= len(blobs)
        assert all(inner) is (package == "port")
    finally:
        submit(vs.stop())
        submit(stub.cleanup())
        loop.call_soon_threadsafe(loop.stop)
        thread.join(5)
        loop.close()
