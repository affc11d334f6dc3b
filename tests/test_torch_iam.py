"""The port's IAM API (`seaweedfs_tpu_torch/s3/iamapi_server.py`) and the
gateway's place in a secured cluster, on port clusters (the port's
master, a port volume server with `device="cpu"`, the port's filer):

- twins of tests/test_iam.py (both);
- an identity.json written by either package's IAM API authenticates in
  the other's gateway, picked up by its identity sync without a restart;
- twin of tests/test_security.py::test_full_jwt_enforcement_chain: the
  filer enforces its JWT keys and the gateway signs its filer calls;
- the CLI's `s3` and `iam` as subprocesses over a port filer: a signed
  PUT and GET, one user created through the IAM API and then signing
  through the gateway, and neither process loads jax, torch or the
  reference package.
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
import xml.etree.ElementTree as ET
from unittest import mock

import pytest

from seaweedfs_tpu.s3 import auth as ref_auth
from seaweedfs_tpu.s3.iamapi_server import IamApiServer as RefIamApiServer
from seaweedfs_tpu.s3.s3api_server import S3ApiServer as RefS3ApiServer

from seaweedfs_tpu_torch.s3 import auth
from seaweedfs_tpu_torch.s3.iamapi_server import IamApiServer
from seaweedfs_tpu_torch.s3.s3api_server import S3ApiServer
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from tests.test_torch_master_cluster import Cluster, free_port

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _quiet_cluster(monkeypatch):
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "0")
    monkeypatch.setenv("WEEDTPU_REPAIR_INTERVAL", "0")


def _call(url: str, **params) -> ET.Element:
    body = urllib.parse.urlencode(params).encode()
    try:
        with urllib.request.urlopen(f"http://{url}/", data=body,
                                    timeout=10) as r:
            return ET.fromstring(r.read().decode())
    except urllib.error.HTTPError as e:
        return ET.fromstring(e.read().decode())


def _texts(root, name):
    return [e.text for e in root.iter() if e.tag.endswith(name)]


def wait_for(pred, timeout=15.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.1)
    return False


def _http(url, data=None, method=None, headers=None):
    req = urllib.request.Request(url, data=data, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=15) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _signed(sign_v4, cred, host, method, path, data=b""):
    headers = sign_v4(cred, method, host, path, {}, payload=data)
    return _http(f"http://{host}{urllib.parse.quote(path)}",
                 data=data if method in ("PUT", "POST") else None,
                 method=method, headers=headers)


# ---- twins of tests/test_iam.py ---------------------------------------------

@pytest.fixture(scope="module")
def iam_stack(tmp_path_factory):
    from seaweedfs_tpu_torch.s3.auth import IdentityAccessManagement
    tmp = tmp_path_factory.mktemp("iam")
    with mock.patch.dict(os.environ, {"WEEDTPU_SCRUB_MBPS": "0",
                                      "WEEDTPU_REPAIR_INTERVAL": "0"}):
        c = Cluster(tmp, n_volume_servers=1).start()
    c.wait_heartbeats()
    filer = FilerServer(c.master.url, port=free_port(),
                        data_dir=str(tmp / "f"))
    shared_iam = IdentityAccessManagement()
    iam_srv = IamApiServer(filer.url, port=free_port(), iam=shared_iam)
    c.submit(filer.start())
    c.submit(iam_srv.start())
    yield iam_srv, shared_iam, c.submit, filer
    c.submit(iam_srv.stop())
    c.submit(filer.stop())
    c.stop()


def test_user_and_key_lifecycle(iam_stack):
    iam_srv, shared_iam, run, filer = iam_stack
    url = iam_srv.url

    _call(url, Action="CreateUser", UserName="alice")
    root = _call(url, Action="ListUsers")
    assert "alice" in _texts(root, "UserName")

    root = _call(url, Action="CreateAccessKey", UserName="alice")
    ak = _texts(root, "AccessKeyId")[0]
    sk = _texts(root, "SecretAccessKey")[0]
    assert ak and sk
    # the key is live in the IAM table the gateway shares
    ident, cred = shared_iam.lookup(ak)
    assert ident.name == "alice" and cred.secret_key == sk

    policy = ('{"Statement": [{"Action": ["s3:GetObject", "s3:PutObject"],'
              '"Effect": "Allow", "Resource": "*"}]}')
    _call(url, Action="PutUserPolicy", UserName="alice",
          PolicyDocument=policy)
    assert ident.can_do("Read", "any")
    assert ident.can_do("Write", "any")
    assert not ident.can_do("List", "any")

    # persisted to the filer; a fresh IAM server sees the same identities
    other = IamApiServer(filer.url, port=free_port())
    run(other.start())
    try:
        ident2, _ = other.iam.lookup(ak)
        assert ident2.name == "alice"
    finally:
        run(other.stop())

    _call(url, Action="DeleteAccessKey", UserName="alice", AccessKeyId=ak)
    root = _call(url, Action="ListAccessKeys", UserName="alice")
    assert ak not in _texts(root, "AccessKeyId")
    _call(url, Action="DeleteUser", UserName="alice")
    root = _call(url, Action="ListUsers")
    assert "alice" not in _texts(root, "UserName")


def test_unknown_action(iam_stack):
    iam_srv, *_ = iam_stack
    root = _call(iam_srv.url, Action="FrobnicateUser")
    assert "InvalidAction" in _texts(root, "Code")


# ---- identity.json across the packages --------------------------------------

@pytest.mark.parametrize("writer,reader", [("reference", "port"),
                                           ("port", "reference")])
def test_identity_file_authenticates_across_packages(tmp_path, writer,
                                                     reader):
    """One package's IAM API creates a user, a key and an s3:* policy;
    the other package's gateway over the same filer picks identity.json
    up through its meta feed and authenticates a request signed with
    that key by the writer's `sign_v4`, while an unsigned one is 403."""
    iam_cls = RefIamApiServer if writer == "reference" else IamApiServer
    gw_cls = S3ApiServer if reader == "port" else RefS3ApiServer
    sign = (ref_auth if writer == "reference" else auth).sign_v4
    cred_cls = (ref_auth if writer == "reference" else auth).Credential
    c = Cluster(tmp_path, n_volume_servers=1).start()
    c.wait_heartbeats()
    filer = FilerServer(c.master.url, port=free_port(),
                        data_dir=str(tmp_path / "f"))
    c.submit(filer.start())
    gw = gw_cls(filer.url, port=free_port())
    iam_srv = iam_cls(filer.url, port=free_port())
    c.submit(gw.start())
    c.submit(iam_srv.start())
    try:
        _call(iam_srv.url, Action="CreateUser", UserName="cross")
        root = _call(iam_srv.url, Action="CreateAccessKey",
                     UserName="cross")
        ak = _texts(root, "AccessKeyId")[0]
        sk = _texts(root, "SecretAccessKey")[0]
        _call(iam_srv.url, Action="PutUserPolicy", UserName="cross",
              PolicyDocument='{"Statement": [{"Action": "s3:*"}]}')
        assert wait_for(lambda: any(
            i.name == "cross" and "Admin" in i.actions
            for i in gw.iam.identities))
        cred = cred_cls(ak, sk)
        st, _ = _signed(sign, cred, gw.url, "PUT", "/xbucket")
        assert st == 200
        st, _ = _signed(sign, cred, gw.url, "PUT", "/xbucket/o.bin",
                        b"crossed")
        assert st == 200
        assert _signed(sign, cred, gw.url, "GET", "/xbucket/o.bin") == \
            (200, b"crossed")
        st, body = _http(f"http://{gw.url}/xbucket/o.bin")
        assert st == 403 and b"AccessDenied" in body
        with urllib.request.urlopen(
                f"http://{filer.url}/etc/iam/identity.json",
                timeout=15) as r:
            stored = json.loads(r.read())
        assert stored == {"identities": [
            {"name": "cross",
             "credentials": [{"accessKey": ak, "secretKey": sk}],
             "actions": ["Admin"]}]}
    finally:
        c.submit(iam_srv.stop())
        c.submit(gw.stop())
        c.submit(filer.stop())
        c.stop()


# ---- JWT enforcement --------------------------------------------------------

def test_full_jwt_enforcement_chain(tmp_path):
    """The volume read JWT and the filer write/read JWTs all enforced on
    the port's servers, and the gateway and the filer sign their inner
    calls so the chain still works."""
    from seaweedfs_tpu_torch.security.guard import SecurityConfig
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer

    sec = SecurityConfig({"jwt": {
        "signing": {"key": "wkey", "read": {"key": "rkey"}},
        "filer": {"signing": {"key": "fkey",
                              "read": {"key": "frkey"}}},
    }})
    assert sec.volume_read and sec.filer_write and sec.filer_read
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def run(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(60)

    master = MasterServer("127.0.0.1", free_port(), security=sec)
    vs = VolumeServer([str(tmp_path)], master.url, port=free_port(),
                      heartbeat_interval=0.2, security=sec, device="cpu")
    filer = FilerServer(master.url, port=free_port(), security=sec)
    s3 = S3ApiServer(filer.url, port=free_port(), security=sec)
    run(master.start())
    run(vs.start())
    run(filer.start())
    run(s3.start())
    try:
        # an unsigned filer write is refused; the gateway (signing) writes
        st, _ = _http(f"http://{filer.url}/x.txt", data=b"d", method="PUT")
        assert st == 401
        st, _ = _http(f"http://{s3.url}/sec-bucket", method="PUT")
        assert st == 200
        st, _ = _http(f"http://{s3.url}/sec-bucket/f.txt",
                      data=b"secret data", method="PUT")
        assert st == 200
        # an unsigned filer read is refused (the filer read key is set)
        st, _ = _http(f"http://{filer.url}/buckets/sec-bucket/f.txt")
        assert st == 401
        # the gateway signs its filer read, the filer its volume read
        assert _http(f"http://{s3.url}/sec-bucket/f.txt") == \
            (200, b"secret data")
    finally:
        run(s3.stop())
        run(filer.stop())
        run(vs.stop())
        run(master.stop())
        loop.call_soon_threadsafe(loop.stop)
        thread.join(5)


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


def _wait_listening(url, proc, log, what):
    deadline = time.time() + 60
    while True:
        try:
            urllib.request.urlopen(f"http://{url}/", data=b"",
                                   timeout=5).close()
            return
        except urllib.error.HTTPError:
            return  # answering
        except OSError:
            assert proc.poll() is None, log.read_text()[-3000:]
            assert time.time() < deadline, f"{what} never listened"
            time.sleep(0.1)


def test_s3_and_iam_cli_serve_without_jax_or_torch(tmp_path):
    """`python -m seaweedfs_tpu_torch s3 -filer F -config s3.json` and
    `... iam -filer F` over a port filer: a signed PUT and GET through
    the gateway, a user created with a key and an s3:* policy through
    the IAM API and then signing through the gateway (hot-reloaded), and
    neither process loads jax, torch or the reference package."""
    c = Cluster(tmp_path, n_volume_servers=1).start()
    c.wait_heartbeats()
    filer = FilerServer(c.master.url, port=free_port(),
                        data_dir=str(tmp_path / "f"))
    c.submit(filer.start())
    cfg = tmp_path / "s3.json"
    cfg.write_text(json.dumps({"identities": [{
        "name": "boot", "credentials": [{"accessKey": "BOOTKEY",
                                         "secretKey": "BOOTSECRET"}],
        "actions": ["Admin"]}]}))
    s3_port, iam_port = free_port(), free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs, logs = [], []
    try:
        for name, argv in (
                ("s3", ["s3", "-filer", filer.url, "-port", str(s3_port),
                        "-config", str(cfg)]),
                ("iam", ["iam", "-filer", filer.url, "-port",
                         str(iam_port)])):
            log_path = tmp_path / f"{name}.log"
            log = open(log_path, "wb")
            logs.append(log)
            procs.append((subprocess.Popen(
                [sys.executable, "-c", SERVER_CHILD] + argv,
                cwd=str(REPO), env=env, stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, stderr=log), log_path))
        s3_url, iam_url = f"127.0.0.1:{s3_port}", f"127.0.0.1:{iam_port}"
        _wait_listening(s3_url, *procs[0], "the gateway")
        _wait_listening(iam_url, *procs[1], "the IAM API")

        boot = auth.Credential("BOOTKEY", "BOOTSECRET")
        assert _signed(auth.sign_v4, boot, s3_url, "PUT", "/cli")[0] == 200
        data = os.urandom(300_000)
        st, _ = _signed(auth.sign_v4, boot, s3_url, "PUT", "/cli/o.bin",
                        data)
        assert st == 200
        assert _signed(auth.sign_v4, boot, s3_url, "GET", "/cli/o.bin") \
            == (200, data)
        assert _http(f"http://{s3_url}/cli/o.bin")[0] == 403

        _call(iam_url, Action="CreateUser", UserName="cli-user")
        root = _call(iam_url, Action="CreateAccessKey", UserName="cli-user")
        user = auth.Credential(_texts(root, "AccessKeyId")[0],
                               _texts(root, "SecretAccessKey")[0])
        assert "cli-user" in _texts(_call(iam_url, Action="ListUsers"),
                                    "UserName")
        # from here on the API holds an Admin with a key: it is signed-only
        _call(iam_url, Action="PutUserPolicy", UserName="cli-user",
              PolicyDocument='{"Statement": [{"Action": "s3:*"}]}')
        assert "AccessDenied" in _texts(
            _call(iam_url, Action="ListUsers"), "Code")
        # the gateway's identity sync replaces its -config identities
        # with the filer's identity.json
        assert wait_for(lambda: _signed(
            auth.sign_v4, user, s3_url, "GET", "/cli/o.bin") == (200, data))
        for proc, log_path in procs:
            out, _ = proc.communicate(b"\n", timeout=60)
            assert json.loads(out.decode().strip().splitlines()[-1]) == {
                "jax": False, "torch": False, "reference": []}, \
                log_path.read_text()[-3000:]
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for log in logs:
            log.close()
        c.submit(filer.stop())
        c.stop()
