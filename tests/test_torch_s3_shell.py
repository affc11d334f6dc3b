"""The port's `s3.*` shell commands, on port clusters (the port's master,
port volume servers with `device="cpu"`, the port's filer and gateway):

- twins of tests/test_shell_commands.py's `TestFsCommands::test_bucket_commands`,
  `test_s3_configure_hot_reload`, `test_s3_bucket_quota_lifecycle` and
  `TestRound5Commands::test_s3_circuitbreaker`;
- both shells across the packages: one script of every `s3.*` command
  runs through the reference's shell and through the port's on two
  fresh clusters of one package (a port gateway's cluster, then a
  reference one), and both print the same, the multipart upload ids
  `s3.clean.uploads` names read as `{upload}`; the cluster's gateway
  hot-reloads what the shells stored.
"""

import io
import re
import time
import urllib.error
import urllib.request

import pytest

from seaweedfs_tpu.shell import commands as ref_commands
from tests import test_cluster as ref_cluster

from seaweedfs_tpu_torch.s3.auth import (Credential, Identity,
                                         IdentityAccessManagement, sign_v4)
from seaweedfs_tpu_torch.s3.s3api_server import S3ApiServer
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.shell import commands
from seaweedfs_tpu_torch.shell.commands import CommandEnv, run_command
from tests.test_torch_master_cluster import Cluster, free_port


@pytest.fixture(autouse=True)
def _quiet_cluster(monkeypatch):
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "0")
    monkeypatch.setenv("WEEDTPU_REPAIR_INTERVAL", "0")


def shell(env, line) -> str:
    buf = io.StringIO()
    run_command(env, line, buf)
    return buf.getvalue()


def wait_for(pred, timeout=6.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.1)
    return False


def _put(filer, path, data: bytes, method="POST"):
    req = urllib.request.Request(f"http://{filer.url}{path}", data=data,
                                 method=method)
    with urllib.request.urlopen(req, timeout=30) as r:
        assert r.status in (200, 201)


def _filer_stack(tmp_path, n_volume_servers):
    c = Cluster(tmp_path, n_volume_servers=n_volume_servers).start()
    c.wait_heartbeats()
    filer = FilerServer(c.master.url, port=free_port(),
                        data_dir=str(tmp_path / "filer"))
    c.submit(filer.start())
    env = CommandEnv(c.master.url)
    assert wait_for(lambda: bool(
        env.master_get("/cluster/status").get("Members", {}).get("filer")))
    return c, filer, env


# ---- twins of tests/test_shell_commands.py ----------------------------------

class TestFsCommands:
    @pytest.fixture()
    def stack(self, tmp_path):
        c, filer, env = _filer_stack(tmp_path, 1)
        yield c, filer, env
        c.submit(filer.stop())
        c.stop()

    def test_bucket_commands(self, stack):
        c, filer, env = stack
        env.acquire_lock()
        shell(env, "s3.bucket.create mybucket")
        assert "mybucket" in shell(env, "s3.bucket.list")
        _put(filer, "/buckets/mybucket/k.txt", b"v")
        shell(env, "s3.bucket.delete mybucket")
        assert "mybucket" not in shell(env, "s3.bucket.list")


def test_s3_configure_hot_reload(tmp_path):
    """s3.configure writes the filer's identity.json; a running gateway
    hot-reloads it."""
    c = Cluster(tmp_path, n_volume_servers=1).start()
    c.wait_heartbeats()
    filer = FilerServer(c.master.url, port=free_port())
    c.submit(filer.start())
    s3 = S3ApiServer(filer.url, port=free_port())
    c.submit(s3.start())
    try:
        env = CommandEnv(c.master.url)
        env.acquire_lock()
        assert wait_for(lambda: bool(
            env.master_get("/cluster/status").get("Members", {}).get("filer")))
        out = shell(env, "s3.configure -user ops -access_key OPSKEY "
                         "-secret_key OPSSECRET -actions Admin")
        assert "configured identity ops" in out
        out = shell(env, "s3.configure -list")
        assert "ops" in out and "OPSKEY" in out
        # the gateway hot-loads it: auth becomes enforced
        assert wait_for(lambda: s3.iam.enabled, timeout=15)
        ident, cred = s3.iam.lookup("OPSKEY")
        assert ident.name == "ops" and cred.secret_key == "OPSSECRET"
        shell(env, "s3.configure -user ops -delete")
        assert wait_for(
            lambda: not any(i.name == "ops" for i in s3.iam.identities),
            timeout=15)
    finally:
        c.submit(s3.stop())
        c.submit(filer.stop())
        c.stop()


def test_s3_bucket_quota_lifecycle(tmp_path):
    """Quota set -> check flips the bucket read-only when over; deletes
    under quota clear it."""
    c = Cluster(tmp_path, n_volume_servers=1).start()
    c.wait_heartbeats()
    filer = FilerServer(c.master.url, port=free_port(),
                        data_dir=str(tmp_path / "f"))
    c.submit(filer.start())
    try:
        env = CommandEnv(c.master.url)
        assert wait_for(lambda: c.master.cluster_members.get("filer"))
        shell(env, "s3.bucket.create -name qb")
        urllib.request.urlopen(urllib.request.Request(
            f"http://{filer.url}/buckets/qb/a.bin", data=b"x" * 4096,
            method="PUT"), timeout=15).read()
        out = shell(env, "s3.bucket.quota -name qb -quotaMB 0.001")  # 1048B
        assert "quota 1048 bytes" in out
        # a lifecycle-style TTL rule at the bucket prefix must survive the
        # quota toggles below
        shell(env, "fs.configure -locationPrefix /buckets/qb/ -ttl 7d "
                   "-collection qb -apply")
        out = shell(env, "s3.bucket.quota.check")
        assert "OVER" in out and "would mark" in out
        out = shell(env, "s3.bucket.quota.check -apply")
        assert "1 rule change(s) applied" in out
        # bucket writes now refuse (the filer's read-only rule)
        st = 0
        try:
            urllib.request.urlopen(urllib.request.Request(
                f"http://{filer.url}/buckets/qb/b.bin", data=b"y",
                method="PUT"), timeout=15)
            st = 200
        except urllib.error.HTTPError as e:
            st = e.code
        assert st == 403
        # free space; check clears the rule; writes flow again
        urllib.request.urlopen(urllib.request.Request(
            f"http://{filer.url}/buckets/qb/a.bin", method="DELETE"),
            timeout=15).read()
        out = shell(env, "s3.bucket.quota.check -apply")
        assert "[ok]" in out
        urllib.request.urlopen(urllib.request.Request(
            f"http://{filer.url}/buckets/qb/c.bin", data=b"z",
            method="PUT"), timeout=15).read()
        conf = env.master_get_raw(filer.url, "/__admin__/filer_conf")
        rule = next(r for r in conf["locations"]
                    if r["location_prefix"] == "/buckets/qb/")
        assert rule["ttl"] == "7d" and not rule.get("read_only")
        out = shell(env, "s3.bucket.quota -name qb -delete true")
        assert "removed" in out
    finally:
        c.submit(filer.stop())
        c.stop()


class TestRound5Commands:
    @pytest.fixture()
    def stack(self, tmp_path):
        c, filer, env = _filer_stack(tmp_path, 2)
        yield c, filer, env
        c.submit(filer.stop())
        c.stop()

    def test_s3_circuitbreaker(self, stack):
        """s3.circuitbreaker stores its config in the filer and a live
        gateway hot-reloads it."""
        c, filer, env = stack
        iam = IdentityAccessManagement([
            Identity("admin", [Credential("AK", "SK")], ["Admin"])])
        s3 = S3ApiServer(filer.url, port=free_port(), iam=iam)
        c.submit(s3.start())
        try:
            out = shell(env, "s3.circuitbreaker")
            assert "no circuit breaker" in out
            out = shell(env, "s3.circuitbreaker -global.requests 7 "
                             "-bucket.requests 3 -apply")
            assert "applied" in out
            out = shell(env, "s3.circuitbreaker")
            assert '"global_max_requests": 7' in out
            assert wait_for(
                lambda: s3.breaker.global_max_requests == 7, timeout=15)
            assert s3.breaker.bucket_max_requests == 3
        finally:
            c.submit(s3.stop())


# ---- both shells over either package's gateway cluster ----------------------

OPS = Credential("OPSKEY", "OPSSECRET")

SCRIPT = [
    "s3.bucket.create -name alpha",
    "s3.bucket.create beta",
    "s3.bucket.list",
    "s3.configure -list",
    "s3.configure -user ops -access_key OPSKEY -secret_key OPSSECRET "
    "-actions Admin",
    "s3.configure -user viewer -access_key VIEWKEY -secret_key VIEWSECRET "
    "-actions Read,List",
    "s3.configure -list",
    "s3.circuitbreaker",
    "s3.circuitbreaker -global.requests 50 -bucket.requests 20 "
    "-global.uploadBytes 1000000000 -apply",
    "s3.circuitbreaker",
    "@put /buckets/alpha/a.bin 4096",
    "@put /buckets/alpha/d/b.bin 100",
    "s3.bucket.quota -name alpha -quotaMB 0.001",
    "s3.bucket.quota.check",
    "s3.bucket.quota.check -apply",
    "s3.bucket.quota -name alpha -quotaMB 1",
    "s3.bucket.quota.check -apply",
    "s3.bucket.quota -name alpha -delete true",
    "@multipart alpha a.bin",
    "@multipart beta big.bin",
    "@multipart beta other.bin",
    "s3.clean.uploads -timeAgo 24h",
    "s3.clean.uploads -timeAgo 0s",
    "s3.configure -user viewer -delete",
    "s3.configure -list",
    "s3.bucket.delete beta",
    "s3.bucket.list",
]

UPLOAD_ID = re.compile(r"/\.uploads/[0-9a-f]{32}")


def _run_script(cluster, filer, gateway, mod) -> str:
    """The script through one package's shell; `@` lines are the
    test's own writes (a filer PUT, a multipart upload initiated
    through the gateway, signed by the `ops` identity)."""
    env = mod.CommandEnv(cluster.master.url)
    assert wait_for(lambda: bool(
        env.master_get("/cluster/status").get("Members", {}).get("filer")))
    env.acquire_lock()
    out = io.StringIO()
    for line in SCRIPT:
        if line.startswith("@put "):
            _, path, size = line.split()
            _put(filer, path, b"q" * int(size), method="PUT")
            continue
        if line.startswith("@multipart "):
            _, bucket, key = line.split()
            path = f"/{bucket}/{key}"
            headers = sign_v4(OPS, "POST", gateway.url, path,
                              {"uploads": ""})
            req = urllib.request.Request(
                f"http://{gateway.url}{path}?uploads=", method="POST",
                headers=headers, data=b"")
            with urllib.request.urlopen(req, timeout=30) as r:
                assert r.status == 200
            continue
        print(f"$ {line}", file=out)
        mod.run_command(env, line, out)
    env.release_lock()
    return UPLOAD_ID.sub("/.uploads/{upload}", out.getvalue())


def _gateway_cluster(tmp_path, package):
    if package == "port":
        c = Cluster(tmp_path, n_volume_servers=1).start()
        filer_cls, gw_cls = FilerServer, S3ApiServer
    else:
        from seaweedfs_tpu.s3.s3api_server import S3ApiServer as RefS3
        from seaweedfs_tpu.server.filer_server import FilerServer as RefF
        c = ref_cluster.Cluster(tmp_path, n_volume_servers=1).start()
        filer_cls, gw_cls = RefF, RefS3
    c.wait_heartbeats()
    filer = filer_cls(c.master.url, port=free_port(),
                      data_dir=str(tmp_path / "filer"))
    c.submit(filer.start())
    gw = gw_cls(filer.url, port=free_port(), master_url=c.master.url)
    c.submit(gw.start())
    return c, filer, gw


@pytest.mark.parametrize("package", ["port", "reference"])
def test_both_shells_print_the_same_s3_commands(tmp_path, package):
    outs, gateways, stacks = {}, {}, []
    try:
        for shell_name, mod in (("reference", ref_commands),
                                ("port", commands)):
            d = tmp_path / shell_name
            d.mkdir()
            c, filer, gw = _gateway_cluster(d, package)
            stacks.append((c, filer, gw))
            outs[shell_name] = _run_script(c, filer, gw, mod)
            gateways[shell_name] = gw
        assert outs["port"] == outs["reference"]
        text = outs["port"]
        assert "alpha\nbeta\n" in text and "[OVER]" in text
        assert text.count("removed /buckets/beta/.uploads/{upload}") == 2
        assert "3 abandoned upload(s) removed" in text
        assert "viewer" not in text.rsplit("$ s3.configure -list", 1)[1]
        for gw in gateways.values():
            # the gateway reloaded what the shell stored in the filer
            assert wait_for(lambda: gw.breaker.global_max_requests == 50,
                            timeout=15)
            assert gw.breaker.bucket_max_requests == 20
            assert wait_for(lambda: [i.name for i in gw.iam.identities]
                            == ["ops"], timeout=15)
    finally:
        for c, filer, gw in stacks:
            c.submit(gw.stop())
            c.submit(filer.stop())
            c.stop()
