"""The port's `fs.*` shell commands over a filer, on port clusters (the
port's master and port volume servers with `device="cpu"`, in process).

- Twins of tests/test_shell_commands.py's filer tests: `fs_roundtrip`,
  `fsck_clean_and_broken`, `fs_tree_and_cluster_ps`,
  `fs_meta_save_load_and_configure_replication` and `fs_breadth`, driven
  by the port's shell over the port's `FilerServer`.  The reference's
  `fs_breadth` stack also starts an MQ broker, which none of its steps
  uses (the port's is held to it in tests/test_torch_mq*.py).
- Both shells over either package's filer: the reference's shell and
  the port's run one script of every `fs.*` command on mirrored trees
  (`/ref` and `/port`, the same bytes) of one filer, the reference's or
  the port's, and print the same once the tree's name is read as
  `{root}` and the fields that differ by write (`fid`, `mtime`,
  `crtime`) are masked.  `fs.meta.notify` raises the same error in both:
  neither filer has a notification queue.
"""

import io
import json
import re
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from seaweedfs_tpu.server.filer_server import FilerServer as RefFilerServer
from seaweedfs_tpu.shell import commands as ref_commands

from seaweedfs_tpu_torch.client import WeedClient
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


def _has_filer(env) -> bool:
    return bool(env.master_get("/cluster/status").get("Members", {})
                .get("filer"))


def _put(filer, path, data: bytes):
    req = urllib.request.Request(f"http://{filer.url}{path}", data=data,
                                 method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        assert r.status in (200, 201)


@pytest.fixture()
def cluster3(tmp_path):
    c = Cluster(tmp_path, n_volume_servers=3).start()
    c.wait_heartbeats()
    yield c
    c.stop()


# ---- twins of tests/test_shell_commands.py's filer tests --------------------

@pytest.fixture()
def fs_stack(tmp_path):
    c = Cluster(tmp_path, n_volume_servers=1).start()
    c.wait_heartbeats()
    filer = FilerServer(c.master.url, port=free_port(),
                        data_dir=str(tmp_path / "filer"))
    c.submit(filer.start())
    env = CommandEnv(c.master.url)
    assert wait_for(lambda: _has_filer(env))
    yield c, filer, env
    c.submit(filer.stop())
    c.stop()


def test_fs_roundtrip(fs_stack):
    c, filer, env = fs_stack
    _put(filer, "/docs/hello.txt", b"hello world")
    out = shell(env, "fs.ls /docs")
    assert "hello.txt" in out
    out = shell(env, "fs.ls -l /docs")
    assert "11" in out
    out = shell(env, "fs.cat /docs/hello.txt")
    assert out == "hello world"
    shell(env, "fs.mkdir /docs/sub")
    assert "sub/" in shell(env, "fs.ls /docs")
    shell(env, "fs.mv /docs/hello.txt /docs/sub/hi.txt")
    assert "hi.txt" in shell(env, "fs.ls /docs/sub")
    out = shell(env, "fs.du /docs")
    assert "11 bytes in 1 file(s)" in out
    out = shell(env, "fs.meta.cat /docs/sub/hi.txt")
    assert "chunks" in out
    shell(env, "fs.rm -r /docs")
    assert "docs" not in shell(env, "fs.ls /")


def test_fsck_clean_and_broken(fs_stack):
    c, filer, env = fs_stack
    env.acquire_lock()
    _put(filer, "/data/f1.bin", b"z" * 50000)
    out = shell(env, "volume.fsck")
    assert "0 orphan(s), 0 broken ref(s)" in out
    client = WeedClient(c.master.url)
    client.upload(b"orphaned blob")
    client.close()
    out = shell(env, "volume.fsck")
    assert "1 orphan(s)" in out
    env.release_lock()


def test_fs_tree_and_cluster_ps(cluster3):
    c = cluster3
    filer = FilerServer(c.master.url, port=free_port())
    c.submit(filer.start())
    try:
        env = CommandEnv(c.master.url)
        assert wait_for(lambda: _has_filer(env))
        urllib.request.urlopen(urllib.request.Request(
            f"http://{filer.url}/t/a/b.txt", data=b"x", method="POST"),
            timeout=15)
        out = shell(env, "fs.tree /t")
        assert "+ a" in out and "- b.txt" in out
        out = shell(env, "cluster.ps")
        assert f"filer {filer.url}" in out
    finally:
        c.submit(filer.stop())


def test_fs_meta_save_load_and_configure_replication(cluster3, tmp_path):
    c = cluster3
    filer = FilerServer(c.master.url, port=free_port())
    c.submit(filer.start())
    try:
        env = CommandEnv(c.master.url)
        env.acquire_lock()
        assert wait_for(lambda: _has_filer(env))
        urllib.request.urlopen(urllib.request.Request(
            f"http://{filer.url}/ms/a.txt", data=b"meta-save",
            method="POST"), timeout=15)
        dump = str(tmp_path / "meta.jsonl")
        out = shell(env, f"fs.meta.save -o {dump} /ms")
        assert "1 entr" in out
        # the entry's metadata only deleted, then restored
        urllib.request.urlopen(urllib.request.Request(
            f"http://{filer.url}/ms/a.txt?skipChunkDeletion=true",
            method="DELETE"), timeout=15)
        out = shell(env, f"fs.meta.load -i {dump}")
        assert "1 entr" in out
        got = urllib.request.urlopen(
            f"http://{filer.url}/ms/a.txt", timeout=15).read()
        assert got == b"meta-save"
        client = WeedClient(c.master.url)
        fid = client.upload(b"rp", name="rp.bin")
        client.close()
        vid = int(fid.split(",")[0])
        out = shell(env, f"volume.configure.replication -volumeId {vid} "
                         f"-replication 001")
        assert "replication -> 001" in out

        def rp_seen():
            for nd in env.topology()["nodes"].values():
                for vi in nd.get("volume_infos", []):
                    if vi["id"] == vid:
                        return vi["replica_placement"] == "001"
            return False
        assert wait_for(rp_seen)
        env.release_lock()
    finally:
        c.submit(filer.stop())


def test_fs_breadth(tmp_path):
    c = Cluster(tmp_path, n_volume_servers=2).start()
    c.wait_heartbeats()
    filer = FilerServer(c.master.url, port=free_port(),
                        data_dir=str(tmp_path / "filer"))
    c.submit(filer.start())
    try:
        env = CommandEnv(c.master.url)
        assert wait_for(lambda: _has_filer(env))
        _put(filer, "/w/a.txt", b"alpha")
        assert shell(env, "fs.pwd").strip() == "/"
        shell(env, "fs.cd /w")
        assert shell(env, "fs.pwd").strip() == "/w"
        assert "alpha" == shell(env, "fs.cat a.txt")  # a relative path
        shell(env, "fs.cp a.txt /w/b.txt")
        assert shell(env, "fs.cat /w/b.txt") == "alpha"
        out = shell(env, "fs.verify /w/a.txt")
        assert "0 missing" in out
        out = shell(env, "fs.configure")
        assert "locations" in out
        out = shell(env, "fs.configure -locationPrefix /w -readOnly true "
                         "-apply")
        assert "applied" in out
        with pytest.raises(urllib.error.HTTPError):
            _put(filer, "/w/blocked.txt", b"nope")
        shell(env, "fs.configure -locationPrefix /w -delete true -apply")
        _put(filer, "/w/ok.txt", b"yes")
        shell(env, "fs.cd /")
    finally:
        c.submit(filer.stop())
        c.stop()


# ---- both shells over either package's filer ---------------------------------

SCRIPT = (
    "fs.ls {root}", "fs.ls -l {root}", "fs.cat {root}/a.txt",
    "fs.du {root}", "fs.tree {root}", "fs.meta.cat {root}/a.txt",
    "fs.mkdir {root}/sub", "fs.mv {root}/a.txt {root}/sub/a.txt",
    "fs.cp {root}/sub/a.txt {root}/b.txt", "fs.verify {root}/big.bin",
    "fs.verify {root}/b.txt", "fs.cd {root}/sub", "fs.pwd", "fs.ls",
    "fs.du", "fs.cd /", "fs.configure",
    "fs.configure -locationPrefix {root}/ro -readOnly true",
    "fs.meta.save -o {dump} {root}", "fs.rm {root}/b.txt",
    "fs.meta.load -i {dump}", "fs.ls -l {root}",
    "fs.meta.change.volume.id -dir {root} -fromVolumeId {vid} "
    "-toVolumeId 77",
    "fs.merge.volumes -dir {root} -fromVolumeId {vid}",
    "fs.meta.notify {root}", "fs.rm -r {root}/sub", "fs.tree {root}",
)


def _mask(text: str) -> str:
    return re.sub(r'("(?:fid|mtime|crtime)": )("[^"]*"|[0-9.e+-]+)',
                  r"\1<masked>", text)


def _run(mod, env, line) -> str:
    buf = io.StringIO()
    try:
        rc = mod.run_command(env, line, buf)
    except RuntimeError as e:
        return f"raised {e}"
    return f"{buf.getvalue()}rc {rc}"


@pytest.mark.parametrize("filer_pkg", ["reference", "port"])
def test_both_shells_print_the_same_over_either_filer(tmp_path,
                                                      filer_pkg):
    c = Cluster(tmp_path, n_volume_servers=1).start()
    c.wait_heartbeats()
    cls = RefFilerServer if filer_pkg == "reference" else FilerServer
    filer = cls(c.master.url, port=free_port(),
                data_dir=str(tmp_path / "filer"), chunk_size=64 * 1024)
    c.submit(filer.start())
    try:
        envs = {"ref": ref_commands.CommandEnv(c.master.url),
                "port": CommandEnv(c.master.url)}
        assert wait_for(lambda: _has_filer(envs["port"]))
        big = np.random.default_rng(7).bytes(200_000)
        vids = set()
        for root in ("/ref", "/port"):
            _put(filer, f"{root}/a.txt", b"hello both shells")
            _put(filer, f"{root}/big.bin", big)
            with urllib.request.urlopen(
                    f"http://{filer.url}{root}/big.bin?metadata=true",
                    timeout=15) as r:
                vids |= {int(ck["fid"].split(",")[0])
                         for ck in json.loads(r.read())["chunks"]}
        assert len(vids) == 1, vids  # one volume: the same dry runs
        for line in SCRIPT:
            outs = {}
            for name, mod in (("ref", ref_commands), ("port", commands)):
                root = f"/{name}"
                text = _run(mod, envs[name], line.format(
                    root=root, vid=min(vids),
                    dump=tmp_path / f"{name}.jsonl"))
                outs[name] = _mask(text.replace(root, "{root}").replace(
                    str(tmp_path / f"{name}.jsonl"), "{dump}"))
            assert outs["port"] == outs["ref"], line
        assert "raised" in _run(commands, envs["port"],
                                "fs.meta.notify /")
    finally:
        c.submit(filer.stop())
        c.stop()
