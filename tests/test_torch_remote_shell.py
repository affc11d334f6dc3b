"""The port shell's `remote.*`, `volume.tier.*` and `fs.meta.notify`
commands and `remote_sync_loop` on port clusters (the port's master,
port volume servers with `device="cpu"` and a port `FilerServer`, in
process).

- Twins of tests/test_shell_commands.py's
  `test_fs_meta_notify_and_change_volume_id`,
  `test_filer_remote_sync_loop`, `TestBreadthCommands::test_remote_commands`
  and `::test_tier_upload_download_roundtrip`, and
  `TestRound5Commands::test_remote_mount_buckets` (against the port's
  gateway), each keeping its name and checks.  The reference's breadth
  stack also starts an MQ broker, which none of these steps uses (the
  port's is held to it in tests/test_torch_mq*.py).
- Both shells over one port cluster print the same for the 11 commands
  this slice brought (`cluster.geo`, the three `volume.tier.*`, the seven
  `remote.*`), each on a tree, a bucket and a volume of its own, once
  those names are masked.
"""

import io
import json
import threading
import time
import urllib.request

import pytest

from seaweedfs_tpu.shell import commands as ref_commands
from seaweedfs_tpu_torch.client import WeedClient
from seaweedfs_tpu_torch.shell import commands
from seaweedfs_tpu_torch.shell.commands import CommandEnv, run_command
from tests.test_torch_master_cluster import Cluster, free_port


@pytest.fixture(autouse=True)
def _quiet_cluster(monkeypatch):
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "0")
    monkeypatch.setenv("WEEDTPU_REPAIR_INTERVAL", "0")
    monkeypatch.setenv("WEEDTPU_AGG_INTERVAL", "0")


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


@pytest.fixture()
def stack(tmp_path):
    """The reference's breadth and round-5 stacks without the broker: two
    port volume servers and one port filer."""
    from seaweedfs_tpu_torch.server.filer_server import FilerServer
    c = Cluster(tmp_path, n_volume_servers=2).start()
    c.wait_heartbeats()
    filer = FilerServer(c.master.url, port=free_port(),
                        data_dir=str(tmp_path / "filer"))
    c.submit(filer.start())
    env = CommandEnv(c.master.url)
    assert wait_for(lambda: _has_filer(env))
    yield c, filer, env
    c.submit(filer.stop())
    c.stop()


# ---- twins of tests/test_shell_commands.py ---------------------------------

def test_tier_upload_download_roundtrip(stack, tmp_path):
    c, filer, env = stack
    client = WeedClient(c.master.url)
    fid = client.upload(b"tiered payload", name="t.bin")
    vid = int(fid.split(",")[0])
    env.acquire_lock()
    out = shell(env, f"volume.tier.upload -volumeId {vid} "
                     f"-dest local:{tmp_path / 'cold'}")
    assert "tier local" in out
    assert client.download(fid) == b"tiered payload"
    out = shell(env, f"volume.tier.download -volumeId {vid} "
                     f"-deleteRemote true")
    assert "back on local disk" in out
    assert client.download(fid) == b"tiered payload"
    # writable again after download
    client.upload(b"after download")
    client.close()


def test_remote_commands(stack, tmp_path):
    c, filer, env = stack
    bucket = tmp_path / "rbucket"
    bucket.mkdir()
    (bucket / "one.txt").write_bytes(b"remote-one")
    out = shell(env, f"remote.mount -remote local:{bucket} -dir /rm "
                     "-cache true")
    assert "1 object(s)" in out
    # remote gains + loses objects; meta.sync reconciles
    (bucket / "two.txt").write_bytes(b"remote-two")
    (bucket / "one.txt").unlink()
    out = shell(env, f"remote.meta.sync -remote local:{bucket} -dir /rm")
    assert "1 updated, 1 deleted" in out
    assert "two.txt" in shell(env, "fs.ls /rm")
    assert "one.txt" not in shell(env, "fs.ls /rm")
    # cache then uncache back to placeholders
    shell(env, f"remote.cache -remote local:{bucket} -dir /rm")
    assert shell(env, "fs.cat /rm/two.txt") == "remote-two"
    out = shell(env, "remote.uncache -dir /rm")
    assert "1 file(s)" in out
    out = shell(env, f"remote.configure -name cold "
                     f"-spec local:{bucket}")
    assert "cold" in out
    out = shell(env, "remote.configure -delete true -name cold")
    assert "no remotes" in out
    # unmount detaches the mapping; entries remain by default
    out = shell(env, "remote.unmount -dir /rm")
    assert "detached" in out
    assert "two.txt" in shell(env, "fs.ls /rm")


def test_remote_mount_buckets(stack, tmp_path):
    """remote.mount.buckets lists an S3 remote's buckets and mounts each,
    against the port's own gateway as the remote."""
    from seaweedfs_tpu_torch.s3.auth import (Credential, Identity,
                                             IdentityAccessManagement,
                                             sign_v4)
    from seaweedfs_tpu_torch.s3.s3api_server import S3ApiServer
    c, filer, env = stack
    cred = Credential("AK2", "SK2")
    iam = IdentityAccessManagement([Identity("admin", [cred], ["Admin"])])
    s3 = S3ApiServer(filer.url, port=free_port(), iam=iam)
    c.submit(s3.start())
    try:
        def s3req(method, path, data=None):
            headers = sign_v4(cred, method, s3.url, path, {},
                              payload=data or b"")
            req = urllib.request.Request(
                f"http://{s3.url}{path}", data=data, method=method,
                headers=headers)
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.status
        assert s3req("PUT", "/books") == 200
        assert s3req("PUT", "/music") == 200
        assert s3req("PUT", "/books/novel.txt", b"pages") == 200
        env.acquire_lock()
        out = shell(env, "remote.mount.buckets -dir /mirror "
                         f"-remote s3:endpoint={s3.url},"
                         f"access_key=AK2,secret_key=SK2 "
                         f"-bucketPattern book*")
        assert "books: 1 object(s) -> /mirror/books" in out
        assert "music" not in out
        out = shell(env, "fs.ls /mirror/books")
        assert "novel.txt" in out
    finally:
        c.submit(s3.stop())


def test_filer_remote_sync_loop(tmp_path):
    """Continuous local->remote push: changes under the mounted dir appear
    on the remote; placeholder traffic is skipped."""
    from seaweedfs_tpu_torch.remote_storage import (LocalDirRemote,
                                                    remote_sync_loop)
    from seaweedfs_tpu_torch.server.filer_server import FilerServer
    c = Cluster(tmp_path, n_volume_servers=1).start()
    c.wait_heartbeats()
    filer = FilerServer(c.master.url, port=free_port())
    c.submit(filer.start())
    stop = threading.Event()
    th = None
    try:
        remote = LocalDirRemote(str(tmp_path / "target"))
        th = threading.Thread(
            target=remote_sync_loop,
            args=(remote, filer.url, "/synced"),
            kwargs={"offset_file": str(tmp_path / "off"),
                    "stop_event": stop},
            daemon=True)
        th.start()
        time.sleep(0.5)
        req = urllib.request.Request(
            f"http://{filer.url}/synced/data.txt", data=b"pushed bytes",
            method="PUT")
        with urllib.request.urlopen(req, timeout=15):
            pass
        assert wait_for(
            lambda: (tmp_path / "target" / "data.txt").exists(), 10)
        assert (tmp_path / "target" / "data.txt").read_bytes() == \
            b"pushed bytes"
        # delete propagates too
        req = urllib.request.Request(
            f"http://{filer.url}/synced/data.txt", method="DELETE")
        with urllib.request.urlopen(req, timeout=15):
            pass
        assert wait_for(
            lambda: not (tmp_path / "target" / "data.txt").exists(), 10)
        stop.set()
    finally:
        stop.set()
        # the port's filer ends its live feeds when it stops, which ends
        # the loop's read
        c.submit(filer.stop())
        c.stop()
        if th is not None:
            th.join(10)
    assert not th.is_alive()


def test_fs_meta_notify_and_change_volume_id(tmp_path):
    from seaweedfs_tpu_torch.notification import MemoryQueue
    from seaweedfs_tpu_torch.server.filer_server import FilerServer
    c = Cluster(tmp_path, n_volume_servers=1).start()
    c.wait_heartbeats()
    q = MemoryQueue()
    filer = FilerServer(c.master.url, port=free_port(),
                        data_dir=str(tmp_path / "f"), notification=q)
    c.submit(filer.start())
    try:
        env = CommandEnv(c.master.url)
        assert wait_for(lambda: c.master.cluster_members.get("filer"))
        for p in ("/nt/a.txt", "/nt/sub/b.txt"):
            urllib.request.urlopen(urllib.request.Request(
                f"http://{filer.url}{p}", data=b"x", method="PUT"),
                timeout=15).read()
        q.messages.clear()  # drop the live events; notify replays
        out = shell(env, "fs.meta.notify /nt")
        # a.txt + sub + sub/b.txt
        assert "notified 3 entr(ies)" in out
        paths = {(m.get("new_entry") or {}).get("full_path")
                 for _, m in q.messages}
        assert {"/nt/a.txt", "/nt/sub", "/nt/sub/b.txt"} <= paths

        # change volume id metadata: dry run then forced rewrite
        meta = json.loads(urllib.request.urlopen(
            f"http://{filer.url}/nt/a.txt?metadata=true",
            timeout=15).read())
        vid = int(meta["chunks"][0]["fid"].split(",")[0])
        out = shell(env, f"fs.meta.change.volume.id -dir /nt "
                         f"-fromVolumeId {vid} -toVolumeId {vid + 90}")
        assert "need updating" in out and "dry run" in out
        meta2 = json.loads(urllib.request.urlopen(
            f"http://{filer.url}/nt/a.txt?metadata=true",
            timeout=15).read())
        assert meta2["chunks"][0]["fid"].startswith(f"{vid},")
        out = shell(env, f"fs.meta.change.volume.id -dir /nt "
                         f"-fromVolumeId {vid} -toVolumeId {vid + 90} "
                         f"-force")
        assert "updated" in out
    finally:
        c.submit(filer.stop())
        c.stop()


# ---- both shells print alike --------------------------------------------------

def test_both_shells_print_the_same_remote_and_tier_commands(stack,
                                                            tmp_path):
    """The reference's shell and the port's, in turn on one port cluster,
    each on a tree (`/ref`, `/prt`: names of one length, as the
    listings pad them), a local bucket, a cold directory, an
    S3 bucket of the port's gateway and a volume of its own: every one of
    the 11 commands prints the same once those names are masked."""
    from seaweedfs_tpu_torch.s3.auth import (Credential, Identity,
                                             IdentityAccessManagement)
    from seaweedfs_tpu_torch.s3.s3api_server import S3ApiServer
    from seaweedfs_tpu_torch.remote_storage import S3Remote
    c, filer, env = stack
    cred = Credential("AK3", "SK3")
    s3 = S3ApiServer(filer.url, port=free_port(),
                     iam=IdentityAccessManagement(
                         [Identity("admin", [cred], ["Admin"])]))
    c.submit(s3.start())
    client = WeedClient(c.master.url)
    try:
        names = {}
        for tag in ("ref", "prt"):
            bucket = tmp_path / f"{tag}-bucket"
            (bucket / "d").mkdir(parents=True)
            (bucket / "one.txt").write_bytes(b"remote-one")
            (bucket / "d" / "two.txt").write_bytes(b"remote-two" * 9)
            r = S3Remote(s3.url, f"{tag}books", access_key="AK3",
                         secret_key="SK3")
            r.create_bucket()
            r.write_file("novel.txt", b"pages")
            fid = client.upload(b"tiered " + tag.encode(), name="t.bin",
                                collection=f"c{tag}")
            vid = int(fid.split(",")[0])
            url = env.volume_locations(vid)[0]
            names[tag] = {"bucket": str(bucket),
                          "cold": str(tmp_path / f"{tag}-cold"),
                          "vid": vid, "fid": fid, "url": url}
        spec = f"s3:endpoint={s3.url},access_key=AK3,secret_key=SK3"
        printed = {}
        for tag, mod in (("ref", ref_commands), ("prt", commands)):
            n = names[tag]
            e = mod.CommandEnv(c.master.url)
            bucket, root = n["bucket"], f"/{tag}"

            def run(line):
                buf = io.StringIO()
                mod.run_command(e, line, buf)
                return buf.getvalue()
            out = [run(f"remote.mount -remote local:{bucket} -dir "
                       f"{root}/rm")]
            with open(f"{bucket}/three.txt", "wb") as f:
                f.write(b"remote-three")
            import os
            os.remove(f"{bucket}/one.txt")
            out += [run(f"remote.meta.sync -remote local:{bucket} -dir "
                        f"{root}/rm"),
                    run(f"remote.cache -remote local:{bucket} -dir "
                        f"{root}/rm"),
                    run(f"remote.uncache -dir {root}/rm"),
                    run(f"remote.configure -name cold{tag} -spec "
                        f"local:{bucket}"),
                    run("remote.configure"),
                    run(f"remote.configure -delete true -name cold{tag}"),
                    run(f"remote.unmount -dir {root}/rm"),
                    run(f"remote.mount.buckets -dir {root}/mb -remote "
                        f"{spec} -bucketPattern {tag}*"),
                    run("cluster.geo"), run("lock"),
                    run(f"volume.tier.upload -volumeId {n['vid']} -dest "
                        f"local:{n['cold']}"),
                    run(f"volume.tier.download -volumeId {n['vid']} "
                        f"-deleteRemote true"),
                    run(f"volume.tier.move -volumeId {n['vid']} -dest "
                        f"local:{n['cold']}"),
                    run(f"volume.tier.download -volumeId {n['vid']}"),
                    run("unlock")]
            text = "".join(out)
            for k in ("bucket", "cold"):
                text = text.replace(n[k], k.upper())
            text = text.replace(n["url"], "URL")
            text = text.replace(f"volume {n['vid']} on", "volume VID on")
            text = text.replace(f"{tag}books", "TAGbooks")
            text = text.replace(root, "/ROOT").replace(f"cold{tag}",
                                                       "coldTAG")
            printed[tag] = text
            assert client.download(n["fid"]) == b"tiered " + \
                tag.encode()
        assert printed["prt"] == printed["ref"]
        text = printed["prt"]
        assert "remote.mount: 2 object(s) from local -> /ROOT/rm" in text
        assert "remote.meta.sync: 1 updated, 1 deleted, 1 unchanged" in text
        assert "remote.uncache: 2 file(s) reverted" in text
        assert "TAGbooks: 1 object(s) -> /ROOT/mb/TAGbooks" in text
        assert "volume VID on URL -> tier local" in text
        assert "back on local disk" in text
        assert "no replication pumps reporting" in text
    finally:
        client.close()
        c.submit(s3.stop())
