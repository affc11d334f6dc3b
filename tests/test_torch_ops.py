"""The PyTorch/CUDA port's GF(2^8) layer held against the JAX package.

Inputs are made with numpy from fixed seeds and handed to both packages.
GF(2^8) arithmetic is exact, so every comparison is exact equality.  The
port runs here on the CPU, where `CudaGFMatrix` takes its plain version;
the reference's Pallas kernel runs in interpret mode, as
tests/test_pallas.py runs it.
"""

import ast
import itertools
import json
import os
import pathlib
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

from seaweedfs_tpu.models import rs as ref_rs
from seaweedfs_tpu.ops import gf as ref_gf
from seaweedfs_tpu.ops import gfmat_jax, pallas_gf

from seaweedfs_tpu_torch.models import rs
from seaweedfs_tpu_torch.ops import codec_base, codecs, dispatch, gf, gf_cuda
from seaweedfs_tpu_torch.storage.ec import ec_files

REPO = pathlib.Path(__file__).resolve().parent.parent


# ---- the port stands alone ---------------------------------------------

def _port_files():
    return sorted((REPO / "seaweedfs_tpu_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax_and_no_reference(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, f"{path}: relative import"
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top != "jax" and top != "jaxlib", f"{path}: imports {name}"
            assert top != "seaweedfs_tpu", f"{path}: imports {name}"
    # the card's path needs none of the servers' packages: none is
    # imported at module level (security/tls.py imports cryptography
    # inside generate_certs, which nothing on the card's path calls);
    # the servers' own modules are the exception, aiohttp being what
    # they serve with: those under server/, the S3 gateway's two and the
    # MQ broker
    if path.parent.name == "server" or path.relative_to(REPO).as_posix() \
            in ("seaweedfs_tpu_torch/s3/s3api_server.py",
                "seaweedfs_tpu_torch/s3/iamapi_server.py",
                "seaweedfs_tpu_torch/mq/broker.py"):
        return
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in (
                    "aiohttp", "google", "cryptography"), \
                    f"{path}: imports {name} at module level"


def test_import_rule_covers_the_store_slice():
    files = {str(p.relative_to(REPO)) for p in _port_files()}
    for rel in ("storage/store.py", "storage/backend.py", "remote_storage.py",
                "storage/volume.py", "storage/needle_map.py",
                "utils/resilience.py", "utils/http.py", "security/tls.py"):
        assert f"seaweedfs_tpu_torch/{rel}" in files, rel


def test_import_rule_covers_the_server_slice():
    files = {str(p.relative_to(REPO)) for p in _port_files()}
    for rel in ("server/volume_server.py", "server/ui.py", "__main__.py",
                "pb/__init__.py", "security/jwt.py", "security/guard.py",
                "utils/weedlog.py", "topology/topology.py", "images.py"):
        assert f"seaweedfs_tpu_torch/{rel}" in files, rel


def test_import_rule_covers_the_maintenance_slice():
    files = {str(p.relative_to(REPO)) for p in _port_files()}
    for rel in ("maintenance/scrub.py", "maintenance/faults.py",
                "ops/fleet_convert.py", "ops/regen.py", "stats/trace.py",
                "stats/metrics.py", "server/volume_server.py"):
        assert f"seaweedfs_tpu_torch/{rel}" in files, rel


def test_import_rule_covers_the_mesh_slice():
    files = {str(p.relative_to(REPO)) for p in _port_files()}
    for rel in ("parallel/__init__.py", "parallel/mesh.py",
                "parallel/dryrun.py", "ops/dispatch.py",
                "ops/fleet_convert.py", "ops/codecs.py"):
        assert f"seaweedfs_tpu_torch/{rel}" in files, rel


def test_import_rule_covers_the_planes_slice():
    files = {str(p.relative_to(REPO)) for p in _port_files()}
    for rel in ("stats/aggregate.py", "stats/history.py",
                "stats/interference.py", "stats/canary.py",
                "stats/loops.py", "stats/heat.py", "stats/pipeline.py",
                "utils/fanout.py", "ops/codec_tags.py", "server/master.py"):
        assert f"seaweedfs_tpu_torch/{rel}" in files, rel


def test_import_rule_covers_the_master_maintenance_slice():
    files = {str(p.relative_to(REPO)) for p in _port_files()}
    for rel in ("maintenance/repair.py", "maintenance/convert.py",
                "maintenance/autopilot.py", "utils/hashring.py",
                "utils/resilience.py", "stats/interference.py",
                "stats/metrics.py", "server/master.py"):
        assert f"seaweedfs_tpu_torch/{rel}" in files, rel


def test_import_rule_covers_the_shell_slice():
    files = {str(p.relative_to(REPO)) for p in _port_files()}
    for rel in ("client.py", "utils/vid_cache.py",
                "server/master_follower.py", "shell/__init__.py",
                "shell/commands.py", "shell/shell.py", "ops/codec_tags.py",
                "__main__.py"):
        assert f"seaweedfs_tpu_torch/{rel}" in files, rel


def test_import_rule_covers_the_filer_slice():
    files = {str(p.relative_to(REPO)) for p in _port_files()}
    for rel in ("filer/__init__.py", "filer/entry.py", "filer/filechunks.py",
                "filer/filechunk_section.py", "filer/filechunk_manifest.py",
                "filer/filerstore.py", "filer/abstract_sql.py",
                "filer/stores_extra.py", "filer/filer_conf.py",
                "filer/filer.py", "filer/filer_deletion.py",
                "utils/chunk_cache.py", "utils/cipher.py", "native.py"):
        assert f"seaweedfs_tpu_torch/{rel}" in files, rel
    assert (REPO / "seaweedfs_tpu_torch/csrc/aes_gcm.cc").exists()


def test_import_rule_covers_the_filer_server_slice():
    files = {str(p.relative_to(REPO)) for p in _port_files()}
    for rel in ("server/filer_server.py", "replication/__init__.py",
                "replication/filer_sync.py", "remote_storage.py",
                "utils/vid_cache.py", "shell/commands.py"):
        assert f"seaweedfs_tpu_torch/{rel}" in files, rel


def test_import_rule_covers_the_s3_slice():
    files = {str(p.relative_to(REPO)) for p in _port_files()}
    for rel in ("s3/__init__.py", "s3/auth.py", "s3/policy.py",
                "s3/circuit_breaker.py", "s3/qos.py", "s3/iamapi_server.py",
                "s3/s3api_server.py", "stats/heat.py", "stats/trace.py",
                "stats/metrics.py", "shell/commands.py", "__main__.py"):
        assert f"seaweedfs_tpu_torch/{rel}" in files, rel


def test_s3_gateway_leaves_jax_and_torch_unloaded():
    """The gateway, the IAM API and the `s3.*` commands in a fresh
    interpreter: a request signed by `sign_v4` and a streamed one by
    `sign_v4_chunked` verify, a gateway and an IAM API are built, the
    shell lists its `s3.*` commands; neither jax, torch nor the
    reference package gets imported, and the signing, policy, breaker
    and QoS modules load without aiohttp."""
    code = (
        "import sys\n"
        "from seaweedfs_tpu_torch.s3 import (auth, circuit_breaker, "
        "policy, qos)\n"
        "assert not [m for m in sys.modules if m.split('.')[0] == "
        "'aiohttp'], 'aiohttp'\n"
        "c = auth.Credential('AK', 'SK')\n"
        "iam = auth.IdentityAccessManagement([auth.Identity('a', [c], "
        "['Admin'])])\n"
        "def both(h):  # a server's headers are case-insensitive\n"
        "    return {**h, **{k.lower(): v for k, v in h.items()}}\n"
        "h = both(auth.sign_v4(c, 'PUT', 'h:1', '/b/k', {}, payload=b'x'))\n"
        "assert iam.authenticate('PUT', '/b/k', {}, h).name == 'a'\n"
        "h, body = auth.sign_v4_chunked(c, 'PUT', 'h:1', '/b/k', {}, "
        "b'y' * 70000)\n"
        "ctx = iam.chunked_context(both(h))\n"
        "assert auth.decode_aws_chunked(body, ctx, 70000) == b'y' * 70000\n"
        "from seaweedfs_tpu_torch.s3.s3api_server import S3ApiServer\n"
        "from seaweedfs_tpu_torch.s3.iamapi_server import IamApiServer\n"
        "from seaweedfs_tpu_torch.shell import commands\n"
        "S3ApiServer('127.0.0.1:1', port=0, iam=iam)\n"
        "IamApiServer('127.0.0.1:1', port=0)\n"
        "assert len([n for n in commands.COMMANDS "
        "if n.startswith('s3.')]) == 8\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'torch', 'seaweedfs_tpu')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_filer_server_leaves_jax_and_torch_unloaded(tmp_path):
    """The filer server, its `fs.*` commands and filer.sync's signature
    in a fresh interpreter: a `FilerServer` over its SQLite store, with
    no master to reach, makes a directory, lists it, answers
    /__meta__/digest and /__hot__/status and stops; `fs.ls` reads it
    through a stand-in master's member list; neither jax, torch nor the
    reference package gets imported."""
    code = (
        "import asyncio, io, json, sys, urllib.request\n"
        "from aiohttp import web\n"
        "from seaweedfs_tpu_torch.server.filer_server import FilerServer\n"
        "from seaweedfs_tpu_torch.shell import commands\n"
        "from seaweedfs_tpu_torch.replication.filer_sync import "
        "filer_signature\n"
        "assert filer_signature('127.0.0.1:8888') > 0\n"
        "async def main():\n"
        "    fs = FilerServer('127.0.0.1:1', port=0, data_dir=sys.argv[1])\n"
        "    await fs.start()\n"
        "    port = fs._runner.addresses[0][1]\n"
        "    fs.port = port\n"
        "    async def status(req):\n"
        "        return web.json_response({'Members': {'filer': "
        "[fs.url]}})\n"
        "    app = web.Application()\n"
        "    app.add_routes([web.get('/cluster/status', status)])\n"
        "    runner = web.AppRunner(app)\n"
        "    await runner.setup()\n"
        "    site = web.TCPSite(runner, '127.0.0.1', 0)\n"
        "    await site.start()\n"
        "    mport = runner.addresses[0][1]\n"
        "    def drive():\n"
        "        u = f'http://127.0.0.1:{port}'\n"
        "        urllib.request.urlopen(urllib.request.Request(\n"
        "            u + '/a/b/', data=b'', method='POST'), timeout=10)\n"
        "        d = json.loads(urllib.request.urlopen(\n"
        "            u + '/__meta__/digest?prefix=/a', timeout=10).read())\n"
        "        assert d['entries'] == 1, d\n"
        "        h = json.loads(urllib.request.urlopen(\n"
        "            u + '/__hot__/status', timeout=10).read())\n"
        "        assert h['enabled'], h\n"
        "        out = io.StringIO()\n"
        "        env = commands.CommandEnv(f'127.0.0.1:{mport}')\n"
        "        commands.run_command(env, 'fs.ls /a', out)\n"
        "        assert out.getvalue() == 'b/\\n', out.getvalue()\n"
        "    await asyncio.to_thread(drive)\n"
        "    await runner.cleanup()\n"
        "    await fs.stop()\n"
        "asyncio.run(main())\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'torch', 'seaweedfs_tpu')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=REPO,
                   check=True, timeout=120)


def test_import_rule_covers_the_gateway_mount_slice():
    files = {str(p.relative_to(REPO)) for p in _port_files()}
    for rel in ("mount/__init__.py", "mount/inode.py", "mount/weedfs.py",
                "mount/fuse_ll.py", "server/webdav_server.py", "ftpd.py",
                "shell/commands.py", "__main__.py"):
        assert f"seaweedfs_tpu_torch/{rel}" in files, rel


def test_gateway_mount_and_offline_cli_leave_jax_and_torch_unloaded(
        tmp_path):
    """The mount, the WebDAV gateway, the FTP stub and the offline CLI in
    a fresh interpreter: a port `FilerServer` with no master to reach
    and a `WebDavServer` over it answer MKCOL and PROPFIND; a `WFS` over
    the filer makes a directory, a symlink and an xattr and reads them
    back through `make_fuse_ops`, its subscription and admin socket
    live; `fix`, `export`, `compact`, `scaffold` and `version` run on a
    volume the port's `Volume` wrote; `mount.configure` answers; neither
    jax, torch nor the reference package gets imported."""
    code = (
        "import asyncio, io, os, sys, urllib.request\n"
        "from seaweedfs_tpu_torch.server.filer_server import FilerServer\n"
        "from seaweedfs_tpu_torch.server.webdav_server import "
        "WebDavServer\n"
        "from seaweedfs_tpu_torch.mount import fuse_ll, weedfs\n"
        "from seaweedfs_tpu_torch import ftpd\n"
        "from seaweedfs_tpu_torch.__main__ import main\n"
        "from seaweedfs_tpu_torch.shell import commands\n"
        "from seaweedfs_tpu_torch.storage.needle import Needle\n"
        "from seaweedfs_tpu_torch.storage.volume import Volume\n"
        "d = sys.argv[1]\n"
        "async def main_():\n"
        "    fs = FilerServer('127.0.0.1:1', port=0, data_dir=d + '/f')\n"
        "    await fs.start()\n"
        "    fs.port = fs._runner.addresses[0][1]\n"
        "    dav = WebDavServer(fs.url, port=0)\n"
        "    await dav.start()\n"
        "    dport = dav._runner.addresses[0][1]\n"
        "    def drive():\n"
        "        u = f'http://127.0.0.1:{dport}'\n"
        "        r = urllib.request.urlopen(urllib.request.Request(\n"
        "            u + '/dav', method='MKCOL'), timeout=10)\n"
        "        assert r.status == 201\n"
        "        r = urllib.request.urlopen(urllib.request.Request(\n"
        "            u + '/', method='PROPFIND', headers={'Depth': '1'}),\n"
        "            timeout=10)\n"
        "        assert r.status == 207 and b'/dav/' in r.read()\n"
        "        w = weedfs.WFS(fs.url, subscribe=True)\n"
        "        admin = weedfs.start_admin_socket(w, d + '/mnt')\n"
        "        ops = weedfs.make_fuse_ops(w, fuse_ll.Operations,\n"
        "                                   fuse_ll.FuseOSError)\n"
        "        ops.mkdir('/m', 0o755)\n"
        "        ops.symlink('/m/l', 'target')\n"
        "        ops.setxattr('/m', 'user.k', b'v', 0)\n"
        "        assert ops.readlink('/m/l') == 'target'\n"
        "        assert ops.getxattr('/m', 'user.k') == b'v'\n"
        "        assert 'l' in ops.readdir('/m', 0)\n"
        "        out = io.StringIO()\n"
        "        commands.run_command(commands.CommandEnv('127.0.0.1:1'),\n"
        "            f'mount.configure -dir {d}/mnt -quotaMB 1', out)\n"
        "        assert 'quota=1MB' in out.getvalue(), out.getvalue()\n"
        "        w.close()\n"
        "        assert not admin.thread.is_alive()\n"
        "    await asyncio.to_thread(drive)\n"
        "    await dav.stop()\n"
        "    await fs.stop()\n"
        "asyncio.run(main_())\n"
        "v = Volume(d, '', 3)\n"
        "for i in range(1, 5):\n"
        "    v.append_needle(Needle(id=i, cookie=i, data=b'x' * i))\n"
        "v.delete_needle(2, 2)\n"
        "v.close()\n"
        "os.remove(d + '/3.idx')\n"
        "for argv in (['fix', '-dir', d, '-volumeId', '3'],\n"
        "             ['export', '-dir', d, '-volumeId', '3', '-o',\n"
        "              d + '/3.tar'],\n"
        "             ['compact', '-dir', d, '-volumeId', '3'],\n"
        "             ['scaffold', '-config', 'filer'], ['version']):\n"
        "    assert main(argv) == 0, argv\n"
        "assert Volume(d, '', 3).read_needle(4).data == b'xxxx'\n"
        "try:\n"
        "    asyncio.run(ftpd.FtpServer(ftpd.FtpServerOption('h:1')).start())\n"
        "except NotImplementedError:\n"
        "    pass\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'torch', 'seaweedfs_tpu')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=REPO,
                   check=True, timeout=120)


def test_import_rule_covers_the_replication_slice():
    files = {str(p.relative_to(REPO)) for p in _port_files()}
    for rel in ("replication/__init__.py", "replication/sink.py",
                "replication/filer_sync.py", "replication/replicate_daemon.py",
                "notification.py", "remote_storage.py", "stats/canary.py",
                "server/master.py", "shell/commands.py", "__main__.py"):
        assert f"seaweedfs_tpu_torch/{rel}" in files, rel


# the CLI's replication and filer client tools, each run by `main` in one
# fresh interpreter against filers of the test's cluster; the long-running
# ones end on a SIGINT a timer sends, as an operator's ^C would
_REPLICATION_CLI = r"""
import json, os, signal, sys, threading
from seaweedfs_tpu_torch.__main__ import main
fa, fb, d, log = sys.argv[1:5]
def run(argv, interrupt_after=None):
    if interrupt_after is not None:
        threading.Timer(interrupt_after, os.kill,
                        (os.getpid(), signal.SIGINT)).start()
    rc = main(argv)
    assert rc == 0, (argv, rc)
run(["filer.copy", "-filer", fa, d + "/up", "/ops/"])
run(["filer.cat", "-filer", fa, "-o", d + "/cat.out", "/ops/up/a.txt"])
run(["filer.meta.tail", "-filer", fa, "-timeAgo", "300", "-untilTimeAgo",
     "0.001", "-pattern", "*.txt"])
run(["filer.sync", "-a", fa, "-b", fb, "-filerPath", "/ops",
     "-offsetFile", d + "/sync.json", "-oneway"], 3.0)
run(["filer.backup", "-filer", fa, "-dir", d + "/bk", "-filerPath", "/ops",
     "-offsetFile", d + "/bk.json"], 2.0)
run(["filer.meta.backup", "-filer", fa, "-filerPath", "/ops", "-store",
     "sqlite:" + d + "/meta.db"], 2.0)
run(["filer.replicate", "-filer", fa, "-notificationLog", log, "-sink",
     "local:" + d + "/rep", "-filerPath", "/ops", "-offsetFile",
     d + "/rep.json"], 2.0)
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "torch", "seaweedfs_tpu")]
assert not bad, bad
print("ok")
"""


def test_replication_cli_leaves_jax_and_torch_unloaded(tmp_path,
                                                      monkeypatch):
    """`filer.copy`, `filer.cat`, `filer.meta.tail`, `filer.sync`,
    `filer.backup`, `filer.meta.backup` and `filer.replicate` in a fresh
    interpreter against two port filers: each does its work (the files
    land on the other filer, in the mirror directories and in the
    metadata store) and neither jax, torch nor the reference package
    gets imported."""
    from seaweedfs_tpu_torch.filer.abstract_sql import SqliteStore
    from seaweedfs_tpu_torch.notification import LogQueue
    from seaweedfs_tpu_torch.server.filer_server import FilerServer
    from tests.test_torch_master_cluster import Cluster, free_port
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "0")
    monkeypatch.setenv("WEEDTPU_REPAIR_INTERVAL", "0")
    (tmp_path / "up" / "sub").mkdir(parents=True)
    (tmp_path / "up" / "a.txt").write_bytes(b"alpha")
    (tmp_path / "up" / "sub" / "b.txt").write_bytes(b"beta" * 100)
    log = str(tmp_path / "events.jsonl")
    queue = LogQueue(log)
    c = Cluster(tmp_path, n_volume_servers=1).start()
    c.wait_heartbeats()
    fa = FilerServer(c.master.url, port=free_port(),
                     data_dir=str(tmp_path / "fa"), notification=queue)
    fb = FilerServer(c.master.url, port=free_port(),
                     data_dir=str(tmp_path / "fb"))
    c.submit(fa.start())
    c.submit(fb.start())
    try:
        r = subprocess.run(
            [sys.executable, "-c", _REPLICATION_CLI, fa.url, fb.url,
             str(tmp_path), log], cwd=REPO, capture_output=True,
            text=True, timeout=180)
        assert r.returncode == 0 and r.stdout.endswith("ok\n"), \
            r.stderr[-3000:]
        assert (tmp_path / "cat.out").read_bytes() == b"alpha"
        with urllib.request.urlopen(
                f"http://{fb.url}/ops/up/sub/b.txt", timeout=30) as resp:
            assert resp.read() == b"beta" * 100
        for mirror in ("bk", "rep"):
            assert (tmp_path / mirror / "ops/up/a.txt").read_bytes() == \
                b"alpha", mirror
        store = SqliteStore(str(tmp_path / "meta.db"))
        assert store.find_entry("/ops/up/sub/b.txt").attr.file_size == 400
        store.shutdown()
    finally:
        c.submit(fa.stop())
        c.submit(fb.stop())
        c.stop()
        queue.close()


def test_import_rule_covers_the_mq_slice():
    files = {str(p.relative_to(REPO)) for p in _port_files()}
    for rel in ("mq/__init__.py", "mq/topic.py", "mq/segments.py",
                "mq/client.py", "mq/broker.py", "shell/commands.py",
                "__main__.py"):
        assert f"seaweedfs_tpu_torch/{rel}" in files, rel


# the port's master and two brokers in one fresh interpreter: a client
# configures, publishes, fetches and commits, and the shell runs the four
# `mq.*` commands (a filer would need a volume server, which loads torch:
# tests/test_torch_mq.py keeps the logs in one)
_MQ_CHILD = r"""
import asyncio, io, sys, threading
from seaweedfs_tpu_torch.mq import segments, topic
assert not [m for m in sys.modules if m.split(".")[0] == "aiohttp"]
msgs = [topic.Message(i, i, b"k", b"v" * i) for i in range(3)]
assert segments.decode_segment(segments.encode_segment(msgs)) == msgs
from seaweedfs_tpu_torch.mq.broker import BrokerServer
from seaweedfs_tpu_torch.mq.client import MQClient
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.shell import commands
import socket
def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
loop = asyncio.new_event_loop()
threading.Thread(target=loop.run_forever, daemon=True).start()
def run(coro):
    return asyncio.run_coroutine_threadsafe(coro, loop).result(60)
m = MasterServer("127.0.0.1", free_port())
run(m.start())
bs = [BrokerServer(m.url, port=free_port(), peer_refresh=0.2)
      for _ in range(2)]
for b in bs:
    run(b.start())
import time
deadline = time.time() + 30
while time.time() < deadline and not all(
        b.peer_brokers == sorted(x.url for x in bs) for b in bs):
    time.sleep(0.05)
c = MQClient([b.url for b in bs])
c.configure("imp.t", partition_count=2)
sent = sorted(c.publish("imp.t", b"v%d" % i, key=b"%d" % i)
              for i in range(10))
got = sorted((pi, m["offset"]) for pi in range(2)
             for m in c.fetch("imp.t", pi, 0)[0])
assert got == sent, (got, sent)
g = c.consumer("imp.t", group="g")
assert len(g.poll()) == 10
g.commit()
env = commands.CommandEnv(m.url)
for line in ("mq.topic.list", "mq.topic.desc -topic imp.t", "mq.balance",
             "mq.topic.configure -topic imp.u -partitionCount 1"):
    out = io.StringIO()
    commands.run_command(env, line, out)
    assert out.getvalue(), line
for b in bs:
    run(b.stop())
run(m.stop())
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "torch", "seaweedfs_tpu")]
assert not bad, bad
print("ok")
"""


def test_mq_broker_and_client_leave_jax_and_torch_unloaded():
    """The broker, the client and the four `mq.*` commands in a fresh
    interpreter, over the port's master: neither jax, torch nor the
    reference package gets imported, and the topic model and the
    segment codec load without aiohttp."""
    r = subprocess.run([sys.executable, "-c", _MQ_CHILD], cwd=REPO, capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, WEEDTPU_SCRUB_MBPS="0",
                                WEEDTPU_REPAIR_INTERVAL="0"))
    assert r.returncode == 0 and r.stdout.endswith("ok\n"), \
        r.stderr[-3000:]


def test_import_rule_covers_the_harness_slice():
    files = {str(p.relative_to(REPO)) for p in _port_files()}
    for rel in ("maintenance/chaos.py", "maintenance/fleetsim.py"):
        assert f"seaweedfs_tpu_torch/{rel}" in files, rel


# the port's master and a 20-vnode fleet in one fresh interpreter: every
# vnode beats and is scraped; neither jax, torch nor the reference loads
_FLEETSIM_CHILD = r"""
import asyncio, json, sys, threading, urllib.request
from seaweedfs_tpu_torch.maintenance import chaos, fleetsim
assert not [m for m in sys.modules if m.split(".")[0] in ("aiohttp", "torch")]
from seaweedfs_tpu_torch.server.master import MasterServer
loop = asyncio.new_event_loop()
threading.Thread(target=loop.run_forever, daemon=True).start()
def run(coro):
    return asyncio.run_coroutine_threadsafe(coro, loop).result(60)
m = MasterServer("127.0.0.1", chaos.free_port())
run(m.start())
sim = fleetsim.FleetSim(m.url, nodes=20, racks=4, volumes_per_node=2,
                        heartbeat_s=3600.0, seed=7).start()
assert sim.beat_all() == 20
with urllib.request.urlopen(f"http://{m.url}/cluster/loops?refresh=1",
                            timeout=60) as r:
    agg = json.load(r)["loops"]["aggregator"]
assert agg["items_total"] >= 21 and agg["backlog"] == 0, agg
sim.stop()
run(m.stop())
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "torch", "seaweedfs_tpu")]
assert not bad, bad
print("ok")
"""


def test_fleetsim_leaves_jax_and_torch_unloaded():
    """The port's fleet simulator against the port's master in a fresh
    interpreter: the harness modules load without aiohttp or torch, and
    a beating, scraped fleet imports neither jax, torch nor the
    reference package."""
    r = subprocess.run([sys.executable, "-c", _FLEETSIM_CHILD], cwd=REPO,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, WEEDTPU_AGG_INTERVAL="0",
                                WEEDTPU_REPAIR_INTERVAL="0"))
    assert r.returncode == 0 and r.stdout.endswith("ok\n"), \
        r.stderr[-3000:]


# `python -m seaweedfs_tpu_torch.maintenance.fleetsim <master>` through
# runpy, ended by a SIGINT as an operator's ^C would; it reports what it
# loaded
_FLEETSIM_CLI = r"""
import json, runpy, sys
sys.argv = ["fleetsim", sys.argv[1]]
try:
    runpy.run_module("seaweedfs_tpu_torch.maintenance.fleetsim",
                     run_name="__main__")
except SystemExit as e:
    rc = e.code
print(json.dumps({"rc": rc, "loaded": sorted(
    m for m in sys.modules if m.split(".")[0] in
    ("jax", "torch", "seaweedfs_tpu"))}))
"""


def test_fleetsim_cli_registers_its_fleet_and_stops_on_sigint(tmp_path,
                                                              monkeypatch):
    """The module's entry point at its defaults (500 vnodes) against a
    port master: every vnode registers within a heartbeat period or
    two, a SIGINT stops it with exit code 0, and it loaded neither
    torch, jax nor the reference package."""
    import signal
    import time
    from tests.test_torch_master_cluster import Cluster
    monkeypatch.setenv("WEEDTPU_AGG_INTERVAL", "0")
    monkeypatch.setenv("WEEDTPU_REPAIR_INTERVAL", "0")
    c = Cluster(tmp_path, n_volume_servers=0).start()
    proc = subprocess.Popen([sys.executable, "-c", _FLEETSIM_CLI,
                             c.master.url], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        deadline = time.time() + 60
        while time.time() < deadline and len(c.master.topo.nodes) < 500:
            assert proc.poll() is None, proc.stderr.read()[-3000:]
            time.sleep(0.1)
        assert len(c.master.topo.nodes) == 500
        racks = {n.rack for n in c.master.topo.nodes.values()}
        assert racks == {f"rack{i}" for i in range(10)}
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        c.stop()
    assert proc.returncode == 0, err[-3000:]
    rep = json.loads(out.splitlines()[-1])
    assert rep == {"rc": 0, "loaded": []}, rep


# one chaos cell on the CPU in a fresh interpreter: the harness drives
# port servers only, so neither jax nor the reference package loads
_CHAOS_CHILD = r"""
import pathlib, sys
from seaweedfs_tpu_torch.maintenance import chaos
c = chaos.ChaosCluster(pathlib.Path(sys.argv[1]), n_volume_servers=2,
                       device="cpu").start()
try:
    c.wait_heartbeats()
    rep = chaos.run_scenario(c, "degraded_read", "shard_loss")
finally:
    c.stop()
assert rep["fault"] == "shard_loss", rep
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "seaweedfs_tpu")]
assert not bad, bad
print("ok")
"""


def test_chaos_cell_leaves_jax_unloaded(tmp_path):
    """A `degraded_read x shard_loss` cell on a port `ChaosCluster` with
    its volume servers on the CPU, in a fresh interpreter: prepare,
    encode, the loss, the heal and the byte and fsck checks import
    neither jax nor the reference package."""
    r = subprocess.run([sys.executable, "-c", _CHAOS_CHILD, str(tmp_path)],
                       cwd=REPO, capture_output=True, text=True,
                       timeout=120,
                       env=dict(os.environ, WEEDTPU_SCRUB_MBPS="0",
                                WEEDTPU_REPAIR_INTERVAL="0"))
    assert r.returncode == 0 and r.stdout.endswith("ok\n"), \
        r.stderr[-3000:]


def test_card_path_modules_import_no_server_package():
    """The store, the EC files and the codecs load without aiohttp and
    protobuf: only the server modules import them at module level."""
    code = ("import sys\n"
            "import seaweedfs_tpu_torch.storage.store\n"
            "import seaweedfs_tpu_torch.pb, seaweedfs_tpu_torch.utils.http\n"
            "import seaweedfs_tpu_torch.stats.trace\n"
            "import seaweedfs_tpu_torch.maintenance.scrub\n"
            "import seaweedfs_tpu_torch.maintenance.faults\n"
            "import seaweedfs_tpu_torch.parallel.mesh\n"
            "import seaweedfs_tpu_torch.parallel.dryrun\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('aiohttp', 'jax') or m.startswith('google.protobuf')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   timeout=120)


def test_port_path_leaves_jax_unloaded(tmp_path):
    """Encode through the codec, convert a fleet of two volumes, scrub
    one of them and repair a lost shard of it from a helper's partials,
    then regenerate a lost MSR shard from helper sub-rows, then encode
    with the native host codec and rebuild a shard host-serial, then boot
    a store, vacuum a volume, encode it, mount its shard set, decode it
    back after losing two data shards and tier another volume out, then
    read a needle of that shard set degraded from a loopback peer through
    PooledHTTP, once plainly and once hedged against the peer's delay,
    then run the mesh: the multi-device dry run, an encode and rebuild
    under WEEDTPU_EC_CODEC=mesh and a fleet on a unit mesh, all on the
    CPU, in a fresh interpreter: neither jax nor the reference package
    gets imported."""
    code = ("import os, sys, numpy as np, torch\n"
            "os.environ.pop('WEEDTPU_EC_CODEC', None)\n"
            "from seaweedfs_tpu_torch.storage.ec import ec_files, ec_volume\n"
            "from seaweedfs_tpu_torch.ops import dispatch, fleet_convert, "
            "gf_cuda\n"
            "from seaweedfs_tpu_torch.maintenance import scrub\n"
            "from seaweedfs_tpu_torch.ops import codecs\n"
            "for tag in ('lrc_10_2_2', 'msr_9_16'):\n"
            "    x = codecs.make_codec(tag, device='cpu')\n"
            "    x.encode_parity(torch.zeros((x.k, 64), dtype=torch.uint8))\n"
            "c = gf_cuda.get_codec(10, 4, device='cpu')\n"
            "c.encode_parity(torch.zeros((10, 16), dtype=torch.uint8))\n"
            "d = sys.argv[1]\n"
            "bases = [os.path.join(d, v) for v in ('1', '2')]\n"
            "for b, n in zip(bases, (30_000, 5_000)):\n"
            "    open(b + '.dat', 'wb').write(os.urandom(n))\n"
            "fleet_convert.convert_volumes(bases, large_block=1000, "
            "small_block=100, device='cpu')\n"
            "open(bases[0] + '.ecx', 'wb').close()\n"
            "ev = ec_volume.EcVolume(bases[0], 1000, 100, device='cpu')\n"
            "scrub.DEFAULT_WINDOW = 512\n"
            "assert scrub.syndrome_scan(ev) == []\n"
            "ev.close()\n"
            "b = bases[0]\n"
            "want = open(b + '.ec03', 'rb').read()\n"
            "os.remove(b + '.ec03')\n"
            "held = {s: np.fromfile(b + '.ec%02d' % s, np.uint8) "
            "for s in (10, 11, 12, 13)}\n"
            "for s in held:\n"
            "    os.remove(b + '.ec%02d' % s)\n"
            "def fetch(group, sids, coeff, off, n):\n"
            "    rows = np.stack([held[s][off:off + n] for s in sids])\n"
            "    return dispatch.apply_matrix(c, coeff, rows).tobytes()\n"
            "r = ec_files.rebuild_ec_reduced(b, [3], [{'node': 'h', "
            "'shards': sorted(held), 'locality': 1}], fetch, device='cpu')\n"
            "assert r['rebuilt'] == [3] and r['helper_bytes'] == {'h': 3000}\n"
            "assert open(b + '.ec03', 'rb').read() == want\n"
            "m = codecs.make_codec('msr_9_16', device='cpu')\n"
            "full = m.encode(torch.from_numpy(np.frombuffer(os.urandom(9 * 64),"
            " np.uint8).reshape(9, 64).copy())).numpy()\n"
            "mb = os.path.join(d, '9')\n"
            "for s in range(1, 6):\n"
            "    open(mb + '.ec%02d' % s, 'wb').write(full[s].tobytes())\n"
            "ec_files.write_vif(mb, 9 * 64, codec='msr_9_16')\n"
            "def sub_fetch(group, vids, coeff, off, n):\n"
            "    rows = np.stack([full[v // 8][off * 8:(off + n) * 8]"
            ".reshape(n, 8)[:, v % 8] for v in vids])\n"
            "    return dispatch.apply_matrix(m, coeff, rows).tobytes()\n"
            "r = ec_files.rebuild_ec_reduced(mb, [0], [{'node': 'h', "
            "'shards': list(range(6, 18)), 'locality': 1}], sub_fetch, "
            "device='cpu')\n"
            "assert r['helper_bytes'] == {'h': 11 * 8}, r\n"
            "assert open(mb + '.ec00', 'rb').read() == full[0].tobytes()\n"
            "os.environ['WEEDTPU_EC_CODEC'] = 'native'\n"
            "nb = os.path.join(d, '8')\n"
            "open(nb + '.dat', 'wb').write(os.urandom(25_000))\n"
            "st = {}\n"
            "ec_files.write_ec_files(nb, large_block=1000, small_block=100, "
            "stats=st)\n"
            "assert st['mode'] == 'pipelined'\n"
            "want = open(nb + '.ec12', 'rb').read()\n"
            "os.remove(nb + '.ec12')\n"
            "st = {}\n"
            "ec_files.rebuild_ec_files(nb, stats=st)\n"
            "assert st['mode'] == 'host-serial'\n"
            "assert open(nb + '.ec12', 'rb').read() == want\n"
            "os.environ.pop('WEEDTPU_EC_CODEC')\n"
            "from seaweedfs_tpu_torch.storage import needle, store\n"
            "sd = os.path.join(d, 'node')\n"
            "s = store.Store([sd], device='cpu')\n"
            "s.allocate_volume(5)\n"
            "for nid in range(1, 41):\n"
            "    s.write_needle(5, needle.Needle(id=nid, cookie=nid, "
            "data=os.urandom(3000)))\n"
            "for nid in range(2, 41, 3):\n"
            "    s.delete_needle(5, nid)\n"
            "s.get_volume(5).compact()\n"
            "s.close()\n"
            "vb = os.path.join(sd, '5')\n"
            "ec_files.write_ec_files(vb, large_block=1000, small_block=100, "
            "device='cpu')\n"
            "ec_files.write_sorted_ecx(vb + '.idx')\n"
            "want = open(vb + '.dat', 'rb').read()\n"
            "for p in (vb + '.dat', vb + '.idx', vb + '.ec01', vb + '.ec07'):\n"
            "    os.remove(p)\n"
            "s = store.Store([sd], device='cpu')\n"
            "assert s.get_ec_volume(5) is not None\n"
            "s.close()\n"
            "ec_files.rebuild_ec_files(vb, device='cpu')\n"
            "ec_files.write_dat_file(vb, ec_files.find_dat_file_size(vb), "
            "1000, 100)\n"
            "ec_files.write_idx_from_ecx(vb + '.ecx')\n"
            "assert open(vb + '.dat', 'rb').read() == want\n"
            "v = s.allocate_volume(6)\n"
            "v.append_needle(needle.Needle(id=1, data=b'cold'))\n"
            "v.tier_move('local', {'directory': os.path.join(d, 'cold')})\n"
            "assert v.read_needle(1).data == b'cold'\n"
            "v.close()\n"
            "import shutil, threading, time\n"
            "from http.server import BaseHTTPRequestHandler, "
            "ThreadingHTTPServer\n"
            "from seaweedfs_tpu_torch.stats import metrics\n"
            "from seaweedfs_tpu_torch.utils import http\n"
            "peer = ec_volume.EcVolume(vb, 1000, 100, device='cpu')\n"
            "delay = [0.0]\n"
            "class Peer(BaseHTTPRequestHandler):\n"
            "    protocol_version = 'HTTP/1.1'\n"
            "    disable_nagle_algorithm = True\n"
            "    def do_GET(self):\n"
            "        q = dict(p.split('=') for p in "
            "self.path.split('?')[1].split('&'))\n"
            "        time.sleep(delay[0])\n"
            "        b = peer._read_local(int(q['shard']), int(q['offset']), "
            "int(q['size']))\n"
            "        self.send_response(200)\n"
            "        self.send_header('Content-Length', str(len(b)))\n"
            "        self.end_headers()\n"
            "        self.wfile.write(b)\n"
            "    def log_message(self, *a):\n"
            "        pass\n"
            "srv = ThreadingHTTPServer(('127.0.0.1', 0), Peer)\n"
            "threading.Thread(target=srv.serve_forever, daemon=True).start()\n"
            "pool = http.PooledHTTP(timeout=5.0)\n"
            "url = ('http://127.0.0.1:%d/admin/ec/shard_read?volume=5&'\n"
            "       'shard=%d&offset=%d&size=%d')\n"
            "def reader(sid, off, size):\n"
            "    st, _, b = pool.request(url % (srv.server_address[1], sid, "
            "off, size))\n"
            "    return b if st == 200 else None\n"
            "rd = os.path.join(d, 'reader')\n"
            "os.makedirs(rd)\n"
            "for ext in ['.ecx', '.vif'] + ['.ec%02d' % i for i in "
            "range(2, 14)]:\n"
            "    shutil.copy(vb + ext, os.path.join(rd, '5' + ext))\n"
            "ev = ec_volume.EcVolume(os.path.join(rd, '5'), 1000, 100, "
            "device='cpu')\n"
            "nid = int(ev.ids[0])\n"
            "want = peer.read_needle(nid).data\n"
            "os.environ['WEEDTPU_HEDGE_PCT'] = '0'\n"
            "assert ev.read_needle(nid, reader).data == want\n"
            "assert ev.read_stats['remote_shard_reads'] > 0\n"
            "assert ev.read_stats['reconstruct_batches'] == 0\n"
            "os.environ['WEEDTPU_HEDGE_PCT'] = '99'\n"
            "os.environ['WEEDTPU_HEDGE_MAX_MS'] = '50'\n"
            "delay[0] = 0.2\n"
            "assert ev.read_needle(nid, reader).data == want\n"
            "assert metrics.HEDGE_TOTAL.labels('hedge_won').value == 1\n"
            "assert ev.read_stats['reconstruct_batches'] == 1\n"
            "time.sleep(0.3)\n"
            "srv.shutdown()\n"
            "pool.close()\n"
            "from seaweedfs_tpu_torch.parallel import dryrun\n"
            "dryrun.dryrun_multichip(8, devices=['cpu'] * 8)\n"
            "cpu4 = ['cpu'] * 4\n"
            "mb = os.path.join(d, '12')\n"
            "open(mb + '.dat', 'wb').write(os.urandom(20_000))\n"
            "os.environ['WEEDTPU_EC_CODEC'] = 'mesh'\n"
            "ec_files.write_ec_files(mb, large_block=1000, small_block=100, "
            "device=cpu4)\n"
            "want = open(mb + '.ec11', 'rb').read()\n"
            "os.remove(mb + '.ec11')\n"
            "ec_files.rebuild_ec_files(mb, device=cpu4)\n"
            "assert open(mb + '.ec11', 'rb').read() == want\n"
            "os.environ.pop('WEEDTPU_EC_CODEC')\n"
            "fleet_convert.convert_volumes([mb], large_block=1000, "
            "small_block=100, codec=fleet_convert.fleet_codec('mesh', "
            "device=cpu4))\n"
            "assert open(mb + '.ec11', 'rb').read() == want\n"
            "assert not any(m == 'jax' or m.startswith('jax.') "
            "or m.startswith('seaweedfs_tpu.') for m in sys.modules), "
            "sorted(m for m in sys.modules if 'jax' in m)\n")
    subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=REPO,
                   check=True, timeout=120)


# ---- entry points need the card -----------------------------------------

@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_get_codec_without_card_raises(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gf_cuda.get_codec(10, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        codecs.make_codec("rs_10_4")
    assert gf_cuda.get_codec(10, 4, device="cpu").device.type == "cpu"


def test_rebuild_ec_reduced_without_card_raises(tmp_path, no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ec_files.rebuild_ec_reduced(str(tmp_path / "1"), [0], [],
                                    lambda *a: b"")


def test_non_rs_family_is_not_ported():
    """The LRC and MSR families are ported now: make_codec builds both on
    the CPU, with the reference's geometry (the name is kept from when it
    refused them)."""
    from seaweedfs_tpu_torch.ops import msr
    lc = codecs.make_codec("lrc_10_2_2", device="cpu")
    assert (lc.k, lc.m, lc.n) == (10, 4, 14) and lc.device.type == "cpu"
    mc = codecs.make_codec("msr_9_16", device="cpu")
    assert isinstance(mc, msr.MSRFileCodec)
    assert (mc.k, mc.m, mc.n, mc.alpha) == (9, 9, 18, 8)
    assert mc.inner.code.parity_matrix.shape == (72, 72)


def test_kernel_wrapper_refuses_cpu_tensors():
    coef = torch.zeros((4, 10), dtype=torch.uint8)
    with pytest.raises(ValueError, match="on one card"):
        gf_cuda.gf_apply_cuda(coef, torch.zeros((1, 10, 32),
                                                dtype=torch.uint8))
    # any [m, k] a GF(2^8) code can give is taken (fault 3.3); past
    # k + m = 256 no code exists, and the matrix is refused
    assert gf_cuda.CudaGFMatrix(np.ones((17, 10), np.uint8)).m == 17
    with pytest.raises(ValueError, match="k \\+ m <= 256"):
        gf_cuda.CudaGFMatrix(np.ones((17, 240), np.uint8))


# ---- tables and matrices -------------------------------------------------

def test_gf_tables_equal_reference():
    assert np.array_equal(gf.GF_EXP, ref_gf.GF_EXP)
    assert np.array_equal(gf.GF_LOG, ref_gf.GF_LOG)
    assert np.array_equal(gf.GF_MUL_TABLE, ref_gf.GF_MUL_TABLE)
    C = np.random.default_rng(7).integers(0, 256, (4, 10), dtype=np.uint8)
    assert np.array_equal(gf.gf_matrix_to_bitmatrix(C),
                          ref_gf.gf_matrix_to_bitmatrix(C))
    assert np.array_equal(gf.gf_mat_inv(rs.vandermonde(10, 10)),
                          ref_gf.gf_mat_inv(ref_rs.vandermonde(10, 10)))


KM = [(6, 3), (10, 4), (12, 4), (16, 4)]


@pytest.mark.parametrize("k,m", KM)
def test_rs_matrix_equals_reference(k, m):
    mine, ref = rs.get_code(k, m), ref_rs.get_code(k, m)
    assert np.array_equal(mine.matrix, ref.matrix)
    assert np.array_equal(rs.from_reference(ref.matrix, k, m).matrix,
                          ref.matrix)


@pytest.mark.parametrize("k,m", KM)
def test_decode_matrices_equal_reference(k, m):
    """15 random survivor/wanted patterns per code (60 in all)."""
    mine, ref = rs.get_code(k, m), ref_rs.get_code(k, m)
    g = np.random.default_rng(k * 100 + m)
    for _ in range(15):
        lost = sorted(g.choice(k + m, size=int(g.integers(1, m + 1)),
                               replace=False).tolist())
        avail = [i for i in range(k + m) if i not in lost]
        wanted = lost if g.random() < 0.7 else \
            sorted(g.choice(k + m, size=2, replace=False).tolist())
        assert np.array_equal(mine.decode_matrix(avail, wanted),
                              ref.decode_matrix(avail, wanted))


def test_from_reference_rejects_non_systematic():
    with pytest.raises(ValueError, match="systematic"):
        rs.from_reference(np.ones((14, 10), np.uint8), 10, 4)


# ---- the plain version against the JAX kernels ---------------------------

def _matrix(kind: str) -> np.ndarray:
    code = ref_rs.get_code(10, 4)
    if kind == "parity":
        return code.parity_matrix
    if kind == "decode":
        return code.decode_matrix([1, 2, 4, 5, 6, 7, 8, 9, 11, 13],
                                  [0, 3, 10, 12])
    return np.random.default_rng(11).integers(0, 256, (4, 10),
                                              dtype=np.uint8)


@pytest.mark.parametrize("kind", ["random", "parity", "decode"])
@pytest.mark.parametrize("n", [1, 255, 4097, 5000])
def test_plain_equals_pallas_jax_and_numpy(kind, n):
    C = _matrix(kind)
    x = np.random.default_rng(n).integers(0, 256, (10, n), dtype=np.uint8)
    got = gf_cuda.CudaGFMatrix(C)(torch.from_numpy(x)).numpy()
    pallas = np.asarray(pallas_gf.PallasGFMatrix(C, tile=256,
                                                 interpret=True)(x))
    assert np.array_equal(got, pallas)
    assert np.array_equal(got, np.asarray(gfmat_jax.JaxGFMatrix(C)(x)))
    assert np.array_equal(got, ref_gf.gf_matmul(C, x))


def test_plain_on_strided_rows():
    """The pipeline hands the codec [:, :step] views of a wider buffer."""
    C = _matrix("parity")
    buf = np.random.default_rng(3).integers(0, 256, (10, 4096),
                                            dtype=np.uint8)
    got = gf_cuda.CudaGFMatrix(C)(torch.from_numpy(buf)[:, :1000]).numpy()
    assert np.array_equal(got, ref_gf.gf_matmul(C, buf[:, :1000]))


def test_apply_batch_equals_jax_batch():
    C = _matrix("random")
    x = np.random.default_rng(5).integers(0, 256, (3, 10, 4097),
                                          dtype=np.uint8)
    mat = gf_cuda.CudaGFMatrix(C)
    got = mat.apply_batch(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 4, 4097)
    assert np.array_equal(got, np.asarray(pallas_gf.PallasGFMatrix(
        C, tile=256, interpret=True).apply_batch(x)))
    assert np.array_equal(got, np.asarray(
        gfmat_jax.JaxGFMatrix(C).apply_batch(x)))


# ---- codec shell ------------------------------------------------------------

def test_codec_round_trip_equals_pallas_codec():
    ref_code = ref_rs.get_code(10, 4)
    mine = gf_cuda.CudaRSCodec(rs.from_reference(ref_code.matrix, 10, 4),
                               device="cpu")
    ref = pallas_gf.PallasRSCodec(ref_code, tile=256, interpret=True)
    data = np.random.default_rng(9).integers(0, 256, (10, 700),
                                             dtype=np.uint8)
    shards = mine.encode(torch.from_numpy(data)).numpy()
    assert np.array_equal(shards, np.asarray(ref.encode(data)))
    patterns = list(itertools.combinations(range(14), 4))
    g = np.random.default_rng(2)
    for idx in g.choice(len(patterns), size=6, replace=False):
        lost = list(patterns[idx])
        present = {i: torch.from_numpy(shards[i])
                   for i in range(14) if i not in lost}
        out = mine.reconstruct(present)
        ref_out = ref.reconstruct({i: shards[i] for i in present})
        for i in lost:
            assert np.array_equal(out[i].numpy(), shards[i]), (lost, i)
            assert np.array_equal(out[i].numpy(), np.asarray(ref_out[i]))


def test_codec_stacks_rows_16_bytes_apart():
    """encode and reconstruct hand the apply rows 16 bytes apart whatever
    n is, so on the card the kernel reads their stack in place (a
    contiguous [10, 700] used to be refused there)."""
    strides = []

    class Spy(gf_cuda.CudaGFMatrix):
        def _apply(self, x, name):
            strides.append(x.stride(-2))
            return super()._apply(x, name)

    code = rs.get_code(10, 4)
    codec = codec_base.RSCodecBase(code, Spy)
    data = np.random.default_rng(12).integers(0, 256, (10, 700),
                                              dtype=np.uint8)
    shards = codec.encode(torch.from_numpy(data))
    want = np.concatenate([data, ref_gf.gf_matmul(code.parity_matrix, data)])
    assert np.array_equal(shards.numpy(), want)
    lost = (0, 3, 10, 12)
    out = codec.reconstruct({i: torch.from_numpy(want[i])
                             for i in range(14) if i not in lost})
    for i in lost:
        assert np.array_equal(out[i].numpy(), want[i])
    assert len(strides) == 2
    assert all(s % gf_cuda.ALIGN == 0 for s in strides), strides


def test_decode_cache_is_lru_bounded(monkeypatch):
    monkeypatch.setenv("WEEDTPU_CODEC_DECODE_CACHE", "2")
    codec = gf_cuda.CudaRSCodec(rs.get_code(6, 3), device="cpu")
    shards = codec.encode(torch.from_numpy(
        np.random.default_rng(4).integers(0, 256, (6, 64), dtype=np.uint8)))
    for lost in ([0], [1], [2], [0, 4]):
        got = codec.reconstruct({i: shards[i] for i in range(9)
                                 if i not in lost})
        for i in lost:
            assert torch.equal(got[i], shards[i])
    assert len(codec._decode_cache) == 2


def test_dispatch_seam_on_cpu():
    codec = gf_cuda.get_codec(10, 4, device="cpu")
    data = np.random.default_rng(6).integers(0, 256, (10, 333),
                                             dtype=np.uint8)
    parity = dispatch.materialize(dispatch.dispatch_parity(codec, data))
    assert np.array_equal(parity,
                          ref_gf.gf_matmul(ref_rs.get_code().parity_matrix,
                                           data))
    mism = dispatch.parity_mismatch(codec, data, {0: parity[0].tobytes(),
                                                  1: parity[1] ^ 1})
    assert not mism[0].any() and mism[1].all()
    shards = {i: data[i] for i in range(10) if i not in (2, 7)}
    shards.update({10: parity[0], 11: parity[1]})
    out = dispatch.reconstruct_batch(codec, shards, [2, 7])
    assert np.array_equal(out[2], data[2]) and np.array_equal(out[7], data[7])


def test_launch_counts_only_where_the_kernel_launches():
    """CPU tensors, empty ones included, go to the plain version and count
    nothing; the kernel wrapper refuses a CPU tensor before it counts."""
    mat = gf_cuda.CudaGFMatrix(_matrix("parity"))
    before = dict(gf_cuda.LAUNCHES)
    staged = dict(gf_cuda.STAGED)
    for shape in ((10, 0), (10, 33)):
        assert mat(torch.zeros(shape, dtype=torch.uint8)).shape == \
            (4, shape[1])
    assert mat.apply_batch(torch.zeros((0, 10, 16), dtype=torch.uint8)
                           ).shape == (0, 4, 16)
    with pytest.raises(ValueError):
        gf_cuda.gf_apply_cuda(torch.zeros((4, 10), dtype=torch.uint8),
                              torch.zeros((1, 10, 16), dtype=torch.uint8))
    assert gf_cuda.LAUNCHES == before
    assert gf_cuda.STAGED == staged


def test_padded_staging_keeps_rows_aligned():
    """The dispatch seam lands every batch with rows 16 bytes apart, the
    layout the kernel reads in place."""
    for n in (1, 16, 255, 4097):
        x = dispatch.device_empty((10, n), torch.device("cpu"))
        assert x.shape == (10, n) and x.stride() == (
            gf_cuda.padded_width(n), 1)
        assert gf_cuda.padded_width(n) % gf_cuda.ALIGN == 0


@pytest.mark.parametrize("view, in_place", [
    ("padded", True), ("padded_units", True), ("one_row", True),
    ("contiguous_700", False), ("offset", False), ("transposed", False)])
def test_kernel_reads_in_place_only_aligned_rows(view, in_place):
    """Which [U, k, n] views the wrapper hands the kernel as they lie and
    which it stages a padded copy of first: rows 16 bytes apart on a
    16-byte base are read in place, and nothing else."""
    wide = dispatch.device_empty((3, 10, 4097), torch.device("cpu"))
    x = {"padded": wide[:1],
         "padded_units": wide,
         "one_row": torch.zeros((1, 1, 700), dtype=torch.uint8),
         "contiguous_700": torch.zeros((1, 10, 700), dtype=torch.uint8),
         "offset": wide[:1, :, 1:],
         "transposed": torch.zeros((1, 64, 10),
                                   dtype=torch.uint8).transpose(1, 2),
         }[view]
    assert gf_cuda._in_place(x) is in_place


def test_plain_version_runs_on_one_intra_op_thread(monkeypatch):
    """A CPU apply runs `gf_apply_plain` on one intra-op thread and gives
    the calling thread its own count back (ROADMAP fault 3.16: an
    OpenMP team per call oversubscribes a loaded host)."""
    seen = []
    plain = gf_cuda.gf_apply_plain

    def probe(bitmat, x):
        seen.append(torch.get_num_threads())
        return plain(bitmat, x)

    monkeypatch.setattr(gf_cuda, "gf_apply_plain", probe)
    before = torch.get_num_threads()
    try:
        torch.set_num_threads(3)
        C = np.random.default_rng(0).integers(0, 256, (4, 10),
                                              dtype=np.uint8)
        x = np.random.default_rng(1).integers(0, 256, (10, 4096),
                                              dtype=np.uint8)
        got = gf_cuda.CudaGFMatrix(C)(torch.from_numpy(x))
        assert torch.get_num_threads() == 3
        with gf_cuda.one_intra_op_thread():
            assert torch.get_num_threads() == 1
        assert torch.get_num_threads() == 3
    finally:
        torch.set_num_threads(before)
    assert seen == [1]
    assert np.array_equal(got.numpy(), ref_gf.gf_matmul(C, x))
