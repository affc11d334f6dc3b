"""A cluster that is all the port's: the port's master and port volume
servers (`device="cpu"`), in process on one asyncio loop in a thread with
real sockets, driven by the reference's `WeedClient` and shell exactly as
tests/test_cluster.py drives the reference's servers.

The nine tests below are twins of that file's.  Then a mixed cluster:
one reference and one port volume server under the port's master, with
a shard set that crosses both ways (the opposite case, port nodes under
the reference master, is tests/test_torch_cluster.py's), and the CLI:
`master`, `volume` and `server` subcommands as subprocesses, where
neither jax nor the reference package is imported.

The port's servers start with WEEDTPU_SCRUB_MBPS=0 and the master with
its repair loop off (WEEDTPU_REPAIR_INTERVAL=0): a background scrub pass
or a planner tick would launch work no step of the flows expects, and
the planner would rebuild the shards the flows delete.
"""

import asyncio
import concurrent.futures
import io
import json
import os
import pathlib
import secrets
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from seaweedfs_tpu.client import WeedClient
from seaweedfs_tpu.shell.commands import CommandEnv, run_command

REPO = pathlib.Path(__file__).resolve().parent.parent


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Cluster:
    """The port's master, `n_volume_servers` port volume servers and
    `n_ref` reference volume servers on one asyncio loop in a daemon
    thread."""

    def __init__(self, tmp_path, n_volume_servers=2, max_volumes=20,
                 volume_size_limit=64 * 1024 * 1024, replication="000",
                 n_ref=0):
        self.tmp = tmp_path
        self.n = n_volume_servers + n_ref
        self.n_port = n_volume_servers
        self.max_volumes = max_volumes
        self.volume_size_limit = volume_size_limit
        self.replication = replication
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.master = None
        self.volume_servers = []

    def submit(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(60)

    def start(self):
        from seaweedfs_tpu.server.volume_server import VolumeServer as RefVS
        from seaweedfs_tpu_torch.server.master import MasterServer
        from seaweedfs_tpu_torch.server.volume_server import VolumeServer
        self.thread.start()
        self.master = MasterServer("127.0.0.1", free_port(),
                                   volume_size_limit=self.volume_size_limit,
                                   default_replication=self.replication)
        self.submit(self.master.start())
        for i in range(self.n):
            d = self.tmp / f"vs{i}"
            d.mkdir(exist_ok=True)
            if i < self.n_port:
                vs = VolumeServer([str(d)], self.master.url, "127.0.0.1",
                                  free_port(), max_volumes=self.max_volumes,
                                  heartbeat_interval=0.3, device="cpu")
            else:
                vs = RefVS([str(d)], self.master.url, "127.0.0.1",
                           free_port(), max_volumes=self.max_volumes,
                           heartbeat_interval=0.3)
            self.submit(vs.start())
            self.volume_servers.append(vs)
        return self

    def stop(self):
        for vs in self.volume_servers:
            self.submit(vs.stop())
        self.submit(self.master.stop())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(5)

    def wait_heartbeats(self, timeout=5.0):
        deadline = time.time() + timeout
        while time.time() < deadline:
            if len(self.master.topo.nodes) == self.n:
                return
            time.sleep(0.05)
        raise TimeoutError("volume servers did not register")


@pytest.fixture(autouse=True)
def _no_scrubber(monkeypatch):
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "0")
    # the master's repair loop would rebuild the shards a flow deletes
    monkeypatch.setenv("WEEDTPU_REPAIR_INTERVAL", "0")


@pytest.fixture()
def cluster(tmp_path):
    c = Cluster(tmp_path).start()
    c.wait_heartbeats()
    yield c
    c.stop()


# ---- twins of tests/test_cluster.py ----------------------------------------

def test_blob_lifecycle(cluster):
    client = WeedClient(cluster.master.url)
    rng = np.random.default_rng(0)
    payloads = {}
    for i in range(50):
        data = rng.integers(0, 256, int(rng.integers(10, 50_000)),
                            dtype=np.uint8).tobytes()
        fid = client.upload(data, name=f"f{i}.bin", mime="application/x-test")
        payloads[fid] = data
    for fid, data in payloads.items():
        assert client.download(fid) == data
    victim = next(iter(payloads))
    client.delete(victim)
    with pytest.raises(RuntimeError):
        client.download(victim)
    # wrong cookie is rejected
    vid, _, keycookie = victim.partition(",")
    bad = f"{vid},{keycookie[:-8]}{'00000000'}"
    with pytest.raises(RuntimeError):
        client.download(bad)


def test_replicated_write_spans_servers(tmp_path):
    c = Cluster(tmp_path, n_volume_servers=2, replication="001").start()
    try:
        c.wait_heartbeats()
        client = WeedClient(c.master.url)
        fid = client.upload(b"replicated payload", replication="001")
        vid = int(fid.partition(",")[0])
        time.sleep(0.7)  # let heartbeats refresh
        locs = client.lookup(vid)
        assert len(locs) == 2, locs
        for url in locs:
            with urllib.request.urlopen(f"http://{url}/{fid}") as r:
                assert r.read() == b"replicated payload"
        # delete propagates to both replicas
        client.delete(fid)
        for url in locs:
            with pytest.raises(urllib.error.HTTPError):
                urllib.request.urlopen(f"http://{url}/{fid}")
    finally:
        c.stop()


def _fill_volume(client, n_blobs=60, seed=1):
    rng = np.random.default_rng(seed)
    payloads = {}
    for i in range(n_blobs):
        data = rng.integers(0, 256, int(rng.integers(1000, 80_000)),
                            dtype=np.uint8).tobytes()
        fid = client.upload(data, name=f"ec{i}.bin")
        payloads[fid] = data
    return payloads


def _delete_shards(url: str, vid: int, shards) -> None:
    body = json.dumps({"volume": vid, "shards": list(shards)}).encode()
    req = urllib.request.Request(
        f"http://{url}/admin/ec/delete_shards", data=body,
        headers={"Content-Type": "application/json"})
    urllib.request.urlopen(req).close()


def _ec_flow(cluster, payloads, vids, dropper):
    """The shell's encode, degraded reads after `dropper` loses two
    shards it holds of each volume, rebuild and decode; every blob read
    back after each step."""
    client = WeedClient(cluster.master.url)
    env = CommandEnv(cluster.master.url)
    out = io.StringIO()
    run_command(env, "lock", out)
    try:
        for vid in sorted(vids):
            run_command(env, f"ec.encode -volumeId {vid}", out)
        time.sleep(0.7)  # shard heartbeats
        client._vid_cache.clear()
        for fid, data in payloads.items():
            assert client.download(fid) == data, fid
        for vid in sorted(vids):
            held = sorted(s for s, urls in env.ec_shard_locations(vid).items()
                          if dropper.url in urls)
            assert held, (vid, env.ec_shard_locations(vid))
            _delete_shards(dropper.url, vid, held[:2])
        time.sleep(0.7)
        client._vid_cache.clear()
        for fid, data in payloads.items():
            assert client.download(fid) == data, f"degraded read {fid}"
        run_command(env, "ec.rebuild", out)
        time.sleep(0.7)
        for vid in sorted(vids):
            locs = env.ec_shard_locations(vid)
            assert sorted(locs) == list(range(14)), (vid, sorted(locs))
            run_command(env, f"ec.decode -volumeId {vid}", out)
        time.sleep(0.7)
        client._vid_cache.clear()
        for fid, data in payloads.items():
            assert client.download(fid) == data, f"post-decode read {fid}"
    finally:
        run_command(env, "unlock", out)


def test_ec_encode_degraded_read_rebuild_decode(cluster):
    client = WeedClient(cluster.master.url)
    payloads = _fill_volume(client)
    vids = {int(fid.partition(",")[0]) for fid in payloads}
    time.sleep(0.7)
    _ec_flow(cluster, payloads, vids, cluster.volume_servers[0])


def test_shell_requires_lock(cluster):
    env = CommandEnv(cluster.master.url)
    with pytest.raises(RuntimeError, match="lock"):
        run_command(env, "volume.vacuum -volumeId 1", io.StringIO())


def test_vacuum_via_shell(cluster):
    client = WeedClient(cluster.master.url)
    fids = [client.upload(bytes(2000)) for _ in range(20)]
    for fid in fids[:15]:
        client.delete(fid)
    vid = int(fids[0].partition(",")[0])
    time.sleep(0.5)
    env = CommandEnv(cluster.master.url)
    out = io.StringIO()
    run_command(env, "lock", out)
    run_command(env, f"volume.vacuum -volumeId {vid}", out)
    run_command(env, "unlock", out)
    assert "garbage" in out.getvalue()
    for fid in fids[15:]:
        assert client.download(fid) == bytes(2000)


def test_paged_range_read_large_blob(cluster):
    """Range requests on large needles read only the page, not the whole
    record (reference: needle_read_page.go)."""
    client = WeedClient(cluster.master.url)
    rng = np.random.default_rng(17)
    blob = rng.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()  # 1MB
    fid = client.upload(blob, name="big.bin")
    url = client.lookup(int(fid.split(",")[0]))[0]
    req = urllib.request.Request(f"http://{url}/{fid}",
                                 headers={"Range": "bytes=500000-500099"})
    with urllib.request.urlopen(req, timeout=30) as r:
        assert r.status == 206
        assert r.headers["Content-Range"] == f"bytes 500000-500099/{1 << 20}"
        assert r.read() == blob[500000:500100]
    req = urllib.request.Request(f"http://{url}/{fid}",
                                 headers={"Range": "bytes=1048000-"})
    with urllib.request.urlopen(req, timeout=30) as r:
        assert r.read() == blob[1048000:]
    assert client.download(fid) == blob


def test_concurrent_write_read_delete_hammer(cluster):
    """Thread hammer on one volume server: concurrent uploads, whole and
    paged (Range) reads, and deletes stay consistent."""
    client = WeedClient(cluster.master.url)
    big = secrets.token_bytes(512 * 1024)
    big_fid = client.upload(big, name="big.bin")
    big_url = client.lookup(int(big_fid.split(",")[0]))[0]

    def paged_read(i):
        lo = (i * 37) % (len(big) - 64)
        req = urllib.request.Request(
            f"http://{big_url}/{big_fid}",
            headers={"Range": f"bytes={lo}-{lo + 63}"})
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.read() == big[lo:lo + 64]
        return True
    blobs: dict[str, bytes] = {}

    def write_one(i):
        data = secrets.token_bytes(1000 + (i % 7) * 3777)
        fid = client.upload(data, name=f"h{i}.bin")
        return fid, data

    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        for fid, data in ex.map(write_one, range(60)):
            blobs[fid] = data

    def read_one(item):
        fid, data = item
        assert client.download(fid) == data
        return True

    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        futs = [ex.submit(read_one, it) for it in blobs.items()]
        futs += [ex.submit(paged_read, i) for i in range(30)]
        for f in futs:
            assert f.result()

    fids = list(blobs)
    doomed, kept = set(fids[::3]), [f for i, f in enumerate(fids) if i % 3]

    def delete_one(fid):
        client.delete(fid)
        return True

    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        futs = [ex.submit(delete_one, f) for f in doomed]
        futs += [ex.submit(read_one, (f, blobs[f])) for f in kept]
        for f in futs:
            assert f.result()

    for fid in doomed:
        with pytest.raises(RuntimeError):
            client.download(fid)
    for fid in kept:
        assert client.download(fid) == blobs[fid]


def test_ec_generate_progress_and_cancel(tmp_path):
    """EC generate is observable (/admin/ec/progress) and cancellable
    (/admin/ec/cancel)."""
    c = Cluster(tmp_path, n_volume_servers=1).start()
    c.wait_heartbeats()
    try:
        client = WeedClient(c.master.url)
        for i in range(20):
            client.upload(bytes([i]) * 20000, name=f"f{i}.bin")
        vid = 1
        vs = c.volume_servers[0]

        def call(path, body=None, method=None):
            data = json.dumps(body).encode() if body is not None else None
            req = urllib.request.Request(
                f"http://{vs.url}{path}", data=data,
                method=method or ("POST" if body is not None else "GET"),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as r:
                return json.loads(r.read())

        call("/admin/volume/readonly", {"volume": vid, "readonly": True})
        r = call("/admin/ec/generate", {"volume": vid})
        assert r["shards"] == list(range(14))
        prog = call(f"/admin/ec/progress?volumeId={vid}")
        assert prog["state"] == "done"
        assert prog["bytes_done"] == prog["total"] > 0
        with pytest.raises(urllib.error.HTTPError) as ei:
            call("/admin/ec/cancel", {"volume": vid})
        assert ei.value.code == 404
        # the cancellation machinery end to end: the port's
        # write_ec_files with a cancel that trips after the first batch
        from seaweedfs_tpu_torch.storage.ec import ec_files
        base = None
        for loc in vs.store.locations:
            cand = loc.base_path(vid, "")
            if os.path.exists(cand + ".dat"):
                base = cand
        hits = []

        def cancel():
            hits.append(1)
            return len(hits) > 1

        with pytest.raises(ec_files.EncodeCancelled):
            ec_files.write_ec_files(base, large_block=1 << 30,
                                    small_block=8192, batch_size=8192,
                                    cancel=cancel, device="cpu")
    finally:
        c.stop()


def test_streamed_vid_map_invalidation(tmp_path):
    """A client on the master's /cluster/stream push feed reroutes around
    a dead volume server as soon as the master expires it."""
    c = Cluster(tmp_path, n_volume_servers=2, replication="001")
    c.start()
    c.master.node_timeout = 1.5
    c.wait_heartbeats()
    try:
        client = WeedClient(c.master.url, stream_updates=True)
        poll_client = WeedClient(c.master.url)  # TTL-poll comparison
        a = client.assign(replication="001")
        fid = a["fid"]
        vid = int(fid.split(",")[0])
        client.upload_to(a["url"], fid, b"replicated-payload",
                         jwt=a.get("auth", ""))
        deadline = time.time() + 8
        while time.time() < deadline:
            if len(client._vid_cache.get(vid, ([], 0))[0]) == 2:
                break
            time.sleep(0.1)
        urls = client._vid_cache[vid][0]
        assert len(urls) == 2
        assert sorted(poll_client.lookup(vid)) == sorted(urls)
        dead = urls[0]
        vs = next(v for v in c.volume_servers if v.url == dead)
        c.submit(vs.stop())
        c.volume_servers.remove(vs)
        # the push client's map drops the dead url once the master
        # expires the node, without any lookup from the client
        deadline = time.time() + 10
        while time.time() < deadline:
            cached = client._vid_cache.get(vid, ([], 0))[0]
            if cached and dead not in cached:
                break
            time.sleep(0.1)
        cached = client._vid_cache.get(vid, ([], 0))[0]
        assert cached and dead not in cached, cached
        assert client.download(fid) == b"replicated-payload"
        stale = poll_client._vid_cache.get(vid, ([], 0))[0]
        assert dead in stale
        client.close()
    finally:
        c.stop()


# ---- a mixed cluster under the port's master --------------------------------

def test_mixed_cluster_under_the_port_master(tmp_path):
    """One port and one reference volume server under the port's master.
    A volume on each is filled, and the shell encodes both, so each shard
    set spreads from its encoder to the other package's server; every
    blob reads back encoded, with two shards lost on the other node,
    after the shell's rebuild and after its decode."""
    c = Cluster(tmp_path, n_volume_servers=1, n_ref=1).start()
    c.wait_heartbeats()
    try:
        port_vs, ref_vs = c.volume_servers
        rng = np.random.default_rng(9)
        payloads, vids = {}, []
        for src, vid in ((port_vs, 41), (ref_vs, 42)):
            req = urllib.request.Request(
                f"http://{src.url}/admin/assign_volume",
                data=json.dumps({"volume": vid}).encode(),
                headers={"Content-Type": "application/json"})
            urllib.request.urlopen(req).close()
            for i in range(24):
                data = rng.integers(0, 256, int(rng.integers(500, 40_000)),
                                    dtype=np.uint8).tobytes()
                fid = f"{vid},{vid * 1000 + i:x}{0x1234abcd:08x}"
                req = urllib.request.Request(f"http://{src.url}/{fid}",
                                             data=data, method="PUT")
                with urllib.request.urlopen(req) as r:
                    assert r.status == 201
                payloads[fid] = data
            vids.append(vid)
        time.sleep(0.7)
        env = CommandEnv(c.master.url)
        client = WeedClient(c.master.url)
        out = io.StringIO()
        run_command(env, "lock", out)
        try:
            for vid in vids:
                run_command(env, f"ec.encode -volumeId {vid}", out)
            time.sleep(0.7)
            for vid in vids:
                locs = env.ec_shard_locations(vid)
                holders = {u for urls in locs.values() for u in urls}
                assert holders == {port_vs.url, ref_vs.url}, (vid, locs)
            client._vid_cache.clear()
            for fid, data in payloads.items():
                assert client.download(fid) == data, fid
            # each volume loses two shards on the node that did not
            # encode it; reads reconstruct from both packages' shards
            for vid, other in ((41, ref_vs), (42, port_vs)):
                held = sorted(s for s, urls in
                              env.ec_shard_locations(vid).items()
                              if other.url in urls)
                _delete_shards(other.url, vid, held[:2])
            time.sleep(0.7)
            client._vid_cache.clear()
            for fid, data in payloads.items():
                assert client.download(fid) == data, f"degraded {fid}"
            run_command(env, "ec.rebuild", out)
            time.sleep(0.7)
            for vid in vids:
                assert sorted(env.ec_shard_locations(vid)) == \
                    list(range(14))
                run_command(env, f"ec.decode -volumeId {vid}", out)
            time.sleep(0.7)
            client._vid_cache.clear()
            for fid, data in payloads.items():
                assert client.download(fid) == data, f"decoded {fid}"
        finally:
            run_command(env, "unlock", out)
    finally:
        c.stop()


# ---- the CLI ---------------------------------------------------------------

CLI_CHILD = r"""
import json, sys, threading
from seaweedfs_tpu_torch.__main__ import main
threading.Thread(target=main, args=(sys.argv[1:],), daemon=True).start()
sys.stdin.readline()  # the test's word to report and leave
print(json.dumps({"jax": "jax" in sys.modules,
                  "reference": sorted(m for m in sys.modules
                                      if m.split(".")[0] ==
                                      "seaweedfs_tpu")}), flush=True)
import os
os._exit(0)
"""


def _child_env() -> dict:
    env = dict(os.environ, PYTHONPATH=str(REPO), WEEDTPU_SCRUB_MBPS="0")
    env.pop("WEEDTPU_EC_CODEC", None)
    return env


@pytest.mark.parametrize("mode", ["master+volume", "server"])
def test_cli_master_and_server_serve_the_reference_client(tmp_path, mode):
    """`python -m seaweedfs_tpu_torch master` with a `volume -device cpu`
    beside it, or one `server -device cpu`: the reference `WeedClient`
    writes, reads and deletes through them, and neither child imported
    jax or the reference package."""
    mport, vport = free_port(), free_port()
    if mode == "server":
        argvs = [["server", "-dir", str(tmp_path / "d"), "-port",
                  str(mport), "-volumePort", str(vport), "-device", "cpu",
                  "-mdir", str(tmp_path / "m")]]
    else:
        argvs = [["master", "-port", str(mport), "-mdir",
                  str(tmp_path / "m")],
                 ["volume", "-dir", str(tmp_path / "d"), "-port",
                  str(vport), "-mserver", f"127.0.0.1:{mport}", "-device",
                  "cpu"]]
    (tmp_path / "d").mkdir()
    procs = []
    try:
        for i, argv in enumerate(argvs):
            log = open(tmp_path / f"child{i}.log", "wb")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", CLI_CHILD, *argv], cwd=str(REPO),
                env=_child_env(), stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, stderr=log))
        master = f"127.0.0.1:{mport}"
        deadline = time.time() + 120
        nodes = {}
        while time.time() < deadline and not nodes:
            try:
                with urllib.request.urlopen(
                        f"http://{master}/dir/status", timeout=2) as r:
                    nodes = json.loads(r.read())["Topology"]["nodes"]
            except OSError:
                pass
            for i, p in enumerate(procs):
                assert p.poll() is None, \
                    (tmp_path / f"child{i}.log").read_text()[-3000:]
            time.sleep(0.1)
        assert list(nodes) == [f"127.0.0.1:{vport}"]
        client = WeedClient(master)
        payloads = {client.upload(b"cli %d" % i * (i + 1)): b"cli %d" % i *
                    (i + 1) for i in range(12)}
        for fid, data in payloads.items():
            assert client.download(fid) == data
        victim = next(iter(payloads))
        client.delete(victim)
        with pytest.raises(RuntimeError):
            client.download(victim)
        for p in procs:
            out, _ = p.communicate(b"report\n", timeout=60)
            got = json.loads(out.decode().strip().splitlines()[-1])
            assert got == {"jax": False, "reference": []}
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)


def test_cli_server_without_device_needs_the_card(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is there")
    r = subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "server", "-dir",
         str(tmp_path), "-port", str(free_port()), "-volumePort",
         str(free_port())], cwd=str(REPO), env=_child_env(),
        capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
