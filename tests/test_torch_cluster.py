"""The port's volume server in a cluster of the reference's master, shell
and client.

The reference `MasterServer` runs in the test process on an asyncio loop
in a thread; each port volume server is its own interpreter, started by
the port's CLI (`python -m seaweedfs_tpu_torch volume ... -device cpu`),
where neither jax nor the reference package is imported.  The tests are
twins of tests/test_cluster.py's and tests/test_pb.py's cluster tests,
driven by the reference `WeedClient` and shell exactly as those drive
the reference's servers, plus mixed clusters (one reference and one
port volume server) whose shard sets and repair partials cross both
ways, and the master's background planes over port nodes: its repair
in mode `reduced`, its canary's probe, and the routes this slice
leaves out.

Tests that share the module's cluster keep their blobs in a collection
of their own (the EC flow's is the default one), so none sees another's
volumes.
"""

import asyncio
import io
import json
import os
import pathlib
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


def port_volume_cmd(d, master_url: str, port: int) -> list[str]:
    return [sys.executable, "-m", "seaweedfs_tpu_torch", "volume",
            "-dir", str(d), "-mserver", master_url, "-ip", "127.0.0.1",
            "-port", str(port), "-max", "20", "-device", "cpu"]


def child_env(**extra) -> dict:
    env = dict(os.environ, PYTHONPATH=str(REPO), **extra)
    env.pop("WEEDTPU_EC_CODEC", None)
    return env


class PortCluster:
    """A master in process (the reference's, or with `master="port"` the
    port's), `n_port` port volume servers in subprocesses and `n_ref`
    reference volume servers in process."""

    def __init__(self, tmp_path, n_port=2, n_ref=0, env=None,
                 volume_size_limit=64 * 1024 * 1024, master="reference"):
        self.master_kind = master
        self.tmp = pathlib.Path(tmp_path)
        self.n_port, self.n_ref = n_port, n_ref
        self.env = child_env(**(env or {}))
        self.volume_size_limit = volume_size_limit
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.master = None
        self.ref_servers = []
        self.procs: list[subprocess.Popen] = []
        self.port_urls: list[str] = []
        self.port_dirs: list[pathlib.Path] = []

    def submit(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(60)

    def start(self):
        from seaweedfs_tpu.server.master import MasterServer
        from seaweedfs_tpu.server.volume_server import VolumeServer
        if self.master_kind == "port":
            from seaweedfs_tpu_torch.server.master import MasterServer
        self.thread.start()
        self.master = MasterServer("127.0.0.1", free_port(),
                                   volume_size_limit=self.volume_size_limit)
        self.submit(self.master.start())
        for i in range(self.n_port):
            d = self.tmp / f"port{i}"
            d.mkdir(exist_ok=True)
            port = free_port()
            with open(self.tmp / f"port{i}.log", "wb") as log:
                self.procs.append(subprocess.Popen(
                    port_volume_cmd(d, self.master.url, port),
                    cwd=str(REPO), env=self.env, stdout=log,
                    stderr=subprocess.STDOUT))
            self.port_urls.append(f"127.0.0.1:{port}")
            self.port_dirs.append(d)
        for i in range(self.n_ref):
            d = self.tmp / f"ref{i}"
            d.mkdir(exist_ok=True)
            vs = VolumeServer([str(d)], self.master.url, "127.0.0.1",
                              free_port(), max_volumes=20,
                              heartbeat_interval=0.3)
            self.submit(vs.start())
            self.ref_servers.append(vs)
        self.wait_heartbeats()
        return self

    def wait_heartbeats(self, timeout=90.0):
        deadline = time.time() + timeout
        want = self.n_port + self.n_ref
        while time.time() < deadline:
            if len(self.master.topo.nodes) == want:
                return
            for i, p in enumerate(self.procs):
                if p.poll() is not None:
                    raise RuntimeError(
                        f"port volume server {i} exited {p.returncode}:\n"
                        + (self.tmp / f"port{i}.log").read_text())
            time.sleep(0.05)
        raise TimeoutError("volume servers did not register")

    def stop(self):
        for p in self.procs:
            p.terminate()
        for p in self.procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)
        for vs in self.ref_servers:
            self.submit(vs.stop())
        self.submit(self.master.stop())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(5)


def vs_call(url: str, path: str, body=None, method=None):
    """(status, parsed JSON or raw bytes) of one admin call."""
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(
        f"http://{url}{path}", data=data,
        method=method or ("POST" if body is not None else "GET"),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            status, raw, ctype = r.status, r.read(), \
                r.headers.get("Content-Type", "")
    except urllib.error.HTTPError as e:
        status, raw, ctype = e.code, e.read(), \
            e.headers.get("Content-Type", "")
    return status, (json.loads(raw) if "json" in ctype else raw)


def wait_for(pred, timeout=15.0, what="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.1)
    raise TimeoutError(what)


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    c = PortCluster(tmp_path_factory.mktemp("port_cluster")).start()
    yield c
    c.stop()


def _fill_volume(client, n_blobs=60, seed=1, collection=""):
    rng = np.random.default_rng(seed)
    payloads = {}
    for i in range(n_blobs):
        data = rng.integers(0, 256, int(rng.integers(1000, 80_000)),
                            dtype=np.uint8).tobytes()
        fid = client.upload(data, name=f"ec{i}.bin", collection=collection)
        payloads[fid] = data
    return payloads


# ---- twins of tests/test_cluster.py --------------------------------------

def test_blob_lifecycle(cluster):
    client = WeedClient(cluster.master.url)
    rng = np.random.default_rng(0)
    payloads = {}
    for i in range(50):
        data = rng.integers(0, 256, int(rng.integers(10, 50_000)),
                            dtype=np.uint8).tobytes()
        fid = client.upload(data, name=f"f{i}.bin", mime="application/x-test",
                            collection="lifecycle")
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


def test_replicated_write_spans_servers(cluster):
    client = WeedClient(cluster.master.url)
    fid = client.upload(b"replicated payload", replication="001",
                        collection="replicated")
    vid = int(fid.partition(",")[0])
    wait_for(lambda: len(client.lookup(vid)) == 2, what="two replicas")
    locs = client.lookup(vid)
    assert sorted(locs) == sorted(cluster.port_urls)
    # read from each server directly
    for url in locs:
        with urllib.request.urlopen(f"http://{url}/{fid}") as r:
            assert r.read() == b"replicated payload"
    # delete propagates to both replicas
    client.delete(fid)
    for url in locs:
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://{url}/{fid}")


def test_ec_encode_degraded_read_rebuild_decode(cluster):
    client = WeedClient(cluster.master.url)
    # the default collection: the shell's ec.rebuild copies survivors
    # without naming one
    payloads = _fill_volume(client)
    vids = {int(fid.partition(",")[0]) for fid in payloads}
    env = CommandEnv(cluster.master.url)
    out = io.StringIO()
    run_command(env, "lock", out)
    try:
        for vid in sorted(vids):
            run_command(env, f"ec.encode -volumeId {vid}", out)
        # all blobs read back through the EC path (the volume is gone)
        client._vid_cache.clear()
        for fid, data in payloads.items():
            assert client.download(fid) == data, fid

        # delete shards on one server -> degraded reads reconstruct,
        # fetching what that server lacks from its peer
        vs0 = cluster.port_urls[0]
        for vid in sorted(vids):
            shards0 = [s for s, locs in env.ec_shard_locations(vid).items()
                       if vs0 in locs]
            assert shards0, (vid, env.ec_shard_locations(vid))
            assert vs_call(vs0, "/admin/ec/delete_shards",
                           {"volume": vid, "shards": shards0[:2]})[0] == 200
        client._vid_cache.clear()
        for fid, data in payloads.items():
            assert client.download(fid) == data, f"degraded read {fid}"

        # rebuild the dropped shards, then decode back to a normal volume
        run_command(env, "ec.rebuild", out)
        for vid in sorted(vids):
            locs = env.ec_shard_locations(vid)
            assert sorted(locs) == list(range(14)), (vid, sorted(locs))
            run_command(env, f"ec.decode -volumeId {vid}", out)
        client._vid_cache.clear()
        for fid, data in payloads.items():
            assert client.download(fid) == data, f"post-decode read {fid}"
    finally:
        run_command(env, "unlock", out)


def test_vacuum_via_shell(cluster):
    client = WeedClient(cluster.master.url)
    fids = [client.upload(bytes(2000), collection="vacuum")
            for _ in range(20)]
    for fid in fids[:15]:
        client.delete(fid)
    vid = int(fids[0].partition(",")[0])
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
    fid = client.upload(blob, name="big.bin", collection="paged")
    url = client.lookup(int(fid.split(",")[0]))[0]
    req = urllib.request.Request(f"http://{url}/{fid}",
                                 headers={"Range": "bytes=500000-500099"})
    with urllib.request.urlopen(req, timeout=30) as r:
        assert r.status == 206
        assert r.headers["Content-Range"] == f"bytes 500000-500099/{1 << 20}"
        assert r.read() == blob[500000:500100]
    # suffix + open-ended ranges still served correctly
    req = urllib.request.Request(f"http://{url}/{fid}",
                                 headers={"Range": "bytes=1048000-"})
    with urllib.request.urlopen(req, timeout=30) as r:
        assert r.read() == blob[1048000:]
    # whole read unchanged
    assert client.download(fid) == blob


def test_ec_generate_progress_and_cancel(cluster):
    """EC generate is observable (/admin/ec/progress) and cancellable
    (/admin/ec/cancel): a wedged 30 GB encode must not be invisible."""
    client = WeedClient(cluster.master.url)
    fids = [client.upload(bytes([i]) * 20000, name=f"f{i}.bin",
                          collection="progress") for i in range(20)]
    vid = int(fids[0].partition(",")[0])
    vs = client.lookup(vid)[0]
    # mark readonly then run a full encode; job state lands on "done"
    vs_call(vs, "/admin/volume/readonly", {"volume": vid, "readonly": True})
    st, r = vs_call(vs, "/admin/ec/generate", {"volume": vid})
    assert st == 200 and r["shards"] == list(range(14))
    st, prog = vs_call(vs, f"/admin/ec/progress?volumeId={vid}")
    assert prog["state"] == "done"
    assert prog["bytes_done"] == prog["total"] > 0
    # cancel with no running job is a clean 404
    assert vs_call(vs, "/admin/ec/cancel", {"volume": vid})[0] == 404
    # the cancellation machinery end to end: the port's write_ec_files
    # on a copy of the volume, with a cancel that trips after one batch
    from seaweedfs_tpu_torch.storage.ec import ec_files
    d = cluster.port_dirs[cluster.port_urls.index(vs)]
    src = d / f"progress_{vid}.dat"
    work = cluster.tmp / "cancel"
    work.mkdir()
    (work / "1.dat").write_bytes(src.read_bytes())
    hits = []

    def cancel():
        hits.append(1)
        return len(hits) > 1

    with pytest.raises(ec_files.EncodeCancelled):
        ec_files.write_ec_files(str(work / "1"), large_block=1 << 30,
                                small_block=8192, batch_size=8192,
                                cancel=cancel, device="cpu")
    assert sorted(os.listdir(work)) == ["1.dat"]  # nothing left behind


# ---- twins of tests/test_pb.py -------------------------------------------

def test_cluster_heartbeats_ride_protobuf(cluster):
    """The default wire is protobuf: a registered port node's topology
    data round-trips the binary framing end to end."""
    topo = cluster.master.topo.to_dict()
    assert sorted(topo["nodes"]) == sorted(cluster.port_urls)
    from seaweedfs_tpu.stats import metrics as ref_metrics
    text = ref_metrics.REGISTRY.render()
    # the master decoded protobuf beats from the port's nodes
    assert "weedtpu_master_received_heartbeats_total" in text


def test_json_fallback_when_forced(tmp_path):
    c = PortCluster(tmp_path, n_port=1,
                    env={"WEEDTPU_WIRE": "json"}).start()
    try:
        assert c.master.topo.to_dict()["nodes"]
        client = WeedClient(c.master.url)
        fid = client.upload(b"over json beats")
        assert client.download(fid) == b"over json beats"
    finally:
        c.stop()


# ---- shard sets cross between the packages ------------------------------

def test_mixed_cluster_shards_cross(tmp_path, monkeypatch):
    """One reference and one port volume server.  A volume on each is
    encoded there, and its whole shard set is copied to the other server,
    mounted there and read through it (degraded too); the copies are
    byte-equal to the encoder's files."""
    monkeypatch.setenv("WEEDTPU_EC_CODEC", "numpy")  # the reference's
    c = PortCluster(tmp_path, n_port=1, n_ref=1).start()
    try:
        ref_vs = c.ref_servers[0]
        port_url = c.port_urls[0]
        client = WeedClient(c.master.url)
        rng = np.random.default_rng(5)
        for src, dst, vid in ((ref_vs.url, port_url, 101),
                              (port_url, ref_vs.url, 102)):
            assert vs_call(src, "/admin/assign_volume",
                           {"volume": vid})[0] == 200
            payloads = {}
            for i in range(24):
                data = rng.integers(0, 256, int(rng.integers(500, 40_000)),
                                    dtype=np.uint8).tobytes()
                key = vid * 1000 + i
                fid = f"{vid},{key:x}{0x1234abcd:08x}"
                req = urllib.request.Request(f"http://{src}/{fid}",
                                             data=data, method="PUT")
                with urllib.request.urlopen(req) as r:
                    assert r.status == 201
                payloads[fid] = data
            vs_call(src, "/admin/volume/readonly", {"volume": vid})
            st, r = vs_call(src, "/admin/ec/generate", {"volume": vid})
            assert st == 200, r
            assert vs_call(dst, "/admin/ec/copy",
                           {"volume": vid, "source": src,
                            "shards": list(range(14)),
                            "copy_ecx": True})[0] == 200
            st, r = vs_call(dst, "/admin/ec/mount", {"volume": vid})
            assert st == 200 and r["shards"] == list(range(14)), r
            src_dir = c.port_dirs[0] if src == port_url else c.tmp / "ref0"
            dst_dir = c.port_dirs[0] if dst == port_url else c.tmp / "ref0"
            for ext in [f".ec{i:02d}" for i in range(14)] + [".ecx", ".vif"]:
                assert (dst_dir / f"{vid}{ext}").read_bytes() == \
                    (src_dir / f"{vid}{ext}").read_bytes(), ext
            # every blob reads back through the copy's server, whole and
            # then with two data shards gone (reconstructed there)
            for fid, data in payloads.items():
                assert vs_call(dst, f"/{fid}") == (200, data)
            assert vs_call(dst, "/admin/ec/delete_shards",
                           {"volume": vid, "shards": [0, 1]})[0] == 200
            for fid, data in payloads.items():
                assert vs_call(dst, f"/{fid}") == (200, data), fid
    finally:
        c.stop()


# ---- the reference master's planes against the port's nodes ------------

def test_master_planes_reach_every_port_route(cluster):
    """The master's repair posts a `reduced` rebuild to a port node, which
    rebuilds the lost shard from its own survivors and the other node's
    partials (the decision ledger says `reduced`); its canary's degraded
    probe reads through a port node (200); its heat and perf fan-outs
    pull every port node's /heat and /perf, and the debug routes answer
    on loopback."""
    client = WeedClient(cluster.master.url)
    payloads = _fill_volume(client, n_blobs=12, seed=3, collection="planes")
    vid = int(next(iter(payloads)).partition(",")[0])
    env = CommandEnv(cluster.master.url)
    out = io.StringIO()
    run_command(env, "lock", out)
    run_command(env, f"ec.encode -volumeId {vid} -collection planes", out)
    run_command(env, "unlock", out)
    a, b = cluster.port_urls
    locs = env.ec_shard_locations(vid)
    lost = min(s for s, urls in locs.items() if a in urls)
    assert vs_call(a, "/admin/ec/delete_shards",
                   {"volume": vid, "shards": [lost]})[0] == 200
    assert lost not in env.ec_shard_locations(vid)
    st, body = vs_call(cluster.master.url, "/maintenance/tick",
                       {"wait": True})
    assert st == 200
    assert sorted(env.ec_shard_locations(vid)) == list(range(14))
    decisions = [d for d in cluster.master.maintenance.decisions
                 if d["vid"] == vid]
    assert [d["mode"] for d in decisions] == ["reduced"], decisions
    client._vid_cache.clear()
    for fid, data in payloads.items():
        assert client.download(fid) == data
    for url in cluster.port_urls:
        st, snap = vs_call(url, "/heat")
        assert st == 200 and "volume" in snap["dims"], (url, snap)
        st, perf = vs_call(url, "/perf")
        assert st == 200 and {"id", "jobs", "roofline"} <= set(perf)
        for path in ("/debug/traces", "/debug/requests",
                     "/debug/pipeline"):
            assert vs_call(url, path)[0] == 200, (url, path)
        st, text = vs_call(url, "/metrics")
        assert st == 200 and b"weedtpu_volume_request_total" in text
    holder = next(u for u in cluster.port_urls
                  if u in env.ec_shard_locations(vid)[0])
    st, probe = vs_call(holder, f"/admin/ec/probe_read?volume={vid}")
    assert st == 200 and probe["bytes"] > 0, probe
    for path in ("/cluster/metrics?refresh=1", "/cluster/status"):
        assert vs_call(cluster.master.url, path)[0] == 200, path
    st, fleet_heat = vs_call(cluster.master.url, "/cluster/heat?refresh=1")
    assert st == 200 and "node_errors" not in fleet_heat, fleet_heat
    assert set(cluster.port_urls) <= set(fleet_heat["nodes"])
    hot = {e["key"] for e in fleet_heat["volumes"]["top"]}
    assert str(vid) in hot, fleet_heat["volumes"]
    st, fleet_perf = vs_call(cluster.master.url, "/cluster/perf")
    assert st == 200 and "node_errors" not in fleet_perf, fleet_perf
    assert set(cluster.port_urls) <= set(fleet_perf["nodes"])
    st = cluster.submit(cluster.master.canary.run_once(("degraded",)))
    assert st["paths"]["degraded"]["outcome"] == "ok", st
    assert vs_call(cluster.master.url, "/cluster/canary")[0] == 200


def test_canary_degraded_probe_reconstructs(cluster):
    """Twin of tests/test_flight_recorder.py::test_canary_degraded_probe_
    reconstructs: the degraded canary path reaches a port node's
    /admin/ec/probe_read, a real needle read with one present shard
    withheld, and the node names the shard it withheld."""
    client = WeedClient(cluster.master.url)
    rng = np.random.default_rng(3)
    fids = [client.upload(rng.integers(0, 256, 40_000,
                                       dtype=np.uint8).tobytes(),
                          name=f"deg{i}.bin", collection="canary")
            for i in range(12)]
    vid = int(fids[0].partition(",")[0])
    time.sleep(0.7)
    env = CommandEnv(cluster.master.url)
    out = io.StringIO()
    run_command(env, "lock", out)
    run_command(env, f"ec.encode -volumeId {vid} -collection canary", out)
    run_command(env, "unlock", out)
    time.sleep(0.7)
    st = cluster.submit(cluster.master.canary.run_once(paths=("degraded",)))
    rec = st["paths"]["degraded"]
    assert rec["outcome"] == "ok", rec
    holder = next(u for u in cluster.port_urls
                  if u in env.ec_shard_locations(vid)[0])
    st, probe = vs_call(holder, f"/admin/ec/probe_read?volume={vid}")
    assert st == 200 and probe["bytes"] == 40_000
    assert probe["skipped_shard"] in range(14)


def test_partials_cross_packages(tmp_path, monkeypatch):
    """One reference and one port volume server: a reduced rebuild on
    each takes the other's partials through its /admin/ec/partial, and
    each rebuilt shard equals the encoder's."""
    monkeypatch.setenv("WEEDTPU_EC_CODEC", "numpy")  # the reference's
    c = PortCluster(tmp_path, n_port=1, n_ref=1).start()
    try:
        ref_vs = c.ref_servers[0]
        port_url = c.port_urls[0]
        rng = np.random.default_rng(8)
        for repairer, helper, vid in ((port_url, ref_vs.url, 201),
                                       (ref_vs.url, port_url, 202)):
            assert vs_call(repairer, "/admin/assign_volume",
                           {"volume": vid})[0] == 200
            for i in range(16):
                data = rng.integers(0, 256, int(rng.integers(500, 30_000)),
                                    dtype=np.uint8).tobytes()
                fid = f"{vid},{vid * 1000 + i:x}{0x1234abcd:08x}"
                req = urllib.request.Request(f"http://{repairer}/{fid}",
                                             data=data, method="PUT")
                with urllib.request.urlopen(req) as r:
                    assert r.status == 201
            vs_call(repairer, "/admin/volume/readonly", {"volume": vid})
            assert vs_call(repairer, "/admin/ec/generate",
                           {"volume": vid})[0] == 200
            held = [9, 10, 11, 12, 13]
            assert vs_call(helper, "/admin/ec/copy",
                           {"volume": vid, "source": repairer,
                            "shards": held, "copy_ecx": True})[0] == 200
            assert vs_call(helper, "/admin/ec/mount",
                           {"volume": vid})[0] == 200
            rdir = c.port_dirs[0] if repairer == port_url \
                else c.tmp / "ref0"
            want = (rdir / f"{vid}.ec02").read_bytes()
            assert vs_call(repairer, "/admin/ec/delete_shards",
                           {"volume": vid, "shards": held + [2]})[0] == 200
            st, r = vs_call(repairer, "/admin/ec/rebuild", {
                "volume": vid, "codec": "rs_10_4", "reduced": {
                    "lost": [2], "shard_size": len(want), "groups": [
                        {"node": helper, "shards": held, "locality": 1}]}})
            assert st == 200, r
            assert r["helper_bytes"] == {helper: len(want)}
            assert r["predicted"]["per_node"] == {helper: len(want)}
            assert (rdir / f"{vid}.ec02").read_bytes() == want, repairer
    finally:
        c.stop()


# ---- the CLI ------------------------------------------------------------

GET_WITHOUT_JAX = r"""
import json, socket, sys, threading, time, urllib.request
from seaweedfs_tpu_torch.__main__ import main
d, port = sys.argv[1], int(sys.argv[2])
with socket.socket() as s:  # a master that is not there
    s.bind(("127.0.0.1", 0))
    dead = s.getsockname()[1]
threading.Thread(target=main, daemon=True, args=(
    ["volume", "-dir", d, "-port", str(port), "-mserver",
     f"127.0.0.1:{dead}", "-device", "cpu"],)).start()
url = f"http://127.0.0.1:{port}"
for _ in range(600):
    try:
        urllib.request.urlopen(url + "/status", timeout=1).close()
        break
    except OSError:
        time.sleep(0.05)
def call(path, data=None, method="POST", ctype="application/json"):
    req = urllib.request.Request(url + path, data=data, method=method,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.read()
call("/admin/assign_volume", json.dumps({"volume": 7}).encode())
call("/7,01637037d6", b"served without jax", "PUT", "application/x-test")
body = call("/7,01637037d6", method="GET")
print(json.dumps({"body": body.decode(), "jax": "jax" in sys.modules,
                  "reference": [m for m in sys.modules
                                if m.split(".")[0] == "seaweedfs_tpu"]}))
sys.stdout.flush()
"""


def test_volume_cli_serves_a_get_without_jax(tmp_path):
    r = subprocess.run(
        [sys.executable, "-c", GET_WITHOUT_JAX, str(tmp_path),
         str(free_port())], cwd=str(REPO), env=child_env(),
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got == {"body": "served without jax", "jax": False,
                   "reference": []}


def test_volume_cli_without_device_needs_the_card(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is there")
    cmd = port_volume_cmd(tmp_path, "127.0.0.1:1", free_port())
    cmd = cmd[:-2]  # no -device: the card
    r = subprocess.run(cmd, cwd=str(REPO), env=child_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr


def test_volume_cli_profile_flags(tmp_path):
    """`-cpuprofile FILE` and `--torch-profile DIR`: the node serves, and
    on SIGTERM it writes a cProfile dump and a torch.profiler Chrome
    trace, and exits 128 + SIGTERM."""
    import pstats
    import signal
    port = free_port()
    prof = tmp_path / "cpu.prof"
    tdir = tmp_path / "trace"
    cmd = port_volume_cmd(tmp_path / "d", "127.0.0.1:1", port) + [
        "-cpuprofile", str(prof), "--torch-profile", str(tdir)]
    with open(tmp_path / "log", "wb") as log:
        p = subprocess.Popen(cmd, cwd=str(REPO), env=child_env(),
                             stdout=log, stderr=subprocess.STDOUT)
    try:
        url = f"127.0.0.1:{port}"

        def up():
            try:
                return vs_call(url, "/status")[0] == 200
            except OSError:
                return False
        wait_for(up, timeout=90, what="the node")
        assert vs_call(url, "/admin/assign_volume", {"volume": 3})[0] == 200
    finally:
        p.send_signal(signal.SIGTERM)
        try:
            p.wait(timeout=60)
        except subprocess.TimeoutExpired:
            p.kill()  # outlived its SIGTERM: fails below, leaks nothing
            p.wait(timeout=10)
    assert p.returncode == 128 + signal.SIGTERM, \
        (tmp_path / "log").read_text()[-3000:]
    stats = pstats.Stats(str(prof))
    assert any("handle_assign_volume" in fn for _, _, fn in stats.stats)
    traces = list(tdir.glob("torch_trace.*.json"))
    assert len(traces) == 1
    assert "traceEvents" in json.loads(traces[0].read_text())


SIGNAL_IN_A_WEAKREF_CALLBACK = r"""
import sys, weakref
grace = __import__(sys.argv[1] + ".utils.grace", fromlist=["grace"])
ran = []
grace.on_interrupt(lambda: ran.append(1))
class A:
    pass
a = A()
# a signal handler runs between any two bytecodes: here, inside a weakref
# callback, where the interpreter ignores what the callback raises
r = weakref.ref(a, lambda _: grace._run_hooks(15))
del a
print("survived", ran, flush=True)
"""


@pytest.mark.parametrize("pkg,rc,out", [
    ("seaweedfs_tpu", 0, "survived [1]"), ("seaweedfs_tpu_torch", 143, "")])
def test_signal_exit_is_not_swallowed_unlike_the_reference(pkg, rc, out):
    """ROADMAP fault 3.8: the reference's shutdown handler exits by
    raising SystemExit, which a weakref callback swallows, so a SIGTERM
    can run the hooks and leave the server running; the port's handler
    ends the process after its hooks."""
    r = subprocess.run([sys.executable, "-c", SIGNAL_IN_A_WEAKREF_CALLBACK,
                        pkg], cwd=str(REPO),
                       env=child_env(JAX_PLATFORMS="cpu"),
                       capture_output=True, text=True, timeout=120)
    assert (r.returncode, r.stdout.strip()) == (rc, out), r.stderr[-2000:]


# ---- twins of tests/test_cluster.py and tests/test_cluster_obs.py -------

def test_concurrent_write_read_delete_hammer(cluster):
    """Twin of tests/test_cluster.py::
    test_concurrent_write_read_delete_hammer on port nodes."""
    import concurrent.futures
    import secrets
    client = WeedClient(cluster.master.url)
    big = secrets.token_bytes(512 * 1024)
    big_fid = client.upload(big, name="big.bin", collection="hammer")
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
        return client.upload(data, name=f"h{i}.bin",
                             collection="hammer"), data

    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        for f, data in ex.map(write_one, range(60)):
            blobs[f] = data

    def read_one(item):
        f, data = item
        assert client.download(f) == data
        return True

    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        futs = [ex.submit(read_one, it) for it in blobs.items()]
        futs += [ex.submit(paged_read, i) for i in range(30)]
        for fu in futs:
            assert fu.result()
    fids = list(blobs)
    doomed = set(fids[::3])
    kept = [f for i, f in enumerate(fids) if i % 3]

    def delete_one(f):
        client.delete(f)
        return True

    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        futs = [ex.submit(delete_one, f) for f in doomed]
        futs += [ex.submit(read_one, (f, blobs[f])) for f in kept]
        for fu in futs:
            assert fu.result()
    for f in doomed:
        with pytest.raises(RuntimeError):
            client.download(f)


def test_streamed_vid_map_invalidation(tmp_path):
    """Twin of tests/test_cluster.py::test_streamed_vid_map_invalidation:
    a client on the master's /cluster/stream feed reroutes around a dead
    port node as soon as the master expires it."""
    c = PortCluster(tmp_path, n_port=2).start()
    try:
        c.master.node_timeout = 1.5
        client = WeedClient(c.master.url, stream_updates=True)
        poll_client = WeedClient(c.master.url)
        a = client.assign(replication="001")
        f = a["fid"]
        vid = int(f.split(",")[0])
        client.upload_to(a["url"], f, b"replicated-payload",
                         jwt=a.get("auth", ""))
        wait_for(lambda: len(client._vid_cache.get(vid, ([], 0))[0]) == 2,
                 what="both replicas in the streamed map")
        urls = client._vid_cache[vid][0]
        assert sorted(poll_client.lookup(vid)) == sorted(urls)
        dead = urls[0]
        p = c.procs[c.port_urls.index(dead)]
        p.terminate()
        p.wait(timeout=10)
        wait_for(lambda: (client._vid_cache.get(vid, ([], 0))[0] and dead
                          not in client._vid_cache[vid][0]),
                 what="the dead node dropped")
        assert client.download(f) == b"replicated-payload"
        assert dead in poll_client._vid_cache.get(vid, ([], 0))[0]
        client.close()
    finally:
        c.stop()


def test_debug_traces_and_pprof_under_load(cluster):
    """Twin of the debug-route checks of tests/test_observability.py::
    test_trace_propagation_degraded_filer_read and of tests/
    test_cluster_obs.py::test_cluster_metrics_federation_and_pprof_under_load
    on port nodes: a forced-sample degraded GET leaves one trace whose
    spans are on both nodes' /debug/traces (the reading node's request,
    plan and shard fetches; the peer's /admin/ec/shard_read), and
    /debug/pprof?seconds=N on a node under degraded reads shows the EC
    read engine's frames."""
    from seaweedfs_tpu.stats import trace as ref_trace
    client = WeedClient(cluster.master.url)
    payloads = _fill_volume(client, n_blobs=16, seed=9, collection="obs")
    vid = int(next(iter(payloads)).partition(",")[0])
    env = CommandEnv(cluster.master.url)
    out = io.StringIO()
    run_command(env, "lock", out)
    run_command(env, f"ec.encode -volumeId {vid} -collection obs", out)
    run_command(env, "unlock", out)
    a, b = cluster.port_urls
    for url in (a, b):
        vs_call(url, "/admin/ec/delete_shards", {"volume": vid,
                                                 "shards": [0, 1]})
    fids = list(payloads)
    tid = ref_trace._new_trace_id()
    req = urllib.request.Request(
        f"http://{a}/{fids[0]}", headers={
            "X-Weedtpu-Trace": f"{tid}-{ref_trace._new_span_id()}-1"})
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.read() == payloads[fids[0]]

    def spans(url):
        st, body = vs_call(url, f"/debug/traces?tid={tid}&pin=1")
        assert st == 200
        return [s for t in body["traces"] for s in t["spans"]]
    wait_for(lambda: any(s["name"] == "volume.request" for s in spans(a)),
             what="the root span")
    names = {s["name"] for s in spans(a)}
    assert {"volume.request", "ec.plan", "ec.reconstruct_batch",
            "volume.shard_fetch"} <= names, names
    assert any(s["name"] == "volume.request" and
               s.get("attrs", {}).get("path") == "/admin/ec/shard_read"
               for s in spans(b))
    st, body = vs_call(a, "/debug/traces?min_ms=1e12")
    assert st == 200 and body["traces"] == []
    st, body = vs_call(a, "/debug/requests")
    assert any(e["path"].startswith("/debug/requests")
               for e in body["requests"])
    stop = threading.Event()

    def hammer():
        i = 0
        while not stop.is_set():
            f = fids[i % len(fids)]
            vs_call(a, "/" + f)
            i += 1

    threads = [threading.Thread(target=hammer, daemon=True)
               for _ in range(4)]
    for t in threads:
        t.start()
    try:
        st, prof = vs_call(a, "/debug/pprof?seconds=1.5&hz=147")
    finally:
        stop.set()
        for t in threads:
            t.join(10)
    lines = [line for line in prof.decode().splitlines() if line.strip()]
    assert st == 200 and lines
    assert any("ec_volume." in line for line in lines), prof[:2000]
    for line in lines[:10]:
        stack, _, count = line.rpartition(" ")
        assert count.isdigit() and stack, line
