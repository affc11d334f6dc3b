"""The port's network faults held against the reference's
(seaweedfs_tpu/maintenance/faults.py) and driven through its clients and
its volume server.

Unit tests are twins of tests/test_chaos.py's: the registry, the hooks
and the parser of each package on the same directives (each package's
registry is its own, so the reference's tests in the same process are not
touched; every test that arms a fault clears it in a `finally`).  Client
tests put `PooledHTTP` and the servers' aiohttp sessions behind an armed
fault.  In-process tests run two port servers behind the reference master
(tests/test_torch_volume_server.py's `Harness`) and partition one from
the other through `/admin/faults`: degraded reads reconstruct, byte-equal,
and the partial fetcher reports its helper dead.  The cluster test is the
twin of tests/test_chaos.py::test_hedged_reads_cut_degraded_p99 over port
volume servers in subprocesses, the slow peer made by `peer_latency`.
"""

import asyncio
import errno
import subprocess
import threading
import time

import numpy as np
import pytest

from seaweedfs_tpu.maintenance import faults as ref_faults
from seaweedfs_tpu.shell.commands import CommandEnv

from seaweedfs_tpu_torch.maintenance import faults
from seaweedfs_tpu_torch.ops import regen
from seaweedfs_tpu_torch.utils import http, resilience

from tests.test_torch_cluster import (PortCluster, port_volume_cmd,
                                      vs_call, wait_for)
from tests.test_torch_volume_server import harness  # noqa: F401
from tests.test_torch_volume_server import put_blobs

SNAP_KEYS = ("partitions", "latency_ms", "wan_latency_ms", "error_rate",
             "shard_write_error")


@pytest.fixture(autouse=True)
def _clear_net():
    yield
    faults.clear_net()
    ref_faults.clear_net()
    resilience.reset_breakers()


# ---- twins of tests/test_chaos.py's unit tests ---------------------------

def test_partition_and_error_rate_hooks():
    faults.register_node("127.0.0.1:1234", "volume")
    faults.add_partition("filer", "volume")
    try:
        with pytest.raises(ConnectionRefusedError):
            faults.check_dial("filer", "127.0.0.1:1234")
        # symmetric: the volume side cannot dial the filer role either
        with pytest.raises(ConnectionRefusedError):
            faults.check_dial("volume", "filer")
        faults.check_dial("client", "127.0.0.1:1234")  # unaffected
    finally:
        faults.clear_net()
    faults.check_dial("filer", "127.0.0.1:1234")  # cleared
    faults.set_peer_error_rate("127.0.0.1:9", 100.0)
    try:
        with pytest.raises(ConnectionResetError):
            faults.maybe_inject_error("127.0.0.1:9")
    finally:
        faults.clear_net()
    faults.set_peer_latency("slowpeer", 40.0)
    try:
        assert 0.03 <= faults.dial_latency_s("slowpeer") <= 0.05
        assert faults.dial_latency_s("otherpeer") == 0.0
    finally:
        faults.clear_net()


def test_shard_write_error_fault(tmp_path):
    faults.set_shard_write_error("ENOSPC")
    try:
        with pytest.raises(OSError) as ei:
            faults.check_shard_write(str(tmp_path / "1"))
        assert ei.value.errno == errno.ENOSPC
    finally:
        faults.clear_net()
    faults.check_shard_write(str(tmp_path / "1"))  # disarmed


def test_parse_env_net_directives():
    spec = ("partition:filer:volume;peer_latency:vs1:50:10;"
            "peer_error:vs1:25;shard_write_error:EIO;clear_net;"
            "unpartition:filer:volume;region_partition:eu:us;"
            "region_unpartition:eu:us;wan_latency:eu:us:80:5")
    parsed = faults.parse_env(spec)
    assert parsed == ref_faults.parse_env(spec)
    assert [p["action"] for p in parsed][:5] == [
        "partition", "peer_latency", "peer_error", "shard_write_error",
        "clear_net"]


@pytest.mark.parametrize("spec", [
    "partition:volume:127.0.0.1:9",
    "partition:filer:volume;unpartition:volume:filer",
    "region_partition:eu:us;peer_latency:volume:30:5",
    "wan_latency:us:eu:80:5;wan_latency:eu:us:0",
    "peer_error:vs1:250;peer_error:vs2:25;peer_error:vs2:0",
    "shard_write_error:ENOSPC;shard_write_error:off;partition:*:x",
    "peer_latency:vs1:50;clear_net;peer_latency:vs2:10"])
def test_apply_net_equals_reference(spec):
    """The same directives applied in turn through each package's
    `apply` leave equal registries and answer alike."""
    for f in faults.parse_env(spec):
        got = faults.apply(None, f)
        assert got == ref_faults.apply(None, f)
        assert got["ok"] is True
    snap, ref = faults.net_snapshot(), ref_faults.net_snapshot()
    assert {k: snap[k] for k in SNAP_KEYS} == {k: ref[k] for k in SNAP_KEYS}
    assert faults.NET_ACTIVE == ref_faults.NET_ACTIVE


def test_region_faults_cross_the_boundary_only():
    faults.register_region("10.0.0.1:80", "eu")
    faults.register_region("10.0.0.2:80", "eu")
    faults.register_region("10.0.1.1:80", "us")
    faults.set_wan_latency("eu", "us", 30.0)
    ids = ("filer", "region:eu")
    assert 0.029 < faults.wan_latency_s(ids, "10.0.1.1:80") < 0.031
    assert faults.wan_latency_s(ids, "10.0.0.2:80") == 0.0
    faults.add_partition("region:eu", "region:us")
    with pytest.raises(ConnectionRefusedError):
        faults.check_net(ids, "10.0.1.1:80")
    faults.check_net(ids, "10.0.0.2:80")


# ---- the clients ---------------------------------------------------------

class _Echo:
    """A loopback server answering every request `ok`, counting them."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        owner = self
        self.hits = 0

        class H(BaseHTTPRequestHandler):
            def do_GET(self):
                owner.hits += 1
                self.send_response(200)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"ok")

            def log_message(self, *a):
                pass

        self.srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.netloc = f"127.0.0.1:{self.srv.server_address[1]}"
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()


def test_pooled_http_dials_through_the_faults():
    """A partition refuses the dial before a byte is sent, an error rate
    of 100 % resets it, a latency delays it; `clear_net` restores it."""
    echo = _Echo()
    pool = http.PooledHTTP(timeout=5.0, role="client")
    url = f"http://{echo.netloc}/x"
    try:
        faults.register_node(echo.netloc, "volume")
        faults.add_partition("client", "volume")
        with pytest.raises(ConnectionRefusedError):
            pool.request(url)
        faults.clear_net()
        faults.set_peer_error_rate(echo.netloc, 100.0)
        with pytest.raises(ConnectionResetError):
            pool.request(url)
        faults.clear_net()
        assert echo.hits == 0
        faults.set_peer_latency("volume", 120.0)
        t0 = time.perf_counter()
        assert pool.request(url)[2] == b"ok"
        assert time.perf_counter() - t0 >= 0.12
        faults.clear_net()
        assert pool.request(url)[2] == b"ok" and echo.hits == 2
    finally:
        pool.close()
        echo.close()


def test_aiohttp_session_dials_through_the_faults():
    import aiohttp
    echo = _Echo()

    async def go():
        async with aiohttp.ClientSession(
                trace_configs=[http.aiohttp_trace_config("volume")]) as s:
            faults.add_partition("volume", echo.netloc)
            with pytest.raises(aiohttp.ClientConnectionError,
                               match="partition"):
                async with s.get(f"http://{echo.netloc}/x"):
                    pass
            faults.clear_net()
            faults.set_peer_latency(echo.netloc, 100.0)
            t0 = time.perf_counter()
            async with s.get(f"http://{echo.netloc}/x") as r:
                assert await r.read() == b"ok"
            return time.perf_counter() - t0

    try:
        assert asyncio.run(go()) >= 0.1
        assert echo.hits == 1
    finally:
        echo.close()


# ---- the volume server ---------------------------------------------------

def test_env_plan_arms_net_faults_at_start(harness, monkeypatch):
    """WEEDTPU_FAULTS' network directives are applied at start, and the
    server registers its role; a malformed one raises before the bind
    (tests/test_torch_maintenance.py)."""
    monkeypatch.setenv("WEEDTPU_FAULTS",
                       "partition:volume:peerx;peer_error:x:30")
    h = harness(master=False)
    snap = faults.net_snapshot()
    assert snap["partitions"] == [["volume", "peerx"]]
    assert snap["error_rate"] == {"x": 30.0}
    assert snap["nodes"][h.vs[0].url] == "volume"


def _split(h, vid, b_shards):
    """Volume `vid` encoded on server 0, shards `b_shards` moved to
    server 1, every server's map current."""
    a, b = h.vs
    h.json(0, "/admin/volume/readonly", {"volume": vid})
    h.json(0, "/admin/ec/generate", {"volume": vid})
    assert h.json(1, "/admin/ec/copy",
                  {"volume": vid, "source": a.url, "shards": b_shards,
                   "copy_ecx": True})[0] == 200
    h.json(1, "/admin/ec/mount", {"volume": vid})
    h.json(0, "/admin/ec/delete_shards", {"volume": vid,
                                          "shards": b_shards})
    h.json(0, "/admin/ec/mount", {"volume": vid})
    h.json(0, "/admin/volume/delete", {"volume": vid})


def test_partitioned_peer_reads_reconstruct(harness, monkeypatch):
    """A holds shards 4-13, B 0-3 (chip_smoke's phase-15 layout).  With
    the volume role partitioned from B through A's /admin/faults, every
    GET from A reconstructs what lives on B: one batch per needle on
    shards 0-3, no remote shard read, each payload byte-equal; the
    partial fetcher reports B dead.  After `clear_net` A reads B's shards
    again."""
    monkeypatch.setenv("WEEDTPU_HEDGE_PCT", "0")
    h = harness(n=2)
    a, b = h.vs
    h.json(0, "/admin/assign_volume", {"volume": 41})
    blobs = put_blobs(h, 0, 41, 24, seed=41, lo=20_000, hi=90_000)
    _split(h, 41, [0, 1, 2, 3])
    ev = a.store.get_ec_volume(41)
    from seaweedfs_tpu_torch.storage import types as t
    from seaweedfs_tpu_torch.storage.ec import layout

    def on_b(f):
        nid = t.FileId.parse(f).key
        off, size = ev.find_needle(nid)
        ivs = layout.locate_data(ev.large_block, ev.small_block,
                                 ev.dat_size, off,
                                 t.actual_size(size, ev.version))
        return any(iv.to_shard_id_and_offset(ev.large_block,
                                             ev.small_block)[0] < 4
                   for iv in ivs)

    touching = [f for f in blobs if on_b(f)]
    assert touching
    st, out = h.json(0, "/admin/faults", {"faults": [
        {"action": "partition", "a": "volume", "b": b.url}]})
    assert st == 200 and out["applied"][0]["ok"] is True
    s0 = ev.read_stats_snapshot()
    for f, data in blobs.items():
        assert h.call(0, "/" + f)[2] == data, f
    grew = {k: v - s0[k] for k, v in ev.read_stats_snapshot().items()}
    assert grew["reconstruct_batches"] == len(touching), grew
    assert grew["remote_shard_reads"] == 0, grew
    fetch = a._partial_fetcher(41)
    with pytest.raises(regen.HelperDied) as ei:
        fetch(regen.HelperGroup(node=b.url, shards=(0,)), [0],
              np.ones((1, 1), np.uint8), 0, 64)
    assert ei.value.node == b.url
    h.json(0, "/admin/faults", {"faults": [{"action": "clear_net"}]})
    assert not faults.NET_ACTIVE
    resilience.reset_breakers()
    ev._recon_cache.clear()
    s0 = ev.read_stats_snapshot()
    for f, data in blobs.items():
        assert h.call(0, "/" + f)[2] == data, f
    grew = {k: v - s0[k] for k, v in ev.read_stats_snapshot().items()}
    assert grew["remote_shard_reads"] > 0 and \
        grew["reconstruct_batches"] == 0, grew


def test_peer_error_opens_the_breaker_reads_stay_equal(harness,
                                                       monkeypatch):
    """`peer_error` at 100 % toward B: A's fetches of B's shards fail,
    B's breaker opens after WEEDTPU_BREAKER_THRESHOLD of them, and every
    read still returns its payload, reconstructed."""
    monkeypatch.setenv("WEEDTPU_HEDGE_PCT", "0")
    h = harness(n=2)
    a, b = h.vs
    h.json(0, "/admin/assign_volume", {"volume": 42})
    blobs = put_blobs(h, 0, 42, 16, seed=42, lo=20_000, hi=90_000)
    _split(h, 42, [0, 1, 2, 3])
    resilience.reset_breakers()
    h.json(0, "/admin/faults", {"faults": [
        {"action": "peer_error", "dst": b.url, "pct": 100}]})
    for f, data in blobs.items():
        assert h.call(0, "/" + f)[2] == data, f
    br = resilience.breaker_for(b.url)
    assert not br.allow() or br.failures >= 5, br.failures
    st = a.store.get_ec_volume(42).read_stats_snapshot()
    assert st["remote_shard_reads"] == 0 and st["reconstruct_batches"] > 0


# ---- twin of tests/test_chaos.py::test_hedged_reads_cut_degraded_p99 ----

def test_hedged_reads_cut_degraded_p99(tmp_path):
    """With one slow shard peer (`peer_latency` 350 ms toward it, armed
    through /admin/faults), hedged reads reconstruct from the local
    survivors after the hedge delay: degraded-read p99 drops >= 1.2x
    against hedging off.  The hedge knobs are read by the port node's
    process, so the node is started once with hedging off and once
    with it on, over the same files."""
    from seaweedfs_tpu.client import WeedClient
    c = PortCluster(tmp_path, n_port=2,
                    env={"WEEDTPU_HEDGE_PCT": "0"}).start()
    try:
        client = WeedClient(c.master.url)
        rng = np.random.default_rng(7)
        blobs = {}
        for _ in range(24):
            data = rng.integers(0, 256, 50_000, dtype=np.uint8).tobytes()
            blobs[client.upload(data)] = data
        vid = int(next(iter(blobs)).partition(",")[0])
        env = CommandEnv(c.master.url)
        vs0 = env.volume_locations(vid)[0]
        i0 = c.port_urls.index(vs0)
        vs1 = c.port_urls[1 - i0]

        def post(url, path, body):
            st, out = vs_call(url, path, body)
            assert st == 200, (path, out)

        post(vs0, "/admin/ec/generate", {"volume": vid})
        post(vs0, "/admin/ec/mount", {"volume": vid})
        post(vs1, "/admin/ec/copy", {"volume": vid, "source": vs0,
                                     "shards": [0, 1]})
        post(vs1, "/admin/ec/mount", {"volume": vid})
        post(vs0, "/admin/ec/delete_shards", {"volume": vid,
                                              "shards": [0, 1]})
        post(vs0, "/admin/volume/unmount", {"volume": vid})
        wait_for(lambda: sorted(env.ec_shard_locations(vid)) ==
                 list(range(14)), what="the shard beats")

        def p99_of_reads() -> float:
            post(vs0, "/admin/faults", {"faults": [
                {"action": "peer_latency", "dst": vs1, "ms": 350}]})
            lat = []
            for f, want in blobs.items():
                t0 = time.monotonic()
                st, got = vs_call(vs0, "/" + f)
                lat.append(time.monotonic() - t0)
                assert st == 200 and got == want, f
            s = sorted(lat)
            return s[min(len(s) - 1, int(0.99 * len(s)))]

        p_off = p99_of_reads()
        # the same node again, hedging on (a fresh process: an empty
        # reconstruction LRU)
        proc = c.procs[i0]
        proc.terminate()
        proc.wait(timeout=10)
        port = int(vs0.rpartition(":")[2])
        with open(tmp_path / f"port{i0}.again.log", "wb") as log:
            c.procs[i0] = subprocess.Popen(
                port_volume_cmd(c.port_dirs[i0], c.master.url, port),
                cwd=str(c.env["PYTHONPATH"]),
                env=dict(c.env, WEEDTPU_HEDGE_PCT="99",
                         WEEDTPU_HEDGE_MAX_MS="100"),
                stdout=log, stderr=subprocess.STDOUT)

        def up():
            try:
                return vs_call(vs0, "/status")[0] == 200
            except OSError:
                return False
        wait_for(up, timeout=60, what="the restarted node")
        # the boot mounts the .dat the first arm unmounted
        post(vs0, "/admin/volume/unmount", {"volume": vid})
        p_on = p99_of_reads()
        ratio = p_off / max(p_on, 1e-6)
        assert ratio >= 1.2, \
            f"hedge p99 {p_on * 1000:.0f}ms vs no-hedge " \
            f"{p_off * 1000:.0f}ms (ratio {ratio:.2f} < 1.2)"
        st, text = vs_call(vs0, "/metrics")
        fired = [float(line.split()[-1]) for line in text.decode()
                 .splitlines()
                 if line.startswith('weedtpu_hedge_total{outcome="fired"}')]
        assert fired and fired[0] > 0, "hedge never fired"
    finally:
        c.stop()
