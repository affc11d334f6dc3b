"""Chaos harness: mixed workloads under compound failures, provably.

The pieces met one at a time in single-scenario tests — faults.py
injection, the scrub/repair loop, tracing, SLO burn rates, the
resilience layer — but nothing proved the cluster survives *mixed
workloads under compound failures*.  This module is what
``tests/test_torch_chaos.py`` and ``chip_smoke.py``'s phase 30 run:

- :class:`ChaosCluster` — an in-process cluster (master(s) + volume
  servers + optional filer/s3/MQ brokers on one background asyncio
  loop) whose servers can be killed and restarted mid-flight on the
  same ports and directories, and whose raft leader can be failed over;
- :data:`WORKLOADS` — s3 multipart, filer streaming, degraded blob
  reads, MQ produce/consume; each writes real data, remembers digests,
  and verifies byte-identical readback through its own gateway path;
- :data:`FAULTS` — shard loss, bit rot (healed through scrub → repair),
  slow peer (hedged reads carry the day), node restart mid-repair,
  network partition, master failover;
- :func:`run_scenario` — prepare → EC-encode the data volumes → inject
  the fault (and drive the heal machinery it requires) → verify every
  byte → assert ``volume.fsck -json`` reports ``ok``.

Every scenario ends in the same two assertions — fsck-clean state and
byte-identical reads — because that is the only definition of
"survived" that matters.

Counterpart of `seaweedfs_tpu/maintenance/chaos.py`, whole.  Every
server it starts is the port's: its master, volume servers, filer, S3
gateway and brokers, driven through the port's client, shell, `faults`,
`resilience` and `netflow`.  `ChaosCluster` and `GeoCluster` take
`device=None`, which means the card, and raise without one;
`device="cpu"` runs the volume servers on the plain versions of the
kernels.  The module loads no torch at import; its servers load it.
"""

from __future__ import annotations

import asyncio
import hashlib
import io
import json
import re
import socket
import threading
import time
import os
import urllib.error
import urllib.parse
import urllib.request

from seaweedfs_tpu_torch.maintenance import faults
from seaweedfs_tpu_torch.storage.ec import layout as _eclayout

__all__ = ["ChaosCluster", "GeoCluster", "WORKLOADS", "FAULTS", "MATRIX",
           "run_scenario", "fsck_report", "encode_all_volumes"]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _req(url: str, method: str = "GET", data: bytes | None = None,
         headers: dict | None = None, timeout: float = 30.0):
    """-> (status, body, headers) without raising on HTTP errors."""
    r = urllib.request.Request(url, data=data, method=method,
                               headers=headers or {})
    try:
        with urllib.request.urlopen(r, timeout=timeout) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _clear_process_state() -> None:
    """Drop what a cluster leaves in the process: the fault plan, the
    breakers, the retry budget and the latency trackers are module
    globals that every later cluster in the process would inherit."""
    from seaweedfs_tpu_torch.utils import resilience
    faults.clear_net()
    resilience.reset_breakers()
    resilience.reset_retry_budget()
    resilience.reset_latency_trackers()


class ChaosCluster:
    """Master(s) + N volume servers (+ filer, s3, MQ brokers) on one
    asyncio loop in a daemon thread, with mid-flight restart support:
    every server can be stopped and a replacement started on the SAME
    port and directories, which is what "the node came back" means."""

    def __init__(self, tmp_path, n_volume_servers: int = 2,
                 n_masters: int = 1, with_filer: bool = True,
                 with_s3: bool = False, with_mq: bool = False,
                 replication: str = "000",
                 volume_size_limit: int = 64 * 1024 * 1024,
                 heartbeat_interval: float = 0.3,
                 racks: list[str] | None = None, device=None):
        from seaweedfs_tpu_torch.ops.gf_cuda import resolve_device
        # every volume server, restarts included, runs on this device
        self.device = resolve_device(device)
        self.tmp = tmp_path
        self.n = n_volume_servers
        # rack label per volume server (None = all on the default rack):
        # the rack-scoped chaos cells and the locality-aware repair
        # planner key off these
        self.racks = racks
        self.n_masters = n_masters
        self.with_filer = with_filer
        self.with_s3 = with_s3
        self.with_mq = with_mq
        self.replication = replication
        self.volume_size_limit = volume_size_limit
        self.heartbeat_interval = heartbeat_interval
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.masters: list = []
        self.volume_servers: list = []
        self.vs_ports: list[int] = []
        self.filer = None
        self.s3 = None
        self.brokers: list = []

    # -- lifecycle -------------------------------------------------------

    def submit(self, coro, timeout: float = 120.0):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    @property
    def master_urls(self) -> str:
        return ",".join(m.url for m in self.masters if m is not None)

    def leader(self):
        live = [m for m in self.masters if m is not None]
        leaders = [m for m in live if m.is_leader]
        return leaders[0] if leaders else live[0]

    def start(self) -> "ChaosCluster":
        from seaweedfs_tpu_torch.server.master import MasterServer
        from seaweedfs_tpu_torch.server.volume_server import VolumeServer
        self.thread.start()
        if self.n_masters > 1:
            ports = [free_port() for _ in range(self.n_masters)]
            peers = [f"127.0.0.1:{p}" for p in ports]
            self.masters = [
                MasterServer("127.0.0.1", p, peers=peers,
                             volume_size_limit=self.volume_size_limit,
                             default_replication=self.replication,
                             raft_state_dir=str(self.tmp / "raft"))
                for p in ports]
            for m in self.masters:
                self.submit(m.start())
            self._wait_leader()
        else:
            m = MasterServer("127.0.0.1", free_port(),
                             volume_size_limit=self.volume_size_limit,
                             default_replication=self.replication)
            self.masters = [m]
            self.submit(m.start())
        for i in range(self.n):
            d = self.tmp / f"vs{i}"
            d.mkdir(exist_ok=True)
            self.vs_ports.append(free_port())
            self.volume_servers.append(None)
            self._start_volume_server(i)
        if self.with_filer:
            from seaweedfs_tpu_torch.server.filer_server import FilerServer
            self.filer = FilerServer(
                self.leader().url, port=free_port(),
                data_dir=str(self.tmp / "filer"))
            self.submit(self.filer.start())
        if self.with_s3:
            from seaweedfs_tpu_torch.s3.s3api_server import S3ApiServer
            self.s3 = S3ApiServer(self.filer.url, port=free_port(),
                                  master_url=self.leader().url)
            self.submit(self.s3.start())
        if self.with_mq:
            from seaweedfs_tpu_torch.mq.broker import BrokerServer
            self.brokers = [BrokerServer(self.leader().url,
                                         port=free_port(),
                                         filer_url=self.filer.url,
                                         peer_refresh=0.5)
                            for _ in range(2)]
            for b in self.brokers:
                self.submit(b.start())
            time.sleep(1.0)  # brokers discover each other
        return self

    def stop(self) -> None:
        for b in self.brokers:
            try:
                self.submit(b.stop())
            except Exception:
                pass
        for srv in (self.s3, self.filer):
            if srv is not None:
                try:
                    self.submit(srv.stop())
                except Exception:
                    pass
        for vs in self.volume_servers:
            if vs is not None:
                try:
                    self.submit(vs.stop())
                except Exception:
                    pass
        for m in self.masters:
            if m is not None:
                try:
                    self.submit(m.stop())
                except Exception:
                    pass
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(5)
        _clear_process_state()

    def _wait_leader(self, timeout: float = 20.0):
        deadline = time.time() + timeout
        while time.time() < deadline:
            live = [m for m in self.masters if m is not None]
            leaders = [m for m in live if m.is_leader]
            if len(leaders) == 1:
                return leaders[0]
            time.sleep(0.05)
        raise TimeoutError("no single raft leader elected")

    def wait_heartbeats(self, timeout: float = 10.0) -> None:
        deadline = time.time() + timeout
        want = sum(1 for vs in self.volume_servers if vs is not None)
        while time.time() < deadline:
            if len(self.leader().topo.nodes) >= want:
                return
            time.sleep(0.05)
        raise TimeoutError("volume servers did not register")

    # -- process faults --------------------------------------------------

    def _start_volume_server(self, i: int) -> None:
        from seaweedfs_tpu_torch.server.volume_server import VolumeServer
        rack = self.racks[i] if self.racks else ""
        vs = VolumeServer([str(self.tmp / f"vs{i}")], self.master_urls,
                          "127.0.0.1", self.vs_ports[i], max_volumes=20,
                          heartbeat_interval=self.heartbeat_interval,
                          rack=rack, device=self.device)
        self.submit(vs.start())
        self.volume_servers[i] = vs

    def stop_volume_server(self, i: int) -> None:
        vs = self.volume_servers[i]
        if vs is not None:
            self.submit(vs.stop())
            self.volume_servers[i] = None

    def restart_volume_server(self, i: int, downtime: float = 0.0) -> None:
        """Kill volume server `i` mid-flight and boot a replacement on
        the same port and directories after `downtime` seconds."""
        self.stop_volume_server(i)
        if downtime > 0:
            time.sleep(downtime)
        # the port may linger in TIME_WAIT for a beat after the runner
        # closes; retry the bind briefly rather than flaking
        deadline = time.time() + 10.0
        while True:
            try:
                self._start_volume_server(i)
                break
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(0.2)
        # the node is demonstrably back: close its (process-global)
        # circuit breaker instead of waiting out the half-open cooldown
        from seaweedfs_tpu_torch.utils import resilience
        resilience.breaker_for(self.volume_servers[i].url).record(True)

    def fail_over_master(self) -> None:
        """Kill the raft leader; wait for a follower to take over; point
        the in-process gateways (filer/s3/brokers hold one static master
        URL, as a statically-configured deployment would until its
        config management catches up) at the new leader."""
        assert self.n_masters > 1, "failover needs a raft master group"
        old = self.leader()
        idx = self.masters.index(old)
        self.submit(old.stop())
        self.masters[idx] = None
        new = self._wait_leader()
        for srv in [self.filer, self.s3] + self.brokers:
            if srv is not None:
                srv.master_url = new.url
        # volume servers rotate on their own via the heartbeat loop's
        # master-list fallback; give them a beat to find the new leader
        self.wait_heartbeats(timeout=15.0)
        # the gateways re-register on their own cadence; the new
        # leader's member registry starts empty, and shell helpers
        # (find_filer) need it populated
        if self.filer is not None:
            deadline = time.time() + 20.0
            while time.time() < deadline:
                if new.cluster_members.get("filer"):
                    break
                time.sleep(0.2)

    # -- helpers ---------------------------------------------------------

    def client(self):
        from seaweedfs_tpu_torch.client import WeedClient
        return WeedClient(self.master_urls)

    def shell_env(self):
        from seaweedfs_tpu_torch.shell.commands import CommandEnv
        return CommandEnv(self.leader().url)

    def drive_repair(self, wait: bool = True, timeout: float = 120.0):
        """One deterministic repair-planner tick on the leader."""
        body = json.dumps({"wait": wait}).encode()
        st, out, _ = _req(
            f"http://{self.leader().url}/maintenance/tick",
            method="POST", data=body,
            headers={"Content-Type": "application/json"},
            timeout=timeout)
        assert st == 200, out
        return json.loads(out)

    def scrub_all(self) -> None:
        """One scrub pass on every live volume server (reports verdicts
        to the master's ledger).  Remote-shard verification is forced on
        for the pass: chaos clusters spread shards across nodes, and a
        local-only syndrome scan would skip every window."""
        import os
        prev = os.environ.get("WEEDTPU_SCRUB_REMOTE")
        os.environ["WEEDTPU_SCRUB_REMOTE"] = "1"
        try:
            for vs in self.volume_servers:
                if vs is None:
                    continue
                st, out, _ = _req(
                    f"http://{vs.url}/admin/scrub", method="POST",
                    data=b"{}",
                    headers={"Content-Type": "application/json"},
                    timeout=120.0)
                assert st == 200, out
        finally:
            if prev is None:
                os.environ.pop("WEEDTPU_SCRUB_REMOTE", None)
            else:
                os.environ["WEEDTPU_SCRUB_REMOTE"] = prev


class GeoCluster:
    """Two independent regions — each a full master + volume server +
    filer cluster — linked by a bidirectional FilerSync, all on one
    asyncio loop in a daemon thread.  The geo-observatory test/chaos
    harness: every node carries its region tag (trace spans, fault
    identities), the masters are cross-registered as ``peer_master`` so
    /cluster/trace federates across the WAN, and region-scoped faults
    (:func:`partition`, :func:`wan_latency`) cut or slow exactly the
    cross-region links while intra-region traffic runs clean."""

    def __init__(self, tmp_path, region_a: str = "a", region_b: str = "b",
                 sync_prefix: str = "/",
                 volume_size_limit: int = 64 * 1024 * 1024,
                 heartbeat_interval: float = 0.3, device=None):
        from seaweedfs_tpu_torch.ops.gf_cuda import resolve_device
        self.device = resolve_device(device)
        self.tmp = tmp_path
        self.region_names = (region_a, region_b)
        self.sync_prefix = sync_prefix
        self.volume_size_limit = volume_size_limit
        self.heartbeat_interval = heartbeat_interval
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        # region name -> {"master": ..., "vs": ..., "filer": ...}
        self.regions: dict[str, dict] = {}
        self.sync = None

    def submit(self, coro, timeout: float = 120.0):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    def master(self, region: str):
        return self.regions[region]["master"]

    def filer(self, region: str):
        return self.regions[region]["filer"]

    def start(self) -> "GeoCluster":
        from seaweedfs_tpu_torch.server.filer_server import FilerServer
        from seaweedfs_tpu_torch.server.master import MasterServer
        from seaweedfs_tpu_torch.server.volume_server import VolumeServer
        self.thread.start()
        for name in self.region_names:
            master = MasterServer(
                "127.0.0.1", free_port(),
                volume_size_limit=self.volume_size_limit, region=name)
            self.submit(master.start())
            d = self.tmp / f"geo_{name}_vs"
            d.mkdir(exist_ok=True)
            vs = VolumeServer([str(d)], master.url, "127.0.0.1",
                              free_port(), max_volumes=20,
                              heartbeat_interval=self.heartbeat_interval,
                              device=self.device)
            self.submit(vs.start())
            # the VS has no region ctor knob; tag it for fault matching
            faults.register_region(vs.url, name)
            filer = FilerServer(master.url, port=free_port(),
                                data_dir=str(self.tmp / f"geo_{name}_f"),
                                region=name)
            self.submit(filer.start())
            self.regions[name] = {"master": master, "vs": vs,
                                  "filer": filer}
        # cross-register the masters so trace federation can hop regions
        a, b = self.region_names
        for me, other in ((a, b), (b, a)):
            st, out, _ = _req(
                f"http://{self.master(other).url}/cluster/register",
                method="POST",
                data=json.dumps({"type": "peer_master",
                                 "address": self.master(me).url}).encode(),
                headers={"Content-Type": "application/json"})
            assert st == 200, out
        from seaweedfs_tpu_torch.replication.filer_sync import FilerSync
        self.sync = FilerSync(
            self.filer(a).url, self.filer(b).url, prefix=self.sync_prefix,
            offset_path=str(self.tmp / "geo_offsets.json"),
            region_a=a, region_b=b)
        self.sync.start()
        return self

    def stop(self) -> None:
        if self.sync is not None:
            try:
                self.sync.stop()
            except Exception:
                pass
        for reg in self.regions.values():
            for key in ("filer", "vs", "master"):
                try:
                    self.submit(reg[key].stop())
                except Exception:
                    pass
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(5)
        _clear_process_state()

    # -- WAN faults ------------------------------------------------------

    def partition(self) -> None:
        """Cut every cross-region link (both directions)."""
        a, b = self.region_names
        faults.add_partition(f"region:{a}", f"region:{b}")
        faults.add_partition(f"region:{b}", f"region:{a}")

    def heal(self) -> None:
        a, b = self.region_names
        faults.remove_partition(f"region:{a}", f"region:{b}")
        # the WAN is demonstrably back: close the (process-global)
        # breakers on every node instead of waiting out half-open
        from seaweedfs_tpu_torch.utils import resilience
        for reg in self.regions.values():
            for key in ("filer", "vs", "master"):
                resilience.breaker_for(reg[key].url).record(True)

    def wan_latency(self, ms: float, jitter_ms: float = 0.0) -> None:
        """Charge every boundary-crossing dial `ms` (±jitter) extra."""
        a, b = self.region_names
        faults.set_wan_latency(a, b, ms, jitter_ms)

    # -- data helpers ----------------------------------------------------

    def write(self, region: str, path: str, data: bytes) -> None:
        st, out, _ = _req(f"http://{self.filer(region).url}{path}",
                          method="PUT", data=data)
        assert st in (200, 201), (region, path, out)

    def read(self, region: str, path: str) -> tuple[int, bytes]:
        st, body, _ = _req(f"http://{self.filer(region).url}{path}")
        return st, body

    def digests(self, prefix: str | None = None) -> tuple[str, str]:
        """(digest_a, digest_b) straight off the filers' meta endpoint."""
        out = []
        for name in self.region_names:
            st, body, _ = _req(
                f"http://{self.filer(name).url}/__meta__/digest?"
                + urllib.parse.urlencode(
                    {"prefix": prefix or self.sync_prefix}))
            assert st == 200, body
            out.append(json.loads(body)["digest"])
        return tuple(out)


def encode_all_volumes(c: ChaosCluster) -> list[int]:
    """EC-encode every data volume through the shell (lock, encode,
    unlock) so shard/scrub/repair faults apply to the workload's bytes
    — collection-scoped volumes (s3 buckets) included.  Returns the
    encoded vids."""
    from seaweedfs_tpu_torch.shell.commands import run_command
    with c.leader().topo._lock:
        vols = sorted({(vid, v.collection)
                       for node in c.leader().topo.nodes.values()
                       for vid, v in node.volumes.items()})
    env = c.shell_env()
    out = io.StringIO()
    run_command(env, "lock", out)
    try:
        for vid, collection in vols:
            cmd = f"ec.encode -volumeId {vid}"
            if collection:
                cmd += f" -collection {collection}"
            run_command(env, cmd, out)
    finally:
        run_command(env, "unlock", out)
    time.sleep(2 * c.heartbeat_interval + 0.2)  # shard heartbeats land
    return [vid for vid, _ in vols]


def hedge_ratio_arms(c: ChaosCluster, blobs: dict, vid: int,
                     delay_s: float = 0.35) -> tuple[float, float]:
    """Deterministic slow-peer hedging measurement.

    Topology: all 14 shards of `vid` generated on node 0, then shards
    0+1 moved to node 1 (which answers shard reads `delay_s` late) and
    the normal volume unmounted — every GET against node 0 is a
    degraded read whose missing interval lives behind the slow peer,
    while 12 local survivors make reconstruction cheap.  Returns
    (p99_hedge_off_s, p99_hedge_on_s): without hedging each read waits
    out the slow peer; with it, reconstruction wins after the hedge
    delay.  `blobs` maps fid -> expected bytes (every read is
    byte-verified)."""
    import os
    vs0, vs1 = c.volume_servers[0], c.volume_servers[1]
    hdrs = {"Content-Type": "application/json"}

    def post(url, path, body, timeout=300.0):
        st, out, _ = _req(f"http://{url}{path}", method="POST",
                          data=json.dumps(body).encode(), headers=hdrs,
                          timeout=timeout)
        assert st == 200, (path, out)

    post(vs0.url, "/admin/ec/generate", {"volume": vid})
    post(vs0.url, "/admin/ec/mount", {"volume": vid})
    post(vs1.url, "/admin/ec/copy", {"volume": vid, "source": vs0.url,
                                     "shards": [0, 1]})
    post(vs1.url, "/admin/ec/mount", {"volume": vid})
    post(vs0.url, "/admin/ec/delete_shards", {"volume": vid,
                                              "shards": [0, 1]})
    post(vs0.url, "/admin/volume/unmount", {"volume": vid})
    time.sleep(2 * c.heartbeat_interval + 0.2)
    vs1._fault_delay_shard_read = delay_s

    def p99(samples):
        s = sorted(samples)
        return s[min(len(s) - 1, int(0.99 * len(s)))]

    def measure() -> float:
        # flush the reconstruction LRU so the previous arm's decodes
        # can't serve this one
        ev = vs0.store.get_ec_volume(vid)
        with ev._recon_lock:
            ev._recon_cache.clear()
            ev._recon_cache_bytes = 0
        lat = []
        for fid, want in blobs.items():
            t0 = time.monotonic()
            st, got, _ = _req(f"http://{vs0.url}/{fid}", timeout=60.0)
            lat.append(time.monotonic() - t0)
            assert st == 200 and got == want, fid
        return p99(lat)

    saved = {k: os.environ.get(k)
             for k in ("WEEDTPU_HEDGE_PCT", "WEEDTPU_HEDGE_MAX_MS")}
    try:
        os.environ["WEEDTPU_HEDGE_PCT"] = "0"
        p_off = measure()
        os.environ["WEEDTPU_HEDGE_PCT"] = "99"
        os.environ["WEEDTPU_HEDGE_MAX_MS"] = "100"
        p_on = measure()
    finally:
        vs1._fault_delay_shard_read = 0.0
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return p_off, p_on


def fsck_report(c: ChaosCluster) -> dict:
    """volume.fsck -json via the shell; returns the parsed report."""
    from seaweedfs_tpu_torch.shell.commands import run_command
    env = c.shell_env()
    out = io.StringIO()
    run_command(env, "lock", out)
    out = io.StringIO()
    try:
        rc = run_command(env, "volume.fsck -json", out)
    finally:
        run_command(env, "unlock", io.StringIO())
    rep = json.loads(out.getvalue())
    rep["rc"] = rc
    return rep


# -- workloads -----------------------------------------------------------
#
# Each workload is (prepare, verify): prepare writes real data through
# its gateway path and returns opaque state with content digests;
# verify reads everything back through the same path and asserts
# byte-identity.  Workloads keep payloads small (hundreds of KB) so a
# 24-cell matrix stays runnable, but always span multiple blocks /
# chunks / parts so the interesting code paths engage.

def _digest(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def _wl_blob_prepare(c: ChaosCluster) -> dict:
    import numpy as np
    client = c.client()
    rng = np.random.default_rng(0xC0FFEE)
    blobs = {}
    for i in range(40):
        data = rng.integers(0, 256, int(rng.integers(2_000, 60_000)),
                            dtype=np.uint8).tobytes()
        fid = client.upload(data, name=f"chaos{i}.bin")
        blobs[fid] = _digest(data)
    return {"blobs": blobs}


def _wl_blob_verify(c: ChaosCluster, state: dict) -> None:
    client = c.client()
    for fid, want in state["blobs"].items():
        got = client.download(fid)
        assert _digest(got) == want, f"blob {fid} bytes changed"


def _wl_filer_prepare(c: ChaosCluster) -> dict:
    import numpy as np
    rng = np.random.default_rng(0xF11E)
    files = {}
    for i in range(3):
        data = rng.integers(0, 256, 600_000 + i * 100_000,
                            dtype=np.uint8).tobytes()
        st, out, _ = _req(f"http://{c.filer.url}/chaos/f{i}.bin",
                          method="PUT", data=data)
        assert st in (200, 201), out
        files[f"/chaos/f{i}.bin"] = data
    return {"files": files}


def _wl_filer_verify(c: ChaosCluster, state: dict) -> None:
    for path, want in state["files"].items():
        st, body, _ = _req(f"http://{c.filer.url}{path}")
        assert st == 200, f"filer GET {path}: HTTP {st}"
        assert body == want, f"filer {path} bytes changed"
        # a mid-file range must slice out of the same bytes (streamed
        # range reads exercise the chunk-fetch path differently)
        st, part, _ = _req(f"http://{c.filer.url}{path}",
                           headers={"Range": "bytes=100000-100999"})
        assert st == 206 and part == want[100000:101000], \
            f"filer {path} range bytes changed"


def _wl_s3_prepare(c: ChaosCluster) -> dict:
    import numpy as np
    rng = np.random.default_rng(0x53)
    base = f"http://{c.s3.url}"
    st, out, _ = _req(f"{base}/chaos-bucket", method="PUT")
    assert st in (200, 409), out
    # multipart upload: two parts crossing the chunk boundary
    st, body, _ = _req(f"{base}/chaos-bucket/big.bin?uploads",
                       method="POST")
    assert st == 200, body
    m = re.search(rb"<UploadId>([^<]+)</UploadId>", body)
    assert m, body
    upload_id = m.group(1).decode()
    parts = [rng.integers(0, 256, 400_000, dtype=np.uint8).tobytes(),
             rng.integers(0, 256, 300_000, dtype=np.uint8).tobytes()]
    etags = []
    for n, part in enumerate(parts, start=1):
        st, out, hdrs = _req(
            f"{base}/chaos-bucket/big.bin?partNumber={n}"
            f"&uploadId={urllib.parse.quote(upload_id)}",
            method="PUT", data=part)
        assert st == 200, out
        etags.append(hdrs.get("ETag", ""))
    complete = "".join(
        f"<Part><PartNumber>{n}</PartNumber><ETag>{e}</ETag></Part>"
        for n, e in enumerate(etags, start=1))
    st, out, _ = _req(
        f"{base}/chaos-bucket/big.bin"
        f"?uploadId={urllib.parse.quote(upload_id)}",
        method="POST",
        data=f"<CompleteMultipartUpload>{complete}"
             "</CompleteMultipartUpload>".encode())
    assert st == 200, out
    whole = b"".join(parts)
    return {"key": "/chaos-bucket/big.bin", "content": whole}


def _wl_s3_verify(c: ChaosCluster, state: dict) -> None:
    base = f"http://{c.s3.url}"
    st, body, _ = _req(f"{base}{state['key']}")
    assert st == 200, f"s3 GET: HTTP {st}"
    assert body == state["content"], "s3 object bytes changed"
    # range across the part boundary
    lo = 399_995
    st, part, _ = _req(f"{base}{state['key']}",
                       headers={"Range": f"bytes={lo}-{lo + 9}"})
    assert st == 206 and part == state["content"][lo:lo + 10], \
        "s3 range bytes changed"


def _wl_mq_prepare(c: ChaosCluster) -> dict:
    from seaweedfs_tpu_torch.mq.client import MQClient
    client = MQClient([b.url for b in c.brokers])
    client.configure("chaos.events", partition_count=2)
    sent = []
    for i in range(30):
        payload = f"chaos-payload-{i:04d}".encode() * 20
        client.publish("chaos.events", payload, key=f"k{i}".encode())
        sent.append(payload)
    # drain RAM tails to filer-backed segments so the messages live on
    # the storage the faults attack
    for b in c.brokers:
        st, out, _ = _req(f"http://{b.url}/flush", method="POST",
                          data=b"{}")
        assert st == 200, out
    return {"sent": sorted(_digest(p) for p in sent)}


def _wl_mq_verify(c: ChaosCluster, state: dict) -> None:
    from seaweedfs_tpu_torch.mq.client import MQClient
    client = MQClient([b.url for b in c.brokers])
    client.refresh()
    got = []
    for pi in range(2):
        offset = 0
        while True:
            msgs, nxt = client.fetch("chaos.events", pi, offset)
            if not msgs:
                break
            # fetch returns decoded str values for text payloads
            got.extend(m["value"].encode()
                       if isinstance(m["value"], str) else m["value"]
                       for m in msgs)
            offset = nxt
    assert sorted(_digest(v) for v in got) == state["sent"], \
        f"MQ lost/changed messages ({len(got)} read)"


WORKLOADS = {
    "s3_multipart": (_wl_s3_prepare, _wl_s3_verify),
    "filer_stream": (_wl_filer_prepare, _wl_filer_verify),
    "degraded_read": (_wl_blob_prepare, _wl_blob_verify),
    "mq": (_wl_mq_prepare, _wl_mq_verify),
}


# -- faults --------------------------------------------------------------
#
# Each fault takes the running cluster, injects its failure against the
# (now EC-encoded) data volumes, drives whatever heal machinery the
# failure requires, and returns with the cluster in the state verify()
# must survive.  "Survive" sometimes means "heal completed" (bit rot,
# shard loss) and sometimes "degraded but correct" (slow peer,
# partition) — both end fsck-clean.

def _ec_vids_on(vs) -> list[int]:
    return sorted({vid for loc in vs.store.locations
                   for vid in loc.ec_volumes})


def heal_until_clean(c: ChaosCluster, timeout: float = 120.0) -> None:
    """Drive repair-planner ticks until every volume's ledger state is
    healthy (repairs are token-bucketed, so one tick may not cover all
    damaged volumes)."""
    deadline = time.monotonic() + timeout
    led = {}
    while time.monotonic() < deadline:
        c.drive_repair(wait=True)
        led = c.leader().maintenance.ledger()
        if led and all(i["state"] == "healthy" for i in led.values()):
            return
        time.sleep(0.5)
    states = {str(v): i["state"] for v, i in led.items()
              if i["state"] != "healthy"}
    raise AssertionError(f"cluster did not heal in {timeout}s: {states}")


def _fault_shard_loss(c: ChaosCluster, ctx: dict) -> None:
    """Delete two shards of every EC volume on one node, then repair."""
    vs = c.volume_servers[0]
    for vid in _ec_vids_on(vs):
        ev = vs.store.get_ec_volume(vid)
        drop = ev.shard_ids()[:2]
        for sid in drop:
            faults.delete_shard(vs.store, vid, sid)
    c.submit(vs._heartbeat_once())
    time.sleep(2 * c.heartbeat_interval)
    heal_until_clean(c)


def _fault_bit_rot(c: ChaosCluster, ctx: dict) -> None:
    """Flip one bit in one shard per EC volume; scrub localizes it,
    repair purges + rebuilds — the full silent-corruption heal path."""
    vs = c.volume_servers[0]
    for vid in _ec_vids_on(vs):
        ev = vs.store.get_ec_volume(vid)
        sid = ev.shard_ids()[0]
        faults.flip_bit(vs.store, vid, sid, offset=4096)
    c.scrub_all()
    heal_until_clean(c)
    # the rebuild remounted shards; re-scrub to confirm clean + refresh
    # the ledger verdicts
    c.scrub_all()


def _fault_slow_peer(c: ChaosCluster, ctx: dict) -> None:
    """One node serves shard reads 400ms late while shards are missing
    locally on its peer — degraded reads must stay correct (and the
    hedged-read path keeps them fast; timing asserted in bench/tests).
    The delay is lifted afterwards; nothing to heal."""
    slow = c.volume_servers[1]
    victim = c.volume_servers[0]
    for vid in _ec_vids_on(victim):
        ev = victim.store.get_ec_volume(vid)
        for sid in ev.shard_ids()[:2]:
            faults.delete_shard(victim.store, vid, sid)
    c.submit(victim._heartbeat_once())
    slow._fault_delay_shard_read = 0.4
    ctx["undo"] = lambda: setattr(slow, "_fault_delay_shard_read", 0.0)
    ctx["verify_during_fault"] = True


def _fault_restart_mid_repair(c: ChaosCluster, ctx: dict) -> None:
    """Lose shards on node 0, start the repair, and bounce node 1 while
    the repair is in flight; repair must converge once it returns."""
    vs = c.volume_servers[0]
    for vid in _ec_vids_on(vs):
        ev = vs.store.get_ec_volume(vid)
        for sid in ev.shard_ids()[:2]:
            faults.delete_shard(vs.store, vid, sid)
    c.submit(vs._heartbeat_once())
    time.sleep(2 * c.heartbeat_interval)
    c.drive_repair(wait=False)  # launch, don't wait
    c.restart_volume_server(1, downtime=0.3)
    # let the in-flight repairs finish; some failed against the
    # restarting node and went to backoff — further ticks pick them up
    heal_until_clean(c, timeout=90.0)


def repair_recv_bytes() -> float:
    """Process-wide class=repair received bytes (stats/netflow): the
    fleet-scale repair-traffic number the reduced-read path minimizes."""
    from seaweedfs_tpu_torch.stats import netflow
    return netflow.class_total("recv", "repair")


def shards_on_rack(c: ChaosCluster, vid: int, rack: str) -> list[tuple]:
    """(server, shard_id) pairs of `vid`'s shards living on `rack`."""
    out = []
    for i, vs in enumerate(c.volume_servers):
        if vs is None or (c.racks[i] if c.racks else "") != rack:
            continue
        ev = vs.store.get_ec_volume(vid)
        if ev is not None:
            out.extend((vs, sid) for sid in ev.shard_ids())
    return out


def _fault_rack_loss(c: ChaosCluster, ctx: dict) -> None:
    """Correlated rack-scoped loss: two shards of every EC volume die
    TOGETHER on one rack (the mass-restart / rack-power shape of the
    1309.0186 study), then the planner heals.  On a rack-labeled
    cluster the survivor selection must route repair pulls same-rack
    first and keep cross-rack bytes inside the budget; on a label-less
    cluster this degrades to correlated two-shard loss."""
    victim_rack = (c.racks[-1] if c.racks else "")
    vids = sorted({vid for vs in c.volume_servers if vs is not None
                   for vid in _ec_vids_on(vs)})
    for vid in vids:
        for svr, sid in shards_on_rack(c, vid, victim_rack)[:2]:
            faults.delete_shard(svr.store, vid, sid)
    for vs in c.volume_servers:
        if vs is not None:
            c.submit(vs._heartbeat_once())
    time.sleep(2 * c.heartbeat_interval)
    heal_until_clean(c)


def _fault_helper_death_mid_rebuild(c: ChaosCluster, ctx: dict) -> None:
    """Lose shards on node 0, launch the repair, and kill the node most
    likely serving partial-sum fetches while the rebuild is in flight.
    The reduced path must re-plan around the dead helper (or back off
    and converge on a later tick), and no partial `.ecXX.tmp` may
    survive anywhere."""
    vs = c.volume_servers[0]
    for vid in _ec_vids_on(vs):
        ev = vs.store.get_ec_volume(vid)
        for sid in ev.shard_ids()[:2]:
            faults.delete_shard(vs.store, vid, sid)
    c.submit(vs._heartbeat_once())
    time.sleep(2 * c.heartbeat_interval)
    c.drive_repair(wait=False)  # launch, don't wait
    c.restart_volume_server(1, downtime=0.4)
    heal_until_clean(c, timeout=90.0)
    # a helper death mid-transfer must never leave a partial shard
    leftovers = [str(p) for i in range(c.n)
                 for p in (c.tmp / f"vs{i}").glob("*.ec??.tmp")]
    assert not leftovers, f"partial shards left behind: {leftovers}"


def _fault_convert_mid_failure(c: ChaosCluster, ctx: dict) -> None:
    """Kill a volume server mid-fleet-conversion: the scheduler's node
    call dies, its volumes are RE-QUEUED (never dropped), and once the
    node returns the conversion converges.  Clean-abort contract: the
    tmp+rename commit means a killed conversion can never leave a
    partial `.ecXX` set visible — after convergence every converted
    volume has all 14 shards, and run_scenario's byte-identical
    readback + fsck close the loop."""
    import asyncio as _aio
    vs = c.volume_servers[0]
    vids = sorted({vid for loc in vs.store.locations
                   for vid in loc.volumes})
    assert vids, "workload left no plain volumes to convert"
    for vid in vids:
        v = vs.store.get_volume(vid)
        if v is not None:
            v.nm.flush()
    leader = c.leader()
    sched = leader.convert
    sched.enqueue(vids)
    # fire the paced tick and kill the node while the batch is in flight
    fut = _aio.run_coroutine_threadsafe(sched.tick(), c.loop)
    c.restart_volume_server(0, downtime=0.5)
    try:
        fut.result(120)
    except Exception:
        pass  # the tick itself survives; failures land in the history
    st = sched.status()
    requeued = set(st["queued"]) | {int(v) for v in st["backoffs"]}
    converted_early = sched.converted
    if not converted_early:
        # the kill landed mid-conversion: every volume must be re-queued
        assert requeued.issuperset(vids), (requeued, vids)
    c.wait_heartbeats()
    # node is back: expire the backoffs and tick until the queue drains
    deadline = time.monotonic() + 90.0
    while time.monotonic() < deadline:
        sched._backoff = {v: (f, 0.0)
                          for v, (f, _) in sched._backoff.items()}
        _aio.run_coroutine_threadsafe(sched.tick(), c.loop).result(120)
        if not sched.queued and not sched.active:
            break
        time.sleep(0.3)
    assert not sched.queued, sched.status()
    vs = c.volume_servers[0]  # the restarted instance
    for vid in vids:
        v = vs.store.get_volume(vid)
        assert v is not None, vid
        shards = [i for i in range(_eclayout.TOTAL_SHARDS)
                  if os.path.exists(v._base + _eclayout.to_ext(i))]
        # all-or-nothing: a partial committed set would mean the
        # tmp+rename contract broke
        assert len(shards) == _eclayout.TOTAL_SHARDS, \
            f"volume {vid}: partial/absent shard set {shards}"
    time.sleep(2 * c.heartbeat_interval + 0.2)  # shard heartbeats land


def _fault_move_mid_failure(c: ChaosCluster, ctx: dict) -> None:
    """Kill the TARGET volume server mid-/admin/volume/move: the move
    must abort cleanly — 500 to the caller, no partial or staged state
    mounted on either side, the source thawed back to writable and
    still serving every byte — and the restarted target must boot with
    NO orphan files (its DiskLocation cleanup deletes crash leftovers).
    A re-run of the same move must then succeed: the abort left a
    re-runnable state, which is the whole contract."""
    import glob as _glob
    import threading as _threading
    src = c.volume_servers[0]
    dst = c.volume_servers[1]
    vids = sorted({vid for loc in src.store.locations
                   for vid in loc.volumes})
    assert vids, "workload left no plain volumes on node 0"
    vid = vids[0]
    body = json.dumps({"volume": vid, "target": dst.url}).encode()
    # stall the source's peer file pulls so the target is reliably
    # mid-transfer when it dies
    src._fault_delay_file_pull = 0.6
    result: dict = {}

    def mover():
        try:
            result["status"], result["body"], _ = _req(
                f"http://{src.url}/admin/volume/move", method="POST",
                data=body, headers={"Content-Type": "application/json"},
                timeout=120)
        except OSError as e:  # the source itself must not die
            result["error"] = str(e)

    t = _threading.Thread(target=mover, daemon=True)
    t.start()
    time.sleep(0.3)  # the target is now inside the staged pull
    c.restart_volume_server(1, downtime=0.5)
    t.join(120)
    src._fault_delay_file_pull = 0.0
    assert result.get("status") == 500, result  # clean abort, reported
    v = src.store.get_volume(vid)
    assert v is not None and not v.read_only  # source thawed + serving
    dst = c.volume_servers[1]  # the restarted instance
    assert dst.store.get_volume(vid) is None  # no half-copy mounted
    for vs in (src, dst):
        leftovers = [p for loc in vs.store.locations
                     for pat in ("*.cpd", "*.cpx", "*.staging",
                                 "*.cptail")
                     for p in _glob.glob(os.path.join(loc.directory,
                                                      pat))]
        assert not leftovers, f"orphan files after abort: {leftovers}"
    c.wait_heartbeats()
    # abort left a re-runnable state: the same move now completes
    status, out, _ = _req(
        f"http://{src.url}/admin/volume/move", method="POST",
        data=body, headers={"Content-Type": "application/json"},
        timeout=120)
    assert status == 200, out
    assert src.store.get_volume(vid) is None
    assert dst.store.get_volume(vid) is not None
    time.sleep(2 * c.heartbeat_interval + 0.2)  # topology settles


def _fault_partition(c: ChaosCluster, ctx: dict) -> None:
    """Partition every GATEWAY (client/shell/filer — and thereby s3 and
    MQ, which read through the filer) from node 1: reads must fail over
    to node 0, which reconstructs node 1's shards over the still-intact
    volume↔volume links.  Lifted before the final fsck (a partition
    heals; data never changed)."""
    target = c.volume_servers[1].url
    for src in ("client", "shell", "filer"):
        faults.add_partition(src, target)
    ctx["undo"] = lambda: faults.clear_net()
    ctx["verify_during_fault"] = True


def _fault_master_failover(c: ChaosCluster, ctx: dict) -> None:
    """Kill the raft leader; the cluster re-elects and serves on."""
    c.fail_over_master()


def _fault_noisy_neighbor(c: ChaosCluster, ctx: dict) -> None:
    """One abusive tenant hammers the s3 edge open-loop while a victim
    tenant keeps reading its object: per-tenant QoS admission must shed
    the abuser with 429s AND keep the victim error-free inside its
    latency bound — one tenant's abuse degrades into its own rejects,
    never into another tenant's SLO (429s are 4xx, so they cannot flip
    the 5xx-based availability SLO either).  The workload's own verify
    runs during the noise too (verify_during_fault), proving the
    scenario tenant is a second un-harmed victim.  Clusters without an
    s3 gateway get a temporary one for the fault's duration."""
    s3 = c.s3
    started = False
    if s3 is None:
        from seaweedfs_tpu_torch.s3.s3api_server import S3ApiServer
        s3 = S3ApiServer(c.filer.url, port=free_port(),
                         master_url=c.leader().url)
        c.submit(s3.start())
        started = True
    prev = (s3.qos.total_rate, s3.qos.burst_s, dict(s3.qos.weights))
    # weighted admission: the victim (and the scenario workload's
    # bucket) carry heat-earned weight, the abuser rides the default —
    # unauthenticated tenants resolve to their bucket name
    s3.qos.configure(rate=200.0, burst_s=1.0,
                     weights={"victim-bucket": 4.0, "chaos-bucket": 4.0,
                              "default": 1.0})
    base = f"http://{s3.url}"
    for bucket in ("victim-bucket", "noisy-bucket"):
        st, out, _ = _req(f"{base}/{bucket}", method="PUT")
        assert st in (200, 409), out
    payload = os.urandom(64 * 1024)
    st, out, _ = _req(f"{base}/victim-bucket/slo.bin", method="PUT",
                      data=payload)
    assert st == 200, out
    st, out, _ = _req(f"{base}/noisy-bucket/spam.bin", method="PUT",
                      data=b"x" * 1024)
    assert st == 200, out

    stop = threading.Event()

    def hammer():
        while not stop.is_set():
            try:
                _req(f"{base}/noisy-bucket/spam.bin", timeout=5)
            except OSError:
                pass

    threads = [threading.Thread(target=hammer, daemon=True)
               for _ in range(6)]
    for t in threads:
        t.start()

    def undo():
        stop.set()
        for t in threads:
            t.join(10)
        s3.qos.configure(rate=prev[0], burst_s=prev[1], weights=prev[2])
        if started:
            c.submit(s3.stop())

    ctx["undo"] = undo
    ctx["verify_during_fault"] = True

    # the edge is throttling the abuser: its shed count must be GROWING
    time.sleep(1.0)
    shed0 = s3.qos.shed_by_tenant.get("noisy-bucket", 0)
    time.sleep(1.5)
    abuser_shed = s3.qos.shed_by_tenant.get("noisy-bucket", 0)
    assert abuser_shed > shed0 and abuser_shed > 10, \
        f"abuser not throttled at the edge: shed {shed0}->{abuser_shed}"
    # the victim's SLO class under the noise: every read succeeds,
    # paced inside its admitted share, p99 bounded
    lat = []
    for _ in range(40):
        t0 = time.monotonic()
        st, body, _ = _req(f"{base}/victim-bucket/slo.bin", timeout=10)
        lat.append(time.monotonic() - t0)
        assert st == 200, f"victim read failed: HTTP {st}"
        assert body == payload, "victim bytes changed under noise"
        time.sleep(0.03)
    lat.sort()
    p99 = lat[min(len(lat) - 1, int(0.99 * len(lat)))]
    assert p99 < 2.0, f"victim p99 {p99:.3f}s out of SLO under noise"
    assert s3.qos.shed_by_tenant.get("victim-bucket", 0) == 0, \
        "victim tenant was shed — admission is not isolating tenants"


# faults that must see PLAIN volumes (their own conversion, or a
# volume move — both operate on .dat volumes): run_scenario must not
# pre-encode the workload's volumes for these
SELF_ENCODING_FAULTS = frozenset({"convert_mid_failure",
                                  "move_mid_failure"})

FAULTS = {
    "shard_loss": _fault_shard_loss,
    "convert_mid_failure": _fault_convert_mid_failure,
    "move_mid_failure": _fault_move_mid_failure,
    "bit_rot": _fault_bit_rot,
    "slow_peer": _fault_slow_peer,
    "restart_mid_repair": _fault_restart_mid_repair,
    "partition": _fault_partition,
    "master_failover": _fault_master_failover,
    "rack_loss": _fault_rack_loss,
    "helper_death_mid_rebuild": _fault_helper_death_mid_rebuild,
    "noisy_neighbor": _fault_noisy_neighbor,
}

MATRIX = [(w, f) for w in WORKLOADS for f in FAULTS]


def run_scenario(c: ChaosCluster, workload: str, fault: str,
                 encode: bool = True, before_fault=None) -> dict:
    """One matrix cell: prepare the workload, EC-encode its volumes,
    inject the fault (driving any heal it needs), verify byte-identical
    readback, and assert fsck-clean end state.  Returns a small report
    with timings.  `before_fault(c)`, when given, runs after the
    pre-fault verify and before the fault, where a caller records the
    state the heal must restore (chip_smoke.py takes every shard file's
    sha256 there)."""
    prepare, verify = WORKLOADS[workload]
    t0 = time.monotonic()
    state = prepare(c)
    if encode and fault not in SELF_ENCODING_FAULTS:
        encode_all_volumes(c)
    verify(c, state)  # the pre-fault baseline must hold before we break it
    if before_fault is not None:
        before_fault(c)
    ctx: dict = {}
    t1 = time.monotonic()
    FAULTS[fault](c, ctx)
    t2 = time.monotonic()
    try:
        verify(c, state)
    finally:
        undo = ctx.get("undo")
        if undo is not None:
            undo()
    if ctx.get("verify_during_fault"):
        # the fault was live during verify; verify once more healed
        verify(c, state)
    rep = fsck_report(c)
    assert rep.get("ok") is True, \
        f"fsck not clean after {workload}x{fault}: " \
        f"{json.dumps({k: v for k, v in rep.items() if k != 'volumes'})}"
    return {"workload": workload, "fault": fault,
            "prepare_s": round(t1 - t0, 3),
            "fault_s": round(t2 - t1, 3),
            "verify_s": round(time.monotonic() - t2, 3)}
