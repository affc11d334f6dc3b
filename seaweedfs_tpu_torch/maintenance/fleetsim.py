"""Fleet simulator: hundreds of virtual volume servers in one process.

The master's control loops (aggregator, history/alerts, repair planner,
autopilot, interference observatory) had only ever seen single-digit
node counts; their superlinear walls are invisible at that scale.  This
module registers hundreds of *virtual* volume servers against a REAL
master: each vnode is an `asyncio.start_server` socket (no threads, no
aiohttp app — ~one open listener per node) that serves a synthesized
Prometheus `/metrics` exposition and a mergeable `/heat` sketch, plus a
real `/heartbeat` POST loop so the topology, repair planner, and
aggregator treat it exactly like a live fleet.

Workload model (deterministic per `seed`):
  - read traffic per volume follows a Zipf(a) popularity curve,
  - fleet rate swings on a diurnal sine (period compressed to minutes),
  - `flash_crowd()` multiplies one node set's rate and fattens its
    latency tail — the interference observatory sees p99 inflation,
  - counters accumulate lazily at scrape time (rate × elapsed), so an
    idle simulator costs nothing between scrapes.

Failure injection: `fail_rack(rack)` silences heartbeats AND scrape
responses for every vnode in the rack (correlated failure, the arxiv
1309.0186 pattern); `recover_rack` lifts it.  `stop_nodes`/`add_nodes`
provide join/leave churn for eviction/retirement audits.

Counterpart of `seaweedfs_tpu/maintenance/fleetsim.py`, whole.  The
reference's WEEDTPU_FLEETSIM_* knobs, which no server or test sets, are
the constants below with the reference's defaults (NODES 500, RACKS 10,
VOLUMES per node 8, HEARTBEAT_S 5, RPS 120 base reads/s per node,
ZIPF_A 1.1, SEED 42, DELAY_MS 0 per-response service delay); the
constructor's keywords override them, as the reference's do.  It loads
no torch.  CLI:

    python -m seaweedfs_tpu_torch.maintenance.fleetsim <master host:port>

runs a fleet against an already-running master until interrupted.
"""

from __future__ import annotations

import asyncio
import json
import math
import random
import threading
import time
import uuid

from seaweedfs_tpu_torch.security.tls import scheme as _tls_scheme
from seaweedfs_tpu_torch.utils import weedlog

# latency buckets the synthesized read histogram exposes — a subset of
# metrics._DEFAULT_BUCKETS is enough for p99 math in the observatory
_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 1.0)

# fraction of reads completing under each bucket bound: calm tail vs
# the fattened tail a flash crowd (or rack failure recovery) causes
_CALM_FRACS = (0.30, 0.60, 0.82, 0.93, 0.985, 0.997, 0.9995, 1.0, 1.0)
_BUSY_FRACS = (0.10, 0.25, 0.45, 0.65, 0.83, 0.93, 0.97, 0.995, 1.0)

# the reference's WEEDTPU_FLEETSIM_* defaults
NODES = 500
RACKS = 10
VOLUMES = 8          # per node
HEARTBEAT_S = 5.0
RPS = 120.0          # base reads/s per node
ZIPF_A = 1.1
SEED = 42
DELAY_MS = 0.0       # per-response service delay


class _VNode:
    """One virtual volume server: listener + lazily-advanced counters."""

    def __init__(self, sim: "FleetSim", idx: int, rack: str,
                 volumes: list[int]):
        self.sim = sim
        self.idx = idx
        self.rack = rack
        self.volumes = volumes  # global volume ids hosted here
        self.url = ""           # "127.0.0.1:port" once the listener is up
        self.tracker_id = uuid.uuid4().hex
        self.server: asyncio.base_events.Server | None = None
        self.hb_task: asyncio.Task | None = None
        self.failed = False     # rack failure: drop scrapes + heartbeats
        # lazily-advanced workload counters
        self._last = sim.t0
        self.reads = 0.0
        self.read_sum = 0.0                       # seconds
        self.buckets = [0.0] * len(_BUCKETS)      # cumulative counts
        self.net = {"scrub": 0.0, "repair": 0.0}  # background bytes
        self.used = 10e9 + (idx % 7) * 1e9        # of 100 GB total
        self.vol_sizes = {v: 1e8 + (v % 13) * 1e7 for v in volumes}
        self.scrub_scale = 1.0  # governor /admin/scrub_rate pushes land

    # -- workload model ---------------------------------------------------

    def _rate(self, t: float) -> float:
        """Reads/s now: base × diurnal sine × flash-crowd multiplier."""
        sim = self.sim
        diurnal = 1.0 + 0.5 * math.sin(
            2 * math.pi * (t - sim.t0) / sim.diurnal_period)
        flash = sim.flash_mult if self.idx in sim.flash_nodes and \
            t < sim.flash_until else 1.0
        return sim.base_rps * diurnal * flash

    def advance(self, now: float) -> None:
        """Integrate counters since the last advance (scrape-triggered)."""
        dt = now - self._last
        if dt <= 0:
            return
        self._last = now
        busy = self.idx in self.sim.flash_nodes and \
            now < self.sim.flash_until
        fracs = _BUSY_FRACS if busy else _CALM_FRACS
        n = self._rate(now) * dt
        self.reads += n
        self.read_sum += n * (0.05 if busy else 0.004)
        for i, frac in enumerate(fracs):
            self.buckets[i] += n * frac
        # background byte flows: scrub paced by the governor's pushed
        # scale, a trickle of repair traffic on a few nodes
        self.net["scrub"] += 20e6 * self.scrub_scale * dt
        if self.idx % 17 == 0:
            self.net["repair"] += 5e6 * dt
        self.used += self.sim.fill_bps * dt
        for v in self.vol_sizes:
            self.vol_sizes[v] += self.sim.fill_bps * dt / \
                max(len(self.vol_sizes), 1)

    # -- synthesized surfaces ---------------------------------------------

    def render_metrics(self) -> str:
        now = time.time()
        self.advance(now)
        L = [
            "# TYPE weedtpu_volume_request_seconds histogram",
        ]
        for le, c in zip(_BUCKETS, self.buckets):
            L.append('weedtpu_volume_request_seconds_bucket'
                     f'{{type="read",le="{le}"}} {c:.3f}')
        L.append('weedtpu_volume_request_seconds_bucket'
                 f'{{type="read",le="+Inf"}} {self.reads:.3f}')
        L.append('weedtpu_volume_request_seconds_count'
                 f'{{type="read"}} {self.reads:.3f}')
        L.append('weedtpu_volume_request_seconds_sum'
                 f'{{type="read"}} {self.read_sum:.3f}')
        L.append("# TYPE weedtpu_net_bytes_total counter")
        for cls, b in self.net.items():
            L.append(f'weedtpu_net_bytes_total{{class="{cls}",'
                     f'direction="sent"}} {b:.0f}')
        L.append("# TYPE weedtpu_disk_bytes gauge")
        L.append(f'weedtpu_disk_bytes{{vs="{self.url}",dir="/sim",'
                 f'kind="total"}} {100e9:.0f}')
        L.append(f'weedtpu_disk_bytes{{vs="{self.url}",dir="/sim",'
                 f'kind="used"}} {self.used:.0f}')
        L.append("# TYPE weedtpu_volume_size_bytes gauge")
        for v, s in self.vol_sizes.items():
            L.append(f'weedtpu_volume_size_bytes{{vid="{v}",'
                     f'vs="{self.url}"}} {s:.0f}')
        return "\n".join(L) + "\n"

    def render_heat(self) -> str:
        """A mergeable HeatTracker serialization: volume-dim Space-Saving
        entries weighted by this node's Zipf curve (distinct tracker id,
        so the master's fleet merge counts every vnode)."""
        now = time.time()
        self.advance(now)
        weights = self.sim.zipf_weights(len(self.volumes))
        entries = []
        for v, w in zip(self.volumes, weights):
            est = self.reads * w
            entries.append([str(v), round(est, 3), 0.0,
                            {"read": round(est, 3),
                             "bytes": round(est * 4096, 1)},
                            self.sim.t0])
        top = {"ts": now, "k": max(len(entries), 1),
               "halflife": 300.0, "total": round(self.reads, 3),
               "min": 0.0, "entries": entries}
        return json.dumps({
            "ts": now, "id": self.tracker_id, "k": top["k"],
            "halflife": 300.0,
            "dims": {"chunk": {}, "volume": top, "tenant": {}},
            "cms": {}})

    def heartbeat_body(self) -> dict:
        return {
            "id": self.url, "url": self.url, "public_url": self.url,
            "data_center": "simdc", "rack": self.rack,
            "max_volume_count": len(self.volumes) + 2,
            "volumes": [{
                "id": v, "collection": "", "size": int(self.vol_sizes[v]),
                "file_count": 100, "delete_count": 0, "deleted_bytes": 0,
                "read_only": False, "replica_placement": "000", "ttl": "",
                "modified_at": int(time.time()),
            } for v in self.volumes],
            "ec_shards": [],
        }

    # -- the listener -----------------------------------------------------

    async def handle(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        try:
            line = await asyncio.wait_for(reader.readline(), 5.0)
            parts = line.decode("latin-1").split()
            path = parts[1] if len(parts) > 1 else "/"
            clen = 0
            while True:
                h = await asyncio.wait_for(reader.readline(), 5.0)
                if h in (b"\r\n", b"\n", b""):
                    break
                if h.lower().startswith(b"content-length:"):
                    clen = int(h.split(b":", 1)[1])
            body = await reader.readexactly(clen) if clen else b""
            if self.failed:
                writer.close()
                return
            if self.sim.response_delay > 0:
                await asyncio.sleep(self.sim.response_delay)
            path = path.split("?", 1)[0]
            if path == "/metrics":
                payload = self.render_metrics().encode()
                ctype = "text/plain; version=0.0.4"
            elif path == "/heat":
                payload = self.render_heat().encode()
                ctype = "application/json"
            elif path == "/admin/scrub_rate":
                try:
                    self.scrub_scale = float(
                        json.loads(body or b"{}").get("scale", 1.0))
                except (ValueError, TypeError):
                    pass
                payload, ctype = b"{}", "application/json"
            else:
                payload, ctype = b"{}", "application/json"
            writer.write(b"HTTP/1.0 200 OK\r\nContent-Type: " +
                         ctype.encode() + b"\r\nContent-Length: " +
                         str(len(payload)).encode() + b"\r\n\r\n" + payload)
            await writer.drain()
        except (asyncio.TimeoutError, asyncio.IncompleteReadError,
                ConnectionError, ValueError, IndexError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass


class FleetSim:
    """Drive a real master with N virtual volume servers.

    Runs its own asyncio loop in a daemon thread; every public method is
    thread-safe.  `start()` brings the listeners up and begins heartbeats;
    `wait_registered()` blocks until the master's topology holds every
    live vnode."""

    def __init__(self, master_url: str, nodes: int | None = None,
                 racks: int | None = None,
                 volumes_per_node: int | None = None,
                 heartbeat_s: float | None = None,
                 base_rps: float | None = None,
                 zipf_a: float | None = None,
                 seed: int | None = None,
                 response_delay: float | None = None):
        self.master_url = master_url
        self.n_nodes = NODES if nodes is None else nodes
        self.n_racks = RACKS if racks is None else racks
        self.vols_per_node = VOLUMES if volumes_per_node is None \
            else volumes_per_node
        self.heartbeat_s = HEARTBEAT_S if heartbeat_s is None \
            else heartbeat_s
        self.base_rps = RPS if base_rps is None else base_rps
        self.zipf_a = ZIPF_A if zipf_a is None else zipf_a
        seed = SEED if seed is None else seed
        # per-response artificial service delay: models real scrape RTT
        # so fan-out pool sizing shows up in aggregator tick wall time
        self.response_delay = DELAY_MS / 1000.0 if response_delay \
            is None else response_delay
        self.rng = random.Random(seed)
        self.t0 = time.time()
        self.diurnal_period = 600.0  # a "day" compressed to 10 minutes
        self.fill_bps = 2e6
        self.flash_nodes: set[int] = set()
        self.flash_until = 0.0
        self.flash_mult = 8.0
        self.nodes: dict[int, _VNode] = {}
        self._next_idx = 0
        self._next_vid = 1
        self._zipf_cache: dict[int, tuple[float, ...]] = {}
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._session = None  # aiohttp session, created on the sim loop
        self._hb_sem: asyncio.Semaphore | None = None
        self._lock = threading.Lock()

    # -- workload helpers -------------------------------------------------

    def zipf_weights(self, n: int) -> tuple[float, ...]:
        w = self._zipf_cache.get(n)
        if w is None:
            raw = [1.0 / (r ** self.zipf_a) for r in range(1, n + 1)]
            s = sum(raw) or 1.0
            w = self._zipf_cache[n] = tuple(v / s for v in raw)
        return w

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "FleetSim":
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._loop.run_forever,
                                        name="fleetsim", daemon=True)
        self._thread.start()
        self._call(self._start_all(self.n_nodes))
        return self

    def stop(self) -> None:
        if self._loop is None:
            return
        try:
            self._call(self._stop_all())
        finally:
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(5.0)
            self._loop.close()
            self._loop = None

    def _call(self, coro, timeout: float = 60.0):
        return asyncio.run_coroutine_threadsafe(
            coro, self._loop).result(timeout)

    async def _start_all(self, n: int) -> None:
        import aiohttp
        if self._session is None:
            self._session = aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=10),
                connector=aiohttp.TCPConnector(limit=64))
            self._hb_sem = asyncio.Semaphore(32)
        await asyncio.gather(*[self._spawn_node() for _ in range(n)])

    async def _spawn_node(self) -> _VNode:
        with self._lock:
            idx = self._next_idx
            self._next_idx += 1
            vids = list(range(self._next_vid,
                              self._next_vid + self.vols_per_node))
            self._next_vid += self.vols_per_node
        node = _VNode(self, idx, f"rack{idx % self.n_racks}", vids)
        node.server = await asyncio.start_server(
            node.handle, "127.0.0.1", 0)
        port = node.server.sockets[0].getsockname()[1]
        node.url = f"127.0.0.1:{port}"
        with self._lock:
            self.nodes[idx] = node
        node.hb_task = asyncio.get_running_loop().create_task(
            self._heartbeat_loop(node))
        return node

    async def _stop_node(self, node: _VNode) -> None:
        if node.hb_task is not None:
            node.hb_task.cancel()
        if node.server is not None:
            node.server.close()
            try:
                await node.server.wait_closed()
            except Exception:
                pass

    async def _stop_all(self) -> None:
        with self._lock:
            nodes = list(self.nodes.values())
            self.nodes.clear()
        await asyncio.gather(*[self._stop_node(n) for n in nodes],
                             return_exceptions=True)
        if self._session is not None:
            await self._session.close()
            self._session = None

    # -- heartbeats -------------------------------------------------------

    async def _beat_once(self, node: _VNode) -> bool:
        async with self._hb_sem:
            try:
                async with self._session.post(
                        f"{_tls_scheme()}://{self.master_url}/heartbeat",
                        json=node.heartbeat_body()) as r:
                    return r.status == 200
            except Exception as e:
                weedlog.V(1, "fleetsim").infof(
                    "heartbeat from %s failed: %s", node.url, e)
                return False

    async def _heartbeat_loop(self, node: _VNode) -> None:
        # stagger the fleet across the interval so the master sees a
        # steady arrival rate, not a thundering herd each period
        await asyncio.sleep(self.rng.random() * self.heartbeat_s)
        while True:
            if not node.failed:
                await self._beat_once(node)
            await asyncio.sleep(self.heartbeat_s)

    def beat_all(self) -> int:
        """One immediate heartbeat from every live node (deterministic
        registration for tests/bench).  Returns the success count."""
        async def _all():
            with self._lock:
                nodes = [n for n in self.nodes.values() if not n.failed]
            oks = await asyncio.gather(*[self._beat_once(n)
                                         for n in nodes])
            return sum(oks)
        return self._call(_all())

    # -- churn + failure injection ---------------------------------------

    def add_nodes(self, n: int) -> list[str]:
        """Join n new vnodes (listener + heartbeats); returns their urls."""
        async def _add():
            nodes = await asyncio.gather(*[self._spawn_node()
                                           for _ in range(n)])
            return [nd.url for nd in nodes]
        return self._call(_add())

    def stop_nodes(self, n: int) -> list[str]:
        """Leave churn: permanently stop the n most recently joined."""
        with self._lock:
            idxs = sorted(self.nodes)[-n:]
            victims = [self.nodes.pop(i) for i in idxs]
        async def _stop():
            await asyncio.gather(*[self._stop_node(v) for v in victims],
                                 return_exceptions=True)
        self._call(_stop())
        return [v.url for v in victims]

    def fail_rack(self, rack: str) -> list[str]:
        """Correlated failure: every vnode in the rack stops answering
        scrapes and heartbeating (connection drops, like a dead ToR)."""
        with self._lock:
            hit = [n for n in self.nodes.values() if n.rack == rack]
            for n in hit:
                n.failed = True
        return [n.url for n in hit]

    def recover_rack(self, rack: str) -> None:
        with self._lock:
            for n in self.nodes.values():
                if n.rack == rack:
                    n.failed = False

    def flash_crowd(self, frac: float = 0.05,
                    duration_s: float = 60.0) -> set[int]:
        """Make `frac` of the fleet suddenly hot with a fat latency tail."""
        with self._lock:
            idxs = sorted(self.nodes)
        k = max(1, int(len(idxs) * frac))
        self.flash_nodes = set(self.rng.sample(idxs, k))
        self.flash_until = time.time() + duration_s
        return set(self.flash_nodes)

    # -- views ------------------------------------------------------------

    def urls(self) -> list[str]:
        with self._lock:
            return [n.url for n in self.nodes.values()]

    def __len__(self) -> int:
        with self._lock:
            return len(self.nodes)


def main(argv: list[str] | None = None) -> int:
    import sys
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m seaweedfs_tpu_torch.maintenance.fleetsim "
              "<master host:port>", file=sys.stderr)
        return 2
    sim = FleetSim(argv[0]).start()
    print(f"fleetsim: {len(sim)} vnodes heartbeating to {argv[0]} "
          f"(Ctrl-C to stop)")
    try:
        while True:
            time.sleep(5)
    except KeyboardInterrupt:
        pass
    finally:
        sim.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
