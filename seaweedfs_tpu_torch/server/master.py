"""Master server: topology bookkeeping, fid assignment, volume lookup.

Counterpart of `seaweedfs_tpu/server/master.py`, cut to the master's
core.  It speaks the reference master's public HTTP API
(weed/server/master_server_handlers.go): /dir/assign, /dir/lookup,
/vol/grow, /cluster/status, plus the JSON endpoints for what the
reference does over gRPC: /heartbeat (volume servers report state,
protobuf or JSON, master_grpc_server.go:61), /dir/ec/lookup
(LookupEcVolume, master_grpc_server_volume.go:156), /cluster/stream (the
KeepConnected vid-map push) and the shell's exclusive admin lock
(master_grpc_server_admin.go).  With `peers` the masters run raft
(`topology/raft.py`) over /raft/*: the leader replicates volume-id
allocations, and a follower answers the client routes with a 409 that
names the leader.

The master's planes (`stats/`) ride on it: the loop monitor, the metrics
aggregator with its SLO engine (/cluster/metrics, /cluster/slo), the
history store, alerts and the capacity forecaster (/cluster/history,
/cluster/alerts, /cluster/dashboard), the interference observatory and
its governor (/cluster/interference), the canary prober
(/cluster/canary), the fleet views that fan out to every node
(/cluster/heat, /cluster/perf, /cluster/trace/{tid}, /cluster/traces)
and /cluster/loops.  Each scrape of the aggregator runs the observers in
the reference's order: history, forecast, alerts, interference,
governor, accounting.

The maintenance plane (`maintenance/`) rides on it too: the repair
planner and its health ledger (/maintenance/status,
/maintenance/scrub_report, /maintenance/tick), the fleet-conversion
scheduler (/maintenance/convert) and the autopilot (/cluster/autopilot).
The leader ticks them every WEEDTPU_REPAIR_INTERVAL seconds (15; <= 0:
driven on demand), and yields while the shell holds the admin lock.
The governor retunes their buckets beside the fleet's scrub rate.

WEEDTPU_AGG_INTERVAL, WEEDTPU_CANARY_INTERVAL and WEEDTPU_REPAIR_INTERVAL
set the background loops.  Every knob of the planes and of the
maintenance plane is read at construction, and a malformed one raises
before the socket binds (the reference reads the repair interval when
its loop starts, and falls back on a malformed one).

The master has no device: it keeps soft state and routes requests.  Its
volume servers run the kernels; the repairs, conversions, promotes and
recodes it posts, the canary's degraded probe and the governed scrub
passes launch them there.

Left out until the module that serves it is ported: `LEFT_OUT`, the
geo-replication view (ROADMAP 1.22), which answers 404.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import json
import logging
import os
import secrets
import threading
import time
import urllib.error
import urllib.request
import zlib

import aiohttp
from aiohttp import web

from seaweedfs_tpu_torch import pb
from seaweedfs_tpu_torch.maintenance import faults
from seaweedfs_tpu_torch.maintenance.autopilot import (Autopilot,
                                                       autopilot_mode)
from seaweedfs_tpu_torch.maintenance.convert import ConvertScheduler
from seaweedfs_tpu_torch.maintenance.repair import (HEALTH_STATES,
                                                    RepairPlanner,
                                                    reduced_enabled)
from seaweedfs_tpu_torch.ops import codec_tags
from seaweedfs_tpu_torch.security import tls
from seaweedfs_tpu_torch.security.jwt import gen_jwt
from seaweedfs_tpu_torch.server import ui
from seaweedfs_tpu_torch.stats import (aggregate, canary, heat, history,
                                       interference, loops, metrics,
                                       netflow, pipeline, profile, trace)
from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.topology.raft import RaftConfig, RaftNode
from seaweedfs_tpu_torch.topology.sequence import SnowflakeSequencer
from seaweedfs_tpu_torch.topology.topology import Topology, VolumeState
from seaweedfs_tpu_torch.utils import fanout, resilience, weedlog
from seaweedfs_tpu_torch.utils.http import aiohttp_trace_config
from seaweedfs_tpu_torch.utils.resilience import _env_float, env_switch

log = logging.getLogger("master")

# the reference master's route that comes with a plane not ported yet:
# the geo-replication view (ROADMAP 1.22)
LEFT_OUT = ("/cluster/geo",)


class MasterServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 9333,
                 volume_size_limit: int = 30 * 1024 * 1024 * 1024,
                 default_replication: str = "000",
                 grow_count: int = 1, security=None,
                 node_timeout: float = 25.0,
                 peers: list[str] | None = None,
                 raft_state_dir: str | None = None,
                 region: str | None = None):
        self.host, self.port = host, port
        # which region this master (and its cluster) lives in: stamped on
        # every server span, and matched by region-scoped fault rules
        self.region = (os.environ.get("WEEDTPU_GEO_REGION", "")
                       if region is None else region)
        self.security = security
        self.guard = security.guard if security is not None else None
        sequencer = None
        if peers:
            # HA masters must never reissue file keys after failover; the
            # snowflake sequencer is stateless-safe (reference: weed master
            # -master.sequencerType=snowflake for multi-master).  The node
            # id is unique per master node, not per port (every host runs
            # 9333): host:port hashed into the 10-bit space
            sequencer = SnowflakeSequencer(
                node_id=zlib.crc32(f"{host}:{port}".encode()) & 0x3FF)
        self.topo = Topology(volume_size_limit=volume_size_limit,
                             replication=default_replication,
                             sequencer=sequencer)
        self.grow_count = grow_count
        self.node_timeout = node_timeout
        # raft among masters (reference: weed/server/raft_server.go):
        # replicates volume-id allocations; followers redirect to the
        # leader
        self.raft = None
        if peers:
            me = f"{host}:{port}"
            others = [p for p in peers if p != me]
            state_path = None
            if raft_state_dir:
                os.makedirs(raft_state_dir, exist_ok=True)
                state_path = os.path.join(
                    raft_state_dir, f"raft_{port}.json")
            self.raft = RaftNode(
                RaftConfig(node_id=me, peers=others,
                           state_path=state_path),
                transport=self._raft_transport,
                apply_command=self._raft_apply,
                take_snapshot=self._raft_take_snapshot,
                restore_snapshot=self._raft_restore_snapshot)
        self.app = web.Application(
            client_max_size=64 * 1024 * 1024,
            middlewares=[self._guard_middleware,
                         trace.aiohttp_middleware(
                             "master", slow_exempt=("/cluster/stream",),
                             region=self.region)])
        self.app.add_routes(trace.debug_routes())
        self.app.add_routes([
            web.route("*", "/dir/assign", self.handle_assign),
            web.get("/dir/lookup", self.handle_lookup),
            web.get("/dir/ec/lookup", self.handle_ec_lookup),
            web.post("/heartbeat", self.handle_heartbeat),
            web.get("/cluster/status", self.handle_cluster_status),
            web.get("/dir/status", self.handle_dir_status),
            web.post("/vol/grow", self.handle_grow),
            web.post("/admin/lock", self.handle_lock),
            web.post("/admin/unlock", self.handle_unlock),
            web.post("/admin/renew_lock", self.handle_renew_lock),
            web.post("/cluster/register", self.handle_cluster_register),
            web.post("/cluster/mq/epoch", self.handle_mq_epoch),
            web.get("/cluster/stream", self.handle_cluster_stream),
            web.post("/vol/vacuum", self.handle_vacuum),
            web.post("/vol/vacuum_toggle", self.handle_vacuum_toggle),
            web.get("/maintenance/status", self.handle_maintenance_status),
            web.post("/maintenance/scrub_report",
                     self.handle_scrub_report),
            web.post("/maintenance/tick", self.handle_maintenance_tick),
            web.route("*", "/maintenance/convert",
                      self.handle_maintenance_convert),
            web.post("/raft/peers/add", self.handle_raft_peer_add),
            web.post("/raft/peers/remove", self.handle_raft_peer_remove),
            web.get("/raft/status", self.handle_raft_status),
            web.post("/raft/request_vote", self.handle_raft_vote),
            web.post("/raft/append_entries", self.handle_raft_append),
            web.post("/raft/install_snapshot", self.handle_raft_install),
            web.get("/metrics", self.handle_metrics),
            web.get("/heat", heat.handle_heat),
            web.get("/perf", pipeline.handle_perf),
            web.get("/cluster/metrics", self.handle_cluster_metrics),
            web.get("/cluster/slo", self.handle_cluster_slo),
            web.get("/cluster/heat", self.handle_cluster_heat),
            web.get("/cluster/perf", self.handle_cluster_perf),
            web.get("/cluster/trace/{tid}", self.handle_cluster_trace),
            web.get("/cluster/traces", self.handle_cluster_traces),
            web.get("/cluster/canary", self.handle_cluster_canary),
            web.get("/cluster/history", self.handle_cluster_history),
            web.get("/cluster/interference",
                    self.handle_cluster_interference),
            web.route("*", "/cluster/autopilot",
                      self.handle_cluster_autopilot),
            web.get("/cluster/alerts", self.handle_cluster_alerts),
            web.get("/cluster/loops", self.handle_cluster_loops),
            web.get("/cluster/dashboard", self.handle_cluster_dashboard),
            web.get("/", self.handle_ui),
        ])
        netflow.install(self.app, "master")
        # non-volume-server cluster members (filers, brokers, gateways):
        # type -> {address: last_seen} (reference: weed/cluster/cluster.go)
        self.cluster_members: dict[str, dict[str, float]] = {}
        self._mq_epochs: dict[str, int] = {}  # MQ partition fencing epochs
        # vid-map stream subscribers (reference: KeepConnected clients,
        # master_grpc_server.go broadcastToClients)
        self._vid_subscribers: set[asyncio.Queue] = set()
        self.topo.on_vid_change = self._push_vid_change
        self.vacuum_enabled = True
        self.garbage_threshold = 0.3
        self._runner: web.AppRunner | None = None
        self._session: aiohttp.ClientSession | None = None
        self._grow_lock = asyncio.Lock()
        self._admin_lock: tuple[str, str, float] | None = None  # (token, owner, ts)
        self._expire_task: asyncio.Task | None = None
        # the planes' and the maintenance plane's switches are re-read
        # live: read them once here too, so that a malformed one raises
        # before the socket binds (the other knobs are read by the
        # constructors, the repair interval here)
        for knob in ("WEEDTPU_HISTORY", "WEEDTPU_INTERFERENCE",
                     "WEEDTPU_GOVERNOR"):
            env_switch(knob)
        fanout.pool_cap()
        canary.canary_interval()
        reduced_enabled()
        autopilot_mode()
        self.repair_interval = _env_float("WEEDTPU_REPAIR_INTERVAL", 15.0)
        # self-healing plane: health ledger + automatic repair executor
        # (maintenance/repair.py); ticked by _repair_loop on the leader
        self.maintenance = RepairPlanner(self)
        self._repair_task: asyncio.Task | None = None
        # fleet EC conversion scheduler (maintenance/convert.py): paced
        # background multi-volume encode, ticked in the same background
        # loop right after the repair planner (repair outranks it)
        self.convert = ConvertScheduler(self)
        self._convert_task: asyncio.Task | None = None
        # control-plane observatory (stats/loops.py): every background
        # loop below ticks through this monitor; constructed first
        # because the aggregator and the observer stages report into it
        self.loops = loops.LoopMonitor()
        # fleet /metrics federation and the SLO burn-rate engine
        # (stats/aggregate.py): every known node's exposition over
        # PooledHTTP, this master's own registry read directly
        self.aggregator = aggregate.ClusterAggregator(
            self._agg_nodes, local=(self.url, metrics.REGISTRY),
            monitor=self.loops)
        # historical telemetry (stats/history.py): every scrape lands in
        # the fixed-memory store, then the forecaster re-regresses fill
        # rates and the alert engine re-evaluates, all on the
        # aggregator's thread
        self.history = history.HistoryStore()
        self.alerts = history.AlertEngine(self.history,
                                          pin_fn=trace.pin_trace)
        self.forecaster = history.CapacityForecaster(self.history)
        # autopilot (maintenance/autopilot.py): the policy engine that
        # turns heat/forecast/health telemetry into typed, dry-run-able
        # action plans.  Constructed BEFORE the governor so its
        # per-policy pacing buckets register as governed targets like
        # repair/convert/scrub
        self.autopilot = Autopilot(self)
        self._autopilot_task: asyncio.Task | None = None
        # interference (stats/interference.py): the per-node foreground
        # impact index rides the same observer seam, and the governor
        # retunes the repair/convert/autopilot buckets and the fleet's
        # scrub rate off it right after
        self.interference = interference.InterferenceObservatory()
        self.governor = interference.Governor(self, self.interference)
        self.aggregator.observers.append(self._on_scrape)
        # the canary (stats/canary.py): probes through every data path,
        # each under a pinned trace, feeding the canary SLO rule
        self.canary = canary.CanaryProber(self)
        # live-entry counts of every stateful subsystem, stamped as
        # weedtpu_subsystem_entries on each scrape and on /cluster/loops
        self.loops.add_cardinality(
            "registry_series", metrics.REGISTRY.series_count)
        self.loops.add_cardinality(
            "history_series", self.history.series_count)
        self.loops.add_cardinality(
            "history_node_baselines", lambda: len(self.history._prev))
        self.loops.add_cardinality(
            "alert_groups", lambda: sum(
                len(st) for st in self.alerts._state.values()))
        self.loops.add_cardinality(
            "interference_nodes", lambda: len(self.interference._nodes))
        self.loops.add_cardinality(
            "heat_entries", lambda: sum(
                len(sk.entries) for sk in heat.TRACKER._top.values()))
        self.loops.add_cardinality(
            "pinned_traces", lambda: len(trace.pinned_ids()))
        # workload heat: the last fleet-merged /cluster/heat view (ts, dict)
        self._heat_cache: tuple[float, dict] | None = None
        self._heat_lock = threading.Lock()

    # -- lifecycle -----------------------------------------------------

    @property
    def url(self) -> str:
        return f"{self.host}:{self.port}"

    async def start(self) -> None:
        await asyncio.to_thread(pb.available)
        self._session = aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(ssl=tls.client_ssl()),
            timeout=aiohttp.ClientTimeout(total=30),
            trace_configs=[aiohttp_trace_config("master")])
        self._runner = web.AppRunner(self.app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.host, self.port,
                           ssl_context=tls.server_ssl("master"))
        await site.start()
        self._expire_task = asyncio.create_task(self._expire_loop())
        self._repair_task = asyncio.create_task(self._repair_loop())
        profile.ensure_started()  # WEEDTPU_PROFILE_HZ, process-wide
        faults.register_node(self.url, "master")
        if self.region:
            faults.register_region(self.url, self.region)
        self.aggregator.start()
        self.canary.start()  # WEEDTPU_CANARY_INTERVAL <= 0 disables
        if self.raft:
            self.raft.start()
        log.info("master listening on %s", self.url)

    async def stop(self) -> None:
        if self.raft:
            self.raft.stop()
        self.canary.stop()
        if self._expire_task:
            self._expire_task.cancel()
        if self._repair_task:
            self._repair_task.cancel()
        if self._convert_task:
            self._convert_task.cancel()
        if self._autopilot_task:
            self._autopilot_task.cancel()
        for task in list(self.autopilot._tasks):
            task.cancel()  # in-flight plan executions die with the master
        # wake /cluster/stream subscribers so their handlers return and
        # runner.cleanup() doesn't wait out its shutdown timeout on them
        for q in list(self._vid_subscribers):
            q.put_nowait(None)
        await asyncio.to_thread(self.aggregator.stop)
        self.interference.close()
        self.loops.close()
        if self._session:
            await self._session.close()
        if self._runner:
            await self._runner.cleanup()

    # -- raft glue ------------------------------------------------------

    def _raft_transport(self, peer: str, rpc: str, payload: dict):
        """Blocking HTTP transport, called from raft threads only."""
        try:
            req = urllib.request.Request(
                f"{tls.scheme()}://{peer}/raft/{rpc}",
                data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=2.0) as r:
                return json.loads(r.read())
        except (urllib.error.URLError, OSError, ValueError):
            return None

    def _raft_apply(self, command: dict) -> None:
        if command.get("op") == "set_max_vid":
            with self.topo._lock:
                self.topo.max_volume_id = max(self.topo.max_volume_id,
                                              int(command["vid"]))

    def _raft_take_snapshot(self) -> dict:
        """The only raft-hard state is the vid high-water mark; soft
        topology is rebuilt from heartbeats (raft_server.go comment)."""
        with self.topo._lock:
            return {"max_volume_id": self.topo.max_volume_id}

    def _raft_restore_snapshot(self, data: dict) -> None:
        with self.topo._lock:
            self.topo.max_volume_id = max(self.topo.max_volume_id,
                                          int(data.get("max_volume_id", 0)))

    async def handle_raft_install(self, req: web.Request) -> web.Response:
        if self.raft is None:
            return web.json_response({"error": "raft disabled"}, status=400)
        body = await req.json()
        return web.json_response(
            await asyncio.to_thread(self.raft.handle_install_snapshot, body))

    async def handle_raft_vote(self, req: web.Request) -> web.Response:
        if self.raft is None:
            return web.json_response({"error": "raft disabled"}, status=400)
        body = await req.json()
        return web.json_response(
            await asyncio.to_thread(self.raft.handle_request_vote, body))

    async def handle_raft_append(self, req: web.Request) -> web.Response:
        if self.raft is None:
            return web.json_response({"error": "raft disabled"}, status=400)
        body = await req.json()
        return web.json_response(
            await asyncio.to_thread(self.raft.handle_append_entries, body))

    async def handle_raft_status(self, req: web.Request) -> web.Response:
        if self.raft is None:
            return web.json_response({"raft": "disabled",
                                      "leader": self.leader_url})
        r = self.raft
        return web.json_response({
            "node_id": r.cfg.node_id, "state": r.state,
            "term": r.current_term, "leader": r.leader_id,
            "peers": r.cfg.peers, "log_len": len(r.log),
            "snap_index": r.snap_index,
            "commit_index": r.commit_index,
        })

    async def handle_raft_peer_add(self, req: web.Request) -> web.Response:
        """Runtime peer addition (reference: cluster.raft.add; the
        reference's hashicorp raft AddVoter). Single-entry change applied
        locally: run against every member."""
        if self.raft is None:
            return web.json_response({"error": "raft disabled"}, status=400)
        body = await req.json()
        peer = body.get("peer", "")
        if peer:
            # persists with the raft state, so a master restart keeps the
            # operated-in membership instead of reverting to CLI -peers
            self.raft.add_peer(peer)
        return web.json_response({"peers": self.raft.cfg.peers})

    async def handle_raft_peer_remove(self, req: web.Request) -> web.Response:
        if self.raft is None:
            return web.json_response({"error": "raft disabled"}, status=400)
        body = await req.json()
        peer = body.get("peer", "")
        if peer:
            self.raft.remove_peer(peer)
        return web.json_response({"peers": self.raft.cfg.peers})

    @property
    def is_leader(self) -> bool:
        return self.raft is None or self.raft.is_leader

    @property
    def leader_url(self) -> str:
        if self.raft is None or self.raft.leader_id is None:
            return self.url
        return self.raft.leader_id

    def _not_leader_response(self) -> web.Response:
        return web.json_response(
            {"error": "not the leader", "leader": self.leader_url},
            status=409)

    # -- background ----------------------------------------------------

    async def _expire_loop(self) -> None:
        tick = 0
        interval = min(5.0, self.node_timeout / 2)
        while True:
            await asyncio.sleep(interval)
            with self.loops.tick("expire", interval=interval) as lt:
                dead = self.topo.expire_dead_nodes(self.node_timeout)
                lt.items = len(dead)
                for nid in dead:
                    log.warning("volume server %s expired from topology",
                                nid)
                now = time.time()
                for members in self.cluster_members.values():
                    for addr in [a for a, ts in members.items()
                                 if now - ts > 30]:
                        del members[addr]
                tick += 1
                if tick % 12 == 0:  # every minute: vacuum scan
                    try:
                        if self.vacuum_enabled:
                            await self._vacuum_scan(self.garbage_threshold)
                    except Exception:
                        log.warning("vacuum scan failed", exc_info=True)

    async def _vacuum_scan(self, threshold: float) -> int:
        """Master-driven compaction: scan volumes whose garbage ratio
        exceeds the threshold and drive the vacuum cycle on their replicas
        (reference: weed/topology/topology_vacuum.go)."""
        vacuumed = 0
        candidates: list[tuple[int, str]] = []
        with self.topo._lock:
            for node in self.topo.nodes.values():
                for vid, v in node.volumes.items():
                    if v.size > 0 and not v.read_only and \
                            v.deleted_bytes / max(v.size, 1) > threshold:
                        candidates.append((vid, node.url))
        for vid, url in candidates:
            try:
                async with self._session.post(
                        f"{tls.scheme()}://{url}/admin/volume/vacuum",
                        json={"volume": vid}) as r:
                    if r.status == 200:
                        vacuumed += 1
                        log.info("vacuumed volume %d on %s", vid, url)
            except aiohttp.ClientError as e:
                log.warning("vacuum of %d on %s failed: %s", vid, url, e)
        return vacuumed

    # -- self-healing maintenance plane ---------------------------------

    async def _repair_loop(self) -> None:
        """Background planner ticks (leader only) every
        `repair_interval` seconds; <= 0 disables the loop (repairs then
        run only via explicit /maintenance/tick).  The loop yields while
        the shell holds the admin lock: automatic maintenance must not
        race an operator."""
        interval = self.repair_interval
        if interval <= 0:
            return
        while True:
            await asyncio.sleep(interval)
            if not self.is_leader:
                continue
            if self._admin_lock and \
                    time.time() - self._admin_lock[2] < 30:
                continue
            await self.maintenance_round(interval)

    async def maintenance_round(self, interval: float | None = None
                                ) -> list[asyncio.Task]:
        """One round of the background loop: the planner's tick, then the
        conversion and autopilot ticks, each as a task of its own (never
        overlapping itself), all through the loop monitor.  Returns those
        two tasks; the loop leaves them running, a caller that drives
        the round by hand (the repair interval <= 0) may await them."""
        try:
            with self.loops.tick("repair", interval=interval) as lt:
                actions = await self.maintenance.tick()
                lt.items = len(actions)
                lt.backlog = len(self.maintenance._active_vids)
        except Exception:
            log.warning("repair tick failed", exc_info=True)
        # conversion rides the same cadence but runs as its OWN task
        # (never overlapping itself): a node batch can hold its HTTP call
        # open for minutes, and awaiting it inline would starve the
        # repair tick above — inverting the repair-outranks-conversion
        # priority exactly when loss recovery is urgent
        t = self._convert_task
        if t is None or t.done():
            self._convert_task = asyncio.create_task(
                self._convert_tick_once())
        # the autopilot rides the same cadence, also as its own
        # non-overlapping task: a promote decode or a volume move can
        # hold its actuator call open for minutes
        t = self._autopilot_task
        if t is None or t.done():
            self._autopilot_task = asyncio.create_task(
                self._autopilot_tick_once())
        return [self._convert_task, self._autopilot_task]

    async def _convert_tick_once(self) -> None:
        try:
            with self.loops.tick("convert") as lt:
                launched = await self.convert.tick()
                lt.items = len(launched)
                lt.backlog = len(self.convert.queued)
        except Exception:
            log.warning("convert tick failed", exc_info=True)

    async def _autopilot_tick_once(self) -> None:
        try:
            with self.loops.tick("autopilot") as lt:
                plans = await self.autopilot.tick()
                lt.items = len(plans)
        except Exception:
            log.warning("autopilot tick failed", exc_info=True)

    def _health_snapshot(self) -> dict:
        led = self.maintenance.ledger()  # also refreshes VOLUME_HEALTH
        counts = {s: 0 for s in HEALTH_STATES}
        for info in led.values():
            counts[info["state"]] = counts.get(info["state"], 0) + 1
        snap = {"volumes": {str(vid): info
                            for vid, info in sorted(led.items())},
                "states": counts,
                "planner": self.maintenance.status(),
                "convert": self.convert.status()}
        # resilience plane: per-peer breaker states feed the health
        # ledger (a tripped breaker is a node the data path has already
        # given up on — often minutes before the heartbeat horizon says
        # so), plus armed chaos faults so `chaos.status` can show an
        # operator what is injected vs what is organically broken
        snap["resilience"] = {
            "breakers": resilience.breakers_snapshot(),
            "retry_budget": resilience.retry_budget().snapshot(),
            "hedge_pct": resilience.hedge_pct(),
            "faults": faults.net_snapshot(),
        }
        try:
            # SLO view from whatever the aggregator last pulled — status
            # must not block on a fleet scrape
            snap["slo"] = self.aggregator.slo_status()
        except Exception:
            log.warning("slo status failed", exc_info=True)
        try:
            # firing alerts + capacity forecasts from the history plane:
            # both read cached state, never a fleet fan-out
            snap["alerts"] = self.alerts.status()
            snap["capacity"] = self.forecaster.snapshot()
            snap["history"] = self.history.status()
        except Exception:
            log.warning("alert status failed", exc_info=True)
        try:
            # interference headline + governed rates (cached state only;
            # /cluster/interference has the per-node detail)
            snap["interference"] = {
                "classes": self.interference.fleet_index(),
                "governor": self.governor.status()}
        except Exception:
            log.warning("interference status failed", exc_info=True)
        try:
            # autopilot headline (mode, plan-state counts, last plans);
            # /cluster/autopilot has the full ledger
            snap["autopilot"] = self.autopilot.headline()
        except Exception:
            log.warning("autopilot status failed", exc_info=True)
        try:
            # control-plane loops headline (slowest loop + overruns);
            # /cluster/loops has per-loop detail and cardinality
            snap["loops"] = {"headline": self.loops.headline()}
        except Exception:
            log.warning("loops status failed", exc_info=True)
        with self._heat_lock:
            cached = self._heat_cache
        if cached is not None:
            # workload heat headline from the LAST merged view only —
            # status never blocks on a fleet fan-out (hit /cluster/heat
            # for a fresh one)
            ts, merged = cached
            snap["heat"] = {
                "ts": ts,
                "volumes": merged.get("volumes", {}).get("top", [])[:5],
                "tenants": merged.get("tenants", {}).get("top", [])[:5],
            }
        return snap

    async def handle_maintenance_status(self, req: web.Request
                                        ) -> web.Response:
        """Machine-readable cluster health: the per-volume ledger the
        repair planner acts on, plus planner/executor state.  The
        maintenance.status shell command and volume.fsck -json read
        this.  It has no `geo` block: the reference adds one only with
        geo directions, peers or a region (ROADMAP 1.22)."""
        return web.json_response(self._health_snapshot())

    async def handle_scrub_report(self, req: web.Request) -> web.Response:
        """Scrub verdict intake from volume servers (maintenance/scrub.py
        report hook)."""
        try:
            body = await req.json()
        except ValueError:
            return web.json_response({"error": "bad json"}, status=400)
        node = body.get("node", "")
        if not node:
            return web.json_response({"error": "node required"}, status=400)
        self.maintenance.record_scrub(node, body)
        return web.json_response({})

    async def handle_maintenance_tick(self, req: web.Request
                                      ) -> web.Response:
        """Force one planner tick; {"wait": true} blocks until every
        launched repair finishes — the deterministic hook tests drive
        instead of sleeping on the background loop."""
        if not self.is_leader:
            return self._not_leader_response()
        try:
            body = await req.json()
        except ValueError:
            body = {}
        actions = await self.maintenance.tick()
        if body.get("wait"):
            await self.maintenance.wait_idle()
        return web.json_response({"actions": actions})

    async def handle_maintenance_convert(self, req: web.Request
                                         ) -> web.Response:
        """Fleet-conversion scheduler surface: GET returns scheduler
        state; POST {"volumes": [vids]} queues volumes (with "seal":
        true, sealed on success), {"tick": true} forces one
        deterministic paced tick."""
        if req.method == "GET":
            return web.json_response(self.convert.status())
        if not self.is_leader:
            return self._not_leader_response()
        try:
            body = await req.json()
        except ValueError:
            body = {}
        accepted = self.convert.enqueue(body.get("volumes") or [],
                                        seal=bool(body.get("seal")))
        actions = []
        if body.get("tick"):
            actions = await self.convert.tick()
        return web.json_response({"accepted": accepted,
                                  "actions": actions,
                                  "status": self.convert.status()})

    async def handle_cluster_autopilot(self, req: web.Request
                                       ) -> web.Response:
        """/cluster/autopilot: the decision ledger — mode, per-policy
        pacing buckets, hysteresis clocks, and every plan with its
        state and pinned trace id.  POST drives the state machine:
        {"tick": true} runs one deterministic policy pass,
        {"approve": "<id>"} executes one plan (the plan-mode runbook
        step), {"abort": "<id>"} kills a not-yet-executing plan,
        {"wait": true} blocks until launched executions settle.
        Loopback-gated like every operator surface (plans name nodes,
        volumes, and trace ids)."""
        err = trace.loopback_error(req)
        if err is not None:
            return err
        if req.method == "GET":
            return web.json_response(self.autopilot.status())
        if req.method != "POST":
            return web.json_response({"error": "method not allowed"},
                                     status=405)
        if not self.is_leader:
            return self._not_leader_response()
        try:
            body = await req.json()
        except ValueError:
            body = {}
        out: dict = {}
        try:
            if body.get("approve"):
                out["approved"] = self.autopilot.serialize_plan(
                    self.autopilot.approve(str(body["approve"])))
            if body.get("abort"):
                out["aborted"] = self.autopilot.serialize_plan(
                    self.autopilot.abort(str(body["abort"])))
        except KeyError as e:
            return web.json_response({"error": f"no plan {e.args[0]}"},
                                     status=404)
        except ValueError as e:
            return web.json_response({"error": str(e)}, status=409)
        if body.get("tick"):
            out["plans"] = await self.autopilot.tick()
        if body.get("wait"):
            await self.autopilot.wait_idle()
        out["status"] = self.autopilot.status()
        return web.json_response(out)

    async def handle_vacuum_toggle(self, req: web.Request) -> web.Response:
        """Pause/resume the automatic vacuum scan (reference: shell
        volume.vacuum.disable / volume.vacuum.enable)."""
        body = await req.json()
        self.vacuum_enabled = bool(body.get("enabled", True))
        return web.json_response({"enabled": self.vacuum_enabled})

    async def handle_vacuum(self, req: web.Request) -> web.Response:
        threshold = float(req.query.get("garbageThreshold",
                                        str(self.garbage_threshold)))
        n = await self._vacuum_scan(threshold)
        return web.json_response({"vacuumed": n})

    async def handle_cluster_register(self, req: web.Request) -> web.Response:
        body = await req.json()
        kind, addr = body.get("type", "filer"), body.get("address", "")
        if addr:
            self.cluster_members.setdefault(kind, {})[addr] = time.time()
        return web.json_response({})

    async def handle_mq_epoch(self, req: web.Request) -> web.Response:
        """Fencing-epoch authority for MQ partition ownership: each bump
        returns a value strictly above every previously issued one, and,
        floored at the wall clock in ns, above anything an earlier master
        incarnation issued too, so epochs need no persistence."""
        body = await req.json()
        key = str(body.get("key", ""))
        if not key:
            return web.json_response({"error": "key required"}, status=400)
        prev = self._mq_epochs.get(key, 0)
        epoch = max(prev + 1, time.time_ns())
        self._mq_epochs[key] = epoch
        return web.json_response({"epoch": epoch})

    # -- the planes' scrape observer ------------------------------------

    def _on_scrape(self, ts: float, per_node: dict) -> None:
        """Aggregator scrape observer: record the tick into history, then
        forecast, evaluate alerts, observe interference and retune the
        governor over the updated store, then stamp the subsystems'
        sizes (the aggregator's thread; each stage is independent, so
        one failing must not starve the others).  Every stage ticks the
        loop monitor with the aggregator's interval."""
        iv = self.aggregator.interval
        iv = iv if iv > 0 else None
        try:
            with self.loops.tick("history_record", interval=iv) as lt:
                lt.items = len(per_node)
                self.history.record(ts, per_node)
                lt.backlog = self.history.series_count()
        except Exception:
            log.warning("history record failed", exc_info=True)
        try:
            with self.loops.tick("forecast", interval=iv):
                self.forecaster.update(
                    ts, volume_size_limit=self.topo.volume_size_limit)
        except Exception:
            log.warning("capacity forecast failed", exc_info=True)
        try:
            with self.loops.tick("alerts", interval=iv) as lt:
                self.alerts.evaluate(ts)
                lt.backlog = sum(
                    len(st) for st in self.alerts._state.values())
        except Exception:
            log.warning("alert evaluation failed", exc_info=True)
        try:
            with self.loops.tick("interference", interval=iv) as lt:
                lt.items = len(per_node)
                self.interference.observe(ts, per_node)
        except Exception as e:
            weedlog.warning("interference observe failed: %s", e,
                            name="interference", exc_info=True)
        try:
            with self.loops.tick("governor", interval=iv):
                self.governor.tick(ts)
        except Exception as e:
            weedlog.warning("governor tick failed: %s", e,
                            name="governor", exc_info=True)
        try:
            self.loops.refresh_accounting()
        except Exception:
            log.warning("loop accounting refresh failed", exc_info=True)

    # -- historical telemetry, interference, alerts, loops ---------------

    async def _refresh(self, what: str) -> None:
        """One scrape tick before answering (?refresh=1), off the loop:
        the scrape pulls every node's /metrics, this process's servers'
        included."""
        try:
            await asyncio.to_thread(self.aggregator.scrape_once)
        except Exception:
            log.warning("%s refresh pull failed", what, exc_info=True)

    async def handle_cluster_history(self, req: web.Request
                                     ) -> web.Response:
        """/cluster/history?series=&labels=&range=&step=&agg=: aligned
        range vectors out of the history store.  ``labels`` is ``k=v``
        comma-separated; ``agg`` one of min/max/last/sum/avg/rate or pNN
        (histogram quantile over time); ``range``/``step`` in seconds.
        ?refresh=1 scrapes (and so records) once first.  Loopback only:
        it names nodes, data dirs and trace ids."""
        err = trace.loopback_error(req)
        if err is not None:
            return err
        series = req.query.get("series", "").strip()
        if not series:
            return web.json_response(
                {"error": "series required", "status": self.history.status()},
                status=400)
        labels: dict[str, str] = {}
        for part in req.query.get("labels", "").split(","):
            k, sep, v = part.partition("=")
            if sep and k.strip():
                labels[k.strip()] = v.strip()
        try:
            range_s = float(req.query.get("range", "600"))
            step = float(req.query.get("step", "0")) or None
        except ValueError:
            return web.json_response({"error": "bad range/step"},
                                     status=400)
        if req.query.get("refresh"):
            await self._refresh("history")
        agg = req.query.get("agg") or None
        result = await asyncio.to_thread(
            self.history.query, series, labels, range_s, step, agg)
        return web.json_response(result)

    async def handle_cluster_interference(self, req: web.Request
                                          ) -> web.Response:
        """/cluster/interference: the per-node foreground-impact index
        and the governor's rates and retune decisions with their pinned
        trace ids.  ?refresh=1 runs one scrape tick first, which observes
        the fresh deltas and re-ticks the governor.  Loopback only."""
        err = trace.loopback_error(req)
        if err is not None:
            return err
        if req.query.get("refresh"):
            await self._refresh("interference")
        return web.json_response({
            "interference": self.interference.snapshot(),
            "governor": self.governor.status()})

    async def handle_cluster_alerts(self, req: web.Request
                                    ) -> web.Response:
        """/cluster/alerts: each rule's state per label group (ok,
        pending, firing, with hysteresis timestamps and pinned exemplar
        trace ids).  ?refresh=1 runs a scrape tick first.  Loopback
        only."""
        err = trace.loopback_error(req)
        if err is not None:
            return err
        if req.query.get("refresh"):
            await self._refresh("alerts")
        elif self.aggregator.interval > 0 and \
                time.time() - self.alerts.last_eval > \
                max(3 * self.aggregator.interval, 5.0):
            # the rule watching for a dead federation plane must not
            # share its failure domain: a stale last_eval means the
            # aggregator stopped ticking, so evaluate on read
            await asyncio.to_thread(self.alerts.evaluate)
        return web.json_response(self.alerts.status())

    async def handle_cluster_loops(self, req: web.Request
                                   ) -> web.Response:
        """/cluster/loops: per-loop tick wall and CPU seconds, items,
        backlog, overruns and last error for every master loop, plus
        the subsystems' live entry counts.  ?refresh=1 runs a scrape
        tick first.  Loopback only: errors can name nodes and paths."""
        err = trace.loopback_error(req)
        if err is not None:
            return err
        if req.query.get("refresh"):
            await self._refresh("loops")
        st = await asyncio.to_thread(self.loops.status)
        st["headline"] = self.loops.headline()
        return web.json_response(st)

    async def handle_cluster_dashboard(self, req: web.Request
                                       ) -> web.Response:
        """/cluster/dashboard: a self-contained HTML page of SLOs,
        alerts, canary latency, net-flow classes and capacity forecasts
        as inline SVG sparklines from the history store.  Loopback
        only."""
        err = trace.loopback_error(req)
        if err is not None:
            return err
        html = await asyncio.to_thread(history.render_dashboard, self)
        return web.Response(text=html, content_type="text/html")

    # -- fleet fan-out: federation targets, traces, heat, perf -----------

    def _agg_nodes(self) -> dict[str, str]:
        """Every node the aggregator pulls /metrics from: volume servers
        from the topology, filers, gateways and brokers from the member
        registry (fresh within /cluster/status's 30 s horizon)."""
        nodes: dict[str, str] = {}
        with self.topo._lock:
            for n in self.topo.nodes.values():
                nodes[n.url] = n.url
        horizon = time.time() - 30.0
        for members in self.cluster_members.values():
            for addr, ts in members.items():
                if ts > horizon:
                    nodes.setdefault(addr, addr)
        return nodes

    def _fan_debug_traces(self, query: str
                          ) -> tuple[list[tuple[str, list[dict]]],
                                     dict[str, str]]:
        """GET /debug/traces?{query} from every known node ->
        ([(node, traces)], {node: error}): a trace is better partial
        than absent, but a refusing node is still reported."""
        out: list[tuple[str, list[dict]]] = []
        errors: dict[str, str] = {}
        for name, traces_, err in self._fan_get(
                f"/debug/traces?{query}", "trace-pull",
                lambda body: json.loads(body).get("traces", [])):
            out.append((name, traces_ or []))
            if err is not None:
                errors[name] = err
        return out, errors

    def _fan_get(self, path_qs: str, pool_name: str, parse
                 ) -> list[tuple[str, object, str | None]]:
        """GET `path_qs` from every known node over the aggregator's
        (thread-safe) PooledHTTP, fanned out so that a few partitioned
        nodes cost the max, not the sum, of their timeouts ->
        [(node, parsed or None, error or None)] in node order.  Errors
        are reported, not swallowed."""
        nodes = self._agg_nodes()

        def pull(item):
            name, netloc = item
            try:
                status, _, body = self.aggregator.pool.request(
                    f"{tls.scheme()}://{netloc}{path_qs}", timeout=5.0)
                if status != 200:
                    return name, None, f"HTTP {status}"
                return name, parse(body), None
            except Exception as e:
                return name, None, str(e) or type(e).__name__

        if not nodes:
            return []
        with concurrent.futures.ThreadPoolExecutor(
                fanout.workers(len(nodes)), pool_name) as ex:
            return list(ex.map(pull, sorted(nodes.items())))

    def collect_heat(self) -> dict:
        """Every known node's /heat sketch (and this master's own),
        merged into the fleet top-K view (a sync function: the handler
        runs it in a thread)."""
        snaps: list[dict] = [heat.serialize()]
        errors: dict[str, str] = {}
        pulled_nodes: list[str] = []
        # dedupe by tracker id: servers sharing one process serve the
        # same tracker, which merged once per node would inflate every
        # estimate N-fold past its error bound
        seen_ids = {snaps[0].get("id")}
        for name, snap, err in self._fan_get("/heat", "heat-pull",
                                             json.loads):
            if err is not None:
                errors[name] = err
                continue
            pulled_nodes.append(name)
            tid = snap.get("id")
            if tid is None or tid not in seen_ids:
                seen_ids.add(tid)
                snaps.append(snap)
        merged = heat.merge_serialized(snaps)
        merged["nodes"] = sorted(pulled_nodes + [self.url])
        if errors:
            merged["node_errors"] = errors
        with self._heat_lock:
            self._heat_cache = (time.time(), merged)
        return merged

    def cached_heat(self, max_age: float = 5.0) -> dict:
        """The last merged heat view, refreshed when stale."""
        with self._heat_lock:
            cached = self._heat_cache
        if cached is not None and time.time() - cached[0] <= max_age:
            return cached[1]
        return self.collect_heat()

    async def handle_cluster_heat(self, req: web.Request) -> web.Response:
        """/cluster/heat: the fleet-merged top-K hot chunks, volumes and
        tenants.  ?refresh=1 forces a fresh fan-out; otherwise a merge
        up to 5 s old may be served.  Loopback only."""
        err = trace.loopback_error(req)
        if err is not None:
            return err
        if req.query.get("refresh"):
            merged = await asyncio.to_thread(self.collect_heat)
        else:
            merged = await asyncio.to_thread(self.cached_heat)
        return web.json_response(merged)

    def collect_perf(self) -> dict:
        """Every node's /perf payload (and this master's own) merged into
        fleet occupancy per (kind, stage), the worst bottleneck per
        kind, the fleet's roofline rows and worst offenders, the live
        filers' hot tier (`collect_hot_tier`) and the EC volumes' codec
        mix from the beats."""
        per_node: list[tuple[str, dict]] = [
            (self.url, pipeline.local_snapshot())]
        errors: dict[str, str] = {}
        for name, payload, err in self._fan_get("/perf", "perf-pull",
                                                json.loads):
            if err is not None:
                errors[name] = err
            else:
                per_node.append((name, payload))
        out = pipeline.aggregate_fleet(per_node)
        # roofline rows over the deduped nodes, busiest first (servers
        # sharing one process share one kernel profile)
        rows: list[dict] = []
        seen: set[str] = set()
        for node, payload in per_node:
            tid = payload.get("id")
            if tid is not None:
                if tid in seen:
                    continue
                seen.add(tid)
            for row in (payload.get("roofline") or {}).get("rows", []):
                rows.append({"node": node, **row})
        rows.sort(key=lambda r: -r.get("busy_s", 0.0))
        out["roofline"] = rows
        out["offenders"] = pipeline.roofline_offenders({"rows": rows})
        hot = self.collect_hot_tier()
        if hot:
            out["hot_tier"] = hot
        with self.topo._lock:
            ec_vids = {vid for n in self.topo.nodes.values()
                       for vid, s in n.ec_shards.items() if s}
            codec_map = dict(self.topo.ec_codecs)
        per_vol = {str(vid): codec_tags.parse_tag(codec_map.get(vid)).tag
                   for vid in sorted(ec_vids)}
        mix: dict = {}
        for tag in per_vol.values():
            mix[tag] = mix.get(tag, 0) + 1
        out["codecs"] = {"volumes": per_vol, "mix": mix}
        if errors:
            out["node_errors"] = errors
        return out

    def collect_hot_tier(self) -> dict:
        """Pull every live filer's /__hot__/status and fold the event
        ledgers into one fleet view: per-node rows plus summed events and
        the tier-wide hit ratio ((local hits + routed hits) / all chunk
        demands)."""
        horizon = time.time() - 30.0
        filers = sorted(a for a, ts in
                        self.cluster_members.get("filer", {}).items()
                        if ts > horizon)
        if not filers:
            return {}

        def pull(netloc):
            try:
                status, _, body = self.aggregator.pool.request(
                    f"{tls.scheme()}://{netloc}/__hot__/status",
                    timeout=5.0)
                if status != 200:
                    return netloc, None, f"HTTP {status}"
                return netloc, json.loads(body), None
            except Exception as e:
                return netloc, None, str(e) or type(e).__name__

        with concurrent.futures.ThreadPoolExecutor(
                fanout.workers(len(filers)), "hot-pull") as ex:
            pulled = list(ex.map(pull, filers))
        nodes: list[dict] = []
        events: dict[str, int] = {}
        errors: dict[str, str] = {}
        for netloc, payload, err in pulled:
            if err is not None:
                errors[netloc] = err
                continue
            nodes.append(payload)
            for k, v in (payload.get("events") or {}).items():
                events[k] = events.get(k, 0) + int(v)
        hits = events.get("hit_local", 0) + events.get("route_out", 0)
        demands = hits + events.get("direct", 0)
        out = {"nodes": nodes, "events": events,
               "hit_ratio": round(hits / demands, 4) if demands else None}
        if errors:
            out["node_errors"] = errors
        return out

    async def handle_cluster_perf(self, req: web.Request) -> web.Response:
        """/cluster/perf: fleet pipeline occupancy, bottleneck verdicts
        and roofline offenders.  Loopback only."""
        err = trace.loopback_error(req)
        if err is not None:
            return err
        return web.json_response(await asyncio.to_thread(self.collect_perf))

    def collect_trace(self, tid: str, federate: bool = True) -> dict:
        """One trace id -> one parent-ordered waterfall stitched from
        every node's span ring (each pull carries pin=1, so the spans
        survive ring wrap on every hop).  With `federate`, registered
        peer masters are asked for their view of the same id
        (``?local=1`` stops the recursion there)."""
        trace.pin_trace(tid)  # the local ring first (and retro-keep it)
        spans: list[dict] = []
        for rec in trace.traces(tid=tid):
            for s in rec["spans"]:
                s = dict(s)
                s.setdefault("node", self.url)
                spans.append(s)
        pulled, errors = self._fan_debug_traces(f"tid={tid}&pin=1")
        for node, remote in pulled:
            for rec in remote:
                for s in rec.get("spans", []):
                    s = dict(s)
                    s.setdefault("node", node)
                    spans.append(s)
        if federate:
            horizon = time.time() - 30.0
            peers = sorted(
                a for a, ts in self.cluster_members.get(
                    "peer_master", {}).items() if ts > horizon)
            for peer in peers:
                try:
                    status, _, body = self.aggregator.pool.request(
                        f"{tls.scheme()}://{peer}/cluster/trace/{tid}"
                        "?local=1", timeout=5.0)
                    if status == 200:
                        spans.extend(json.loads(body).get("spans", []))
                    elif status != 404:  # absent there is not an error
                        errors[peer] = f"HTTP {status}"
                except Exception as e:
                    errors[peer] = str(e) or type(e).__name__
        wf = trace.assemble(spans)  # dedupes by span id
        if errors:
            wf["node_errors"] = errors
        return wf

    def collect_traces(self, min_ms: float, limit: int
                       ) -> tuple[list[dict], dict[str, str]]:
        """The fleet's recent traces merged by trace id (one request's
        spans live in several rings), newest first, without span bodies,
        and the per-node pull errors."""
        by_tid: dict[str, dict] = {}

        def fold(node: str, recs: list[dict]) -> None:
            for rec in recs:
                tid = rec.get("trace_id")
                if not tid:
                    continue
                agg = by_tid.setdefault(
                    tid, {"trace_id": tid, "start": rec["start"],
                          "end": 0.0, "error": False, "spans": 0,
                          "nodes": set(), "servers": set()})
                agg["start"] = min(agg["start"], rec["start"])
                agg["end"] = max(agg["end"],
                                 rec["start"] + rec["ms"] / 1000.0)
                agg["error"] = agg["error"] or bool(rec.get("error"))
                agg["spans"] += len(rec.get("spans", []))
                agg["nodes"].add(node)
                for s in rec.get("spans", []):
                    server = (s.get("attrs") or {}).get("server")
                    if server:
                        agg["servers"].add(server)

        fold(self.url, trace.traces(min_ms=min_ms, limit=limit))
        pulled, errors = self._fan_debug_traces(
            f"min_ms={min_ms:g}&limit={limit}")
        for node, remote in pulled:
            fold(node, remote)
        out = []
        for agg in by_tid.values():
            ms = (agg.pop("end") - agg["start"]) * 1000.0
            if ms < min_ms:
                continue
            agg["ms"] = round(ms, 3)
            agg["nodes"] = sorted(agg["nodes"])
            agg["servers"] = sorted(agg["servers"])
            out.append(agg)
        out.sort(key=lambda r: r["start"], reverse=True)
        return out[:max(1, limit)], errors

    async def handle_cluster_trace(self, req: web.Request) -> web.Response:
        """/cluster/trace/<tid>: the stitched cross-node waterfall of one
        trace id.  Loopback only."""
        err = trace.loopback_error(req)
        if err is not None:
            return err
        tid = req.match_info["tid"]
        if len(tid) != 32 or any(c not in "0123456789abcdef"
                                 for c in tid):
            return web.json_response({"error": "bad trace id"},
                                     status=400)
        # ?local=1: a federating peer asks; answer from this region only
        result = await asyncio.to_thread(
            self.collect_trace, tid, req.query.get("local") != "1")
        if not result["spans"]:
            # node_errors stay in the 404: "trace expired" and "every
            # node's debug gate refused the master" must be told apart
            return web.json_response(
                {"error": "trace not found on any node",
                 "trace_id": tid,
                 "node_errors": result.get("node_errors", {})},
                status=404)
        return web.json_response(result)

    async def handle_cluster_traces(self, req: web.Request
                                    ) -> web.Response:
        err = trace.loopback_error(req)
        if err is not None:
            return err
        try:
            min_ms = float(req.query.get("min_ms", "0"))
        except ValueError:
            min_ms = 0.0
        try:
            limit = int(req.query.get("limit", "50"))
        except ValueError:
            limit = 50
        traces_, errors = await asyncio.to_thread(
            self.collect_traces, min_ms, limit)
        return web.json_response({"traces": traces_,
                                  "node_errors": errors})

    async def handle_cluster_canary(self, req: web.Request
                                    ) -> web.Response:
        """The canary's per-path outcomes, latency quantiles, pinned
        trace ids and the last failure's waterfall.  ?probe=1 runs one
        probe round inline.  Loopback only."""
        err = trace.loopback_error(req)
        if err is not None:
            return err
        if req.query.get("probe"):
            await self.canary.run_once()
        return web.json_response(self.canary.status())

    # -- handlers ------------------------------------------------------

    # the whitelist guards client-facing endpoints only: volume servers must
    # always heartbeat and Prometheus must always scrape (the reference
    # guards HTTP handlers while heartbeats ride unguarded gRPC)
    # scrub reports ride the same trust boundary as heartbeats: volume
    # servers must always be able to deliver verdicts
    _UNGUARDED = ("/heartbeat", "/metrics", "/maintenance/scrub_report")

    @web.middleware
    async def _guard_middleware(self, req: web.Request, handler):
        """IP-whitelist guard on master endpoints (security/guard.go)."""
        if self.guard and req.remote and req.path not in self._UNGUARDED \
                and not self.guard.is_allowed(req.remote):
            return web.json_response({"error": "forbidden"}, status=403)
        return await handler(req)

    async def handle_ui(self, req: web.Request) -> web.Response:
        """Operator status page with live topology, volume and EC shard
        tables (reference: weed/server/master_ui/templates.go)."""
        topo = self.topo.to_dict()
        node_rows = []
        vol_rows = []
        ec_map: dict[str, dict[int, list[str]]] = {}
        for nid, n in sorted(topo.get("nodes", {}).items()):
            node_rows.append([nid, n.get("dc", ""), n.get("rack", ""),
                              len(n.get("volume_infos", [])),
                              n.get("free_slots", 0),
                              sum(len(s) for s in
                                  n.get("ec_shards", {}).values())])
            for v in n.get("volume_infos", []):
                vol_rows.append([
                    v["id"], v.get("collection", "") or "-", nid,
                    ui.fmt_bytes(v.get("size", 0)),
                    v.get("file_count", 0),
                    v.get("replica_placement", "000"),
                    v.get("ttl", "") or "-", v.get("read_only", False)])
            for vid, shards in n.get("ec_shards", {}).items():
                for s in shards:
                    ec_map.setdefault(vid, {}).setdefault(s, []).append(nid)
        vol_rows.sort(key=lambda r: (r[0], r[2]))
        ec_rows = [[vid,
                    " ".join(f"{s}:{','.join(nodes)}"
                             for s, nodes in sorted(shards.items())),
                    len(shards)]
                   for vid, shards in sorted(ec_map.items(),
                                             key=lambda kv: int(kv[0]))]
        return web.Response(text=ui.render(
            f"weedtpu master {self.url}",
            {"cluster": ui.Table(
                ["leader", "this node is leader", "max volume id",
                 "volume size limit"],
                [[self.leader_url or "-", self.is_leader,
                  topo.get("max_volume_id", 0),
                  ui.fmt_bytes(topo.get("volume_size_limit", 0))]]),
             "members": ui.Table(
                ["role", "nodes"],
                [[k, ", ".join(sorted(v))]
                 for k, v in sorted(self.cluster_members.items())]),
             "topology": ui.Table(
                ["node", "dc", "rack", "volumes", "free slots",
                 "ec shards"], node_rows),
             "volumes": ui.Table(
                ["id", "collection", "node", "size", "files",
                 "replication", "ttl", "read-only"], vol_rows),
             "ec shard map": ui.Table(
                ["volume", "shard -> nodes", "present shards"], ec_rows),
             "writables": {k: v for k, v in
                           topo.get("writables", {}).items()}},
            links={"metrics": "/metrics", "topology json": "/dir/status",
                   "cluster json": "/cluster/status"}),
            content_type="text/html")

    async def handle_metrics(self, req: web.Request) -> web.Response:
        return metrics.scrape_response(req)

    async def handle_cluster_metrics(self, req: web.Request
                                     ) -> web.Response:
        """Fleet federation: every known node's /metrics merged into one
        exposition with a `node` label per sample.  ?refresh=1 pulls
        first; otherwise the background loop's last pull is served,
        refreshed only when stale."""
        try:
            await asyncio.to_thread(
                self.aggregator.ensure_fresh,
                0.0 if req.query.get("refresh") else None)
        except Exception:
            log.warning("cluster metrics pull failed", exc_info=True)
        return web.Response(text=self.aggregator.render(),
                            content_type="text/plain")

    async def handle_cluster_slo(self, req: web.Request) -> web.Response:
        """Burn-rate SLO evaluation over the merged fleet metrics;
        ?refresh=1 pulls before evaluating."""
        try:
            # the backlog rule reads the VOLUME_HEALTH gauge, which only
            # moves when the ledger is rebuilt — and the repair loop
            # (its usual rebuilder) parks while operators hold the admin
            # lock, exactly when they are ASKING about backlog
            self.maintenance.ledger()
            await asyncio.to_thread(
                self.aggregator.ensure_fresh,
                0.0 if req.query.get("refresh") else None)
        except Exception:
            log.warning("cluster slo pull failed", exc_info=True)
        return web.json_response(self.aggregator.slo_status())

    async def handle_heartbeat(self, req: web.Request) -> web.Response:
        if not self.is_leader:
            return self._not_leader_response()
        metrics.MASTER_RECEIVED_HEARTBEATS.labels().inc()
        if req.content_type == pb.CONTENT_TYPE:
            # binary framing (reference: master.proto Heartbeat); 415 when
            # this master cannot decode it, so senders fall back to JSON
            if not pb.available():
                return web.Response(status=415)
            try:
                beat = pb.heartbeat_from_bytes(await req.read())
            except Exception as e:
                # a corrupt frame must not 500: senders only latch the
                # JSON fallback on 415, so a persistent DecodeError would
                # otherwise fail every heartbeat from that sender
                return web.json_response(
                    {"error": f"bad protobuf heartbeat: {e}"}, status=400)
        else:
            try:
                beat = await req.json()
            except ValueError:
                return web.json_response(
                    {"error": "bad json heartbeat"}, status=400)
        if beat.get("max_file_key"):
            self.topo.sequencer.set_max(int(beat["max_file_key"]))
        self.topo.register_heartbeat(
            node_id=beat["id"], url=beat["url"],
            public_url=beat.get("public_url", ""),
            dc=beat.get("data_center", ""), rack=beat.get("rack", ""),
            beat=beat)
        return web.json_response({
            "volume_size_limit": self.topo.volume_size_limit,
        })

    async def handle_assign(self, req: web.Request) -> web.Response:
        if not self.is_leader:
            return self._not_leader_response()
        q = req.query
        count = int(q.get("count", "1"))
        collection = q.get("collection", "")
        replication = q.get("replication") or self.topo.default_replication
        ttl = q.get("ttl", "")

        picked = self.topo.pick_for_write(collection, replication, ttl)
        if picked is None:
            async with self._grow_lock:
                picked = self.topo.pick_for_write(collection, replication, ttl)
                if picked is None:
                    grown = await self._grow(collection, replication, ttl,
                                             self.grow_count)
                    if not grown:
                        return web.json_response(
                            {"error": "no free volumes and cannot grow"},
                            status=500)
                picked = self.topo.pick_for_write(collection, replication, ttl)
        if picked is None:
            return web.json_response({"error": "no writable volume"}, status=500)
        vid, nodes = picked
        key = self.topo.sequencer.next_ids(count)
        cookie = secrets.randbits(32)
        fid = t.FileId(vid, key, cookie)
        node = nodes[0]
        metrics.MASTER_ASSIGN_COUNTER.labels(collection).inc()
        resp = {
            "fid": str(fid), "count": count,
            "url": node.url, "publicUrl": node.public_url,
        }
        # per-fid write JWT, like the reference Assign response
        # (master_grpc_server_assign.go:119)
        if self.security is not None and self.security.volume_write:
            resp["auth"] = gen_jwt(self.security.volume_write, str(fid))
        return web.json_response(resp)

    async def handle_lookup(self, req: web.Request) -> web.Response:
        # the fan-in the gateway vid caches exist to absorb
        metrics.MASTER_LOOKUPS.labels().inc()
        raw = req.query.get("volumeId", "")
        vid = int(raw.partition(",")[0])
        nodes = self.topo.lookup(vid, req.query.get("collection", ""))
        if not nodes:
            # a raft follower's topology is empty (heartbeats only reach
            # the leader): a local miss there means "ask the leader", not
            # "volume gone"; without the 409 a client that landed on a
            # follower after a failover would read every volume as deleted
            if not self.is_leader:
                return self._not_leader_response()
            return web.json_response(
                {"volumeId": raw, "error": "volume id not found"}, status=404)
        return web.json_response({
            "volumeId": raw,
            "locations": [{"url": n.url, "publicUrl": n.public_url}
                          for n in nodes],
        })

    async def handle_ec_lookup(self, req: web.Request) -> web.Response:
        vid = int(req.query.get("volumeId", "0"))
        shards = self.topo.lookup_ec_shards(vid)
        if shards is None:
            if not self.is_leader:  # the follower-miss redirect of
                return self._not_leader_response()  # handle_lookup
            return web.json_response({"error": "not an ec volume"}, status=404)
        return web.json_response({
            "volumeId": vid,
            # dc/rack ride along so readers can rank candidates by
            # locality (same-rack survivor fetches before cross-rack)
            "shards": {str(sid): [{"url": n.url, "publicUrl": n.public_url,
                                   "dc": n.dc, "rack": n.rack}
                                  for n in nodes]
                       for sid, nodes in shards.items()},
        })

    def _vid_event(self, vid: int) -> dict:
        nodes = self.topo.lookup(vid)
        return {"vid": vid,
                "locations": [{"url": n.url, "publicUrl": n.public_url}
                              for n in nodes]}

    def _push_vid_change(self, vid: int) -> None:
        """Topology hook: fan a volume-location delta out to every
        /cluster/stream subscriber (runs on the event loop: heartbeats
        are handled there)."""
        if not self._vid_subscribers:
            return
        ev = self._vid_event(vid)
        for q in list(self._vid_subscribers):
            if q.qsize() < 10000:  # a stuck client must not hoard memory
                q.put_nowait(ev)

    async def handle_cluster_stream(self, req: web.Request) -> web.StreamResponse:
        """NDJSON push of volume-location deltas (the reference's
        KeepConnected stream, wdclient/masterclient.go:20-45): a snapshot
        of every known vid first, then live updates; an empty `locations`
        list means the volume is gone."""
        resp = web.StreamResponse()
        resp.content_type = "application/x-ndjson"
        await resp.prepare(req)
        q: asyncio.Queue = asyncio.Queue()
        self._vid_subscribers.add(q)
        try:
            with self.topo._lock:
                vids = sorted({vid for n in self.topo.nodes.values()
                               for vid in n.volumes} |
                              {vid for n in self.topo.nodes.values()
                               for vid, s in n.ec_shards.items() if s})
            for vid in vids:
                await resp.write(json.dumps(self._vid_event(vid)).encode()
                                 + b"\n")
            await resp.write(b'{"snapshot_end": true}\n')
            while True:
                try:
                    ev = await asyncio.wait_for(q.get(), timeout=10.0)
                except asyncio.TimeoutError:
                    await resp.write(b'{"ping": true}\n')  # liveness probe
                    continue
                if ev is None:  # server shutting down
                    break
                await resp.write(json.dumps(ev).encode() + b"\n")
        except (ConnectionResetError, asyncio.CancelledError, OSError):
            pass
        finally:
            self._vid_subscribers.discard(q)
        return resp

    async def handle_dir_status(self, req: web.Request) -> web.Response:
        """Topology snapshot (reference: master /dir/status,
        master_server_handlers_admin.go dirStatusHandler)."""
        return web.json_response({"Topology": self.topo.to_dict()})

    async def handle_cluster_status(self, req: web.Request) -> web.Response:
        # members go stale when their register loop stops (reference:
        # cluster.go removes nodes on connection loss): 30 s covers three
        # missed 10 s registration beats
        horizon = time.time() - 30.0
        return web.json_response({
            "IsLeader": self.is_leader,
            "Leader": self.leader_url,
            "Topology": self.topo.to_dict(),
            "Members": {k: sorted(a for a, ts in v.items() if ts > horizon)
                        for k, v in self.cluster_members.items() if v},
        })

    async def handle_grow(self, req: web.Request) -> web.Response:
        q = req.query
        n = await self._grow(q.get("collection", ""),
                             q.get("replication") or self.topo.default_replication,
                             q.get("ttl", ""), int(q.get("count", "1")))
        if n == 0:
            return web.json_response({"error": "growth failed"}, status=500)
        return web.json_response({"count": n})

    # -- admin lock (shell exclusivity) --------------------------------

    async def handle_lock(self, req: web.Request) -> web.Response:
        body = await req.json()
        now = time.time()
        if self._admin_lock and now - self._admin_lock[2] < 30:
            return web.json_response(
                {"error": f"locked by {self._admin_lock[1]}"}, status=409)
        token = secrets.token_hex(8)
        self._admin_lock = (token, body.get("owner", "?"), now)
        return web.json_response({"token": token})

    async def handle_renew_lock(self, req: web.Request) -> web.Response:
        body = await req.json()
        if not self._admin_lock or self._admin_lock[0] != body.get("token"):
            return web.json_response({"error": "not lock owner"}, status=409)
        self._admin_lock = (self._admin_lock[0], self._admin_lock[1], time.time())
        return web.json_response({})

    async def handle_unlock(self, req: web.Request) -> web.Response:
        body = await req.json()
        if self._admin_lock and self._admin_lock[0] == body.get("token"):
            self._admin_lock = None
        return web.json_response({})

    # -- growth --------------------------------------------------------

    def _allocate_vid(self) -> int | None:
        """Next volume id; raft-replicated when HA is on (the reference
        persists MaxVolumeId through raft the same way)."""
        if self.raft is None:
            return self.topo.next_volume_id()
        with self.topo._lock:
            # reserve locally before proposing: the raft apply loop runs
            # async, and a second allocation must not read the stale max
            # (apply's max() keeps this idempotent)
            self.topo.max_volume_id += 1
            vid = self.topo.max_volume_id
        if not self.raft.propose({"op": "set_max_vid", "vid": vid}):
            return None
        return vid

    async def _grow(self, collection: str, replication: str, ttl: str,
                    count: int) -> int:
        """Allocate `count` new volumes on free nodes (reference:
        volume_growth.go GrowByCountAndType -> AllocateVolume RPCs)."""
        rp = t.ReplicaPlacement.parse(replication)
        if count <= 0:
            # reference volume_growth defaults: more copies -> fewer new
            # volumes per grow (copy_1=7, copy_2=6, copy_3=3, else 1)
            count = {1: 7, 2: 6, 3: 3}.get(rp.copy_count, 1)
            # cap by what the cluster can actually host
            free = sum(n.free_slots for n in self.topo.nodes.values())
            count = max(1, min(count, free // max(1, rp.copy_count)))
        slots = self.topo.find_empty_slots(rp, count)
        if not slots:
            return 0
        grown = 0
        for replica_set in slots:
            vid = await asyncio.to_thread(self._allocate_vid)
            if vid is None:
                log.warning("vid allocation failed (lost leadership?)")
                break
            ok = True
            for node in replica_set:
                try:
                    async with self._session.post(
                            f"{tls.scheme()}://{node.url}/admin/assign_volume",
                            json={"volume": vid, "collection": collection,
                                  "replication": replication, "ttl": ttl}) as r:
                        ok &= r.status == 200
                except aiohttp.ClientError as e:
                    log.warning("assign_volume to %s failed: %s", node.url, e)
                    ok = False
            if ok:
                # register optimistically so the next pick_for_write can use
                # the volume before the next heartbeat lands
                for node in replica_set:
                    v = VolumeState(id=vid, collection=collection,
                                    replica_placement=replication, ttl=ttl)
                    node.volumes[v.id] = v
                    self.topo.layout(collection, replication, ttl).register(v, node)
                # heartbeats will see prev==new for this vid, so the
                # stream event must fire here
                self.topo._vids_changed({vid})
                grown += 1
        return grown
