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

The master has no device: it keeps soft state and routes requests.  Its
volume servers run the kernels.

Left out until the modules that serve them are ported (ROADMAP 1.18c,
1.18d): the routes of `LEFT_OUT`, which answer 404, and the planes
behind them (the repair planner, the conversion scheduler, the loop
monitor, the metrics aggregator, history, alerts, the capacity
forecaster, the autopilot, the interference governor and the canary).
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import secrets
import time
import urllib.error
import urllib.request
import zlib

import aiohttp
from aiohttp import web

from seaweedfs_tpu_torch import pb
from seaweedfs_tpu_torch.maintenance import faults
from seaweedfs_tpu_torch.security import tls
from seaweedfs_tpu_torch.security.jwt import gen_jwt
from seaweedfs_tpu_torch.server import ui
from seaweedfs_tpu_torch.stats import (heat, metrics, netflow, pipeline,
                                       profile, trace)
from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.topology.raft import RaftConfig, RaftNode
from seaweedfs_tpu_torch.topology.sequence import SnowflakeSequencer
from seaweedfs_tpu_torch.topology.topology import Topology, VolumeState
from seaweedfs_tpu_torch.utils.http import aiohttp_trace_config

log = logging.getLogger("master")

# the reference master's routes that come with its planes: the
# maintenance plane (ROADMAP 1.18d) and the observability planes (1.18c)
LEFT_OUT = (
    "/maintenance/status", "/maintenance/scrub_report", "/maintenance/tick",
    "/maintenance/convert",
    "/cluster/metrics", "/cluster/slo", "/cluster/heat", "/cluster/perf",
    "/cluster/trace/{tid}", "/cluster/traces", "/cluster/canary",
    "/cluster/history", "/cluster/interference", "/cluster/autopilot",
    "/cluster/alerts", "/cluster/loops", "/cluster/dashboard",
    "/cluster/geo",
)


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
            web.post("/raft/peers/add", self.handle_raft_peer_add),
            web.post("/raft/peers/remove", self.handle_raft_peer_remove),
            web.get("/raft/status", self.handle_raft_status),
            web.post("/raft/request_vote", self.handle_raft_vote),
            web.post("/raft/append_entries", self.handle_raft_append),
            web.post("/raft/install_snapshot", self.handle_raft_install),
            web.get("/metrics", self.handle_metrics),
            web.get("/heat", heat.handle_heat),
            web.get("/perf", pipeline.handle_perf),
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
        profile.ensure_started()  # WEEDTPU_PROFILE_HZ, process-wide
        faults.register_node(self.url, "master")
        if self.region:
            faults.register_region(self.url, self.region)
        if self.raft:
            self.raft.start()
        log.info("master listening on %s", self.url)

    async def stop(self) -> None:
        if self.raft:
            self.raft.stop()
        if self._expire_task:
            self._expire_task.cancel()
        # wake /cluster/stream subscribers so their handlers return and
        # runner.cleanup() doesn't wait out its shutdown timeout on them
        for q in list(self._vid_subscribers):
            q.put_nowait(None)
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
            for nid in self.topo.expire_dead_nodes(self.node_timeout):
                log.warning("volume server %s expired from topology", nid)
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
