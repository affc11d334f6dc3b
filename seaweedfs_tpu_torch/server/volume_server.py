"""Volume server: the HTTP blob data path and the volume and EC admin.

Counterpart of `seaweedfs_tpu/server/volume_server.py`, cut to the
serving core that the reference master, shell and clients drive
(reference: weed/server/volume_server_handlers_write.go, _read.go,
volume_grpc_erasure_coding.go):

  POST/PUT /{fid}   upload (raw body or multipart); ?type=replicate marks
                    a forwarded replica write (no re-fan-out)
  GET/HEAD /{fid}   read; EC volumes are served transparently and a
                    degraded read reconstructs online on the store's
                    device, pulling shards it lacks from peers
  DELETE /{fid}     delete (+ replica fan-out)

and the admin routes behind the shell's `ec.encode`, `ec.rebuild`,
`ec.decode` and `volume.*` commands: assign, delete, leave, readonly,
configure_replication, mount, unmount, vacuum; EC generate, progress,
cancel, rebuild, mount, unmount, delete_shards, copy, to_volume,
shard_read; and the peer file pull.  The routes the reference master's
autopilot, repair and shell drive:

  POST /admin/volume/copy      pull a volume from a peer (temp names, the
                               CRC computed while streaming); `staging`
                               keeps it read-only and out of the beat
                               until `finalize`; a volume already here
                               catches up incrementally (the .dat tail)
  POST /admin/volume/move      freeze, staged copy to the target, CRC
                               check, finalize, retire the source
  POST /admin/volume/unconvert an EC volume back to a writable volume:
                               missing data shards rebuilt on the store's
                               device (K1), decode, thaw, shards retired
  POST /admin/volume/tier_move, /admin/volume/tier_download
  GET  /admin/volume/needles   the live needle ids
  POST /admin/query            JSON documents filtered and projected
  POST /admin/scrub            one scrub pass now (loopback only); the
                               background Scrubber runs every
                               WEEDTPU_SCRUB_INTERVAL at
                               WEEDTPU_SCRUB_MBPS and reports each pass
                               to the master's /maintenance/scrub_report
  POST /admin/scrub_rate       the operator's `mbps` or the governor's
                               `scale`, applied mid-pass
  POST /admin/faults           storage faults, the shard-read and
                               file-pull delays, and the process-wide
                               network faults (loopback only)
  POST /admin/ec/fleet_convert several local volumes into shard sets in
                               one stream of batched launches (K2)
  POST /admin/ec/partial       a repair helper's partial product of its
                               shard ranges (K1), MSR sub-rows included
  POST /admin/ec/rebuild       with `reduced`: the reduced-read rebuild,
                               pulling partials from the helpers
  GET  /admin/ec/probe_read    the canary's degraded read of one needle
  POST /admin/ec/recode        an EC volume re-encoded under another code
  GET  /heat, /perf            the heat sketches and the pipeline
                               snapshot, for the master's fan-outs
  GET  /debug/traces, /debug/requests, /debug/pprof, /debug/pipeline
                               (loopback only)

Differences from the reference, kept on purpose:
- `VolumeServer(..., device=None)` resolves its device once, through its
  `Store` (None: the card, raising without one; "cpu": the plain
  version), and every codec it builds runs there: the EC volumes it
  mounts, the encode of `/admin/ec/generate`, the rebuilds of
  `/admin/ec/rebuild`, `/admin/ec/to_volume` and
  `/admin/volume/unconvert`, the fleet conversion, the helper's partial,
  the recode and its remount, where the reference passes no device;
- `weedtpu_ec_encode_bytes_total` labels an encode by the store's device
  type ("cuda", "cpu") where the reference writes "tpu";
- a malformed WEEDTPU_SCRUB_* or WEEDTPU_PROFILE_HZ knob or
  WEEDTPU_FAULTS directive raises at start, before the socket binds,
  where the reference falls back or drops it;
- a blob read of a volume on a remote tier runs on a pool of the
  server's own (`TIER_READ_THREADS`), not the loop's default pool
  (ROADMAP fault 3.15): where the tier target is served by this same
  server (a gateway over its filer), the reference's tier reads hold the
  default pool's threads while the gateway's reads wait for one.
"""

from __future__ import annotations

import asyncio
import contextvars
import functools
import json
import logging
import os
import threading
import time
import urllib.error
import urllib.request
import zlib
from concurrent.futures import ThreadPoolExecutor

import aiohttp
import numpy as np
from aiohttp import web

from seaweedfs_tpu_torch import pb
from seaweedfs_tpu_torch.maintenance import faults
from seaweedfs_tpu_torch.maintenance import scrub as scrubmod
from seaweedfs_tpu_torch.ops import codecs, dispatch, fleet_convert, regen
from seaweedfs_tpu_torch.security import jwt as sjwt
from seaweedfs_tpu_torch.security import tls
from seaweedfs_tpu_torch.stats import (heat, metrics, netflow, pipeline,
                                       profile, trace)
from seaweedfs_tpu_torch.storage import needle as ndl
from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage.ec import ec_files, layout
from seaweedfs_tpu_torch.storage.ec import ec_volume as ecv
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.storage.super_block import SuperBlock
from seaweedfs_tpu_torch.storage.volume import Volume
from seaweedfs_tpu_torch.topology.topology import (locality_class,
                                                    locality_name)
from seaweedfs_tpu_torch.utils import resilience, weedlog
from seaweedfs_tpu_torch.utils.http import (aiohttp_trace_config,
                                            parse_range, post_json)

log = logging.getLogger("volume")

EC_FILE_EXTS = [layout.to_ext(i)
                for i in range(layout.MAX_TOTAL_SHARDS)] + \
    [".ecx", ".ecj", ".vif"]

try:
    from aiohttp.http_writer import StreamWriter as _AioSW
    from aiohttp.http_writer import _serialize_headers as _ser_headers
    # write_eof leans on these writer privates too: probe them all, so a
    # partial aiohttp internals change disables the fast path instead of
    # failing the hottest GET route
    if not all(hasattr(_AioSW, a)
               for a in ("_writelines", "_write", "chunked")):
        _ser_headers = None
except ImportError:  # aiohttp internals moved: two writes, as stock
    _ser_headers = None

# responses that went out in one transport write, and those that took
# aiohttp's stock two-write path
ONE_SHOT = {"one_write": 0, "stock": 0}


class _OneShotResponse(web.Response):
    """web.Response that defers the header write and flushes headers+body
    in ONE transport write.  Stock aiohttp issues two socket sends per
    response (headers at prepare, body at write_eof); on syscall-taxed
    hosts that second send is a measurable slice of a small-blob GET, and
    the blob read path is exactly small responses at high rate.  Any
    non-simple shape (chunked, compressed, payload body, empty-body
    methods) falls back to the stock path."""

    async def _write_headers(self) -> None:
        if _ser_headers is None:
            return await super()._write_headers()
        version = self._req.version
        status_line = (f"HTTP/{version[0]}.{version[1]} "
                       f"{self._status} {self._reason}")
        self._hdr_buf = _ser_headers(status_line, self._headers)

    async def write_eof(self, data: bytes = b"") -> None:
        buf = getattr(self, "_hdr_buf", None)
        if buf is None:
            ONE_SHOT["stock"] += 1
            return await super().write_eof(data)
        self._hdr_buf = None
        writer = self._payload_writer
        try:
            # everything read here is aiohttp-private; an internals
            # change must degrade to the stock two-write path (no bytes
            # are on the wire yet)
            from aiohttp.payload import Payload
            body = (self._body if self._compressed_body is None
                    else self._compressed_body)
            simple = (writer is not None and not self._eof_sent
                      and not writer.chunked and writer._compress is None
                      and not self._must_be_empty_body
                      and not isinstance(body, Payload) and not data)
        except AttributeError:
            simple = False
        if not simple:
            ONE_SHOT["stock"] += 1
            if writer is not None and not self._eof_sent:
                writer._write(buf)
            return await super().write_eof(data)
        ONE_SHOT["one_write"] += 1
        if body:
            if writer.length is not None:
                writer.length = max(0, writer.length - len(body))
            writer._writelines((buf, body))
        else:
            writer._write(buf)
        await web.StreamResponse.write_eof(self)


class VolumeServer:
    # in-flight throttling (reference: volume server
    # -concurrentUploadLimitMB / inFlightUploadDataLimitCond)
    CONCURRENT_UPLOADS = 64
    CONCURRENT_DOWNLOADS = 256
    PAGED_READ_MIN = 256 * 1024  # Range on bigger needles skips full load
    # small plain-volume needles are pread directly on the event loop:
    # cheaper than a thread-pool round-trip per request when the pages
    # are cache-resident.  A cold page stalls the loop for one disk read,
    # so deployments whose working set exceeds RAM set
    # WEEDTPU_INLINE_READ_MAX=0 to send every read through the pool
    INLINE_READ_MAX = int(os.environ.get("WEEDTPU_INLINE_READ_MAX",
                                         str(64 * 1024)))
    # threads of the pool that reads volumes on a remote tier (3.15)
    TIER_READ_THREADS = 4

    def __init__(self, directories: list[str], master_url: str,
                 host: str = "127.0.0.1", port: int = 8080,
                 public_url: str = "", max_volumes: int = 8,
                 data_center: str = "", rack: str = "",
                 heartbeat_interval: float = 3.0, security=None,
                 device=None):
        self.security = security
        self.host, self.port = host, port
        self.url = f"{host}:{port}"
        self.public_url = public_url or self.url
        # comma-separated master list (HA): heartbeats follow the leader
        self.master_urls = [m.strip() for m in master_url.split(",")
                            if m.strip()]
        self.master_url = self.master_urls[0]
        self.data_center, self.rack = data_center, rack
        self.heartbeat_interval = heartbeat_interval
        self.store = Store(directories, max_volumes, self.public_url,
                           device=device)
        self._tier_pool: ThreadPoolExecutor | None = None  # at first use
        self.volume_size_limit = 30 * 1024 * 1024 * 1024

        self.app = web.Application(
            client_max_size=256 * 1024 * 1024,
            middlewares=[trace.aiohttp_middleware("volume")])
        netflow.install(self.app, "volume")
        self.app.add_routes(trace.debug_routes())
        self.app.add_routes([
            web.get("/", self.handle_ui),
            web.get("/status", self.handle_status),
            web.get("/metrics", self.handle_metrics),
            web.get("/heat", heat.handle_heat),
            web.get("/perf", pipeline.handle_perf),
            web.post("/admin/assign_volume", self.handle_assign_volume),
            web.post("/admin/volume/delete", self.handle_volume_delete),
            web.post("/admin/leave", self.handle_leave),
            web.post("/admin/volume/readonly", self.handle_volume_readonly),
            web.post("/admin/volume/configure_replication",
                     self.handle_configure_replication),
            web.post("/admin/volume/mount", self.handle_volume_mount),
            web.post("/admin/volume/unmount", self.handle_volume_unmount),
            web.post("/admin/volume/vacuum", self.handle_vacuum),
            web.post("/admin/volume/copy", self.handle_volume_copy),
            web.post("/admin/volume/move", self.handle_volume_move),
            web.post("/admin/volume/unconvert",
                     self.handle_volume_unconvert),
            web.post("/admin/volume/tier_move", self.handle_tier_move),
            web.post("/admin/volume/tier_download",
                     self.handle_tier_download),
            web.get("/admin/volume/needles", self.handle_volume_needles),
            web.post("/admin/ec/generate", self.handle_ec_generate),
            web.get("/admin/ec/progress", self.handle_ec_progress),
            web.post("/admin/ec/cancel", self.handle_ec_cancel),
            web.post("/admin/ec/rebuild", self.handle_ec_rebuild),
            web.post("/admin/ec/mount", self.handle_ec_mount),
            web.post("/admin/ec/unmount", self.handle_ec_unmount),
            web.post("/admin/ec/delete_shards", self.handle_ec_delete_shards),
            web.post("/admin/ec/copy", self.handle_ec_copy),
            web.post("/admin/ec/to_volume", self.handle_ec_to_volume),
            web.get("/admin/ec/shard_read", self.handle_ec_shard_read),
            web.post("/admin/ec/fleet_convert",
                     self.handle_ec_fleet_convert),
            web.post("/admin/ec/recode", self.handle_ec_recode),
            web.post("/admin/ec/partial", self.handle_ec_partial),
            web.get("/admin/ec/probe_read", self.handle_ec_probe_read),
            web.post("/admin/scrub", self.handle_scrub),
            web.post("/admin/scrub_rate", self.handle_scrub_rate),
            web.post("/admin/faults", self.handle_faults),
            web.get("/admin/file", self.handle_file_pull),
            web.post("/admin/query", self.handle_query),
            web.route("*", "/{fid:[^/]*,[^/]+}", self.handle_blob),
        ])
        self._upload_sem = asyncio.Semaphore(self.CONCURRENT_UPLOADS)
        self._download_sem = asyncio.Semaphore(self.CONCURRENT_DOWNLOADS)
        # vid -> live EC job state (observable and cancellable)
        self._ec_jobs: dict[int, dict] = {}
        self._runner: web.AppRunner | None = None
        self._session: aiohttp.ClientSession | None = None
        self._hb_task: asyncio.Task | None = None
        self._wire_pb: bool | None = None  # protobuf heartbeat framing
        self._left = False
        # vid -> (expiry, shard location map) for degraded-read fan-out;
        # read from shard_reader worker threads, hence the locks.  The
        # master fetch runs under a per-vid lock, so a stalled lookup for
        # one volume cannot serialize degraded reads of every other
        # volume; _ec_loc_lock guards only the cache and lock tables
        self._ec_loc_cache: dict[int, tuple[float, dict]] = {}
        self._ec_loc_lock = threading.Lock()
        self._ec_loc_vid_locks: dict[int, threading.Lock] = {}
        # the background scrubber (None when WEEDTPU_SCRUB_MBPS=0) and
        # the injected delays of /admin/faults
        self.scrubber: scrubmod.Scrubber | None = None
        self._fault_delay_shard_read = 0.0
        self._fault_delay_file_pull = 0.0
        # vids with an /admin/volume/move in flight from this server: a
        # second move of the same volume would stage and commit a second
        # live copy
        self._moves_active: set[int] = set()

    @property
    def device(self):
        return self.store.device

    # -- lifecycle -----------------------------------------------------

    async def start(self) -> None:
        # the background scrubber (WEEDTPU_SCRUB_MBPS=0 disables it), the
        # profiler's rate and the fault plan are read before the server
        # binds, so a malformed knob or directive fails the start cleanly
        plan = faults.parse_env(os.environ.get("WEEDTPU_FAULTS", ""))
        profile.profile_hz()
        mbps = scrubmod.env_mbps()
        if mbps > 0:
            self.scrubber = scrubmod.Scrubber(
                self.store, mbps=mbps, report=self._report_scrub,
                shard_reader_factory=self._shard_reader)
        self._session = aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(ssl=tls.client_ssl()),
            timeout=aiohttp.ClientTimeout(total=300),
            trace_configs=[aiohttp_trace_config("volume")])
        self._runner = web.AppRunner(self.app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.host, self.port,
                           ssl_context=tls.server_ssl("volume"))
        await site.start()
        try:
            await self._heartbeat_once()
        except aiohttp.ClientError as e:
            # master not up yet; the heartbeat loop keeps retrying (and
            # rotates through -mserver candidates under HA)
            log.warning("initial heartbeat failed: %s", e)
            if len(self.master_urls) > 1:
                i = self.master_urls.index(self.master_url)
                self.master_url = self.master_urls[
                    (i + 1) % len(self.master_urls)]
        self._hb_task = asyncio.create_task(self._heartbeat_loop())
        profile.ensure_started()  # WEEDTPU_PROFILE_HZ, process-wide
        # the fault plan from the environment (maintenance/faults.py);
        # the role lets a partition of "volume" find this server's dials
        faults.register_node(self.url, "volume")
        for f in plan:
            if f["action"] == "delay_shard_read":
                self._fault_delay_shard_read = f["ms"] / 1000.0
            elif f["action"] == "delay_file_pull":
                self._fault_delay_file_pull = f["ms"] / 1000.0
            else:
                res = faults.apply(self.store, f)
                if not res["ok"]:
                    log.warning("env fault %s failed", res)
        if self.scrubber is not None:
            self.scrubber.start()
        log.info("volume server on %s (dirs=%s, device=%s)", self.url,
                 [loc.directory for loc in self.store.locations],
                 self.device)

    async def stop(self) -> None:
        if self.scrubber is not None:
            await asyncio.to_thread(self.scrubber.stop)
        if self._hb_task:
            self._hb_task.cancel()
        if self._session:
            await self._session.close()
        if self._runner:
            await self._runner.cleanup()
        if self._tier_pool is not None:
            self._tier_pool.shutdown(wait=False, cancel_futures=True)
        self.store.close()
        # retire this instance's capacity series from the process-wide
        # registry: a stopped server must not leave stale series behind
        metrics.DISK_BYTES.remove_matching(vs=self.url)
        metrics.VOLUME_SIZE.remove_matching(vs=self.url)

    async def _heartbeat_loop(self) -> None:
        while True:
            await asyncio.sleep(self.heartbeat_interval)
            try:
                await self._heartbeat_once()
            except (aiohttp.ClientError, asyncio.TimeoutError) as e:
                log.warning("heartbeat to master %s failed: %s",
                            self.master_url, e)
                # dead leader: rotate through the configured master list
                # so a raft failover picks up
                if len(self.master_urls) > 1:
                    i = self.master_urls.index(self.master_url) \
                        if self.master_url in self.master_urls else -1
                    self.master_url = self.master_urls[
                        (i + 1) % len(self.master_urls)]

    async def _heartbeat_once(self) -> None:
        if self._left:
            # decommissioned via /admin/leave: admin calls that trigger
            # delta beats must not re-register this server
            return
        beat = self.store.collect_heartbeat()
        metrics.VOLUME_COUNT_GAUGE.labels("", "normal").set(
            len(beat.get("volumes", [])))
        metrics.VOLUME_COUNT_GAUGE.labels("", "ec").set(
            len(beat.get("ec_shards", [])))
        # capacity inputs of the master's history plane: per-data-dir
        # disk occupancy and per-volume sizes, at heartbeat cadence
        for loc in self.store.locations:
            try:
                st = os.statvfs(loc.directory)
            except OSError:
                continue
            total = float(st.f_frsize * st.f_blocks)
            free = float(st.f_frsize * st.f_bavail)
            for kind, v in (("total", total), ("used", total - free),
                            ("free", free)):
                metrics.DISK_BYTES.labels(self.url, loc.directory,
                                          kind).set(v)
        for v in beat.get("volumes", []):
            # the vs label keeps replicas apart
            metrics.VOLUME_SIZE.labels(str(v["id"]), self.url).set(
                v["size"])
        beat.update({"id": self.url, "url": self.url,
                     "public_url": self.public_url,
                     "data_center": self.data_center, "rack": self.rack})
        # binary protobuf framing (reference: master.proto Heartbeat);
        # JSON when WEEDTPU_WIRE=json or protobuf cannot be imported.  A
        # 415 from a JSON-only master latches JSON.  Only the request
        # framing differs: the reply handling is shared
        use_pb = self._wire_pb
        if use_pb is None:
            use_pb = self._wire_pb = (
                os.environ.get("WEEDTPU_WIRE", "pb") != "json"
                and pb.available())
        url = f"{tls.scheme()}://{self.master_url}/heartbeat"
        if use_pb:
            req = self._session.post(
                url, data=pb.heartbeat_to_bytes(beat),
                headers={"Content-Type": pb.CONTENT_TYPE})
        else:
            req = self._session.post(url, json=beat)
        async with req as r:
            if r.status == 415 and use_pb:
                self._wire_pb = False
                return await self._heartbeat_once()
            if r.status == 200:
                data = await r.json()
                self.volume_size_limit = data.get(
                    "volume_size_limit", self.volume_size_limit)
                return
            if r.status == 409:
                # raft follower: re-point at the leader it names, else
                # rotate through the configured master list
                data = await r.json()
                leader = data.get("leader")
                if leader and leader != self.master_url:
                    log.info("heartbeat: switching master %s -> leader %s",
                             self.master_url, leader)
                    self.master_url = leader
                elif self.master_urls:
                    i = self.master_urls.index(self.master_url) \
                        if self.master_url in self.master_urls else -1
                    self.master_url = self.master_urls[
                        (i + 1) % len(self.master_urls)]

    # -- blob data path -------------------------------------------------

    async def handle_blob(self, req: web.Request) -> web.StreamResponse:
        try:
            fid = t.FileId.parse(req.match_info["fid"])
        except ValueError as e:
            return web.json_response({"error": str(e)}, status=400)
        if req.method in ("POST", "PUT", "DELETE"):
            # write JWT check (reference: volume_server_handlers_write.go:33)
            err = self._check_jwt(req)
            if err is not None:
                return err
        if req.method in ("POST", "PUT"):
            metrics.VOLUME_REQUEST_COUNTER.labels("write").inc()
            async with self._upload_sem:
                with metrics.VOLUME_REQUEST_HISTOGRAM.labels("write").time():
                    return await self._write_blob(req, fid)
        if req.method == "GET" or req.method == "HEAD":
            # read JWT, only when a [jwt.signing.read] key is configured
            if self.security is not None and self.security.volume_read:
                token = sjwt.token_from_request(req.headers, req.query)
                try:
                    sjwt.decode_jwt(self.security.volume_read, token,
                                    expected_fid=req.match_info["fid"])
                except sjwt.JwtError as e:
                    return web.json_response({"error": str(e)}, status=401)
            metrics.VOLUME_REQUEST_COUNTER.labels("read").inc()
            async with self._download_sem:
                with metrics.VOLUME_REQUEST_HISTOGRAM.labels("read").time():
                    return await self._read_blob(req, fid)
        if req.method == "DELETE":
            metrics.VOLUME_REQUEST_COUNTER.labels("delete").inc()
            return await self._delete_blob(req, fid)
        return web.json_response({"error": "method not allowed"}, status=405)

    def _check_jwt(self, req: web.Request) -> web.Response | None:
        if self.security is None or not self.security.volume_write:
            return None
        token = sjwt.token_from_request(req.headers, req.query)
        if not token:
            return web.json_response({"error": "missing jwt"}, status=401)
        try:
            sjwt.decode_jwt(self.security.volume_write, token,
                            expected_fid=req.match_info["fid"])
        except sjwt.JwtError as e:
            return web.json_response({"error": str(e)}, status=401)
        return None

    async def _write_blob(self, req: web.Request,
                          fid: t.FileId) -> web.Response:
        name, mime, data = b"", b"", b""
        ctype = req.headers.get("Content-Type", "")
        if ctype.startswith("multipart/"):
            reader = await req.multipart()
            part = await reader.next()
            while part is not None:
                if part.name in (None, "file"):
                    name = (part.filename or "").encode()
                    pm = part.headers.get("Content-Type", "")
                    mime = b"" if pm == "application/octet-stream" \
                        else pm.encode()
                    data = await part.read(decode=False)
                    break
                part = await reader.next()
        else:
            data = await req.read()
            if ctype and ctype != "application/octet-stream":
                mime = ctype.encode()
            hname = req.headers.get("X-File-Name")
            if hname:
                name = hname.encode()
        n = ndl.Needle(cookie=fid.cookie, id=fid.key, data=data,
                       name=name, mime=mime,
                       last_modified=int(time.time()))
        try:
            await asyncio.to_thread(
                self.store.write_needle, fid.volume_id, n)
        except KeyError:
            return web.json_response({"error": "volume not found"},
                                     status=404)
        except PermissionError as e:
            return web.json_response({"error": str(e)}, status=409)
        if heat.ambient_is_data():
            # replica fan-in (class=replication) stays out of the sketches
            heat.record("volume", str(fid.volume_id), len(data), "write")
        if req.query.get("type") != "replicate":
            err = await self._replicate(fid, "PUT", data, name, mime)
            if err:
                return web.json_response({"error": err}, status=500)
        return web.json_response({"name": name.decode(errors="replace"),
                                  "size": len(data),
                                  "eTag": f"{n.checksum:x}"}, status=201)

    async def _replicate(self, fid: t.FileId, method: str,
                         data: bytes | None, name: bytes = b"",
                         mime: bytes = b"") -> str | None:
        """Synchronous fan-out to the other replica locations
        (reference: weed/topology/store_replicate.go:24-135).  Every peer
        is written concurrently; the caller still waits for every ack."""
        vol = self.store.get_volume(fid.volume_id)
        if vol is None or vol.super_block.replica_placement.copy_count <= 1:
            return None
        try:
            async with self._session.get(
                    f"{tls.scheme()}://{self.master_url}/dir/lookup",
                    params={"volumeId": str(fid.volume_id)}) as r:
                locations = (await r.json()).get("locations", [])
        except aiohttp.ClientError as e:
            return f"replica lookup failed: {e}"
        peers = [loc["url"] for loc in locations if loc["url"] != self.url]
        if not peers:
            return None
        headers = {}
        if self.security is not None and self.security.volume_write:
            headers["Authorization"] = "Bearer " + sjwt.gen_jwt(
                self.security.volume_write, str(fid))
        if mime:
            headers["Content-Type"] = mime.decode(errors="replace")
        if name:
            headers["X-File-Name"] = name.decode(errors="replace")

        async def one(peer: str) -> str | None:
            url = f"{tls.scheme()}://{peer}/{fid}?type=replicate"
            try:
                with trace.span("volume.replicate_peer", peer=peer,
                                method=method):
                    if method == "PUT":
                        async with self._session.put(url, data=data,
                                                     headers=headers) as r:
                            if r.status >= 300:
                                return f"replica write to {peer}: {r.status}"
                    else:
                        async with self._session.delete(
                                url, headers=headers) as r:
                            if r.status >= 300:
                                return \
                                    f"replica delete to {peer}: {r.status}"
            except (aiohttp.ClientError, asyncio.TimeoutError) as e:
                return f"replica {method} to {peer} failed: {e!r}"
            return None

        # every peer's outcome is awaited and folded in; the fan-out bytes
        # book as class=replication (the contextvar rides into the tasks)
        with netflow.flow("replication"), \
                trace.span("volume.replicate", peers=len(peers),
                           method=method):
            results = await asyncio.gather(*(one(p) for p in peers),
                                           return_exceptions=True)
        for err in results:
            if isinstance(err, BaseException):
                return f"replica {method} failed: {err!r}"
            if err:
                return err
        return None

    async def _read_off_loop(self, vid: int, fn, *args):
        """`asyncio.to_thread(fn, *args)`, but a volume on a remote tier
        is read on the server's tier pool: a tier read waits on the
        network, perhaps on a gateway that reads this server in turn,
        and must not hold the threads that gateway's reads need."""
        v = self.store.get_volume(vid)
        if v is None or v.backend_kind != "remote":
            return await asyncio.to_thread(fn, *args)
        if self._tier_pool is None:
            self._tier_pool = ThreadPoolExecutor(
                self.TIER_READ_THREADS, thread_name_prefix="tier-read")
        call = functools.partial(contextvars.copy_context().run, fn, *args)
        return await asyncio.get_running_loop().run_in_executor(
            self._tier_pool, call)

    async def _read_blob(self, req: web.Request,
                         fid: t.FileId) -> web.StreamResponse:
        # parsing an empty query string still costs a parse_qsl pass per
        # GET; the common blob read has no query at all
        query = req.query if req.query_string else {}
        rng = req.headers.get("Range", "")
        if rng.startswith("bytes=") and "width" not in query \
                and "height" not in query:
            resp = await self._read_blob_paged(req, fid, rng)
            if resp is not None:
                return resp
        try:
            n = self.store.read_needle_inline(
                fid.volume_id, fid.key, fid.cookie, self.INLINE_READ_MAX) \
                if self.INLINE_READ_MAX else None
            if n is None:
                n = await self._read_off_loop(
                    fid.volume_id, self.store.read_needle, fid.volume_id,
                    fid.key, fid.cookie, self._shard_reader(fid.volume_id))
        except KeyError:
            return web.json_response({"error": "not found"}, status=404)
        except PermissionError:
            return web.json_response({"error": "cookie mismatch"},
                                     status=404)
        except ValueError as e:
            # needle CRC mismatch or a corrupt record: never return the
            # bad bytes; count it and serve from a replica when one exists
            return await self._blob_corrupt_fallback(req, fid, e)
        except IOError as e:
            return web.json_response({"error": str(e)}, status=500)
        if heat.ambient_is_data():
            heat.record("volume", str(fid.volume_id), len(n.data), "read")
        headers = {"Etag": f'"{n.checksum:x}"', "Accept-Ranges": "bytes"}
        if n.name:
            headers["Content-Disposition"] = \
                f'inline; filename="{n.name.decode(errors="replace")}"'
        data, status = n.data, 200
        # on-read image resize/crop (reference: images/resizing.go served
        # via ?width= on the volume read handler)
        mime = n.mime.decode() if n.mime else ""
        if "width" in query or "height" in query:
            from seaweedfs_tpu_torch import images
            try:
                w = int(query.get("width", "0") or 0)
                h = int(query.get("height", "0") or 0)
            except ValueError:
                w = h = 0  # malformed size params are ignored
            if (w or h) and images.is_image_mime(mime):
                data = await asyncio.to_thread(
                    images.resized, data, mime, w, h, query.get("mode", ""))
        if rng.startswith("bytes=") and data:
            try:
                lo, length = parse_range(rng, len(data))
            except ValueError:
                return web.Response(
                    status=416,
                    headers={"Content-Range": f"bytes */{len(data)}"})
            headers["Content-Range"] = \
                f"bytes {lo}-{lo + length - 1}/{len(data)}"
            data, status = data[lo:lo + length], 206
        body = b"" if req.method == "HEAD" else data
        return _OneShotResponse(
            body=body, status=status,
            content_type=mime or "application/octet-stream",
            headers=headers)

    async def _read_blob_paged(self, req: web.Request, fid: t.FileId,
                               rng: str) -> web.StreamResponse | None:
        """Serve a Range request by reading only the needed page of a
        large plain-volume needle (reference: needle_read_page.go).
        Returns None to fall back to the whole-record path (EC volumes,
        small needles, parse errors)."""
        v = self.store.get_volume(fid.volume_id)
        if v is None or v.version == t.VERSION1:
            return None
        loc = v.nm.get(fid.key)
        if loc is None or loc[1] < self.PAGED_READ_MIN:
            return None
        try:
            # cheap probe: header + meta tail (cookie and TTL enforced,
            # mime and checksum recovered without touching the data)
            meta = await self._read_off_loop(
                fid.volume_id, v.read_needle_meta, fid.key, fid.cookie)
        except (KeyError, PermissionError):
            return web.json_response({"error": "not found"}, status=404)
        except (ValueError, EOFError, OSError):
            return None  # odd record: fall back to the full path
        total = meta.size
        if total < self.PAGED_READ_MIN:
            return None
        try:
            lo, length = parse_range(rng, total)
        except ValueError:
            return web.Response(
                status=416, headers={"Content-Range": f"bytes */{total}"})
        try:
            data = await self._read_off_loop(
                fid.volume_id, v.read_needle_page, fid.key, lo, length,
                fid.cookie)
        except (KeyError, PermissionError):
            return web.json_response({"error": "not found"}, status=404)
        except (ValueError, EOFError, OSError):
            return None
        if heat.ambient_is_data():
            heat.record("volume", str(fid.volume_id), len(data), "read")
        headers = {"Accept-Ranges": "bytes",
                   "Etag": f'"{meta.checksum:x}"',
                   "Content-Range":
                   f"bytes {lo}-{lo + len(data) - 1}/{total}"}
        if meta.name:
            headers["Content-Disposition"] = \
                f'inline; filename="{meta.name.decode(errors="replace")}"'
        return web.Response(
            body=data, status=206,
            content_type=(meta.mime.decode() if meta.mime
                          else "application/octet-stream"),
            headers=headers)

    async def _blob_corrupt_fallback(self, req: web.Request, fid: t.FileId,
                                     err: Exception) -> web.StreamResponse:
        """A read hit corrupt bytes (CRC mismatch, unparseable record):
        count it, log a rate-limited line carrying the trace id, and
        proxy the read to another replica.  The peer is told not to fall
        back again (X-Weedtpu-No-Fallback), so two corrupt replicas cannot
        bounce a request between themselves."""
        metrics.NEEDLE_CRC_MISMATCH.labels().inc()
        tctx = trace.current()
        weedlog.warn_ratelimited(
            f"crc_fallback:{fid.volume_id}", 5.0,
            "needle %s CRC mismatch on %s (trace %s): %s; trying replica",
            str(fid), self.url, tctx.trace_id if tctx else "-", err,
            name="volume")
        if req.headers.get("X-Weedtpu-No-Fallback"):
            return web.json_response({"error": str(err)}, status=500)
        locations: list[dict] = []
        try:
            async with self._session.get(
                    f"{tls.scheme()}://{self.master_url}/dir/lookup",
                    params={"volumeId": str(fid.volume_id)}) as r:
                if r.status == 200:
                    locations = (await r.json()).get("locations", [])
        except (aiohttp.ClientError, asyncio.TimeoutError):
            pass
        for loc in locations:
            if loc["url"] == self.url:
                continue
            try:
                fwd = {"X-Weedtpu-No-Fallback": "1"}
                if req.headers.get("Range"):
                    fwd["Range"] = req.headers["Range"]
                with trace.span("volume.crc_fallback", peer=loc["url"]):
                    async with self._session.get(
                            f"{tls.scheme()}://{loc['url']}/{fid}",
                            headers=fwd) as r:
                        if r.status not in (200, 206):
                            continue
                        body = await r.read()
                        headers = {"Accept-Ranges": "bytes"}
                        for h in ("Etag", "Content-Range",
                                  "Content-Disposition"):
                            if r.headers.get(h):
                                headers[h] = r.headers[h]
                        return web.Response(
                            body=b"" if req.method == "HEAD" else body,
                            status=r.status,
                            content_type=r.headers.get(
                                "Content-Type", "application/octet-stream"),
                            headers=headers)
            except (aiohttp.ClientError, asyncio.TimeoutError):
                continue
        return web.json_response({"error": str(err)}, status=500)

    async def _delete_blob(self, req: web.Request,
                           fid: t.FileId) -> web.Response:
        try:
            size = await asyncio.to_thread(
                self.store.delete_needle, fid.volume_id, fid.key, fid.cookie)
        except KeyError:
            return web.json_response({"error": "not found"}, status=404)
        except PermissionError:
            return web.json_response({"error": "cookie mismatch"},
                                     status=404)
        if req.query.get("type") != "replicate":
            if self.store.get_volume(fid.volume_id) is None:
                err = await self._delete_on_ec_peers(fid)
            else:
                err = await self._replicate(fid, "DELETE", None)
            if err:
                return web.json_response({"error": err}, status=500)
        return web.json_response({"size": size})

    async def _delete_on_ec_peers(self, fid: t.FileId) -> str | None:
        """A needle deleted on an EC volume is tombstoned in every other
        holder's .ecx too, as the reference's Go store does for the
        holders of the needle's shards (store_ec_delete.go
        doDeleteNeedleFromAtLeastOneRemoteEcShards).  Each holder keeps
        its own .ecx, so a tombstone on this node alone would leave the
        needle readable through the others; the Python reference tombstones
        only here (ROADMAP fault 3.11).  Every peer is asked at once; a
        peer that no longer has the volume answers 404, which is no
        error."""
        try:
            shards = await asyncio.to_thread(self._ec_shard_locations,
                                             fid.volume_id)
        except (OSError, ValueError) as e:
            return f"ec peer lookup failed: {e}"
        peers = sorted({loc["url"] for locs in shards.values()
                        for loc in locs} - {self.url})
        if not peers:
            return None
        headers = {}
        if self.security is not None and self.security.volume_write:
            headers["Authorization"] = "Bearer " + sjwt.gen_jwt(
                self.security.volume_write, str(fid))

        async def one(peer: str) -> str | None:
            try:
                async with self._session.delete(
                        f"{tls.scheme()}://{peer}/{fid}?type=replicate",
                        headers=headers) as r:
                    if r.status >= 300 and r.status != 404:
                        return f"ec delete on {peer}: {r.status}"
            except (aiohttp.ClientError, asyncio.TimeoutError) as e:
                return f"ec delete on {peer} failed: {e!r}"
            return None

        with trace.span("volume.ec_delete_peers", peers=len(peers)):
            results = await asyncio.gather(*(one(p) for p in peers))
        return next((err for err in results if err), None)

    # -- degraded reads: where the shards live --------------------------

    def _ec_loc_vid_lock(self, vid: int) -> threading.Lock:
        """Per-vid fetch lock, created on first use and pruned with the
        cache; a pruned-then-recreated lock merely allows two concurrent
        fetches for one vid, resolved by the double-checked insert."""
        with self._ec_loc_lock:
            lk = self._ec_loc_vid_locks.get(vid)
            if lk is None:
                lk = self._ec_loc_vid_locks[vid] = threading.Lock()
            return lk

    def _ec_shard_locations(self, vid: int) -> dict:
        """Master shard-location lookup with a short TTL cache (reference:
        store_ec.go cachedLookupEcShardLocations): a degraded read fans
        out to many shards and must not ask the master once per shard.
        Empty results get a much shorter TTL, so a transient bad answer
        cannot blank a volume for 10 s."""
        import json
        import urllib.request
        with self._ec_loc_vid_lock(vid):
            now = time.monotonic()
            with self._ec_loc_lock:
                cached = self._ec_loc_cache.get(vid)
            if cached and cached[0] > now:
                return cached[1]
            try:
                with urllib.request.urlopen(
                        f"{tls.scheme()}://{self.master_url}"
                        f"/dir/ec/lookup?volumeId={vid}",
                        timeout=10) as r:
                    shards = json.load(r).get("shards", {})
            except Exception:
                # a short-TTL negative entry before re-raising: without a
                # cache entry the vid's lock slot is never evicted, and
                # vid is client-controlled
                with self._ec_loc_lock:
                    self._ec_loc_cache.setdefault(vid, (now + 1.0, {}))
                    self._ec_loc_evict_locked()
                raise
            # nearest-first candidate order: degraded reads and survivor
            # gathering try same-rack peers before crossing racks or DCs
            for locs in shards.values():
                locs.sort(key=self._loc_rank)
            ttl = 10.0 if shards else 1.0
            with self._ec_loc_lock:
                self._ec_loc_cache[vid] = (now + ttl, shards)
                self._ec_loc_evict_locked()
            return shards

    def _loc_rank(self, loc) -> int:
        """Locality class of a shard-location record relative to this
        server (0 self, 1 same rack, 2 same DC, 3 remote DC).  A bare url
        string (older or minimal masters) counts as label-less."""
        if not isinstance(loc, dict):
            loc = {"url": loc}
        return locality_class(self.data_center, self.rack,
                              loc.get("dc", ""), loc.get("rack", ""),
                              same_node=loc.get("url") == self.url)

    def _ec_loc_evict_locked(self) -> None:
        """Bound the location cache and its lock table (insertion order
        is eviction order).  The caller holds _ec_loc_lock."""
        while len(self._ec_loc_cache) > 256:
            evicted = next(iter(self._ec_loc_cache))
            self._ec_loc_cache.pop(evicted)
            self._ec_loc_vid_locks.pop(evicted, None)

    def _shard_reader(self, vid: int):
        """Remote-shard fetch for EC degraded reads: ask the master where
        each shard lives and pull the byte range from a peer (reference:
        store_ec.go readRemoteEcShardInterval).  The trace context, the
        ambient traffic class and the deadline are captured here, on the
        calling thread, because read() runs on the read engine's pool
        threads, which never see the request's context: the captured
        trace parents the per-fetch spans, and the class rides
        X-Weedtpu-Class to the peer so both sides book the shard bytes
        under one flow."""
        tctx = trace.current()
        flow_cls = netflow.current_class() or "data"
        dl = resilience.deadline()

        def read(shard_id: int, offset: int, size: int) -> bytes | None:
            # runs inside a worker thread: a blocking client
            import urllib.error
            import urllib.request
            try:
                shards = self._ec_shard_locations(vid)
                for loc in shards.get(str(shard_id), []):
                    if loc["url"] == self.url:
                        continue
                    # per-peer circuit breaker: a tripped peer is skipped
                    # outright, and the next location (or reconstruction)
                    # serves the interval without paying its timeout
                    breaker = resilience.breaker_for(loc["url"]) \
                        if resilience.breaker_enabled() else None
                    if breaker is not None and not breaker.allow():
                        continue
                    try:
                        if faults.NET_ACTIVE:
                            lat = faults.check_net("volume", loc["url"])
                            if lat > 0:
                                time.sleep(lat)
                        # the socket timeout respects the captured budget
                        tmo = 30.0
                        if dl is not None:
                            tmo = min(tmo, dl - time.monotonic())
                            if tmo <= 0.01:
                                # budget spent: our state, not the peer's
                                return None
                        with trace.span("volume.shard_fetch", parent=tctx,
                                        vid=vid, shard=shard_id,
                                        peer=loc["url"], bytes=size) as sp:
                            req = urllib.request.Request(
                                f"{tls.scheme()}://{loc['url']}"
                                f"/admin/ec/shard_read?"
                                f"volume={vid}&shard={shard_id}"
                                f"&offset={offset}&size={size}")
                            # the peer's span parents to this fetch span
                            hdr_ctx = sp.trace or tctx
                            if hdr_ctx is not None:
                                req.add_header(
                                    trace.TRACE_HEADER,
                                    trace.format_header(hdr_ctx))
                            req.add_header(netflow.CLASS_HEADER, flow_cls)
                            req.add_header(netflow.ROLE_HEADER, "volume")
                            if dl is not None:
                                req.add_header(
                                    resilience.DEADLINE_HEADER,
                                    str(max(1, int((dl - time.monotonic())
                                                   * 1000))))
                            with urllib.request.urlopen(
                                    req, timeout=tmo) as rr:
                                data = rr.read()
                            netflow.account("recv", flow_cls, "volume",
                                            len(data))
                            if len(data) != size:
                                sp.set(short=len(data))
                        if breaker is not None:
                            breaker.record(True)
                        if len(data) == size:
                            return data
                    except urllib.error.HTTPError:
                        # the peer answered (404 shard moved, 5xx): a
                        # routing or content miss, not a transport
                        # failure; breakers count unreachable peers only
                        if breaker is not None:
                            breaker.record(True)
                        continue
                    except OSError:
                        # a timeout caused by our nearly spent budget is
                        # no evidence against the peer
                        if breaker is not None and \
                                (dl is None
                                 or dl - time.monotonic() > 0.05):
                            breaker.record(False)
                        continue
            except OSError:
                return None
            return None

        def locality_rank(shard_id: int) -> int:
            """Best locality class among a shard's remote locations: the
            read engine tries same-rack helpers before cross-rack ones."""
            try:
                locs = self._ec_shard_locations(vid).get(str(shard_id), [])
            except Exception:
                return 3
            return min((self._loc_rank(loc) for loc in locs
                        if (loc.get("url") if isinstance(loc, dict)
                            else loc) != self.url), default=3)

        read.locality_rank = locality_rank
        return read

    # -- status ----------------------------------------------------------

    async def handle_ui(self, req: web.Request) -> web.Response:
        """Operator status page with volume and EC shard tables
        (reference: weed/server/volume_server_ui/templates.go)."""
        from seaweedfs_tpu_torch.server import ui
        hb = self.store.collect_heartbeat()
        vol_rows = [[v["id"], v.get("collection", "") or "-",
                     ui.fmt_bytes(v.get("size", 0)), v.get("file_count", 0),
                     v.get("delete_count", 0),
                     ui.fmt_bytes(v.get("deleted_bytes", 0)),
                     v.get("replica_placement", "000"),
                     v.get("ttl", "") or "-", v.get("read_only", False)]
                    for v in sorted(hb.get("volumes", []),
                                    key=lambda v: v["id"])]
        # the beat lists a volume's shards under "shard_ids" (the
        # reference's page reads "shards" and shows none)
        ec_rows = [[e["id"], e.get("collection", "") or "-",
                    " ".join(str(s) for s in sorted(e["shard_ids"])),
                    len(e["shard_ids"])]
                   for e in sorted(hb.get("ec_shards", []),
                                   key=lambda e: e["id"])]
        return web.Response(text=ui.render(
            f"weedtpu volume server {self.url}",
            {"server": ui.Table(
                ["master", "max slots", "volumes", "ec volumes", "device"],
                [[self.master_url, hb.get("max_volume_count", 0),
                  len(vol_rows), len(ec_rows), str(self.device)]]),
             "volumes": ui.Table(
                ["id", "collection", "size", "files", "deleted",
                 "deleted bytes", "replication", "ttl", "read-only"],
                vol_rows),
             "ec shards": ui.Table(
                ["volume", "collection", "shards here", "count"], ec_rows)},
            links={"metrics": "/metrics", "status json": "/status"}),
            content_type="text/html")

    async def handle_status(self, req: web.Request) -> web.Response:
        return web.json_response(self.store.collect_heartbeat())

    async def handle_metrics(self, req: web.Request) -> web.Response:
        # per-stage degraded-read counters live on each mounted EcVolume;
        # mirror their sums into the registry at scrape time
        totals: dict[str, int] = {}
        for loc in self.store.locations:
            for ev in list(loc.ec_volumes.values()):
                for stat, v in ev.read_stats_snapshot().items():
                    totals[stat] = totals.get(stat, 0) + v
        for stat, v in totals.items():
            metrics.EC_DEGRADED_READ.labels(stat).set(v)
        return metrics.scrape_response(req)

    # -- admin: volumes --------------------------------------------------

    async def handle_assign_volume(self, req: web.Request) -> web.Response:
        body = await req.json()
        try:
            self.store.allocate_volume(
                body["volume"], body.get("collection", ""),
                body.get("replication", "000"), body.get("ttl", ""))
        except FileExistsError:
            pass  # idempotent
        except OSError as e:
            return web.json_response({"error": str(e)}, status=500)
        return web.json_response({})

    async def handle_volume_delete(self, req: web.Request) -> web.Response:
        body = await req.json()
        self.store.delete_volume(body["volume"])
        await self._heartbeat_once()
        return web.json_response({})

    async def handle_leave(self, req: web.Request) -> web.Response:
        """Stop heartbeating so the master expires this server from the
        topology (reference: volume_grpc_admin.go VolumeServerLeave)."""
        self._left = True  # sticky: delta beats from admin calls stay off
        if self._hb_task:
            self._hb_task.cancel()
            self._hb_task = None
        return web.json_response({"ok": True})

    async def handle_configure_replication(self, req: web.Request
                                           ) -> web.Response:
        """Rewrite the replica-placement byte in the super block
        (reference: volume_grpc_admin.go VolumeConfigure)."""
        body = await req.json()
        v = self.store.get_volume(body["volume"])
        if v is None:
            return web.json_response({"error": "volume not found"},
                                     status=404)
        try:
            rp = t.ReplicaPlacement.parse(body.get("replication", "000"))
        except (ValueError, KeyError) as e:
            return web.json_response({"error": str(e)}, status=400)
        try:
            await asyncio.to_thread(v.set_replica_placement, rp)
        except PermissionError as e:
            return web.json_response({"error": str(e)}, status=409)
        await self._heartbeat_once()
        return web.json_response({"replication": str(rp)})

    async def handle_volume_unmount(self, req: web.Request) -> web.Response:
        """Close a volume without deleting its files (reference:
        VolumeUnmount): frees the slot; a later mount or restart picks
        the files back up."""
        body = await req.json()
        vid = body["volume"]
        for loc in self.store.locations:
            v = loc.volumes.pop(vid, None)
            if v is not None:
                await asyncio.to_thread(v.close)
                await self._heartbeat_once()
                return web.json_response({})
        return web.json_response({"error": "volume not found"}, status=404)

    async def handle_volume_mount(self, req: web.Request) -> web.Response:
        """(Re)open an existing volume's files (reference: VolumeMount)."""
        body = await req.json()
        vid = body["volume"]
        collection = body.get("collection", "")
        if self.store.get_volume(vid) is not None:
            return web.json_response({})  # already mounted
        for loc in self.store.locations:
            # an earlier unmount leaves the collection recorded; try it
            # first so `volume.mount -volumeId N` works without -collection
            collection = collection or loc.collections.get(vid, "")
            base = loc.base_path(vid, collection)
            if os.path.exists(base + ".dat") or \
                    os.path.exists(base + ".tier"):
                try:
                    vol = await asyncio.to_thread(
                        Volume, loc.directory, collection, vid)
                except Exception as e:
                    return web.json_response({"error": f"load: {e}"},
                                             status=500)
                loc.volumes[vid] = vol
                loc.collections[vid] = collection
                await self._heartbeat_once()
                return web.json_response({})
        return web.json_response({"error": "volume files not found"},
                                 status=404)

    async def handle_volume_readonly(self, req: web.Request) -> web.Response:
        body = await req.json()
        v = self.store.get_volume(body["volume"])
        if v is None:
            return web.json_response({"error": "volume not found"},
                                     status=404)
        readonly = bool(body.get("readonly", True))
        if not readonly and v.tiering:
            return web.json_response(
                {"error": f"volume {v.id} is moving to or from a remote "
                          "tier"}, status=409)
        v.read_only = readonly
        await self._heartbeat_once()
        return web.json_response({})

    async def handle_vacuum(self, req: web.Request) -> web.Response:
        body = await req.json()
        v = self.store.get_volume(body["volume"])
        if v is None:
            return web.json_response({"error": "volume not found"},
                                     status=404)
        garbage = v.garbage_ratio()
        try:
            await asyncio.to_thread(v.compact)
        except PermissionError as e:  # a remote tier, or one moving
            return web.json_response({"error": str(e)}, status=409)
        return web.json_response({"garbage_ratio": garbage})

    # -- admin: EC -------------------------------------------------------

    def _ec_base(self, vid: int) -> str | None:
        for loc in self.store.locations:
            for cand in (loc.base_path(vid, loc.collections.get(vid, "")),
                         loc.base_path(vid)):
                if any(os.path.exists(cand + ext) for ext in
                       (".dat", ".ecx", layout.to_ext(0))):
                    return cand
        return None

    async def handle_ec_generate(self, req: web.Request) -> web.Response:
        """VolumeEcShardsGenerate (volume_grpc_erasure_coding.go:38): .dat
        -> its shard files + .ecx, parity computed on the store's
        device."""
        body = await req.json()
        vid = body["volume"]
        v = self.store.get_volume(vid)
        if v is None:
            return web.json_response({"error": "volume not found"},
                                     status=404)
        base = v._base
        if self._ec_jobs.get(vid, {}).get("state") == "running":
            return web.json_response({"error": "encode already running"},
                                     status=409)
        # `stages` is written in place by the encode pipeline (per-stage
        # seconds, mode, overlap_frac): /admin/ec/progress shows where a
        # long encode spends its time, not just how far it is
        stages: dict = {}
        job = {"state": "running", "kind": "encode", "bytes_done": 0,
               "total": os.path.getsize(base + ".dat"),
               "cancel": False, "error": None, "started": time.time(),
               "stages": stages}
        self._ec_jobs[vid] = job
        spec = codecs.parse_tag(body.get("codec") or codecs.default_tag())
        job["codec"] = spec.tag

        def gen():
            v.nm.flush()
            ec_files.write_ec_files(
                base,
                progress=lambda n: job.__setitem__("bytes_done", n),
                cancel=lambda: job["cancel"],
                stats=stages, codec_tag=spec.tag, device=self.device)
            ec_files.write_sorted_ecx(base + ".idx")
            metrics.EC_ENCODE_BYTES.labels(self.device.type).inc(
                job["total"])

        try:
            await asyncio.to_thread(gen)
        except ec_files.EncodeCancelled:
            # write_ec_files builds under temp names: a cancelled encode
            # has cleaned up after itself, and an earlier shard set is
            # untouched
            job["state"] = "cancelled"
            return web.json_response({"error": "cancelled"}, status=409)
        except Exception as e:
            job["state"] = "failed"
            job["error"] = str(e)
            raise
        job["state"] = "done"
        job["bytes_done"] = job["total"]
        return web.json_response({"shards": list(range(spec.n)),
                                  "codec": spec.tag})

    async def handle_ec_fleet_convert(self, req: web.Request
                                      ) -> web.Response:
        """Batched multi-volume conversion (ops/fleet_convert.py): the
        listed local volumes' units interleave into one stream of
        batched launches (K2) on the store's device instead of one
        /admin/ec/generate each.  The master's conversion scheduler
        drives it.  The volumes are frozen read-only for the run (a
        needle written after the .dat snapshot would be missing from
        the shard set); success keeps the freeze, failure or cancel
        thaws the volumes that did not commit.  The run registers as
        one job shared by every volume's entry of the per-vid job table,
        so /admin/ec/progress observes it and /admin/ec/cancel on any of
        its volumes aborts it.  A run that commits books the handler's
        own seconds under its stages' `server`: `flush_s`, `convert_s`
        (the whole `convert_volumes` call, of which `wall_s` is the
        stream), `ecx_s`, `beat_s` and `handler_s`, from the body read
        to the answer."""
        t_handler = time.perf_counter()
        body = await req.json()
        vids: list[int] = []
        for v_ in (body.get("volumes") or [])[:64]:  # bounded fan-in
            try:
                vid = int(v_)
            except (TypeError, ValueError):
                continue
            if vid not in vids:
                vids.append(vid)
        vols, skipped = [], {}
        for vid in vids:
            v = self.store.get_volume(vid)
            if v is None:
                skipped[str(vid)] = "not found"
            elif self._ec_jobs.get(vid, {}).get("state") == "running":
                skipped[str(vid)] = "ec job already running"
            else:
                vols.append((vid, v))
        if not vols:
            return web.json_response(
                {"error": "no convertible volumes here",
                 "skipped": skipped}, status=404)
        was_writable = [(v, v.read_only) for _, v in vols]
        for v, _ in was_writable:
            v.read_only = True
        total = sum(os.path.getsize(v._base + ".dat") for _, v in vols)
        stages: dict = {}
        shared = {"state": "running", "kind": "fleet_convert",
                  "bytes_done": 0, "total": total, "cancel": False,
                  "error": None, "started": time.time(),
                  "volumes": [vid for vid, _ in vols], "stages": stages}
        for vid, _ in vols:
            self._ec_jobs[vid] = shared
        server: dict = {}  # the handler's seconds, booked once it commits

        def run():
            t0 = time.perf_counter()
            for _, v in vols:
                v.flush()  # the .dat and .idx the snapshot must hold
            t1 = time.perf_counter()
            rep = fleet_convert.convert_volumes(
                [v._base for _, v in vols],
                progress=lambda n: shared.__setitem__("bytes_done", n),
                cancel=lambda: shared["cancel"],
                stats=stages, device=self.device)
            t2 = time.perf_counter()
            for _, v in vols:
                ec_files.write_sorted_ecx(v._base + ".idx")
            metrics.EC_ENCODE_BYTES.labels("fleet").inc(total)
            server.update(flush_s=t1 - t0, convert_s=t2 - t1,
                          ecx_s=time.perf_counter() - t2)
            return rep

        def settle_failed():
            """A volume whose shard set committed before the run died
            stays frozen (the shard set is its copy of record) and gets
            its .ecx; only the rolled-back ones thaw."""
            committed = set(stages.get("committed_bases") or [])
            for v, ro in was_writable:
                if v._base in committed:
                    try:
                        ec_files.write_sorted_ecx(v._base + ".idx")
                    except OSError:
                        log.warning("post-abort .ecx write failed for %s",
                                    v._base, exc_info=True)
                else:
                    v.read_only = ro

        try:
            report = await asyncio.to_thread(run)
        except ec_files.EncodeCancelled:
            shared["state"] = "cancelled"
            settle_failed()
            return web.json_response({"error": "cancelled"}, status=409)
        except Exception as e:
            shared["state"] = "failed"
            shared["error"] = str(e)
            settle_failed()
            raise
        shared["state"] = "done"
        shared["bytes_done"] = total
        t_beat = time.perf_counter()
        await self._heartbeat_once()
        t_end = time.perf_counter()
        server.update(beat_s=t_end - t_beat, handler_s=t_end - t_handler)
        stages["server"] = server
        return web.json_response(
            {"converted": [vid for vid, _ in vols], "skipped": skipped,
             "bytes": report["bytes"], "units": report["units"],
             "wall_s": report["wall_s"]})

    async def handle_ec_progress(self, req: web.Request) -> web.Response:
        """Observability of a long-running encode or rebuild."""
        vid = int(req.query.get("volumeId", "0"))
        job = self._ec_jobs.get(vid)
        if job is None:
            return web.json_response({"error": "no encode job"}, status=404)
        # dict() is one C-level copy (atomic under the GIL): the worker
        # thread inserts keys into job and its nested stages while the
        # reply is serialized
        snap = {k: dict(v) if isinstance(v, dict) else v
                for k, v in dict(job).items()}
        return web.json_response(snap)

    async def handle_ec_cancel(self, req: web.Request) -> web.Response:
        body = await req.json()
        job = self._ec_jobs.get(body["volume"])
        if job is None or job["state"] != "running":
            return web.json_response({"error": "no running encode"},
                                     status=404)
        job["cancel"] = True
        return web.json_response({"ok": True})

    async def handle_ec_rebuild(self, req: web.Request) -> web.Response:
        """VolumeEcShardsRebuild (volume_grpc_erasure_coding.go:84),
        registered under the same per-vid job state as encode, so
        /admin/ec/progress and /admin/ec/cancel observe and abort it.
        With `reduced` ({lost, groups, shard_size, d}: the master's
        repair plan) no survivor copies land here: each helper node
        ships partials through its /admin/ec/partial
        (`ec_files.rebuild_ec_reduced`)."""
        body = await req.json()
        vid = body["volume"]
        base = self._ec_base(vid)
        if base is None:
            return web.json_response({"error": "no shards here"}, status=404)
        if self._ec_jobs.get(vid, {}).get("state") == "running":
            return web.json_response({"error": "ec job already running"},
                                     status=409)
        reduced = body.get("reduced")
        # codec identity: the caller's tag (master plans carry it) wins,
        # else the local .vif
        spec = codecs.parse_tag(body.get("codec") or
                                (ec_files.read_vif(base) or {}).get("codec"))
        present = [i for i in range(spec.n)
                   if os.path.exists(base + layout.to_ext(i))]
        total = (os.path.getsize(base + layout.to_ext(present[0]))
                 * spec.k) if present else 0
        stages: dict = {}
        job = {"state": "running",
               "kind": "rebuild_reduced" if reduced else "rebuild",
               "codec": spec.tag, "bytes_done": 0, "total": total,
               "cancel": False, "error": None, "started": time.time(),
               "stages": stages}
        self._ec_jobs[vid] = job
        try:
            if reduced:
                lost = sorted(int(s) for s in reduced.get("lost", []))
                groups = [g for g in (reduced.get("groups") or [])
                          if g.get("node") and g["node"] != self.url]
                if reduced.get("shard_size"):
                    for g in groups:
                        g.setdefault("shard_size", reduced["shard_size"])
                result = await asyncio.to_thread(
                    ec_files.rebuild_ec_reduced, base, lost, groups,
                    self._partial_fetcher(vid, alpha=spec.alpha),
                    d=reduced.get("d"),
                    progress=lambda n: job.__setitem__("bytes_done", n),
                    cancel=lambda: job["cancel"],
                    stats=stages, codec_tag=spec.tag, device=self.device)
                job["state"] = "done"
                job["bytes_done"] = job["total"]
                await self._heartbeat_once()
                return web.json_response(result)
            rebuilt = await asyncio.to_thread(
                ec_files.rebuild_ec_files, base,
                progress=lambda n: job.__setitem__("bytes_done", n),
                cancel=lambda: job["cancel"],
                stats=stages, device=self.device, codec_tag=spec.tag)
        except ec_files.EncodeCancelled:
            job["state"] = "cancelled"
            return web.json_response({"error": "cancelled"}, status=409)
        except regen.HelperDied as e:
            # replanning ran out of substitutes: the master falls back to
            # survivor copies and reads who died and how often it replanned
            job["state"] = "failed"
            job["error"] = str(e)
            return web.json_response(
                {"error": str(e), "helper": e.node or "<local>",
                 "helper_shards": list(e.shards),
                 "replans": stages.get("replans", 0),
                 "dead_helpers": stages.get("dead_helpers", [])},
                status=500)
        except Exception as e:
            job["state"] = "failed"
            job["error"] = str(e)
            raise
        job["state"] = "done"
        job["bytes_done"] = job["total"]
        return web.json_response({"rebuilt": rebuilt})

    async def handle_ec_mount(self, req: web.Request) -> web.Response:
        body = await req.json()
        vid = body["volume"]
        base = self._ec_base(vid)
        if base is None:
            return web.json_response({"error": "no shard files"}, status=404)
        loc = next(loc for loc in self.store.locations
                   if base.startswith(loc.directory))
        old = loc.ec_volumes.pop(vid, None)
        if old is not None:
            old.close()
        loc.ec_volumes[vid] = ecv.EcVolume(base, device=self.device)
        await self._heartbeat_once()
        return web.json_response({"shards": loc.ec_volumes[vid].shard_ids()})

    async def handle_ec_unmount(self, req: web.Request) -> web.Response:
        body = await req.json()
        vid = body["volume"]
        for loc in self.store.locations:
            ev = loc.ec_volumes.pop(vid, None)
            if ev is not None:
                ev.close()
        await self._heartbeat_once()
        return web.json_response({})

    async def handle_ec_delete_shards(self, req: web.Request) -> web.Response:
        body = await req.json()
        vid, shards = body["volume"], body.get("shards", [])
        base = self._ec_base(vid)
        if base is None:
            return web.json_response({})
        mounted = self.store.get_ec_volume(vid)
        for sid in shards:
            p = base + layout.to_ext(sid)
            if os.path.exists(p):
                os.remove(p)
            if mounted is not None:
                f = mounted.shards.pop(sid, None)
                if f is not None:
                    f.close()
                # a purged shard's scrub verdicts die with its file: a
                # rebuilt replacement must not inherit the quarantine
                mounted.clear_quarantine(sid)
        # with no shard left here, the index files go too
        if not any(os.path.exists(base + layout.to_ext(i))
                   for i in range(layout.MAX_TOTAL_SHARDS)):
            for ext in (".ecx", ".ecj"):
                if os.path.exists(base + ext):
                    os.remove(base + ext)
        await self._heartbeat_once()
        return web.json_response({})

    async def handle_ec_copy(self, req: web.Request) -> web.Response:
        """VolumeEcShardsCopy (volume_grpc_erasure_coding.go:126): pull
        shard files from a peer (the reference's CopyFile stream, as
        HTTP)."""
        body = await req.json()
        vid, source = body["volume"], body["source"]
        shards = body.get("shards", [])
        collection = body.get("collection", "")
        exts = [layout.to_ext(s) for s in shards]
        if body.get("copy_ecx", True):
            exts += [".ecx", ".vif"]
        if body.get("copy_ecj", False):
            exts.append(".ecj")
        loc = min(self.store.locations, key=lambda loc: len(loc.volumes))
        base = loc.base_path(vid, collection)
        for ext in exts:
            name = os.path.basename(base + ext)
            try:
                async with self._session.get(
                        f"{tls.scheme()}://{source}/admin/file",
                        params={"name": name}) as r:
                    if r.status != 200:
                        if ext in (".ecj", ".vif"):
                            continue  # optional files
                        return web.json_response(
                            {"error": f"pull {name} from {source}: "
                                      f"{r.status}"}, status=500)
                    with open(base + ext, "wb") as f:
                        async for chunk in r.content.iter_chunked(1 << 20):
                            # streamed reads bypass the aiohttp trace
                            # hooks: book the shard bytes here
                            netflow.account("recv",
                                            netflow.current_class(),
                                            "volume", len(chunk))
                            f.write(chunk)
            except aiohttp.ClientError as e:
                return web.json_response({"error": str(e)}, status=500)
        loc.collections.setdefault(vid, collection)
        return web.json_response({})

    async def handle_ec_to_volume(self, req: web.Request) -> web.Response:
        """VolumeEcShardsToVolume (volume_grpc_erasure_coding.go:407):
        decode the local data shards back into a normal volume, rebuilding
        missing data shards first on the store's device."""
        body = await req.json()
        vid = body["volume"]
        collection = body.get("collection", "")
        base = self._ec_base(vid)
        if base is None:
            return web.json_response({"error": "no shards here"}, status=404)
        spec = codecs.parse_tag((ec_files.read_vif(base) or {}).get("codec"))
        missing = [i for i in range(spec.k)
                   if not os.path.exists(base + layout.to_ext(i))]

        def decode():
            if missing:
                ec_files.rebuild_ec_files(base, device=self.device,
                                          codec_tag=spec.tag)
            dat_size = ec_files.find_dat_file_size(base)
            ec_files.write_dat_file(base, dat_size)
            ec_files.write_idx_from_ecx(base + ".ecx")
        await asyncio.to_thread(decode)
        loc = next(loc for loc in self.store.locations
                   if base.startswith(loc.directory))
        loc.volumes[vid] = Volume(loc.directory, collection, vid)
        loc.collections[vid] = collection
        await self._heartbeat_once()
        return web.json_response({})

    # -- admin: volume copy, move, unconvert, tiering ------------------

    async def handle_volume_copy(self, req: web.Request) -> web.Response:
        """VolumeCopy (reference: volume_grpc_copy.go:199-223 doCopyFile):
        pull a whole volume's .dat and .idx from a peer and mount it here
        (volume.balance, volume.fix.replication and the move).  The pull
        goes to `.cpd`/`.cpx` temp names, renamed only when both landed,
        with each file's CRC32 computed while it streams.  `staging`
        keeps the copy read-only, out of the beat and marked on disk
        (`.staging`, which a boot deletes) until a `finalize` call flips
        it live.  A volume already here catches up incrementally."""
        body = await req.json()
        vid, source = body["volume"], body["source"]
        collection = body.get("collection", "")
        staging = bool(body.get("staging"))
        finalize = bool(body.get("finalize"))
        existing = self.store.get_volume(vid)
        if existing is not None:
            resp = await self._volume_copy_incremental(
                existing, vid, source, collection)
            if finalize and resp.status == 200 and existing.staging:
                # only a staged copy flips live: a replica read-only for
                # another reason (a remote tier) stays read-only
                try:
                    os.remove(existing._base + ".staging")
                except OSError:
                    pass
                existing.staging = False
                existing.read_only = False
                await self._heartbeat_once()
            return resp
        loc = min(self.store.locations, key=lambda loc: len(loc.volumes))
        base = loc.base_path(vid, collection)
        tmp_ext = {".dat": ".cpd", ".idx": ".cpx"}
        crcs: dict[str, int] = {}
        try:
            for ext in (".dat", ".idx"):
                name = os.path.basename(base + ext)
                crc = 0
                async with self._session.get(
                        f"{tls.scheme()}://{source}/admin/file",
                        params={"name": name}) as r:
                    if r.status != 200:
                        raise OSError(
                            f"pull {name} from {source}: HTTP {r.status}")
                    with open(base + tmp_ext[ext], "wb") as f:
                        async for chunk in r.content.iter_chunked(1 << 20):
                            # streamed reads bypass the aiohttp trace
                            # hooks: book the bytes here
                            netflow.account("recv",
                                            netflow.current_class(),
                                            "volume", len(chunk))
                            crc = zlib.crc32(chunk, crc)
                            f.write(chunk)
                crcs[ext.lstrip(".")] = crc
            if staging:
                # the marker lands before the .dat: a crash between the
                # renames leaves a marked copy, which no boot mounts
                with open(base + ".staging", "w"):
                    pass
            for ext in (".dat", ".idx"):
                os.replace(base + tmp_ext[ext], base + ext)
        except (aiohttp.ClientError, OSError) as e:
            for ext in (".cpd", ".cpx", ".staging"):
                try:
                    os.remove(base + ext)
                except OSError:
                    pass
            return web.json_response({"error": str(e)}, status=500)
        try:
            vol = await asyncio.to_thread(Volume, loc.directory, collection,
                                          vid)
        except Exception as e:
            return web.json_response({"error": f"load: {e}"}, status=500)
        if staging:
            vol.staging = True
            vol.read_only = True
        loc.volumes[vid] = vol
        loc.collections[vid] = collection
        if not staging:  # a staged copy stays unseen until finalize
            await self._heartbeat_once()
        return web.json_response({"file_count": vol.info().file_count,
                                  "crc": crcs})

    async def handle_volume_move(self, req: web.Request) -> web.Response:
        """POST /admin/volume/move {"volume", "target"}: move one volume
        off this server (the autopilot's balancing).  Freeze writes, copy
        to the target staged, check the target's streamed CRC against the
        source .dat, finalize (the staged copy goes live), retire the
        source.  Every byte books as netflow class `rebalance`.  Until
        the finalize succeeds the target's copy is staged and the source
        serves; a failure deletes the staged copy (a killed target's boot
        deletes it) and thaws the source to its earlier writability."""
        body = await req.json()
        try:
            vid = int(body["volume"])
            target = str(body["target"])
        except (KeyError, TypeError, ValueError):
            return web.json_response(
                {"error": "volume and target required"}, status=400)
        v = self.store.get_volume(vid)
        if v is None:
            return web.json_response({"error": "volume not found"},
                                     status=404)
        if target == self.url or not target:
            return web.json_response({"error": "bad target"}, status=400)
        # one move per vid (handlers run on one loop, so the check and
        # the add are atomic)
        if vid in self._moves_active or v.staging:
            return web.json_response({"error": "volume is mid-move"},
                                     status=409)
        self._moves_active.add(vid)
        try:
            return await self._volume_move(
                vid, v, str(body.get("collection") or ""), target)
        finally:
            self._moves_active.discard(vid)

    async def _volume_move(self, vid: int, v: Volume, collection: str,
                           target: str) -> web.Response:
        if not collection:
            for loc in self.store.locations:
                if vid in loc.volumes:
                    collection = loc.collections.get(vid, "")
                    break

        async def post(path: str, pbody: dict,
                       timeout: float = 600.0) -> dict:
            return await post_json(self._session, target, path, pbody,
                                   timeout)

        def dat_crc() -> int:
            crc = 0
            with open(v.dat_path, "rb") as f:
                while True:
                    chunk = f.read(1 << 20)
                    if not chunk:
                        break
                    crc = zlib.crc32(chunk, crc)
            return crc

        was_ro = v.read_only
        copy_body = {"volume": vid, "source": self.url,
                     "collection": collection, "staging": True}
        try:
            with netflow.flow("rebalance"), \
                    trace.span("volume.move", vid=vid, target=target,
                               bytes=v.data_size()):
                # freeze first: against a frozen source the staged copy
                # is complete once its CRC matches, and the finalizing
                # catch-up moves 0 bytes
                v.read_only = True
                await asyncio.to_thread(v.flush)
                data = await post("/admin/volume/copy", copy_body)
                if data.get("incremental"):
                    # the target already held a live replica: refuse
                    # without the abort below, whose delete would take a
                    # real replica
                    v.read_only = was_ro
                    metrics.VOLUME_MOVES.labels("aborted").inc()
                    return web.json_response(
                        {"error": f"{target} already holds volume "
                                  f"{vid}; move refused (that is "
                                  "volume.fix.replication's job)"},
                        status=409)
                remote_crc = (data.get("crc") or {}).get("dat")
                local_crc = await asyncio.to_thread(dat_crc)
                if remote_crc != local_crc:
                    raise RuntimeError(
                        f"CRC mismatch after copy: source {local_crc} "
                        f"vs target {remote_crc}")
                await post("/admin/volume/copy",
                           dict(copy_body, finalize=True))
        except Exception as e:
            try:
                await post("/admin/volume/delete", {"volume": vid},
                           timeout=10.0)
            except Exception:
                pass  # a dead target's boot removes the staged copy
            v.read_only = was_ro
            metrics.VOLUME_MOVES.labels("aborted").inc()
            return web.json_response({"error": str(e)}, status=500)
        await asyncio.to_thread(self.store.delete_volume, vid)
        await self._heartbeat_once()
        metrics.VOLUME_MOVES.labels("ok").inc()
        return web.json_response({"moved": vid, "target": target,
                                  "crc": local_crc})

    async def _volume_copy_incremental(self, v: Volume, vid: int,
                                       source: str,
                                       collection: str) -> web.Response:
        """Stage the source's .dat tail and .idx without touching the
        live volume, then apply both at once under the volume's lock
        (`Volume.apply_catch_up`): a concurrent write either lands before
        the size snapshot (and is copied) or fails the apply cleanly
        (reference: volume_grpc_copy_incremental.go)."""
        name = os.path.basename(v.dat_path)
        # a vacuumed source has another compaction revision: its tail
        # appended to the pre-vacuum bytes here would corrupt the replica
        try:
            async with self._session.get(
                    f"{tls.scheme()}://{source}/admin/file",
                    params={"name": name},
                    headers={"Range": "bytes=0-7"}) as r:
                if r.status not in (200, 206):
                    return web.json_response(
                        {"error": f"probe super block: HTTP {r.status}"},
                        status=500)
                remote_sb = await r.read()
        except aiohttp.ClientError as e:
            return web.json_response({"error": str(e)}, status=500)
        try:
            remote_rev = SuperBlock.from_bytes(
                remote_sb.ljust(64, b"\0")).compaction_revision
        except Exception:
            return web.json_response({"error": "bad source super block"},
                                     status=500)
        if remote_rev != v.super_block.compaction_revision:
            return web.json_response(
                {"error": "source compaction revision differs; full "
                          "re-copy required (delete the local copy)"},
                status=409)

        local_size = v.data_size()
        tail_path = v.dat_path + ".cptail"
        try:
            async with self._session.get(
                    f"{tls.scheme()}://{source}/admin/file",
                    params={"name": name},
                    headers={"Range": f"bytes={local_size}-"}) as r:
                if r.status == 416:
                    cr = r.headers.get("Content-Range", "")  # "bytes */N"
                    try:
                        src_size = int(cr.rpartition("/")[2])
                    except ValueError:
                        src_size = local_size
                    if src_size < local_size:
                        return web.json_response(
                            {"error": "local replica is ahead of the "
                                      "source; refusing incremental copy"},
                            status=409)
                    with open(tail_path, "wb"):
                        pass
                elif r.status == 206:
                    with open(tail_path, "wb") as f:
                        async for chunk in r.content.iter_chunked(1 << 20):
                            netflow.account("recv",
                                            netflow.current_class(),
                                            "volume", len(chunk))
                            f.write(chunk)
                elif r.status == 200:
                    return web.json_response(
                        {"error": "source ignored the Range; refusing "
                                  "incremental copy"}, status=409)
                else:
                    return web.json_response(
                        {"error": f"pull tail: HTTP {r.status}"}, status=500)
            idx_name = os.path.basename(v.idx_path)
            async with self._session.get(
                    f"{tls.scheme()}://{source}/admin/file",
                    params={"name": idx_name}) as r:
                if r.status != 200:
                    return web.json_response(
                        {"error": f"pull idx: HTTP {r.status}"}, status=500)
                idx_raw = await r.read()
            try:
                appended = await asyncio.to_thread(
                    v.apply_catch_up, local_size, tail_path, idx_raw)
            except (RuntimeError, PermissionError) as e:
                return web.json_response({"error": str(e)}, status=409)
        except aiohttp.ClientError as e:
            return web.json_response({"error": str(e)}, status=500)
        finally:
            try:
                os.remove(tail_path)
            except OSError:
                pass
        await self._heartbeat_once()
        return web.json_response({"incremental": True,
                                  "appended_bytes": appended})

    async def handle_volume_unconvert(self, req: web.Request
                                      ) -> web.Response:
        """POST /admin/volume/unconvert {"volume"}: an EC volume back to a
        writable volume (the autopilot's tiering promote, reversing the
        fleet conversion's demote).  Missing data shards are rebuilt on
        the store's device (K1); the data shards decode into `.dat.unc`
        and the `.ecx` into `.idx.unc`, renamed once both are written
        (a crash mid-decode leaves no half .dat a boot would mount); the
        volume mounts, thaws, and the shard set is retired, its `.ecx`
        first.  When the conversion's frozen `.dat` is still mounted the
        decode is skipped: the thaw alone promotes.  The job registers
        in the per-vid table, so /admin/ec/progress observes it."""
        body = await req.json()
        try:
            vid = int(body["volume"])
        except (KeyError, TypeError, ValueError):
            return web.json_response({"error": "volume required"},
                                     status=400)
        base = self._ec_base(vid)
        if base is None or not os.path.exists(base + ".ecx"):
            return web.json_response({"error": "no ec volume here"},
                                     status=404)
        if self._ec_jobs.get(vid, {}).get("state") == "running":
            return web.json_response({"error": "ec job already running"},
                                     status=409)
        existing = self.store.get_volume(vid)
        job = {"state": "running", "kind": "unconvert", "bytes_done": 0,
               "total": 0, "cancel": False, "error": None,
               "started": time.time(), "stages": {}}
        self._ec_jobs[vid] = job

        def decode() -> bool:
            if existing is not None and \
                    os.path.exists(existing._base + ".dat"):
                return False  # the frozen .dat survives: thaw only
            spec = codecs.parse_tag(
                (ec_files.read_vif(base) or {}).get("codec"))
            missing = [i for i in range(spec.k)
                       if not os.path.exists(base + layout.to_ext(i))]
            if missing:
                ec_files.rebuild_ec_files(base, device=self.device,
                                          codec_tag=spec.tag)
            dat_size = ec_files.find_dat_file_size(base)
            job["total"] = dat_size
            dat_tmp, idx_tmp = base + ".dat.unc", base + ".idx.unc"
            try:
                ec_files.write_dat_file(base, dat_size, out_path=dat_tmp)
                ec_files.write_idx_from_ecx(base + ".ecx", idx_tmp)
            except BaseException:
                for p in (dat_tmp, idx_tmp):
                    try:
                        os.remove(p)
                    except OSError:
                        pass
                raise
            # the .idx lands first: a .dat without its .idx rebuilds its
            # map at mount, an orphan .idx mounts nothing
            os.replace(idx_tmp, base + ".idx")
            os.replace(dat_tmp, base + ".dat")
            job["bytes_done"] = dat_size
            return True

        try:
            with trace.span("volume.unconvert", vid=vid):
                decoded = await asyncio.to_thread(decode)
        except Exception as e:
            job["state"] = "failed"
            job["error"] = str(e)
            return web.json_response({"error": str(e)}, status=500)
        loc = next(loc for loc in self.store.locations
                   if base.startswith(loc.directory))
        v = existing
        if v is None:
            stem = os.path.basename(base)
            collection = body.get("collection") or \
                loc.collections.get(vid) or \
                (stem[: -(len(str(vid)) + 1)]
                 if stem.endswith(f"_{vid}") else "")
            try:
                v = await asyncio.to_thread(Volume, loc.directory,
                                            collection, vid)
            except Exception as e:
                job["state"] = "failed"
                job["error"] = str(e)
                return web.json_response({"error": f"load: {e}"},
                                         status=500)
            loc.volumes[vid] = v
            loc.collections[vid] = collection
        # the shard set goes before the thaw, its .ecx first: a boot
        # mounts EC volumes by their .ecx, so a crash from here on boots
        # the plain volume alone, never a writable .dat beside a stale
        # shard set
        for lc in self.store.locations:
            ev = lc.ec_volumes.pop(vid, None)
            if ev is not None:
                ev.close()
        for ext in (".ecx", ".ecj", ".vif"):
            if os.path.exists(base + ext):
                os.remove(base + ext)
        removed = []
        for i in range(layout.MAX_TOTAL_SHARDS):
            p = base + layout.to_ext(i)
            if os.path.exists(p):
                os.remove(p)
                removed.append(i)
        v.read_only = False  # the thaw
        job["state"] = "done"
        await self._heartbeat_once()
        return web.json_response({"volume": vid, "decoded": decoded,
                                  "thawed": True,
                                  "shards_retired": removed})

    async def handle_tier_move(self, req: web.Request) -> web.Response:
        """Move a sealed volume's .dat to a remote tier (reference:
        volume_grpc_tier.go VolumeTierMoveDatToRemote)."""
        body = await req.json()
        vid = body["volume"]
        v = self.store.get_volume(vid)
        if v is None:
            return web.json_response({"error": "volume not found"},
                                     status=404)
        kind = body.get("kind", "local")
        options = body.get("options", {})
        try:
            await asyncio.to_thread(v.tier_move, kind, options,
                                    body.get("key"))
        except (ValueError, TypeError, OSError, PermissionError,
                RuntimeError) as e:
            return web.json_response({"error": str(e)}, status=500)
        await self._heartbeat_once()
        return web.json_response({"backend": v.backend_kind})

    async def handle_tier_download(self, req: web.Request) -> web.Response:
        """Pull a tiered volume's .dat back from the remote (reference:
        volume_grpc_tier.go VolumeTierMoveDatFromRemote); with
        `delete_remote` the remote copy goes too."""
        body = await req.json()
        vid = body["volume"]
        v = self.store.get_volume(vid)
        if v is None:
            return web.json_response({"error": "volume not found"},
                                     status=404)
        try:
            await asyncio.to_thread(
                v.tier_download, bool(body.get("delete_remote")))
        except (ValueError, TypeError, OSError, PermissionError) as e:
            return web.json_response({"error": str(e)}, status=500)
        await self._heartbeat_once()
        return web.json_response({"backend": v.backend_kind})

    # -- admin: needles and query ----------------------------------------

    async def handle_volume_needles(self, req: web.Request) -> web.Response:
        """The live needle ids of a volume (volume.fsck and
        volume.check.disk; the reference streams the .idx through
        CopyFile or VolumeNeedleStatus)."""
        vid = int(req.query["volume"])
        v = self.store.get_volume(vid)
        if v is None:
            return web.json_response({"error": "not found"}, status=404)
        limit = int(req.query.get("limit", "1000000"))
        needles = []
        for nid, (_off, size) in v.nm.items():
            if size >= 0:
                needles.append(nid)
                if len(needles) >= limit:
                    break
        return web.json_response({"volume": vid, "count": len(needles),
                                  "needles": needles})

    async def handle_query(self, req: web.Request) -> web.Response:
        """S3-Select-style JSON query over a volume's needles (reference:
        volume_server.proto:107 Query, weed/server/volume_grpc_query.go,
        weed/query/json).  Body: {volume, filter: {field, op, value}?,
        projections: [fields]?, limit?} -> NDJSON of the matching,
        projected documents.  The read key, when configured, gates it as
        it gates GET /{fid}."""
        if self.security is not None and self.security.volume_read:
            token = sjwt.token_from_request(req.headers, req.query)
            try:
                sjwt.decode_jwt(self.security.volume_read, token)
            except sjwt.JwtError as e:
                return web.json_response({"error": str(e)}, status=401)
        body = await req.json()
        vid = body["volume"]
        v = self.store.get_volume(vid)
        if v is None:
            return web.json_response({"error": "volume not found"},
                                     status=404)
        flt = body.get("filter")
        projections = body.get("projections")
        limit = int(body.get("limit", 10000))

        def match(doc: dict) -> bool:
            if not flt:
                return True
            val = doc.get(flt["field"])
            want = flt.get("value")
            op = flt.get("op", "=")
            try:
                if op in ("=", "=="):
                    return val == want
                if op == "!=":
                    return val != want
                if op == ">":
                    return val is not None and val > want
                if op == ">=":
                    return val is not None and val >= want
                if op == "<":
                    return val is not None and val < want
                if op == "<=":
                    return val is not None and val <= want
                if op == "like":
                    return isinstance(val, str) and str(want) in val
            except TypeError:
                return False
            return False

        def run_query() -> list[bytes]:
            rows = []
            for offset, n in v.scan():
                if not n.data or not v.has_needle(n.id):
                    continue
                # only the record the needle map points at is live: the
                # map holds offsets in NEEDLE_PADDING_SIZE units
                live = v.nm.get(n.id)
                if live is None or \
                        live[0] != offset // t.NEEDLE_PADDING_SIZE:
                    continue
                try:
                    doc = json.loads(n.data)
                except (ValueError, UnicodeDecodeError):
                    continue
                if not isinstance(doc, dict) or not match(doc):
                    continue
                if projections:
                    doc = {k: doc.get(k) for k in projections}
                rows.append(json.dumps(doc, separators=(",", ":")).encode())
                if len(rows) >= limit:
                    break
            return rows

        rows = await asyncio.to_thread(run_query)
        return web.Response(body=b"\n".join(rows) + (b"\n" if rows else b""),
                            content_type="application/x-ndjson")

    async def handle_ec_shard_read(self, req: web.Request) -> web.Response:
        if self._fault_delay_shard_read > 0:
            await asyncio.sleep(self._fault_delay_shard_read)
        q = req.query
        vid, sid = int(q["volume"]), int(q["shard"])
        offset, size = int(q["offset"]), int(q["size"])
        ev = self.store.get_ec_volume(vid)
        if ev is None:
            return web.json_response({"error": "not mounted"}, status=404)
        data = ev._read_local(sid, offset, size)
        if data is None:
            return web.json_response({"error": "shard not local"},
                                     status=404)
        return web.Response(body=data,
                            content_type="application/octet-stream")

    async def handle_ec_partial(self, req: web.Request) -> web.Response:
        """A reduced-read repair helper's hop: the XOR-combinable partial
        product coeff @ local shard ranges over GF(2^8), computed on the
        store's device (K1 through `dispatch.apply_matrix`), returned as
        the raw [f, size] bytes.  MSR sub-rows: with `alpha` > 1 the
        shard ids are virtual (file * alpha + row) and offset and size
        are in sub-row bytes.  A quarantined range reads as unreadable:
        409, and the repairing node replans around it."""
        if self._fault_delay_shard_read > 0:
            await asyncio.sleep(self._fault_delay_shard_read)
        try:
            body = await req.json()
            vid = int(body["volume"])
            sids = [int(s) for s in body["shards"]]
            offset, size = int(body["offset"]), int(body["size"])
            coeff = np.asarray(body["coeff"], dtype=np.uint8)
            alpha = int(body.get("alpha", 1) or 1)
        except (KeyError, TypeError, ValueError):
            return web.json_response({"error": "bad partial request"},
                                     status=400)
        # len(sids) x size bounds the rows stacked in memory: one
        # malformed request must not pread an unbounded multiple of size
        if not sids or alpha < 1 or alpha > 64 or \
                len(sids) > layout.TOTAL_SHARDS * max(1, alpha) or \
                len(set(sids)) != len(sids) or \
                size <= 0 or size * alpha > ec_files.DEFAULT_BATCH or \
                coeff.ndim != 2 or coeff.shape[1] != len(sids) or \
                coeff.shape[0] > max(layout.PARITY_SHARDS, len(sids)):
            return web.json_response({"error": "bad partial shape"},
                                     status=400)
        base = self._ec_base(vid)
        if base is None:
            return web.json_response({"error": "no shards here"},
                                     status=404)
        ev = self.store.get_ec_volume(vid)

        def read_range(fsid: int, off: int, n: int) -> bytes | None:
            if ev is not None:
                # honours the quarantine: corrupt ranges read as None
                return ev._read_local(fsid, off, n)
            try:
                fd = os.open(base + layout.to_ext(fsid), os.O_RDONLY)
            except OSError:
                return None
            try:
                return os.pread(fd, n, off)
            except OSError:
                return None
            finally:
                os.close(fd)

        def compute() -> bytes:
            rows = []
            if alpha > 1:
                # one pread and de-interleave per file, shared by its
                # alpha virtual sub-rows
                blocks: dict[int, np.ndarray] = {}
                for fsid in sorted({s // alpha for s in sids}):
                    data = read_range(fsid, offset * alpha, size * alpha)
                    if data is None or len(data) != size * alpha:
                        raise KeyError(fsid)
                    blocks[fsid] = np.frombuffer(
                        data, dtype=np.uint8).reshape(size, alpha)
                for sid in sids:
                    rows.append(np.ascontiguousarray(
                        blocks[sid // alpha][:, sid % alpha]))
            else:
                for sid in sids:
                    data = read_range(sid, offset, size)
                    if data is None or len(data) != size:
                        raise KeyError(sid)
                    rows.append(np.frombuffer(data, dtype=np.uint8))
            codec = ec_files._get_codec(self.device)
            return dispatch.apply_matrix(codec, coeff,
                                         np.stack(rows)).tobytes()

        try:
            with trace.span("volume.ec_partial", vid=vid,
                            shards=",".join(map(str, sids)),
                            bytes=size * len(sids)):
                out = await asyncio.to_thread(compute)
        except KeyError as e:
            return web.json_response(
                {"error": f"shard {e.args[0]} unreadable or quarantined"},
                status=409)
        return web.Response(body=out,
                            content_type="application/octet-stream")

    def _partial_fetcher(self, vid: int, alpha: int = 1):
        """The repairing node's side of /admin/ec/partial.  It runs on the
        repair's pool threads, so the trace context, the traffic class
        and the deadline are captured here.  It rides the per-peer
        breakers and the deadline, and maps every failure of a helper to
        regen.HelperDied, so the rebuild replans with a substitute
        survivor instead of aborting."""
        tctx = trace.current()
        flow_cls = netflow.current_class() or "repair"
        dl = resilience.deadline()

        def fetch(group, sids, coeff, offset, size) -> bytes:
            node = group.node
            breaker = resilience.breaker_for(node) \
                if resilience.breaker_enabled() else None
            if breaker is not None and not breaker.allow():
                raise regen.HelperDied(node, tuple(sids))
            try:
                if faults.NET_ACTIVE:
                    lat = faults.check_net("volume", node)
                    if lat > 0:
                        time.sleep(lat)
            except OSError as e:
                raise regen.HelperDied(node, tuple(sids)) from e
            tmo = 60.0
            if dl is not None:
                tmo = min(tmo, dl - time.monotonic())
                if tmo <= 0.01:
                    raise regen.HelperDied(node, tuple(sids))
            payload = json.dumps({
                "volume": vid, "shards": list(sids),
                "coeff": coeff.tolist(), "offset": offset, "size": size,
                **({"alpha": alpha} if alpha > 1 else {})}).encode()
            try:
                with trace.span("repair.partial_fetch", parent=tctx,
                                vid=vid, peer=node,
                                shards=",".join(map(str, sids)),
                                bytes=coeff.shape[0] * size,
                                locality=group.locality) as sp:
                    r = urllib.request.Request(
                        f"{tls.scheme()}://{node}/admin/ec/partial",
                        data=payload,
                        headers={"Content-Type": "application/json"})
                    hdr_ctx = sp.trace or tctx
                    if hdr_ctx is not None:
                        r.add_header(trace.TRACE_HEADER,
                                     trace.format_header(hdr_ctx))
                    r.add_header(netflow.CLASS_HEADER, flow_cls)
                    r.add_header(netflow.ROLE_HEADER, "volume")
                    if dl is not None:
                        r.add_header(
                            resilience.DEADLINE_HEADER,
                            str(max(1, int((dl - time.monotonic())
                                           * 1000))))
                    with urllib.request.urlopen(r, timeout=tmo) as rr:
                        data = rr.read()
            except urllib.error.HTTPError as e:
                # the peer answered (quarantined survivor, shard moved):
                # a content miss, not a transport failure; replan
                # without the helper, its breaker untouched
                if breaker is not None:
                    breaker.record(True)
                raise regen.HelperDied(node, tuple(sids)) from e
            except OSError as e:
                if breaker is not None and \
                        (dl is None or dl - time.monotonic() > 0.05):
                    breaker.record(False)
                raise regen.HelperDied(node, tuple(sids)) from e
            if breaker is not None:
                breaker.record(True)
            netflow.account("recv", flow_cls, "volume", len(data))
            metrics.REPAIR_BYTES.labels(
                locality_name(group.locality)).inc(len(data))
            return data

        return fetch

    async def handle_ec_probe_read(self, req: web.Request) -> web.Response:
        """The canary's degraded-read probe (the reference master's
        stats/canary.py): read one real needle of an EC volume with one
        of its planned shards withheld (`skip_shards`, which blocks the
        remote reader too), so the read reconstructs.  Returns the byte
        count and the withheld shard."""
        try:
            vid = int(req.query.get("volume", "0"))
        except ValueError:
            return web.json_response({"error": "bad volume"}, status=400)
        ev = self.store.get_ec_volume(vid)
        if ev is None:
            return web.json_response({"error": "not mounted"}, status=404)
        nid = next((int(i) for i, sz in zip(ev.ids, ev.sizes)
                    if t.size_is_valid(int(sz))), None)
        if nid is None:
            return web.json_response({"error": "no needles"}, status=404)
        try:
            dat_off, size = ev.find_needle(nid)
            intervals = layout.locate_data(
                ev.large_block, ev.small_block, ev.dat_size, dat_off,
                t.actual_size(size, ev.version))
            planned = sorted({iv.to_shard_id_and_offset(
                ev.large_block, ev.small_block)[0] for iv in intervals})
        except KeyError:
            planned = []
        if not planned:
            return web.json_response({"error": "no needles"}, status=404)
        skip = next((s for s in planned if s in ev.shards), planned[0])
        reader = self._shard_reader(vid)
        try:
            with trace.span("volume.probe_read", vid=vid, skip=skip):
                n = await asyncio.to_thread(
                    ev.read_needle, nid, reader, None, frozenset({skip}))
        except (KeyError, IOError, ValueError) as e:
            return web.json_response(
                {"error": f"degraded probe read failed: {e}"}, status=503)
        return web.json_response({"needle": f"{nid:x}",
                                  "bytes": len(n.data),
                                  "skipped_shard": skip})

    async def handle_ec_recode(self, req: web.Request) -> web.Response:
        """Re-encode an EC volume under another code, in place (the
        autopilot's codec select): the data shards (any missing one
        regenerated first) decode to a temporary .dat, which
        `write_ec_files` encodes under the target code on the store's
        device, committing each shard by rename and rewriting the .vif;
        shard files past the new geometry are then retired and the
        volume remounted.  Needs k of the old code's shards here."""
        body = await req.json()
        try:
            vid = int(body["volume"])
        except (KeyError, TypeError, ValueError):
            return web.json_response({"error": "bad volume"}, status=400)
        to = codecs.parse_tag(body.get("codec") or codecs.default_tag())
        base = self._ec_base(vid)
        if base is None:
            return web.json_response({"error": "no shards here"}, status=404)
        old = codecs.parse_tag((ec_files.read_vif(base) or {}).get("codec"))
        if old.tag == to.tag:
            return web.json_response({"codec": to.tag, "unchanged": True})
        if self._ec_jobs.get(vid, {}).get("state") == "running":
            return web.json_response({"error": "ec job already running"},
                                     status=409)
        present = [i for i in range(old.n)
                   if os.path.exists(base + layout.to_ext(i))]
        if len(present) < old.k:
            return web.json_response(
                {"error": f"recode needs {old.k} local shards, "
                          f"have {len(present)}"}, status=409)
        stages: dict = {}
        job = {"state": "running", "kind": "recode", "bytes_done": 0,
               "total": 0, "cancel": False, "error": None,
               "started": time.time(), "stages": stages,
               "from": old.tag, "codec": to.tag}
        self._ec_jobs[vid] = job
        tmp_dat = base + ".dat.recode"

        def work():
            if any(i not in present for i in range(old.k)):
                ec_files.rebuild_ec_files(base, codec_tag=old.tag,
                                          device=self.device)
            dat_size = ec_files.find_dat_file_size(base)
            job["total"] = dat_size
            ec_files.write_dat_file(base, dat_size, out_path=tmp_dat)
            ec_files.write_ec_files(
                base, dat_path=tmp_dat,
                progress=lambda n: job.__setitem__("bytes_done", n),
                cancel=lambda: job["cancel"],
                stats=stages, codec_tag=to.tag, device=self.device)
            # shard files past the new geometry are the old code's: a
            # later fsck or rebuild must not count or mix them
            for i in range(to.n, max(old.n, to.n)):
                try:
                    os.remove(base + layout.to_ext(i))
                except OSError:
                    pass

        try:
            await asyncio.to_thread(work)
        except ec_files.EncodeCancelled:
            job["state"] = "cancelled"
            return web.json_response({"error": "cancelled"}, status=409)
        except Exception as e:
            job["state"] = "failed"
            job["error"] = str(e)
            return web.json_response({"error": str(e)}, status=500)
        finally:
            try:
                os.remove(tmp_dat)
            except OSError:
                pass
        # remount, so the served code is the new shard set's
        loc = next(loc for loc in self.store.locations
                   if base.startswith(loc.directory))
        ev = loc.ec_volumes.pop(vid, None)
        if ev is not None:
            ev.close()
        loc.ec_volumes[vid] = ecv.EcVolume(base, device=self.device)
        job["state"] = "done"
        job["bytes_done"] = job["total"]
        await self._heartbeat_once()
        return web.json_response(
            {"codec": to.tag, "from": old.tag,
             "shards": loc.ec_volumes[vid].shard_ids()})

    async def handle_file_pull(self, req: web.Request) -> web.StreamResponse:
        """Serve a volume or EC file by basename for peer pulls (the
        source side of VolumeEcShardsCopy)."""
        if self._fault_delay_file_pull > 0:
            await asyncio.sleep(self._fault_delay_file_pull)
        name = req.query.get("name", "")
        if "/" in name or ".." in name:
            return web.json_response({"error": "bad name"}, status=400)
        ok_ext = name.endswith((".dat", ".idx")) or \
            any(name.endswith(e) for e in EC_FILE_EXTS)
        if not ok_ext:
            return web.json_response({"error": "bad extension"}, status=400)
        if name.endswith((".dat", ".idx")):
            # flush buffered index and data writes so peers pull a
            # current copy
            stem = name.rsplit(".", 1)[0]
            try:
                vid = int(stem.rsplit("_", 1)[-1] if "_" in stem else stem)
            except ValueError:
                vid = -1
            v = self.store.get_volume(vid)
            if v is not None:
                await asyncio.to_thread(v.flush)
        for loc in self.store.locations:
            p = os.path.join(loc.directory, name)
            if os.path.exists(p):
                return web.FileResponse(p)
        return web.json_response({"error": "file not found"}, status=404)

    # -- maintenance: scrub and fault injection ------------------------

    def _report_scrub(self, summary: dict) -> None:
        """Push a scrub pass's verdicts to the master's repair planner.
        Runs on the scrub thread: a blocking client."""
        body = json.dumps({"node": self.url, "ts": summary.get("ts"),
                           "volumes": summary.get("volumes", {})}).encode()
        try:
            r = urllib.request.Request(
                f"{tls.scheme()}://{self.master_url}"
                "/maintenance/scrub_report", data=body,
                headers={"Content-Type": "application/json"})
            urllib.request.urlopen(r, timeout=10).close()
        except OSError as e:
            log.warning("scrub report to %s failed: %s", self.master_url, e)

    async def handle_scrub(self, req: web.Request) -> web.Response:
        """Run one scrub pass now at the configured rate, report it to
        the master and answer its summary (loopback only).  Without a
        background scrubber (WEEDTPU_SCRUB_MBPS=0) the pass is made by
        one built for it from the knobs, and so answers paused, as the
        reference's does."""
        err = trace.loopback_error(req)
        if err is not None:
            return err
        s = self.scrubber
        if s is None:
            s = scrubmod.Scrubber(self.store,
                                  shard_reader_factory=self._shard_reader)
        summary = await asyncio.to_thread(s.scrub_once)
        await asyncio.to_thread(self._report_scrub, summary)
        return web.json_response(summary)

    async def handle_scrub_rate(self, req: web.Request) -> web.Response:
        """Retune the background scrubber live: the operator's `mbps`
        ({"mbps": 0} pauses until an operator resumes) or the master's
        interference governor's `scale` of this node's configured rate
        (and `governed: true` on an `mbps` push, which respects the
        operator's pause).  A node without a scrubber answers
        {"mbps": null}."""
        try:
            body = await req.json()
            scale = body.get("scale")
            mbps = float(scale) if scale is not None \
                else float(body.get("mbps"))
        except (ValueError, TypeError, AttributeError):
            # AttributeError: a JSON body that is not an object ('[2.5]')
            return web.json_response({"error": "mbps or scale required"},
                                     status=400)
        if self.scrubber is None:
            return web.json_response({"mbps": None})
        if scale is not None:
            out = self.scrubber.apply_governed_scale(mbps)
        else:
            out = self.scrubber.set_mbps(
                mbps, governed=bool(body.get("governed")))
        return web.json_response(
            {"mbps": out, "operator_paused": self.scrubber.operator_paused})

    async def handle_faults(self, req: web.Request) -> web.Response:
        """Fault injection (maintenance/faults.py): delete a shard, flip
        a bit, delay peer shard reads or file pulls, and the process-wide
        network and disk faults.  Loopback only."""
        err = trace.loopback_error(req)
        if err is not None:
            return err
        body = await req.json()
        applied = []
        for f in body.get("faults", []):
            if f.get("action") == "delay_shard_read":
                self._fault_delay_shard_read = float(f.get("ms", 0)) / 1000.0
                applied.append(dict(f, ok=True))
                continue
            if f.get("action") == "delay_file_pull":
                self._fault_delay_file_pull = float(f.get("ms", 0)) / 1000.0
                applied.append(dict(f, ok=True))
                continue
            applied.append(await asyncio.to_thread(
                faults.apply, self.store, f))
        await self._heartbeat_once()
        return web.json_response({"applied": applied})
