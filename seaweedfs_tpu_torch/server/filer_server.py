"""Filer server: HTTP file API over the Filer metadata core + blob store.

Capability parity with the reference filer server (weed/server/
filer_server.go, filer_server_handlers_write_autochunk.go:26-151,
filer_server_handlers_read.go + weed/filer/stream.go):

  POST/PUT /path/file   upload; body auto-chunked into blob-store chunks
                        assigned by the master (?collection ?replication
                        ?ttl ?maxMB override path rules); `Seaweed-`
                        headers become extended attrs; trailing slash or
                        empty body with dir mime creates a directory
  GET /path/file        stream file (Range supported); ?metadata=true
                        returns the entry JSON
  GET /path/dir/        JSON listing (?limit ?lastFileName ?prefix)
  HEAD                  attrs only
  DELETE                ?recursive=true for dirs; chunks enqueued for
                        background blob deletion
  POST /new?mv.from=/x  rename/move (subtree-safe)
  POST /new?link.from=/x  hardlink: second name for the same chunks
  POST /p?symlink.to=t  symlink entry (readlink = ?metadata=true)
  POST /p?op=attr       JSON attr deltas: mode/uid/gid/mtime/crtime +
                        extended_set/extended_del (chmod/chown/utimens/
                        xattr seam for the mount)

Plus the meta-event feed the reference serves over gRPC
(SubscribeMetadata): GET /__meta__/subscribe?since=<ts_ns> streams JSONL
events, replay-then-live, for filer.sync and gateway cache invalidation.

Counterpart of `seaweedfs_tpu/server/filer_server.py`, whole: the same
routes, answers, listing JSON, meta events and store files, so a filer
data directory written by either package serves from the other, and
either package's shell drives either filer.  Like the port's master,
client and shell it has no device and loads no torch: its reads are
chunk GETs from the volume servers, and a GET of a needle on a lost data
shard of an EC volume is a degraded read that the card server decodes.

`notification` is any object with `send(key, dict)`; the queue classes
come with replication (ROADMAP 1.22a), and /__admin__/notify answers 400
without one.  A remote mount reads through `remote_storage.make_remote`,
which knows `local` only until then: a mount of another kind raises on
its first read.
"""

from __future__ import annotations

import asyncio
import gzip
import hashlib
import html
import json
import logging
import mimetypes
import os
import stat
import sys
import time
import urllib.parse
from collections import deque

import aiohttp
from aiohttp import web

from seaweedfs_tpu_torch.client import WeedClient
from seaweedfs_tpu_torch.filer import filechunk_manifest as fcm
from seaweedfs_tpu_torch.filer import filechunks as fc
from seaweedfs_tpu_torch.filer.abstract_sql import SqliteStore
from seaweedfs_tpu_torch.filer.entry import (Attr, Entry, FileChunk,
                                             new_directory_entry)
from seaweedfs_tpu_torch.filer.filechunk_section import (ChunkGroup,
                                                         ReaderPattern)
from seaweedfs_tpu_torch.filer.filer import Filer, dir_has_prefix
from seaweedfs_tpu_torch.filer.filer_conf import (FilerConf, PathConf,
                                                  load_filer_conf,
                                                  save_filer_conf)
from seaweedfs_tpu_torch.filer.filer_deletion import DeletionQueue
from seaweedfs_tpu_torch.filer.filerstore import (MemoryStore, NotFound,
                                                  make_store)
from seaweedfs_tpu_torch.maintenance import faults
from seaweedfs_tpu_torch.remote_storage import make_remote, parse_remote_spec
from seaweedfs_tpu_torch.replication.filer_sync import filer_signature
from seaweedfs_tpu_torch.security import jwt
from seaweedfs_tpu_torch.security import tls as _tls
from seaweedfs_tpu_torch.security.tls import scheme as _tls_scheme
from seaweedfs_tpu_torch.server import ui
from seaweedfs_tpu_torch.stats import (heat, metrics, netflow, pipeline,
                                       profile, trace)
from seaweedfs_tpu_torch.utils import cipher, resilience
from seaweedfs_tpu_torch.utils.chunk_cache import ChunkCache
from seaweedfs_tpu_torch.utils.hashring import RendezvousRing
from seaweedfs_tpu_torch.utils.http import aiohttp_trace_config, parse_range
from seaweedfs_tpu_torch.utils.resilience import _env_float
from seaweedfs_tpu_torch.utils.vid_cache import AsyncVidResolver, VidCache

log = logging.getLogger("filer")

DEFAULT_CHUNK_SIZE = 4 * 1024 * 1024  # reference filer -maxMB default (4MB)


class FilerServer:
    def __init__(self, master_url: str, host: str = "127.0.0.1",
                 port: int = 8888, data_dir: str | None = None,
                 collection: str = "", replication: str = "",
                 chunk_size: int = DEFAULT_CHUNK_SIZE,
                 jwt_signer=None, security=None, notification=None,
                 encrypt_data: bool = False,
                 chunk_cache_mem: int = 32 * 1024 * 1024,
                 chunk_cache_disk: int = 0, store_kind: str | None = None,
                 aggregate_peers: bool = False, region: str | None = None):
        self.master_url = master_url
        self.host, self.port = host, port
        # geo region this filer serves in ("" = single-region): stamped
        # on trace spans so /cluster/trace waterfalls show which side of
        # the WAN each hop ran on, and registered with the fault plane
        # so region_partition/wan_latency chaos can find us
        self.region = os.environ.get("WEEDTPU_GEO_REGION", "") \
            if region is None else region
        self.collection = collection
        self.replication = replication
        self.chunk_size = chunk_size
        self.security = security
        if jwt_signer is None and security is not None and \
                security.volume_write:
            jwt_signer = lambda fid: jwt.gen_jwt(  # noqa: E731
                security.volume_write, fid)
        self.jwt_signer = jwt_signer

        if data_dir:
            os.makedirs(data_dir, exist_ok=True)
            if store_kind and store_kind not in ("sqlite",):
                if store_kind == "logstore":
                    store = make_store("logstore",
                                       directory=os.path.join(
                                           data_dir, "logstore"))
                else:
                    store = make_store(store_kind)
            else:
                store = SqliteStore(os.path.join(data_dir, "filer.db"))
            meta_log_path = os.path.join(data_dir, "meta_events.jsonl")
        elif store_kind and store_kind != "memory":
            if store_kind in ("logstore", "sqlite"):
                raise ValueError(
                    f"filer store {store_kind!r} needs -dir for its files")
            store = make_store(store_kind)
            meta_log_path = None
        else:
            store = MemoryStore()
            meta_log_path = None
        self._rmw_locks: dict[str, asyncio.Lock] = {}
        self.deletion = DeletionQueue(
            WeedClient(master_url, jwt_signer=self.jwt_signer),
            resolve_manifest=self._resolve_for_delete)
        self.filer = Filer(store, meta_log_path=meta_log_path,
                           on_delete_chunks=self.deletion.enqueue_chunks)
        self.conf: FilerConf = load_filer_conf(self.filer.store)

        self.app = web.Application(
            client_max_size=1024 * 1024 * 1024,
            middlewares=[trace.aiohttp_middleware(
                "filer", slow_exempt=("/__meta__/subscribe",),
                region=self.region)])
        netflow.install(self.app, "filer")
        self.app.add_routes(trace.debug_routes())
        self.app.add_routes([
            web.get("/__meta__/subscribe", self.handle_meta_subscribe),
            web.get("/__meta__/digest", self.handle_meta_digest),
            web.post("/__admin__/entry", self.handle_raw_entry),
            web.get("/status", self.handle_server_status),
            web.get("/__admin__/filer_conf", self.handle_get_conf),
            web.get("/__admin__/remote_mounts", self.handle_get_mounts),
            web.post("/__admin__/remote_mounts", self.handle_put_mounts),
            web.post("/__admin__/filer_conf", self.handle_put_conf),
            web.post("/__admin__/notify", self.handle_notify_subtree),
            web.get("/__admin__/status", self.handle_status),
            web.get("/__ui__", self.handle_ui),
            web.get("/metrics", self.handle_metrics),
            web.get("/heat", heat.handle_heat),
            web.get("/perf", pipeline.handle_perf),
            web.get("/__hot__/chunk/{fid}", self.handle_hot_chunk),
            web.post("/__hot__/seed", self.handle_hot_seed),
            web.get("/__hot__/status", self.handle_hot_status),
            web.route("*", "/{path:.*}", self.handle_path),
        ])
        self.notification = notification  # MessageQueue | None
        # per-chunk AES-GCM (reference: filer -encryptVolumeData)
        self.encrypt_data = encrypt_data
        # tiered chunk cache on the read path (reference: util/chunk_cache)
        # sectioned chunk resolution + read-pattern detection for huge
        # files (reference: filechunk_group.go / reader_pattern.go)
        self._chunk_groups: dict = {}
        self._read_patterns: dict = {}
        cache_dir = None
        if chunk_cache_disk and data_dir:
            cache_dir = os.path.join(data_dir, "chunk_cache")
        self.chunk_cache = ChunkCache(mem_limit=chunk_cache_mem,
                                      disk_dir=cache_dir,
                                      disk_limit=chunk_cache_disk)
        # singleflight table for the streaming read path: (fid, cache) ->
        # the one in-flight fetch+decode every concurrent GET of that
        # chunk joins
        self._chunk_flight: dict[tuple[str, bool], asyncio.Future] = {}
        # shared vid->locations cache (utils/vid_cache.py): steady-state
        # chunk fetches resolve locations here instead of paying one
        # master /dir/lookup per cache miss; entries are pushed fresh by
        # the /cluster/stream subscription and carry the invalidate-once
        # re-lookup contract on total location failure
        self.vid_cache = VidCache()
        self._vid_resolver = AsyncVidResolver(self.vid_cache,
                                              self._master_lookup_vid)
        self._vid_stream_task: asyncio.Task | None = None
        self._vid_stream_live = False
        # cluster hot tier: each chunk has one home filer chosen by
        # rendezvous hash over live filer membership; local misses route
        # to the home so a hot chunk is fetched from the volume tier once
        # per cluster, not once per filer
        self.hot_ring = RendezvousRing()
        self.hot_enabled = os.environ.get("WEEDTPU_HOT_TIER", "1") != "0"
        # L1 mode additionally caches remote-home chunks locally (burns
        # the one-copy-per-cluster economy for lower hit latency)
        self.hot_l1 = os.environ.get("WEEDTPU_HOT_TIER_L1", "0") == "1"
        self.hot_stats = {"hit_local": 0, "route_out": 0, "route_in": 0,
                          "route_fail": 0, "seeded": 0, "seed_skipped": 0,
                          "direct": 0}
        self._blob_flight: dict[str, asyncio.Future] = {}
        self._hot_seed_task: asyncio.Task | None = None
        # peer meta aggregation (reference: weed/filer/meta_aggregator.go)
        self.aggregate_peers = aggregate_peers
        self._peer_tasks: dict[str, asyncio.Task] = {}
        self._runner: web.AppRunner | None = None
        self._session: aiohttp.ClientSession | None = None
        self._subscribers: set[asyncio.Queue] = set()
        # aggregator peers subscribe local-only so relayed events don't
        # fan back out (A->B->C duplication in 3+ filer clusters)
        self._local_subscribers: set[asyncio.Queue] = set()
        self._loop: asyncio.AbstractEventLoop | None = None

    def _notify_queue(self, ev) -> None:
        """Publish meta events to the configured notification queue
        (reference: weed/filer/filer_notify.go -> notification backend)."""
        try:
            self.notification.send(ev.directory, ev.to_dict())
        except Exception:
            log.warning("notification send failed", exc_info=True)

    # -- lifecycle -----------------------------------------------------

    @property
    def url(self) -> str:
        return f"{self.host}:{self.port}"

    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._session = aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(ssl=_tls.client_ssl()),
            timeout=aiohttp.ClientTimeout(total=60),
            trace_configs=[aiohttp_trace_config("filer")])
        self.deletion.start()
        self.filer.meta_log.subscribe(self._fanout_event)
        if self.notification is not None:
            self.filer.meta_log.subscribe(self._notify_queue)
        self._runner = web.AppRunner(self.app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.host, self.port,
                           ssl_context=_tls.server_ssl("filer"))
        await site.start()
        self._register_task = asyncio.create_task(self._register_loop())
        if os.environ.get("WEEDTPU_FILER_VID_STREAM", "1") != "0":
            self._vid_stream_task = asyncio.create_task(
                self._vid_stream_loop())
        seed_interval = _env_float("WEEDTPU_HOT_SEED_INTERVAL", 0.0)
        if self.hot_enabled and seed_interval > 0:
            self._hot_seed_task = asyncio.create_task(
                self._hot_seed_loop(seed_interval))
        profile.ensure_started()  # WEEDTPU_PROFILE_HZ, process-wide
        faults.register_node(self.url, "filer")
        if self.region:
            faults.register_region(self.url, self.region)
        log.info("filer listening on %s", self.url)

    async def _register_loop(self) -> None:
        """Announce this filer in the master's cluster membership so shells
        and peers can discover it (reference: weed/cluster/cluster.go
        filer registration through KeepConnected)."""
        bo = resilience.Backoff(base=2.0, cap=30.0)
        while True:
            try:
                async with self._session.post(
                        f"{_tls_scheme()}://{self.master_url}"
                        "/cluster/register",
                        json={"type": "filer", "address": self.url}):
                    pass
                await self._refresh_hot_ring()
                if self.aggregate_peers:
                    await self._refresh_peer_aggregators()
            except asyncio.CancelledError:
                raise
            except Exception:
                # the registration loop must survive anything (a dead
                # master, truncated JSON, timeouts) or the filer silently
                # drops out of the cluster until restart.  Failures retry
                # on the shared jittered backoff — quickly at first (a
                # master restart should re-register us well inside the
                # 30s membership horizon), decorrelated under a longer
                # outage so a filer fleet doesn't stampede the master
                log.warning("register/aggregate refresh failed",
                            exc_info=True)
                await asyncio.sleep(bo.next())
                continue
            bo.reset()
            await asyncio.sleep(10)

    # -- meta aggregator (reference: weed/filer/meta_aggregator.go) ------

    async def _refresh_peer_aggregators(self) -> None:
        """Discover peer filers via the master and keep one subscription
        per peer feeding this filer's live event stream, so subscribers of
        THIS filer see a cluster-wide merged change feed."""
        async with self._session.get(
                f"{_tls_scheme()}://{self.master_url}/cluster/status") as r:
            members = (await r.json()).get("Members", {})
        peers = [f for f in members.get("filer", []) if f != self.url]
        for peer in peers:
            if peer not in self._peer_tasks or self._peer_tasks[peer].done():
                self._peer_tasks[peer] = asyncio.create_task(
                    self._aggregate_from_peer(peer))
        for peer, task in list(self._peer_tasks.items()):
            if peer not in peers:
                task.cancel()
                del self._peer_tasks[peer]

    async def _aggregate_from_peer(self, peer: str) -> None:
        """Subscribe to one peer's local events and re-publish them into
        this filer's subscriber queues (not the local meta log).  Loop
        prevention mirrors the reference signature scheme: re-published
        events carry the source peer's signature, and events already
        stamped with OUR signature are skipped."""
        my_sig = filer_signature(self.url)
        peer_sig = filer_signature(peer)
        # resume from the per-peer offset persisted in the local store
        offset_key = f"meta_aggregator.{peer}".encode()
        try:
            since = int(self.filer.store.kv_get(offset_key))
        except (NotFound, ValueError):
            since = time.time_ns()
        log.info("aggregating meta events from peer filer %s", peer)
        while True:
            try:
                async with self._session.get(
                        f"{_tls_scheme()}://{peer}/__meta__/subscribe",
                        params={"since": str(since), "live": "true",
                                "localOnly": "true"},
                        timeout=aiohttp.ClientTimeout(total=None,
                                                      sock_read=300)) as r:
                    last_persist = 0.0
                    async for raw in r.content:
                        line = raw.strip()
                        if not line:
                            continue
                        d = json.loads(line)
                        since = max(since, d.get("ts_ns", since))
                        sigs = d.get("signatures") or []
                        if my_sig in sigs:
                            continue  # originated here; don't echo
                        if peer_sig not in sigs:
                            d["signatures"] = sigs + [peer_sig]
                        payload = json.dumps(d, separators=(",", ":"))
                        for q in list(self._subscribers):
                            if q.qsize() < 4096:
                                q.put_nowait(payload)
                        now = time.monotonic()
                        if now - last_persist >= 2.0:
                            last_persist = now
                            try:
                                await asyncio.to_thread(
                                    self.filer.store.kv_put, offset_key,
                                    str(since).encode())
                            except Exception:
                                pass
            except asyncio.CancelledError:
                return
            except (aiohttp.ClientError, json.JSONDecodeError,
                    ConnectionError, OSError):
                await asyncio.sleep(3)

    async def stop(self) -> None:
        if getattr(self, "_register_task", None):
            self._register_task.cancel()
        if self._vid_stream_task is not None:
            self._vid_stream_task.cancel()
        if self._hot_seed_task is not None:
            self._hot_seed_task.cancel()
        for task in self._peer_tasks.values():
            task.cancel()
        # live /__meta__/subscribe handlers end now rather than at their
        # next keepalive, which the runner's cleanup would wait for
        for q in self._subscribers | self._local_subscribers:
            q.put_nowait(None)
        self.deletion.stop(drain=False)
        if self._session:
            await self._session.close()
        if self._runner:
            await self._runner.cleanup()
        self.filer.meta_log.close()
        self.filer.store.shutdown()

    def _fanout_event(self, ev) -> None:
        if self._loop is None:
            return
        payload = json.dumps(ev.to_dict(), separators=(",", ":"))

        def put():
            for q in list(self._subscribers) + list(self._local_subscribers):
                if q.qsize() < 4096:
                    q.put_nowait(payload)
        self._loop.call_soon_threadsafe(put)

    # -- helpers -------------------------------------------------------

    def _resolve_for_delete(self, chunks):
        return fcm.resolve_chunk_manifest(
            lambda fid: self._read_chunk_blob_sync(fid), chunks,
            include_manifests=True)

    def _read_chunk_blob_sync(self, fid: str) -> bytes:
        # runs only on the deletion worker thread, never the event loop
        return self.deletion.client.download(fid)

    async def _assign(self, collection: str, replication: str,
                      ttl: str) -> dict:
        params = {"count": "1"}
        if collection:
            params["collection"] = collection
        if replication:
            params["replication"] = replication
        if ttl:
            params["ttl"] = ttl
        async with self._session.get(
                f"{_tls_scheme()}://{self.master_url}/dir/assign",
                params=params) as r:
            a = await r.json()
        if "error" in a:
            raise RuntimeError(f"assign: {a['error']}")
        return a

    async def _upload_chunk(self, data: bytes, collection: str,
                            replication: str, ttl: str,
                            mime: str = "", raw: bool = False) -> FileChunk:
        """`raw` skips compression/encryption — manifest blobs are internal
        metadata that the resolve paths read directly."""
        a = await self._assign(collection, replication, ttl)
        headers = {"Content-Type": "application/octet-stream"}
        if a.get("auth"):
            # per-fid write JWT from the master's Assign response
            headers["Authorization"] = "Bearer " + a["auth"]
        elif self.jwt_signer:
            headers["Authorization"] = "Bearer " + self.jwt_signer(a["fid"])
        logical_size = len(data)
        etag = hashlib.md5(data).hexdigest()
        is_compressed = False
        cipher_key = b""
        # gzip compressible payloads when it actually helps (reference:
        # util.MaybeGzipData in operation/upload_content.go)
        if not raw and _is_gzippable(mime) and logical_size > 128:
            packed = await asyncio.to_thread(gzip.compress, data, 6)
            if len(packed) * 10 < logical_size * 9:
                data = packed
                is_compressed = True
        if self.encrypt_data and not raw:
            cipher_key, data = await asyncio.to_thread(cipher.encrypt, data)
        async with self._session.put(
                f"{_tls_scheme()}://{a['url']}/{a['fid']}", data=data,
                headers=headers) as r:
            if r.status >= 300:
                raise RuntimeError(f"chunk upload: HTTP {r.status}")
        if heat.ambient_is_data():
            heat.record("chunk", a["fid"], logical_size, "write")
        return FileChunk(fid=a["fid"], offset=0, size=logical_size,
                         mtime=time.time_ns(), etag=etag,
                         cipher_key=cipher_key, is_compressed=is_compressed)

    async def _master_lookup_vid(self, vid: int) -> list[str]:
        """One real master /dir/lookup for the shared vid cache.  404
        ('volume id not found') returns [] so the resolver caches it
        negatively; transport errors raise and stay uncached."""
        async with self._session.get(
                f"{_tls_scheme()}://{self.master_url}/dir/lookup",
                params={"volumeId": str(vid)}) as r:
            if r.status == 404:
                return []
            if r.status >= 300:
                raise IOError(f"/dir/lookup vid {vid}: HTTP {r.status}")
            locs = (await r.json()).get("locations", [])
        return [l["url"] for l in locs]

    async def _vid_stream_loop(self) -> None:
        """Subscribe to the master's /cluster/stream push feed (the same
        contract the client rides): volume-location deltas land in the
        shared vid cache the moment the master learns them, stamped past
        the poll TTL up to the push horizon; a broken feed drops all
        pushed entries so lookups degrade to TTL polling."""
        horizon = WeedClient.STREAM_ENTRY_HORIZON
        while True:
            try:
                async with self._session.get(
                        f"{_tls_scheme()}://{self.master_url}/cluster/stream",
                        timeout=aiohttp.ClientTimeout(total=None,
                                                      sock_read=60)) as r:
                    self._vid_stream_live = True
                    async for raw in r.content:
                        line = raw.strip()
                        if not line:
                            continue
                        ev = json.loads(line)
                        if "vid" not in ev:
                            continue  # ping / snapshot_end
                        urls = [l["url"] for l in ev.get("locations", [])]
                        if urls:
                            self.vid_cache.put(
                                ev["vid"], urls,
                                ts=time.time() + horizon
                                - self.vid_cache.ttl)
                        else:
                            self.vid_cache.invalidate(ev["vid"])
            except asyncio.CancelledError:
                raise
            except (aiohttp.ClientError, json.JSONDecodeError, OSError,
                    ValueError):
                pass
            finally:
                self._vid_stream_live = False
            # pushed entries go stale the moment the feed breaks
            self.vid_cache.clear()
            await asyncio.sleep(1.0)

    def _volume_read_headers(self, fid: str) -> dict:
        headers = {}
        if self.security is not None and self.security.volume_read:
            headers["Authorization"] = "Bearer " + jwt.gen_jwt(
                self.security.volume_read, fid)
        return headers

    async def _fetch_chunk_direct(self, fid: str, sp, cache: bool) -> bytes:
        """Volume-tier fetch through the shared vid cache: resolve
        locations (singleflighted, TTL'd, stream-fed), fan over them, and
        on TOTAL failure invalidate the cached route once and re-ask the
        master — the same invalidate-once contract the client's download
        path carries, now deduped through utils/vid_cache.py."""
        vid = int(fid.partition(",")[0])
        headers = self._volume_read_headers(fid)
        last = None
        for attempt in range(2):
            urls = await self._vid_resolver.lookup(vid)
            for url in urls:
                try:
                    async with self._session.get(
                            f"{_tls_scheme()}://{url}/{fid}",
                            headers=headers) as r:
                        if r.status == 200:
                            blob = await r.read()
                            sp.set(peer=url, bytes=len(blob))
                            if cache and self.chunk_cache.tiers:
                                await asyncio.to_thread(
                                    self.chunk_cache.put, fid, blob)
                            elif cache:
                                self.chunk_cache.put(fid, blob)
                            return blob
                        last = f"HTTP {r.status}"
                except aiohttp.ClientError as e:
                    last = str(e)
            if attempt == 0 and self.vid_cache.invalidate(vid):
                continue  # stale route dropped: re-ask the master once
            break
        raise IOError(f"chunk {fid}: {last or 'no locations'}")

    def _hot_home(self, fid: str) -> str | None:
        """The hot-tier home filer for a chunk, or None when the tier is
        off / the ring is empty / this node IS the home."""
        if not self.hot_enabled or len(self.hot_ring) < 2:
            return None
        home = self.hot_ring.home(fid)
        return None if home in (None, self.url) else home

    async def _hot_route(self, home: str, fid: str) -> bytes | None:
        """Fetch a chunk's stored bytes from its home filer.  None means
        the peer failed — the caller falls back to a direct volume-tier
        fetch, so a dead home degrades to pre-hot-tier behavior, never an
        error."""
        headers = {}
        if self.security is not None and self.security.filer_read:
            headers["Authorization"] = "Bearer " + jwt.gen_jwt(
                self.security.filer_read, fid)
        try:
            async with self._session.get(
                    f"{_tls_scheme()}://{home}/__hot__/chunk/{fid}",
                    headers=headers) as r:
                if r.status == 200:
                    self.hot_stats["route_out"] += 1
                    return await r.read()
        except (aiohttp.ClientError, asyncio.TimeoutError, OSError):
            pass
        self.hot_stats["route_fail"] += 1
        return None

    async def _fetch_chunk(self, fid: str, cache: bool = True,
                           track: bool | None = None,
                           allow_route: bool = True) -> bytes:
        with trace.span("filer.chunk_fetch", fid=fid) as sp:
            # workload heat: every demanded chunk access counts, cache
            # hit or miss — "hot" means requested often, and the hot
            # tier's promotion policy sizes itself on exactly this
            # signal.  Readahead counts too (it is demand one chunk
            # early); canary/internal traffic does not.
            if track is None:
                track = heat.ambient_is_data(include_readahead=True)
            # disk tiers do blocking IO; mem-only lookups stay inline
            if self.chunk_cache.tiers:
                cached = await asyncio.to_thread(self.chunk_cache.get, fid)
            else:
                cached = self.chunk_cache.get(fid)
            if cached is not None:
                sp.set(cache_hit=True, bytes=len(cached))
                self.hot_stats["hit_local"] += 1
                if track:
                    heat.record("chunk", fid, len(cached), "read")
                return cached
            sp.set(cache_hit=False)
            # local miss: if the chunk's hot-tier home is another live
            # filer, route there — the home fetches from the volume tier
            # once and every gateway serves from that one copy
            home = self._hot_home(fid) if allow_route else None
            if home is not None:
                blob = await self._hot_route(home, fid)
                if blob is not None:
                    sp.set(hot_home=home, bytes=len(blob))
                    if track:
                        heat.record("chunk", fid, len(blob), "read")
                    if self.hot_l1 and cache:
                        self.chunk_cache.put(fid, blob)
                    return blob
            blob = await self._fetch_chunk_stored(fid, sp, cache)
            if track:
                heat.record("chunk", fid, len(blob), "read")
            return blob

    async def _fetch_chunk_stored(self, fid: str, sp,
                                  cache: bool) -> bytes:
        """Volume-tier fetch with stored-bytes singleflight: EVERY
        concurrent demand for one cold chunk — local readers (whose
        decoded-view flights are a separate table) and hot-tier
        route-ins alike — collapses into a single upstream fetch here.
        This is what makes the cluster-wide fetch count exactly one per
        chunk: the home node's `direct` counter ticks once per actual
        volume-tier fetch, never once per demand.  The cache flag joins
        the key for the same reason as the view flight's: a no-cache
        reader must not suppress cache population for a caching one."""
        key = (fid, cache)
        fut = self._blob_flight.get(key)
        if fut is None:
            async def flight():
                # shared flight: strip the starter's deadline so a
                # joiner with a healthy budget never inherits a
                # budget-poisoned starter's 504
                tok = resilience.set_deadline(None)
                try:
                    self.hot_stats["direct"] += 1
                    return await self._fetch_chunk_direct(fid, sp, cache)
                finally:
                    resilience.reset_deadline(tok)
            fut = asyncio.ensure_future(flight())
            self._blob_flight[key] = fut
            fut.add_done_callback(
                lambda _f, k=key: self._blob_flight.pop(k, None))
        else:
            metrics.FILER_SINGLEFLIGHT_JOINED.labels().inc()
        return await asyncio.shield(fut)

    async def _fetch_chunk_home(self, fid: str,
                                track: bool = False) -> bytes:
        """Stored-bytes fetch on the HOME side of a hot-tier route (or a
        seed): cache-first, never re-routed (a mismatched membership
        view during churn must not create routing loops), collapsed with
        every other demand at the `_fetch_chunk_stored` singleflight."""
        return await self._fetch_chunk(
            fid, cache=True, track=track, allow_route=False)

    async def _refresh_hot_ring(self) -> None:
        """Rebuild the rendezvous ring from the master's live filer
        membership (piggybacked on the 10s register heartbeat, so joins
        and leaves re-home 1/N of the key space within one beat)."""
        if not self.hot_enabled:
            return
        async with self._session.get(
                f"{_tls_scheme()}://{self.master_url}/cluster/status") as r:
            members = (await r.json()).get("Members", {})
        filers = set(members.get("filer", []))
        filers.add(self.url)  # self is a member even pre-heartbeat
        if self.hot_ring.update(filers):
            log.info("hot-tier ring now %s", sorted(filers))

    async def _hot_seed_loop(self, interval: float) -> None:
        """Pre-warm this filer with the cluster heat sketch's hottest
        chunks homed here (WEEDTPU_HOT_SEED_INTERVAL > 0 enables;
        /cluster/heat top-K, WEEDTPU_HOT_SEED_TOPK)."""
        topk = int(_env_float("WEEDTPU_HOT_SEED_TOPK", 32))
        while True:
            await asyncio.sleep(interval)
            try:
                async with self._session.get(
                        f"{_tls_scheme()}://{self.master_url}"
                        "/cluster/heat") as r:
                    if r.status != 200:
                        continue
                    view = await r.json()
                top = (view.get("chunks") or {}).get("top", [])[:topk]
                fids = [e["key"] for e in top
                        if self.hot_ring.home(e["key"]) in (None, self.url)]
                await self._seed_fids(fids)
            except asyncio.CancelledError:
                raise
            except Exception:
                log.debug("hot seed pass failed", exc_info=True)

    async def _seed_fids(self, fids: list[str]) -> tuple[int, int]:
        """Pull-through the given chunks into the local cache (books as
        readahead, not demand, and records no heat — seeding must not
        feed back into the signal that triggered it)."""
        seeded = skipped = 0
        for fid in fids[:256]:
            if self.chunk_cache.get(fid) is not None:
                skipped += 1
                continue
            try:
                with netflow.flow("readahead"):
                    await self._fetch_chunk_home(fid, track=False)
                seeded += 1
            except (IOError, OSError, aiohttp.ClientError):
                skipped += 1
        self.hot_stats["seeded"] += seeded
        self.hot_stats["seed_skipped"] += skipped
        return seeded, skipped

    # -- hot-tier HTTP face ---------------------------------------------

    async def handle_hot_chunk(self, req: web.Request) -> web.Response:
        """Serve a chunk's STORED bytes as its hot-tier home (peer
        gateways route their misses here).  Always serves locally —
        routed requests never re-route, so mismatched membership views
        during churn cannot loop."""
        err = self._check_filer_jwt(req, write=False)
        if err is not None:
            return err
        fid = req.match_info["fid"]
        self.hot_stats["route_in"] += 1
        try:
            blob = await self._fetch_chunk_home(fid, track=False)
        except (IOError, OSError, aiohttp.ClientError) as e:
            return web.json_response({"error": str(e)}, status=404)
        return web.Response(body=blob,
                            content_type="application/octet-stream")

    async def handle_hot_seed(self, req: web.Request) -> web.Response:
        """POST {"fids": [...]}: pull-through the listed chunks into this
        filer's cache — the actuator behind the autopilot's chunk-granular
        promotion policy."""
        err = self._check_filer_jwt(req, write=True)
        if err is not None:
            return err
        try:
            fids = list((await req.json()).get("fids", []))
        except (ValueError, TypeError):
            return web.json_response({"error": "bad body"}, status=400)
        seeded, skipped = await self._seed_fids(
            [f for f in fids if isinstance(f, str)])
        return web.json_response({"seeded": seeded, "skipped": skipped})

    async def handle_hot_status(self, req: web.Request) -> web.Response:
        return web.json_response(self.hot_status())

    def hot_status(self) -> dict:
        cc = self.chunk_cache.stats()
        return {"node": self.url, "enabled": self.hot_enabled,
                "ring": list(self.hot_ring.members),
                "ring_version": self.hot_ring.version,
                "events": dict(self.hot_stats),
                "cache": {"hits": cc.get("hits", 0),
                          "misses": cc.get("misses", 0),
                          "mem_bytes": cc.get("mem_bytes", 0)},
                "vid_cache": self.vid_cache.stats(),
                "vid_stream_live": self._vid_stream_live,
                "vid_lookups": self._vid_resolver.upstream_lookups,
                "vid_joined": self._vid_resolver.joined}

    async def _decode_chunk_blob(self, blob: bytes, cipher_key: bytes,
                                 is_compressed: bool) -> bytes:
        """Stored chunk bytes -> logical bytes: decrypt, then gunzip
        (reference: weed/filer/stream.go fetchChunkRange +
        util.DecompressData)."""
        if cipher_key:
            blob = await asyncio.to_thread(cipher.decrypt, cipher_key, blob)
        if is_compressed:
            blob = await asyncio.to_thread(gzip.decompress, blob)
        return blob

    async def _load_chunk_once(self, v, cache: bool) -> bytes:
        blob = await self._fetch_chunk(v.fid, cache=cache)
        return await self._decode_chunk_blob(blob, v.cipher_key,
                                             v.is_compressed)

    async def _load_chunk_view(self, v, cache: bool = True) -> bytes:
        """Fetch+decode one chunk view with singleflight: N concurrent
        GETs of the same hot chunk share ONE in-flight upstream fetch and
        decode instead of stampeding the volume server and the chunk
        cache (reference: reader_cache.go's one-downloader-per-chunk
        discipline).  Failures are never cached — the table entry dies
        with the future — and waiters are shielded so one cancelled
        client (disconnect mid-stream) can't kill the fetch the others
        are waiting on.  The flight key includes the cache flag so a
        random-pattern reader's no-cache fetch can't suppress cache
        population for a sequential reader of the same chunk (or vice
        versa) — worst case one extra upstream GET for a doubly-hot
        chunk, never an inverted cache decision."""
        key = (v.fid, cache)
        fut = self._chunk_flight.get(key)
        if fut is None:
            async def flight():
                # the flight is SHARED: it may outlive the waiter that
                # started it and serve waiters with different budgets.
                # Strip the starter's deadline so a deadline-free reader
                # joining a budget-poisoned flight doesn't inherit the
                # upstream 504 (enforcement stays at the waiter level —
                # the middleware cancels ITS wait, the shielded flight
                # finishes for everyone else)
                tok = resilience.set_deadline(None)
                try:
                    return await self._load_chunk_once(v, cache)
                finally:
                    resilience.reset_deadline(tok)
            fut = asyncio.ensure_future(flight())
            self._chunk_flight[key] = fut
            fut.add_done_callback(
                lambda _f, k=key: self._chunk_flight.pop(k, None))
            return await asyncio.shield(fut)
        metrics.FILER_SINGLEFLIGHT_JOINED.labels().inc()
        # the joined fetch's span belongs to the request that started it;
        # this request's trace records the wait instead
        with trace.span("filer.chunk_join", fid=v.fid):
            return await asyncio.shield(fut)

    async def _load_prefetch(self, v, cache: bool) -> bytes:
        """Speculative pipeline fetch: upstream bytes pulled BEFORE the
        in-order writer needs them book as class=readahead in the flow
        ledger, so `/cluster/metrics` can separate bytes the client asked
        for from bytes the pipeline gambled on."""
        with netflow.flow("readahead"):
            return await self._load_chunk_view(v, cache)

    @staticmethod
    def _readahead_depth() -> int:
        """Chunk views prefetched ahead of the in-order writer
        (WEEDTPU_READAHEAD; 0 = the serial fetch->write loop).  The
        default is a conservative 2: enough to hide one volume-server
        round-trip behind the client write, without cycling N multi-MB
        chunk buffers through a narrow host's cache (measured: depth 4
        runs ~15% SLOWER than serial on a 2-core box, depth 2 wins there
        and everywhere wider; raise it when volume servers are remote)."""
        try:
            return int(os.environ.get("WEEDTPU_READAHEAD", "2"))
        except ValueError:
            return 2

    async def _resolve_chunks(self, entry: Entry) -> list[FileChunk]:
        """Expand manifest refs, fetching manifest blobs level by level
        (they may nest)."""
        out = entry.chunks
        while fcm.has_chunk_manifest(out):
            blobs = {c.fid: await self._fetch_chunk(c.fid)
                     for c in out if c.is_chunk_manifest}
            expanded: list[FileChunk] = []
            for c in out:
                if not c.is_chunk_manifest:
                    expanded.append(c)
                    continue
                payload = json.loads(blobs[c.fid])
                expanded.extend(FileChunk.from_dict(d)
                                for d in payload["chunks"])
            out = expanded
        return out

    @staticmethod
    def _norm(path: str) -> str:
        path = "/" + path.strip("/")
        return path

    # -- main dispatch -------------------------------------------------

    async def handle_metrics(self, req: web.Request) -> web.Response:
        # ChunkCache keeps its own counters; mirror them into the registry
        # at scrape time so the bench can read filer cache hit ratio
        for name, value in self.chunk_cache.stats().items():
            metrics.FILER_CHUNK_CACHE.labels(name).set(value)
        for name, value in self.vid_cache.stats().items():
            if isinstance(value, (int, float)):
                metrics.VID_CACHE.labels(name).set(value)
        for event, value in self.hot_stats.items():
            metrics.HOT_TIER_EVENTS.labels(event).set(value)
        metrics.HOT_TIER_RING.labels().set(len(self.hot_ring))
        return metrics.scrape_response(req)

    async def handle_raw_entry(self, req: web.Request) -> web.Response:
        """Create/replace an entry from a raw entry dict, chunk refs
        included — the HTTP face of filer_pb CreateEntry, needed by the S3
        gateway to assemble multipart uploads without copying data
        (reference: weed/s3api/filer_multipart.go)."""
        err = self._check_filer_jwt(req, write=True)
        if err is not None:
            return err
        try:
            body = await req.json()
            entry = Entry.from_dict(body["entry"])
        except (KeyError, TypeError, ValueError) as e:
            return web.json_response({"error": f"bad entry: {e}"}, status=400)
        def put():
            self.filer.create_entry(entry, o_excl=bool(body.get("o_excl")))
        try:
            await asyncio.to_thread(put)
        except FileExistsError as e:
            return web.json_response({"error": str(e)}, status=409)
        return web.json_response({"path": entry.full_path}, status=201)

    def _check_filer_jwt(self, req: web.Request,
                         write: bool) -> web.Response | None:
        """Filer JWT enforcement (reference: filer tokens checked at
        volume_server_handlers_write.go:53 / filer auth): mutations need a
        [jwt.filer.signing] token, reads a [jwt.filer.signing.read] one —
        each only when the corresponding key is configured."""
        if self.security is None:
            return None
        key = self.security.filer_write if write else self.security.filer_read
        if not key:
            return None
        token = jwt.token_from_request(req.headers, req.query)
        if not token:
            return web.json_response({"error": "missing jwt"}, status=401)
        try:
            jwt.decode_jwt(key, token)
        except jwt.JwtError as e:
            return web.json_response({"error": str(e)}, status=401)
        return None

    async def handle_path(self, req: web.Request) -> web.StreamResponse:
        metrics.FILER_REQUEST_COUNTER.labels(req.method.lower()).inc()
        err = self._check_filer_jwt(req, req.method in ("POST", "PUT",
                                                        "DELETE"))
        if err is not None:
            return err
        raw = req.match_info["path"]
        is_dir_request = raw.endswith("/") or raw == ""
        path = self._norm(raw)
        with metrics.FILER_REQUEST_HISTOGRAM.labels(req.method.lower()).time():
            return await self._dispatch(req, path, is_dir_request)

    async def _dispatch(self, req: web.Request, path: str,
                        is_dir_request: bool) -> web.StreamResponse:
        try:
            if req.method in ("POST", "PUT"):
                if "mv.from" in req.query:
                    return await self._handle_move(req, path)
                if "link.from" in req.query:
                    return await self._handle_link(req, path)
                if "symlink.to" in req.query:
                    return await self._handle_symlink(req, path)
                if req.query.get("op") == "attr":
                    return await self._handle_set_attr(req, path)
                return await self._handle_upload(req, path, is_dir_request)
            if req.method in ("GET", "HEAD"):
                return await self._handle_read(req, path, is_dir_request)
            if req.method == "DELETE":
                return await self._handle_delete(req, path)
        except NotFound:
            return web.json_response({"error": "not found"}, status=404)
        except (IsADirectoryError, NotADirectoryError, FileExistsError) as e:
            return web.json_response(
                {"error": f"{type(e).__name__}: {e}"}, status=409)
        return web.json_response({"error": "method not allowed"}, status=405)

    # -- write ---------------------------------------------------------

    async def _handle_move(self, req: web.Request, path: str) -> web.Response:
        src = self._norm(req.query["mv.from"])
        try:
            moved = self.filer.rename_entry(src, path)
        except (FileExistsError, NotADirectoryError, OSError) as e:
            return web.json_response({"error": str(e)}, status=409)
        return web.json_response({"path": moved.full_path})

    async def _handle_link(self, req: web.Request, path: str) -> web.Response:
        """`POST /new?link.from=/old`: hardlink — a second name for the same
        chunks (reference: weedfs_link.go over filer_hardlink.go)."""
        src = self._norm(req.query["link.from"])
        try:
            link = self.filer.link_entry(src, path,
                                         signatures=_req_signatures(req))
        except FileExistsError as e:
            return web.json_response({"error": str(e)}, status=409)
        except (IsADirectoryError, NotADirectoryError) as e:
            # POSIX link(2): hardlinking a directory is EPERM, not EEXIST
            return web.json_response({"error": str(e)}, status=403)
        return web.json_response({"path": link.full_path,
                                  "nlink": link.hard_link_counter})

    async def _handle_symlink(self, req: web.Request,
                              path: str) -> web.Response:
        """`POST /path?symlink.to=<target>` (reference:
        weedfs_symlink.go:15-60 — a chunkless entry whose attr carries the
        target; resolution is the client's job, like FUSE readlink)."""
        now = time.time()
        entry = Entry(full_path=path,
                      attr=Attr(mtime=now, crtime=now,
                                mode=stat.S_IFLNK | 0o777,
                                symlink_target=req.query["symlink.to"]))
        self._apply_headers(entry, req)
        try:
            self.filer.create_entry(entry, o_excl=True,
                                    signatures=_req_signatures(req))
        except FileExistsError as e:
            return web.json_response({"error": str(e)}, status=409)
        return web.json_response({"name": entry.name}, status=201)

    async def _handle_set_attr(self, req: web.Request,
                               path: str) -> web.Response:
        """`POST /path?op=attr` with a JSON body of attribute deltas:
        {mode, uid, gid, mtime, crtime, extended_set: {k: v},
        extended_del: [k]} — the SetAttr/xattr seam of the FUSE mount
        (reference: weedfs_attr.go SetAttr, weedfs_xattr.go)."""
        body = await req.json()
        try:
            entry = self.filer.find_entry(path)
        except NotFound:
            return web.json_response({"error": "not found"}, status=404)
        a = entry.attr
        if "mode" in body:
            # keep the file-type bits; callers set permission bits only
            a.mode = (a.mode & ~0o7777) | (int(body["mode"]) & 0o7777)
        for f_ in ("uid", "gid"):
            if f_ in body:
                setattr(a, f_, int(body[f_]))
        for f_ in ("mtime", "crtime"):
            if f_ in body:
                setattr(a, f_, float(body[f_]))
        for k, v in (body.get("extended_set") or {}).items():
            entry.extended[str(k)] = str(v)
        for k in body.get("extended_del") or []:
            entry.extended.pop(str(k), None)
        # POSIX: chmod/chown/xattr change ctime, never mtime — and an
        # explicit utimens mtime must stick; so attr updates never touch
        self.filer.update_entry(entry, touch=False)
        return web.json_response({"name": entry.name})

    async def _handle_upload(self, req: web.Request, path: str,
                             is_dir_request: bool) -> web.Response:
        rule = self.conf.match(path)
        if rule.read_only:
            return web.json_response({"error": "read only path"}, status=403)
        collection = req.query.get("collection") or rule.collection or \
            self.collection
        replication = req.query.get("replication") or rule.replication or \
            self.replication
        ttl = req.query.get("ttl") or rule.ttl
        chunk_size = int(req.query.get("maxMB", "0")) * 1024 * 1024 or \
            self.chunk_size

        if is_dir_request and path != "/":
            d = new_directory_entry(path)
            self._apply_headers(d, req)
            self.filer.create_entry(d, signatures=_req_signatures(req))
            return web.json_response({"name": d.name}, status=201)

        if "offset" in req.query:
            return await self._handle_patch(req, path, collection,
                                            replication, ttl, chunk_size)
        if "truncate" in req.query:
            return await self._handle_truncate(req, path)

        # autochunk the body (reference: doPostAutoChunk)
        mime = req.headers.get("Content-Type", "")
        if mime in ("application/octet-stream", ""):
            mime = mimetypes.guess_type(path)[0] or mime
        chunks: list[FileChunk] = []
        md5 = hashlib.md5()
        try:
            total = await self._stream_chunks(
                req.content, chunk_size, 0, collection, replication, ttl,
                mime, chunks, md5)
        except (RuntimeError, OSError, aiohttp.ClientError) as e:
            # clean up already-written chunks on failure
            self.deletion.enqueue_chunks(chunks)
            return web.json_response({"error": str(e)}, status=500)

        # many-chunk files get manifestized through the blob store
        if len(chunks) > fcm.MANIFEST_BATCH:
            try:
                chunks = await self._maybe_manifestize_async(
                    chunks, collection, replication, ttl)
            except (RuntimeError, OSError, aiohttp.ClientError) as e:
                self.deletion.enqueue_chunks(chunks)
                return web.json_response({"error": str(e)}, status=500)

        now = time.time()
        entry = Entry(
            full_path=path,
            attr=Attr(mtime=now, crtime=now, mode=0o660, mime=mime,
                      ttl_sec=_ttl_seconds(ttl), md5=md5.hexdigest(),
                      file_size=total),
            chunks=chunks)
        self._apply_headers(entry, req)
        self.filer.create_entry(entry, signatures=_req_signatures(req))
        return web.json_response(
            {"name": entry.name, "size": total, "eTag": md5.hexdigest()},
            status=201)

    async def _stream_chunks(self, content, chunk_size: int,
                             base_offset: int, collection: str,
                             replication: str, ttl: str, mime: str,
                             chunks: list[FileChunk],
                             md5=None) -> int:
        """Stream a request body into blob-store chunks at logical offsets
        base_offset.. — shared by whole-file uploads and ranged patches.
        Appends into the caller's `chunks` list so a failure mid-stream
        leaves the partial refs visible for cleanup. Returns byte count.

        Chunk uploads run CONCURRENTLY behind a bounded window while the
        body keeps streaming in (reference: the limited upload pool in
        filer_server_handlers_write_upload.go) — serial awaiting would
        make every large upload latency-bound on one volume round-trip
        per chunk.  Offsets are assigned at emit time, so completion
        order doesn't matter; the list is offset-sorted at the end."""
        total = 0
        pending = bytearray()
        inflight: set[asyncio.Task] = set()
        window = 4

        async def upload(blob: bytes, offset: int) -> None:
            ck = await self._upload_chunk(blob, collection, replication,
                                          ttl, mime)
            ck.offset = offset
            chunks.append(ck)

        async def emit(blob: bytes) -> None:
            nonlocal total
            off = base_offset + total
            total += len(blob)
            inflight.add(asyncio.create_task(upload(blob, off)))
            if len(inflight) >= window:
                done, rest = await asyncio.wait(
                    inflight, return_when=asyncio.FIRST_COMPLETED)
                inflight.clear()
                inflight.update(rest)
                # retrieve EVERY done task's result before raising: a
                # multi-failure window must not leak unretrieved-exception
                # warnings for the tasks behind the first one
                errs = [t.exception() for t in done]
                first = next((e for e in errs if e is not None), None)
                if first is not None:
                    raise first

        try:
            while True:
                piece = await content.read(min(chunk_size, 1 << 20))
                if not piece:
                    break
                if md5 is not None:
                    md5.update(piece)
                pending.extend(piece)
                while len(pending) >= chunk_size:
                    blob = bytes(pending[:chunk_size])
                    del pending[:chunk_size]
                    await emit(blob)
            if pending:  # empty files carry no chunks, like the reference
                await emit(bytes(pending))
        finally:
            # drain in-flight uploads on BOTH paths: late completions must
            # land in `chunks` before the caller cleans up or commits
            if inflight:
                results = await asyncio.gather(*inflight,
                                               return_exceptions=True)
                err = next((r for r in results
                            if isinstance(r, BaseException)), None)
                if err is not None and sys.exc_info()[0] is None:
                    raise err  # never mask the original in-flight error
        chunks.sort(key=lambda c: c.offset)
        return total

    def _path_lock(self, path: str) -> asyncio.Lock:
        """Per-path mutex serializing entry read-modify-writes (patch /
        truncate): without it two concurrent patches each base their
        update_entry on the pre-other chunk list and one range silently
        reverts. Locks are pruned opportunistically when uncontended."""
        if len(self._rmw_locks) > 1024:
            for p, lk in list(self._rmw_locks.items()):
                if not lk.locked():
                    del self._rmw_locks[p]
        return self._rmw_locks.setdefault(path, asyncio.Lock())

    async def _handle_patch(self, req: web.Request, path: str,
                            collection: str, replication: str, ttl: str,
                            chunk_size: int) -> web.Response:
        """Ranged write `PUT path?offset=N`: store the body as chunks at
        logical offset N without touching the file's other bytes — the
        chunk model's mtime-wins interval resolution (filechunks.py) makes
        the new range shadow whatever it overlaps. This is the server half
        of the mount's chunked dirty-page flush (the reference pairs
        dirty_pages_chunked.go saveDataAsChunk with filer UpdateEntry the
        same way), and gives any HTTP client O(range) random writes."""
        try:
            off = int(req.query["offset"])
        except ValueError:
            return web.json_response({"error": "bad offset"}, status=400)
        if off < 0:
            return web.json_response({"error": "negative offset"},
                                     status=400)
        mime = req.headers.get("Content-Type", "")
        async with self._path_lock(path):
            entry = None
            try:
                entry = self.filer.find_entry(path)
                if entry.is_directory:
                    return web.json_response({"error": "is a directory"},
                                             status=409)
            except NotFound:
                pass
            chunks: list[FileChunk] = []
            try:
                total = await self._stream_chunks(
                    req.content, chunk_size, off, collection, replication,
                    ttl, mime, chunks)
            except (RuntimeError, OSError, aiohttp.ClientError) as e:
                self.deletion.enqueue_chunks(chunks)
                return web.json_response({"error": str(e)}, status=500)
            now = time.time()
            if entry is None:
                entry = Entry(
                    full_path=path,
                    attr=Attr(mtime=now, crtime=now, mode=0o660, mime=mime,
                              file_size=off + total),
                    chunks=chunks)
                self._apply_headers(entry, req)
                self.filer.create_entry(entry,
                                        signatures=_req_signatures(req))
            else:
                merged = list(entry.chunks) + chunks
                # prune fully-shadowed refs so a rewrite-heavy workload
                # (database file through the mount) can't grow the chunk
                # list and leak blobs forever; shadowed manifests keep
                # their metadata (their inner refs would leak otherwise)
                compacted, garbage = fc.compact_chunks(merged)
                keep = [c for c in garbage if c.is_chunk_manifest]
                drop = [c for c in garbage if not c.is_chunk_manifest]
                entry.chunks = compacted + keep
                if len(entry.chunks) > fcm.MANIFEST_BATCH:
                    entry.chunks = await self._maybe_manifestize_async(
                        entry.chunks, collection, replication, ttl)
                entry.attr.mtime = now
                entry.attr.file_size = max(entry.size(), off + total)
                entry.attr.md5 = ""  # no longer a whole-body hash
                self.filer.update_entry(entry)
                if drop:
                    self.deletion.enqueue_chunks(drop)
        return web.json_response(
            {"name": entry.name, "offset": off, "size": total}, status=201)

    async def _handle_truncate(self, req: web.Request,
                               path: str) -> web.Response:
        """`POST path?truncate=N`: metadata-only resize. Shrink drops/trims
        chunk refs beyond N (freed chunks go to the deletion queue; a
        straddling manifest is resolved to its inner refs first so the trim
        is real); grow just raises file_size — the read path zero-fills
        past the last chunk (filer/stream semantics, like the reference)."""
        try:
            length = int(req.query["truncate"])
        except ValueError:
            return web.json_response({"error": "bad length"}, status=400)
        if length < 0:
            return web.json_response({"error": "negative length"},
                                     status=400)
        async with self._path_lock(path):
            entry = self.filer.find_entry(path)  # NotFound -> 404
            if entry.is_directory:
                return web.json_response({"error": "is a directory"},
                                         status=409)
            chunks = entry.chunks
            resolved_manifests: list[FileChunk] = []
            if any(c.is_chunk_manifest and c.offset < length <
                   c.offset + c.size for c in chunks):
                resolved_manifests = [c for c in chunks
                                      if c.is_chunk_manifest]
                chunks = await self._resolve_chunks(entry)
            kept, freed = [], []
            for c in chunks:
                if c.offset >= length:
                    freed.append(c)
                elif c.offset + c.size > length:
                    c.size = length - c.offset  # straddler: trim the tail
                    kept.append(c)
                else:
                    kept.append(c)
            entry.chunks = kept
            entry.attr.file_size = length
            entry.attr.mtime = time.time()
            entry.attr.md5 = ""
            self.filer.update_entry(entry)
            # resolved manifest blobs left the entry: free them too (their
            # inner refs are now inlined in kept/freed)
            freed = [c for c in freed if not c.is_chunk_manifest] \
                + resolved_manifests
            if freed:
                self.deletion.enqueue_chunks(freed)
        return web.json_response({"name": entry.name, "size": length})

    async def _maybe_manifestize_async(self, chunks, collection,
                                       replication, ttl):
        """Async twin of fcm.maybe_manifestize (same grouping, shared
        payload/ref builders; the save callback here is an await)."""
        plain = [c for c in chunks if not c.is_chunk_manifest]
        out = [c for c in chunks if c.is_chunk_manifest]
        for i in range(0, len(plain), fcm.MANIFEST_BATCH):
            group = plain[i:i + fcm.MANIFEST_BATCH]
            if len(group) < fcm.MANIFEST_BATCH:
                out.extend(group)
                break
            stored = await self._upload_chunk(
                fcm.manifest_payload(group), collection, replication, ttl,
                raw=True)
            out.append(fcm.manifest_ref(stored, group))
        out.sort(key=lambda c: c.offset)
        return out

    @staticmethod
    def _apply_headers(entry: Entry, req: web.Request) -> None:
        for k, v in req.headers.items():
            if k.lower().startswith("seaweed-"):
                entry.extended[k[len("Seaweed-"):]] = v

    # -- read ----------------------------------------------------------

    async def _handle_read(self, req: web.Request, path: str,
                           is_dir_request: bool) -> web.StreamResponse:
        entry = self.filer.find_entry(path)
        if req.query.get("metadata") == "true":
            d = entry.to_dict()
            if req.query.get("resolveManifest") == "true" and \
                    not entry.is_directory:
                resolved = await self._resolve_chunks(entry)
                d["chunks"] = [c.to_dict() for c in resolved]
            return web.json_response(d)
        if entry.is_directory:
            return await self._list_directory(req, path)

        chunks = await self._resolve_chunks(entry)
        size = max(entry.size(), fc.total_size(chunks))
        # read-through for remote placeholders (reference: read_remote.go —
        # a mounted-but-uncached object serves straight from the remote)
        ext_lower = {k.lower(): v for k, v in entry.extended.items()}
        remote_read = None
        if not chunks and ext_lower.get("remote-placeholder") == "true" \
                and ext_lower.get("remote-key"):
            remote, _ = self._remote_for(path)
            if remote is not None:
                remote_read = (remote, ext_lower["remote-key"])
                size = max(size, int(ext_lower.get("remote-size", "0") or 0))
        headers = {
            "Accept-Ranges": "bytes",
            "Last-Modified": time.strftime(
                "%a, %d %b %Y %H:%M:%S GMT",
                time.gmtime(entry.attr.mtime)),
        }
        if entry.attr.md5:
            headers["ETag"] = f'"{entry.attr.md5}"'
        for k, v in entry.extended.items():
            headers[f"Seaweed-{k}"] = v
        mime = entry.attr.mime or "application/octet-stream"

        rng = req.headers.get("Range", "")
        offset, length, status = 0, size, 200
        if rng.startswith("bytes="):
            try:
                offset, length = parse_range(rng, size)
                status = 206
                headers["Content-Range"] = \
                    f"bytes {offset}-{offset + length - 1}/{size}"
            except ValueError:
                return web.Response(
                    status=416, headers={"Content-Range": f"bytes */{size}"})

        if req.method == "HEAD":
            headers["Content-Length"] = str(length)
            return web.Response(status=status, headers=headers,
                                content_type=mime)

        # deadline-armed requests fetch the FIRST chunk before the 200
        # is committed: a slow/broken upstream then surfaces as the
        # middleware's clean 504 instead of a torn mid-stream 200 (and
        # costs no extra upstream load — the fetch lands in the
        # singleflight/chunk-cache the stream loop reads from)
        if resilience.deadline() is not None and chunks:
            first = self._group_for(path, entry, chunks).read_views(
                offset, length)
            if first:
                await self._load_chunk_view(first[0], True)

        resp = web.StreamResponse(status=status, headers=headers)
        resp.content_type = mime
        resp.content_length = length
        await resp.prepare(req)
        if remote_read is not None:
            remote, key = remote_read
            pos = offset
            end = offset + length
            while pos < end:
                n = min(4 * 1024 * 1024, end - pos)
                data = await asyncio.to_thread(remote.read_range, key,
                                               pos, n)
                if not data:
                    break
                await resp.write(data)
                pos += len(data)
        else:
            peer = req.transport.get_extra_info("peername") \
                if req.transport else None
            await self._stream_range(resp, chunks, offset, length,
                                     path=path, entry=entry,
                                     client=str(peer) if peer else "")
        await resp.write_eof()
        return resp

    def _group_for(self, path: str, entry: Entry,
                   chunks: list[FileChunk]):
        """Per-entry-version ChunkGroup cache: a ranged read of a huge
        file resolves only the 64MiB sections it touches instead of the
        full chunk list (reference: filechunk_group.go)."""
        key = (path, entry.attr.mtime, len(chunks))
        group = self._chunk_groups.get(key)
        if group is None:
            group = ChunkGroup(chunks)
            self._chunk_groups[key] = group
            while len(self._chunk_groups) > 32:
                self._chunk_groups.pop(next(iter(self._chunk_groups)))
        return group

    async def _stream_range(self, resp, chunks: list[FileChunk],
                            offset: int, length: int,
                            path: str = "", entry: Entry | None = None,
                            client: str = "") -> None:
        """Stream [offset, offset+length) to the client, zero-filling
        sparse gaps (reference: filer/stream.go StreamContent)."""
        if entry is not None:
            views = self._group_for(path, entry, chunks).read_views(
                offset, length)
        else:
            views = fc.view_from_chunks(chunks, offset, length)
        # random readers must not churn the chunk cache with bytes nobody
        # revisits (reference: reader_pattern.go -> reader_cache).  The
        # pattern is tracked per (path, client connection) — the closest
        # HTTP analogue of the reference's per-file-handle tracking: two
        # concurrent sequential readers of one hot file must not interleave
        # offsets into a false "random" verdict that disables caching for
        # exactly the object that benefits most.  Only ranged reads vote —
        # repeated whole-file GETs of a hot object are the cache's best
        # case and must never disable it
        cache_chunks = True
        whole_file = entry is not None and offset == 0 and \
            length >= entry.size()
        if path and not whole_file:
            pkey = (path, client)
            rp = self._read_patterns.get(pkey)
            if rp is None:
                rp = self._read_patterns[pkey] = ReaderPattern()
                while len(self._read_patterns) > 256:
                    self._read_patterns.pop(
                        next(iter(self._read_patterns)))
            rp.monitor_read(offset, length)
            cache_chunks = not rp.is_random
        # bounded readahead pipeline: prefetch up to `depth` chunk views
        # as tasks while the response is written strictly IN ORDER — the
        # fetch+decode of view N+1.. overlaps the client write of view N
        # (the serial loop paid full upstream latency per chunk).  Bytes
        # on the wire are identical to the serial loop by construction:
        # only completed head-of-line tasks are written.
        pos = offset
        depth = self._readahead_depth()
        # entered as a plain CM so readahead tasks created below inherit
        # this span as their parent (noop when the request is unsampled)
        with trace.span("filer.stream_range", chunks=len(views),
                        offset=offset, length=length, readahead=depth,
                        cache_chunks=cache_chunks):
            if depth <= 0:
                for v in views:
                    if v.logic_offset > pos:
                        await _write_zeros(resp, v.logic_offset - pos)
                        pos = v.logic_offset
                    blob = await self._load_chunk_once(v, cache_chunks)
                    await resp.write(
                        blob[v.offset_in_chunk:v.offset_in_chunk + v.size])
                    pos += v.size
            else:
                pending: deque = deque()
                nxt = 0
                try:
                    # a task created while another is already pending is
                    # speculative (class=readahead); the head-of-line
                    # fetch the writer is about to wait on is plain data
                    while nxt < len(views) and len(pending) < depth:
                        v = views[nxt]
                        nxt += 1
                        fetch = self._load_prefetch if pending \
                            else self._load_chunk_view
                        pending.append((v, asyncio.ensure_future(
                            fetch(v, cache_chunks))))
                    while pending:
                        v, task = pending.popleft()
                        blob = await task
                        if v.logic_offset > pos:
                            await _write_zeros(resp, v.logic_offset - pos)
                            pos = v.logic_offset
                        await resp.write(
                            blob[v.offset_in_chunk:
                                 v.offset_in_chunk + v.size])
                        pos += v.size
                        while nxt < len(views) and len(pending) < depth:
                            v = views[nxt]
                            nxt += 1
                            fetch = self._load_prefetch if pending \
                                else self._load_chunk_view
                            pending.append((v, asyncio.ensure_future(
                                fetch(v, cache_chunks))))
                finally:
                    for _, task in pending:
                        # cancelling a waiter never kills a shared
                        # in-flight fetch (_load_chunk_view shields the
                        # real future)
                        task.cancel()
            if pos < offset + length:
                await _write_zeros(resp, offset + length - pos)

    async def _list_directory(self, req: web.Request,
                              path: str) -> web.Response:
        limit = int(req.query.get("limit", "100"))
        last = req.query.get("lastFileName", "")
        prefix = req.query.get("prefix", "")
        include_last = req.query.get("includeLastFile") == "true"
        entries = self.filer.list_entries(path, start_from=last,
                                          include_start=include_last,
                                          limit=limit + 1, prefix=prefix)
        more = len(entries) > limit
        entries = entries[:limit]
        return web.json_response({
            "Path": path,
            "Entries": [_entry_json(e) for e in entries],
            "Limit": limit,
            "LastFileName": entries[-1].name if entries else "",
            "ShouldDisplayLoadMore": more,
        })

    # -- delete --------------------------------------------------------

    async def _handle_delete(self, req: web.Request,
                             path: str) -> web.Response:
        recursive = req.query.get("recursive") == "true"
        ignore = req.query.get("ignoreRecursiveError") == "true"
        # skipChunkDeletion: metadata-only delete — used by the S3 gateway
        # when chunk refs were spliced into another entry (multipart
        # complete), mirroring filer_pb DeleteEntry.delete_data=false
        delete_chunks = req.query.get("skipChunkDeletion") != "true"
        try:
            self.filer.delete_entry(path, recursive=recursive,
                                    ignore_recursive_error=ignore,
                                    delete_chunks=delete_chunks,
                                    signatures=_req_signatures(req))
        except OSError as e:
            if isinstance(e, (FileNotFoundError,)) or "not found" in str(e):
                return web.json_response({"error": str(e)}, status=404)
            return web.json_response({"error": str(e)}, status=409)
        return web.Response(status=204)

    # -- meta subscribe ------------------------------------------------

    async def handle_meta_subscribe(
            self, req: web.Request) -> web.StreamResponse:
        since = int(req.query.get("since", "0"))
        prefix = req.query.get("prefix", "/")
        live = req.query.get("live", "true") == "true"
        local_only = req.query.get("localOnly") == "true"
        resp = web.StreamResponse()
        resp.content_type = "application/x-ndjson"
        await resp.prepare(req)
        q: asyncio.Queue = asyncio.Queue()
        if live:
            (self._local_subscribers if local_only
             else self._subscribers).add(q)
        try:
            last_ts = since
            for ev in self.filer.meta_log.replay(since_ts_ns=since,
                                                 prefix=prefix):
                await resp.write(json.dumps(
                    ev.to_dict(), separators=(",", ":")).encode() + b"\n")
                last_ts = ev.ts_ns
            if not live:
                await resp.write_eof()
                return resp
            while True:
                try:
                    payload = await asyncio.wait_for(q.get(), timeout=5.0)
                except asyncio.TimeoutError:
                    # ndjson keepalive: surfaces dead peers so shutdown
                    # doesn't hang on handlers parked in q.get()
                    await resp.write(b"\n")
                    continue
                if payload is None:  # the filer is stopping
                    break
                d = json.loads(payload)
                if d["ts_ns"] <= last_ts:
                    continue
                old_dir = ((d.get("old_entry") or {}).get("full_path")
                           or "").rsplit("/", 1)[0] or "/"
                if not (dir_has_prefix(d["directory"], prefix)
                        or (d.get("old_entry")
                            and dir_has_prefix(old_dir, prefix))):
                    continue
                await resp.write(payload.encode() + b"\n")
        except (ConnectionResetError, asyncio.CancelledError):
            pass
        finally:
            self._subscribers.discard(q)
            self._local_subscribers.discard(q)
        return resp

    async def handle_meta_digest(self, req: web.Request) -> web.Response:
        """/__meta__/digest?prefix=&since=&digest=0|1: the geo
        observatory's convergence probe.  Returns the meta-log head
        ts_ns and the backlog of events newer than `since` (the sync
        pump differences its resume offset against this for backlog
        depth — digest=0 skips the tree walk for that cheap path), plus
        a deterministic subtree content digest (path+size+md5, no fids
        or mtimes — see Filer.subtree_digest) the divergence auditor
        compares across regions."""
        prefix = req.query.get("prefix", "/") or "/"
        try:
            since = int(req.query.get("since", "0"))
        except ValueError:
            return web.json_response({"error": "bad since"}, status=400)
        out = {"prefix": prefix, "region": self.region,
               "head_ts_ns": self.filer.meta_log.head_ts(),
               "backlog_events": await asyncio.to_thread(
                   self.filer.meta_log.backlog_count, since, prefix)}
        if req.query.get("digest", "1") != "0":
            digest, entries = await asyncio.to_thread(
                self.filer.subtree_digest, prefix)
            out["digest"] = digest
            out["entries"] = entries
        return web.json_response(out)

    # -- admin ---------------------------------------------------------

    async def handle_server_status(self, req: web.Request) -> web.Response:
        return web.json_response({
            "version": "weedtpu", "role": "filer", "url": self.url,
            "master": self.master_url, "region": self.region,
        })

    # -- remote mount mappings (reference: filer/remote_mapping.go) ----

    _MOUNTS_KV = b"remote.mounts"

    def _load_mounts(self) -> dict:
        now = time.monotonic()
        if now - getattr(self, "_mounts_ts", 0.0) < 10.0:
            return self._mounts_map
        try:
            raw = self.filer.store.kv_get(self._MOUNTS_KV)
            self._mounts_map = json.loads(raw)
        except (NotFound, ValueError):
            self._mounts_map = {}
        self._mounts_ts = now
        return self._mounts_map

    async def handle_get_mounts(self, req: web.Request) -> web.Response:
        return web.json_response(self._load_mounts())

    async def handle_put_mounts(self, req: web.Request) -> web.Response:
        err = self._check_filer_jwt(req, write=True)
        if err is not None:
            return err
        body = await req.json()
        mounts = self._load_mounts()
        for d, spec in (body.get("set") or {}).items():
            mounts[d.rstrip("/") or "/"] = spec
        for d in body.get("remove") or []:
            mounts.pop(d.rstrip("/") or "/", None)
        self.filer.store.kv_put(
            self._MOUNTS_KV, json.dumps(mounts).encode())
        self._mounts_ts = 0.0
        return web.json_response(mounts)

    def _remote_for(self, path: str):
        """Longest-prefix mount mapping -> remote client (cached by spec);
        the read-through half of the reference's read_remote.go."""
        mounts = self._load_mounts()
        best = ""
        for d in mounts:
            pref = d.rstrip("/") + "/"
            if (path.startswith(pref) or path == d) and len(d) > len(best):
                best = d
        if not best:
            return None, None
        spec = mounts[best]
        cache = getattr(self, "_remote_clients", None)
        if cache is None:
            cache = self._remote_clients = {}
        client = cache.get(spec)
        if client is None:
            kind, options = parse_remote_spec(spec)
            client = cache[spec] = make_remote(kind, **options)
        return client, best

    async def handle_notify_subtree(self, req: web.Request) -> web.Response:
        """Re-send every entry under a prefix to the notification queue as
        a create event (reference: command_fs_meta_notify.go) — primes a
        fresh replication consumer with the existing tree."""
        if self.notification is None:
            return web.json_response(
                {"error": "no notification queue configured"}, status=400)
        body = await req.json()
        prefix = (body.get("prefix") or "/").rstrip("/") or "/"
        sent = 0

        def walk(d: str) -> None:
            nonlocal sent
            for e in self.filer.iter_entries(d):
                self.notification.send(e.directory, {
                    "directory": e.directory,
                    "old_entry": None,
                    "new_entry": e.to_dict(),
                })
                sent += 1
                if e.is_directory:
                    walk(e.full_path)

        await asyncio.to_thread(walk, prefix)
        return web.json_response({"sent": sent})

    async def handle_get_conf(self, req: web.Request) -> web.Response:
        return web.Response(text=self.conf.to_json(),
                            content_type="application/json")

    async def handle_put_conf(self, req: web.Request) -> web.Response:
        err = self._check_filer_jwt(req, write=True)
        if err is not None:
            return err
        body = await req.json()
        if "locations" in body:
            self.conf = FilerConf.from_json(json.dumps(body))
        elif "delete_prefix" in body:
            # per-prefix ops let concurrent writers (e.g. two buckets'
            # lifecycle updates) compose instead of clobbering the
            # whole document
            self.conf.delete_prefix(body["delete_prefix"])
        else:
            self.conf.upsert(PathConf(**{
                k: v for k, v in body.items()
                if k in PathConf.__dataclass_fields__}))
        save_filer_conf(self.filer.store, self.conf)
        return web.json_response({"ok": True})

    async def handle_ui(self, req: web.Request) -> web.Response:
        """Operator status page with a directory browser
        (reference: weed/server/filer_ui/ — the filer UI's core feature
        is browsing the tree).  /__ui__?path=/some/dir lists entries."""
        path = req.query.get("path", "/")
        if not path.startswith("/"):
            path = "/" + path
        rows = []
        try:
            entries = await asyncio.to_thread(
                self.filer.list_entries, path.rstrip("/") or "/", "",
                False, 200, "")
        except Exception:
            entries = []
        for e in entries:
            is_dir = stat.S_ISDIR(e.attr.mode)
            quoted = urllib.parse.quote(e.full_path)
            href = f"/__ui__?path={quoted}" if is_dir else quoted
            name = e.name + ("/" if is_dir else "")
            rows.append([f"<a href='{href}'>", name,
                         ui.fmt_bytes(e.size()) if not is_dir else "-",
                         len(e.chunks)])
        # render links without double-escaping: build the browse table by
        # hand as a preformatted HTML section
        browse = "<table><tr><th>name</th><th>size</th><th>chunks</th></tr>"
        for href_open, name, size, nchunks in rows:
            browse += (f"<tr><td>{href_open}{html.escape(name)}</a>"
                       f"</td><td class='num'>{html.escape(str(size))}"
                       f"</td><td class='num'>{nchunks}</td></tr>")
        browse += "</table>" + ("" if rows else "<p><em>empty</em></p>")
        page = ui.render(
            f"weedtpu filer {self.url}",
            {"server": ui.Table(
                ["master", "store", "deletion queue", "chunk cache hits",
                 "chunk cache misses"],
                [[self.master_url, self.filer.store.actual.name,
                  self.deletion.pending_count(), self.chunk_cache.hits,
                  self.chunk_cache.misses]]),
             "store ops": ui.Table(
                ["operation", "count"],
                [[k, v] for k, v in
                 sorted(self.filer.store.counters.items())])},
            links={"metrics": "/metrics", "status json": "/__admin__/status"})
        page = page.replace(
            "</body></html>",
            f"<h2>browse {html.escape(path)}</h2>{browse}</body></html>")
        return web.Response(text=page, content_type="text/html")

    async def handle_status(self, req: web.Request) -> web.Response:
        return web.json_response({
            "master": self.master_url,
            "store": self.filer.store.actual.name,
            "counters": dict(self.filer.store.counters),
            "deletion_pending": self.deletion.pending_count(),
            "deletion_done": self.deletion.deleted_count,
        })




_GZIPPABLE_MIME_PREFIXES = ("text/",)
_GZIPPABLE_MIMES = {
    "application/json", "application/javascript", "application/xml",
    "application/x-javascript", "application/xhtml+xml", "image/svg+xml"}


def _is_gzippable(mime: str) -> bool:
    mime = (mime or "").lower().partition(";")[0].strip()
    return mime.startswith(_GZIPPABLE_MIME_PREFIXES) or \
        mime in _GZIPPABLE_MIMES

def _req_signatures(req) -> list[int]:
    """X-Weed-Signatures: comma-separated ints; stamped by filer.sync
    writers for loop prevention (reference: filer_pb signatures)."""
    raw = req.headers.get("X-Weed-Signatures", "")
    out = []
    for part in raw.split(","):
        part = part.strip()
        if part:
            try:
                out.append(int(part))
            except ValueError:
                pass
    return out

def _entry_json(e: Entry) -> dict:
    return {
        "FullPath": e.full_path,
        "Mtime": e.attr.mtime,
        "Crtime": e.attr.crtime,
        "Mode": e.attr.mode,
        "Mime": e.attr.mime,
        "FileSize": e.size(),
        "IsDirectory": e.is_directory,
        "Md5": e.attr.md5,
        "Extended": e.extended,
        "chunks": len(e.chunks),
    }


async def _write_zeros(resp, n: int, block: int = 1 << 20) -> None:
    zero = bytes(min(n, block))
    while n > 0:
        step = min(n, len(zero))
        await resp.write(zero[:step])
        n -= step


def _ttl_seconds(ttl: str) -> int:
    if not ttl:
        return 0
    units = {"s": 1, "m": 60, "h": 3600, "d": 86400, "w": 7 * 86400,
             "M": 30 * 86400, "y": 365 * 86400}
    if ttl[-1] in units:
        return int(ttl[:-1]) * units[ttl[-1]]
    return int(ttl)
