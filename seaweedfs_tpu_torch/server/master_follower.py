"""Read-only follower master.

Counterpart of `seaweedfs_tpu/server/master_follower.py`, whole.
Reference: `weed master.follower` (weed/command/master_follower.go) — a
lookup-serving proxy that keeps its vid→locations map fresh off the real
master cluster and scales read QPS without joining raft.  Lookups are
answered locally from the streamed map (falling back to a proxied lookup
on a miss); writes (assign / grow) are forwarded to the leader.  It has
no device.
"""

from __future__ import annotations

import asyncio
import logging

import aiohttp
from aiohttp import web

from seaweedfs_tpu_torch.client import WeedClient
from seaweedfs_tpu_torch.security import tls as _tls
from seaweedfs_tpu_torch.security.tls import scheme as _tls_scheme
from seaweedfs_tpu_torch.stats import metrics

log = logging.getLogger("master.follower")


class MasterFollower:
    def __init__(self, masters: str, host: str = "127.0.0.1",
                 port: int = 9334):
        self.host, self.port = host, port
        self.client = WeedClient(masters, stream_updates=True)
        self.app = web.Application()
        self.app.add_routes([
            web.get("/dir/lookup", self.handle_lookup),
            web.get("/dir/ec/lookup", self.handle_proxy_get),
            web.get("/dir/status", self.handle_proxy_get),
            web.get("/cluster/status", self.handle_proxy_get),
            web.route("*", "/dir/assign", self.handle_proxy),
            web.post("/vol/grow", self.handle_proxy),
            web.get("/metrics", self.handle_metrics),
            web.get("/", self.handle_ui),
        ])
        self._runner: web.AppRunner | None = None
        self._session: aiohttp.ClientSession | None = None

    @property
    def url(self) -> str:
        return f"{self.host}:{self.port}"

    async def start(self) -> None:
        self._session = aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(ssl=_tls.client_ssl()),
            timeout=aiohttp.ClientTimeout(total=30))
        self._runner = web.AppRunner(self.app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.host, self.port)
        await site.start()
        log.info("master follower on %s tracking %s", self.url,
                 ",".join(self.client.masters))

    async def stop(self) -> None:
        self.client.close()
        if self._session:
            await self._session.close()
        if self._runner:
            await self._runner.cleanup()

    async def handle_lookup(self, req: web.Request) -> web.Response:
        vid_s = req.query.get("volumeId", "")
        if not vid_s.isdigit():
            return web.json_response({"error": "volumeId required"},
                                     status=400)
        try:
            locs = await asyncio.to_thread(self.client.lookup, int(vid_s))
        except RuntimeError as e:
            return web.json_response({"error": str(e)}, status=404)
        if not locs:
            return web.json_response(
                {"volumeId": vid_s, "error": "not found"}, status=404)
        return web.json_response({
            "volumeId": vid_s,
            "locations": [{"url": u, "publicUrl": u} for u in locs]})

    async def _leader(self) -> str:
        try:
            status = await asyncio.to_thread(
                self.client._master_json, "/cluster/status")
            return status.get("Leader") or self.client.master
        except RuntimeError:
            return self.client.master

    async def handle_proxy(self, req: web.Request) -> web.Response:
        leader = await self._leader()
        url = (f"{_tls_scheme()}://{leader}{req.path}"
               + (f"?{req.query_string}" if req.query_string else ""))
        body = await req.read()
        async with self._session.request(
                req.method, url, data=body or None,
                headers={"Content-Type":
                         req.headers.get("Content-Type", "")}) as r:
            return web.Response(body=await r.read(), status=r.status,
                                content_type=r.content_type)

    async def handle_proxy_get(self, req: web.Request) -> web.Response:
        return await self.handle_proxy(req)

    async def handle_metrics(self, req: web.Request) -> web.Response:
        return web.Response(text=metrics.REGISTRY.render(),
                            content_type="text/plain")

    async def handle_ui(self, req: web.Request) -> web.Response:
        from seaweedfs_tpu_torch.server import ui
        # snapshot: the stream thread mutates _vid_cache concurrently
        cached = {vid: locs for vid, (locs, _) in
                  sorted(dict(self.client._vid_cache).items())}
        return web.Response(text=ui.render(
            f"weedtpu master follower {self.url}",
            {"tracking": ui.Table(
                ["masters", "stream live", "cached volumes"],
                [[", ".join(self.client.masters),
                  self.client._stream_live, len(cached)]]),
             "vid cache": ui.Table(
                ["volume", "locations"],
                [[vid, ", ".join(locs)] for vid, locs in cached.items()])},
            links={"metrics": "/metrics"}),
            content_type="text/html")
