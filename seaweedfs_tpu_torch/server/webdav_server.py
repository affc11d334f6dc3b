"""WebDAV gateway over the filer (RFC 4918 subset).

Counterpart of `seaweedfs_tpu/server/webdav_server.py`: the same verbs,
status codes, headers and multistatus bodies, but for one repair: COPY
of a collection copies its members (the reference's copies the filer's
listing of it into a file).  It has no device and loads no torch.  Reference: weed/server/webdav_server.go + wrapped_webdav_fs.go (the
reference wraps golang.org/x/net/webdav around a filer-backed FS; here the
DAV verbs are implemented directly over the filer HTTP API).  Supports
OPTIONS, PROPFIND (Depth 0/1), HEAD, GET, PUT, DELETE, MKCOL, MOVE, COPY,
and no-op LOCK/UNLOCK (class-2 clients like macOS Finder insist on LOCK).
"""

from __future__ import annotations

import logging
import time
import urllib.parse
import xml.etree.ElementTree as ET

import aiohttp
from aiohttp import web
from seaweedfs_tpu_torch.security import tls as _tls
from seaweedfs_tpu_torch.security.jwt import gen_jwt
from seaweedfs_tpu_torch.security.tls import scheme as _tls_scheme

log = logging.getLogger("webdav")

DAV_NS = "DAV:"


def _iso8601(ts: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(ts or 0))


def _http_date(ts: float) -> str:
    return time.strftime("%a, %d %b %Y %H:%M:%S GMT", time.gmtime(ts or 0))


class WebDavServer:
    def __init__(self, filer_url: str, host: str = "127.0.0.1",
                 port: int = 7333, prefix: str = "/", security=None):
        self.filer_url = filer_url
        self.host, self.port = host, port
        self.prefix = prefix.rstrip("/")
        self.security = security
        self.app = web.Application(client_max_size=1024 * 1024 * 1024)
        self.app.router.add_route("*", "/{path:.*}", self.dispatch)
        self._runner: web.AppRunner | None = None
        self._session: aiohttp.ClientSession | None = None

    @property
    def url(self) -> str:
        return f"{self.host}:{self.port}"

    async def start(self) -> None:
        self._session = aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(ssl=_tls.client_ssl()),
            timeout=aiohttp.ClientTimeout(total=3600))
        self._runner = web.AppRunner(self.app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.host, self.port,
                           ssl_context=_tls.server_ssl("webdav"))
        await site.start()
        log.info("webdav on %s -> filer %s", self.url, self.filer_url)

    async def stop(self) -> None:
        if self._session:
            await self._session.close()
        if self._runner:
            await self._runner.cleanup()

    # -- filer client ---------------------------------------------------

    def _fp(self, path: str) -> str:
        p = self.prefix + "/" + path.strip("/")
        return p.rstrip("/") or "/"

    def _filer_auth(self) -> dict:
        if self.security is None or not self.security.filer_write:
            return {}
        return {"Authorization":
                "Bearer " + gen_jwt(self.security.filer_write, "")}

    async def _meta(self, path: str) -> dict | None:
        url = (f"{_tls_scheme()}://{self.filer_url}{urllib.parse.quote(self._fp(path))}"
               "?metadata=true")
        async with self._session.get(url, headers=self._filer_auth()) as r:
            if r.status != 200:
                return None
            return await r.json()

    async def _list(self, path: str) -> list[dict]:
        d = self._fp(path).rstrip("/") + "/"
        url = (f"{_tls_scheme()}://{self.filer_url}{urllib.parse.quote(d)}"
               "?limit=10000")
        async with self._session.get(
                url, headers={"Accept": "application/json",
                              **self._filer_auth()}) as r:
            if r.status != 200:
                return []
            body = await r.json()
            return body.get("Entries") or []

    # -- dispatch -------------------------------------------------------

    async def dispatch(self, req: web.Request) -> web.StreamResponse:
        path = "/" + req.match_info["path"]
        m = req.method.upper()
        handler = {
            "OPTIONS": self.do_options, "PROPFIND": self.do_propfind,
            "GET": self.do_get, "HEAD": self.do_get, "PUT": self.do_put,
            "DELETE": self.do_delete, "MKCOL": self.do_mkcol,
            "MOVE": self.do_move, "COPY": self.do_copy,
            "LOCK": self.do_lock, "UNLOCK": self.do_unlock,
            "PROPPATCH": self.do_proppatch,
        }.get(m)
        if handler is None:
            return web.Response(status=405)
        try:
            return await handler(req, path)
        except aiohttp.ClientError as e:
            log.warning("webdav %s %s: %s", m, path, e)
            return web.Response(status=502, text=str(e))

    async def do_options(self, req, path) -> web.Response:
        return web.Response(headers={
            "DAV": "1, 2",
            "Allow": ("OPTIONS, PROPFIND, GET, HEAD, PUT, DELETE, MKCOL, "
                      "MOVE, COPY, LOCK, UNLOCK, PROPPATCH"),
            "MS-Author-Via": "DAV",
        })

    # -- PROPFIND -------------------------------------------------------

    def _prop_response(self, multistatus: ET.Element, href: str,
                       meta: dict, is_dir: bool) -> None:
        resp = ET.SubElement(multistatus, f"{{{DAV_NS}}}response")
        ET.SubElement(resp, f"{{{DAV_NS}}}href").text = urllib.parse.quote(
            href + ("/" if is_dir and not href.endswith("/") else ""))
        propstat = ET.SubElement(resp, f"{{{DAV_NS}}}propstat")
        prop = ET.SubElement(propstat, f"{{{DAV_NS}}}prop")
        rtype = ET.SubElement(prop, f"{{{DAV_NS}}}resourcetype")
        if is_dir:
            ET.SubElement(rtype, f"{{{DAV_NS}}}collection")
        attr = meta.get("attr") or {}
        size = meta.get("FileSize", attr.get("file_size", 0))
        if not is_dir:
            ET.SubElement(prop,
                          f"{{{DAV_NS}}}getcontentlength").text = str(size)
            mime = meta.get("Mime") or attr.get("mime") or \
                "application/octet-stream"
            ET.SubElement(prop, f"{{{DAV_NS}}}getcontenttype").text = mime
        mtime = meta.get("Mtime", attr.get("mtime", 0))
        ET.SubElement(prop,
                      f"{{{DAV_NS}}}getlastmodified").text = _http_date(mtime)
        crtime = meta.get("Crtime", attr.get("crtime", 0))
        ET.SubElement(prop,
                      f"{{{DAV_NS}}}creationdate").text = _iso8601(crtime)
        ET.SubElement(prop, f"{{{DAV_NS}}}displayname").text = \
            href.rstrip("/").rsplit("/", 1)[-1]
        ET.SubElement(propstat, f"{{{DAV_NS}}}status").text = \
            "HTTP/1.1 200 OK"

    async def do_propfind(self, req, path) -> web.Response:
        depth = req.headers.get("Depth", "1")
        meta = await self._meta(path)
        if meta is None and path not in ("/", ""):
            return web.Response(status=404)
        is_dir = path in ("/", "") or bool(
            (meta or {}).get("attr", {}).get("mode", 0) & 0o040000)
        ET.register_namespace("D", DAV_NS)
        ms = ET.Element(f"{{{DAV_NS}}}multistatus")
        self._prop_response(ms, path, meta or {}, is_dir)
        if is_dir and depth != "0":
            for e in await self._list(path):
                name = e["FullPath"].rsplit("/", 1)[-1]
                child = path.rstrip("/") + "/" + name
                self._prop_response(ms, child, e, bool(e.get("IsDirectory")))
        body = (b'<?xml version="1.0" encoding="utf-8"?>'
                + ET.tostring(ms))
        return web.Response(status=207, body=body,
                            content_type="application/xml")

    async def do_proppatch(self, req, path) -> web.Response:
        # accept-and-ignore (same as most simple servers); 207 keeps
        # clients happy
        ET.register_namespace("D", DAV_NS)
        ms = ET.Element(f"{{{DAV_NS}}}multistatus")
        resp = ET.SubElement(ms, f"{{{DAV_NS}}}response")
        ET.SubElement(resp, f"{{{DAV_NS}}}href").text = path
        ET.SubElement(resp, f"{{{DAV_NS}}}status").text = "HTTP/1.1 200 OK"
        return web.Response(status=207, body=ET.tostring(ms),
                            content_type="application/xml")

    # -- data verbs -----------------------------------------------------

    async def do_get(self, req, path) -> web.StreamResponse:
        url = f"{_tls_scheme()}://{self.filer_url}{urllib.parse.quote(self._fp(path))}"
        headers = self._filer_auth()
        if "Range" in req.headers:
            headers["Range"] = req.headers["Range"]
        async with self._session.get(url, headers=headers) as r:
            if r.status == 404:
                return web.Response(status=404)
            if r.status >= 300 and r.status not in (206,):
                return web.Response(status=502)
            out = web.StreamResponse(status=r.status)
            for h in ("Content-Type", "Content-Range", "Last-Modified",
                      "ETag"):
                if h in r.headers:
                    out.headers[h] = r.headers[h]
            if r.headers.get("Content-Length"):
                out.content_length = int(r.headers["Content-Length"])
            await out.prepare(req)
            if req.method != "HEAD":
                async for chunk in r.content.iter_chunked(1 << 20):
                    await out.write(chunk)
            await out.write_eof()
            return out

    async def do_put(self, req, path) -> web.Response:
        body = await req.read()
        url = f"{_tls_scheme()}://{self.filer_url}{urllib.parse.quote(self._fp(path))}"
        headers = {**self._filer_auth(),
                   "Content-Type": req.headers.get(
                       "Content-Type", "application/octet-stream")}
        async with self._session.put(url, data=body, headers=headers) as r:
            if r.status >= 300:
                return web.Response(status=502)
        return web.Response(status=201)

    async def do_delete(self, req, path) -> web.Response:
        url = (f"{_tls_scheme()}://{self.filer_url}{urllib.parse.quote(self._fp(path))}"
               "?recursive=true")
        async with self._session.delete(url, headers=self._filer_auth()) as r:
            if r.status == 404:
                return web.Response(status=404)
            return web.Response(status=204)

    async def do_mkcol(self, req, path) -> web.Response:
        url = (f"{_tls_scheme()}://{self.filer_url}"
               f"{urllib.parse.quote(self._fp(path).rstrip('/') + '/')}")
        async with self._session.post(url, data=b"",
                                      headers=self._filer_auth()) as r:
            if r.status >= 300:
                return web.Response(status=409)
        return web.Response(status=201)

    def _dest_path(self, req) -> str | None:
        dest = req.headers.get("Destination", "")
        if not dest:
            return None
        parsed = urllib.parse.urlparse(dest)
        return urllib.parse.unquote(parsed.path)

    async def do_move(self, req, path) -> web.Response:
        dest = self._dest_path(req)
        if not dest:
            return web.Response(status=400)
        url = (f"{_tls_scheme()}://{self.filer_url}{urllib.parse.quote(self._fp(dest))}"
               f"?mv.from={urllib.parse.quote(self._fp(path))}")
        async with self._session.post(url, data=b"",
                                      headers=self._filer_auth()) as r:
            if r.status >= 300:
                return web.Response(status=502)
        return web.Response(status=201)

    async def do_copy(self, req, path) -> web.Response:
        dest = self._dest_path(req)
        if not dest:
            return web.Response(status=400)
        meta = await self._meta(path)
        if (meta or {}).get("attr", {}).get("mode", 0) & 0o040000:
            # a collection copies with its members (RFC 4918 9.8.3, Depth
            # infinity); the reference's GET of a directory would copy
            # the filer's listing into a file
            return web.Response(status=await self._copy_tree(path, dest))
        return web.Response(status=await self._copy_file(path, dest))

    async def _copy_file(self, path: str, dest: str) -> int:
        src = f"{_tls_scheme()}://{self.filer_url}{urllib.parse.quote(self._fp(path))}"
        async with self._session.get(src, headers=self._filer_auth()) as r:
            if r.status != 200:
                return 404
            data = await r.read()
            ctype = r.headers.get("Content-Type",
                                  "application/octet-stream")
        dst = f"{_tls_scheme()}://{self.filer_url}{urllib.parse.quote(self._fp(dest))}"
        async with self._session.put(
                dst, data=data,
                headers={**self._filer_auth(), "Content-Type": ctype}) as r:
            if r.status >= 300:
                return 502
        return 201

    async def _copy_tree(self, path: str, dest: str) -> int:
        url = (f"{_tls_scheme()}://{self.filer_url}"
               f"{urllib.parse.quote(self._fp(dest).rstrip('/') + '/')}")
        async with self._session.post(url, data=b"",
                                      headers=self._filer_auth()) as r:
            if r.status >= 300:
                return 409
        for e in await self._list(path):
            name = e["FullPath"].rsplit("/", 1)[-1]
            src = path.rstrip("/") + "/" + name
            dst = dest.rstrip("/") + "/" + name
            st = await (self._copy_tree(src, dst) if e.get("IsDirectory")
                        else self._copy_file(src, dst))
            if st != 201:
                return st
        return 201

    async def do_lock(self, req, path) -> web.Response:
        token = f"opaquelocktoken:weedtpu-{int(time.time() * 1000):x}"
        body = (f'<?xml version="1.0" encoding="utf-8"?>'
                f'<D:prop xmlns:D="DAV:"><D:lockdiscovery><D:activelock>'
                f'<D:locktype><D:write/></D:locktype>'
                f'<D:lockscope><D:exclusive/></D:lockscope>'
                f'<D:depth>infinity</D:depth>'
                f'<D:timeout>Second-3600</D:timeout>'
                f'<D:locktoken><D:href>{token}</D:href></D:locktoken>'
                f'</D:activelock></D:lockdiscovery></D:prop>')
        return web.Response(status=200, body=body.encode(),
                            content_type="application/xml",
                            headers={"Lock-Token": f"<{token}>"})

    async def do_unlock(self, req, path) -> web.Response:
        return web.Response(status=204)
