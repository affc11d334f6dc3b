"""Client operation primitives: assign, upload, download, delete.

Counterpart of `seaweedfs_tpu/client.py`, whole.  The equivalent of the
reference's weed/operation package (assign_file_id.go:141 Assign,
upload_content.go:85 UploadWithRetry, lookup.go, delete_content.go) plus
a vid->locations cache like wdclient/vid_map.go.  It has no device and
loads no torch: a read of an EC volume with lost shards reaches the card
through the volume server's degraded read.
"""

from __future__ import annotations

import json
import time
import urllib.parse
import urllib.request
from seaweedfs_tpu_torch.security.tls import scheme as _tls_scheme
from seaweedfs_tpu_torch.utils.http import PooledHTTP
from seaweedfs_tpu_torch.utils.vid_cache import SyncVidResolver, VidCache


class WeedClient:
    def __init__(self, master: str, timeout: float = 30.0, jwt_signer=None,
                 jwt_read_signer=None, stream_updates: bool = False):
        """`jwt_signer(fid) -> token` signs volume writes/deletes, and
        `jwt_read_signer(fid)` signs reads, when the cluster enforces JWTs
        (reference: operation callers hold the security.toml signing keys,
        security/jwt.go GenJwtForVolumeServer).

        `stream_updates=True` attaches to the master's /cluster/stream
        push feed (the reference's KeepConnected, masterclient.go:20-45):
        volume-location deltas land in the vid cache the moment the master
        learns them — a dead volume server stops being routed to
        immediately instead of after the poll-TTL.  The TTL cache remains
        as the fallback whenever the stream is down."""
        # `master` may be a comma-separated HA list; requests follow the
        # raft leader like the reference wdclient (masterclient.go:20-45)
        self.masters = [m.strip() for m in master.split(",") if m.strip()]
        self.master = self.masters[0]
        self.timeout = timeout
        self.jwt_signer = jwt_signer
        self.jwt_read_signer = jwt_read_signer
        self._vid_cache = VidCache()
        self._resolver = SyncVidResolver(self._vid_cache, self._lookup_master)
        # keep-alive pool: every blob op reuses a warm connection to its
        # volume server instead of paying a TCP (and TLS) handshake per
        # request — the reference client rides Go's default Transport
        # reuse, and `weed benchmark`-shape workloads are handshake-bound
        # without it
        self._http = PooledHTTP(timeout=timeout)
        self._stream_live = False
        self._stream_stop = None
        if stream_updates:
            import threading
            self._stream_stop = threading.Event()
            t = threading.Thread(target=self._stream_loop,
                                 name="weed-vidmap-stream", daemon=True)
            t.start()

    @property
    def vid_cache_ttl(self) -> float:
        return self._vid_cache.ttl

    @vid_cache_ttl.setter
    def vid_cache_ttl(self, ttl: float) -> None:
        self._vid_cache.ttl = ttl

    def close(self) -> None:
        if self._stream_stop is not None:
            self._stream_stop.set()
        self._http.close()

    # pushed entries outlive the poll TTL but NOT forever: if the feed
    # goes silently stale (e.g. the master was demoted but its process
    # lives on) lookups degrade to TTL polling within this horizon
    STREAM_ENTRY_HORIZON = 60.0

    def _stream_loop(self) -> None:
        while not self._stream_stop.is_set():
            try:
                # the stream must follow the raft leader: only the leader
                # receives heartbeats, so a follower's feed would be empty
                try:
                    status = self._master_json("/cluster/status")
                    leader = status.get("Leader")
                    if leader and leader != self.master:
                        self.master = leader
                except (RuntimeError, OSError):
                    pass
                req = urllib.request.Request(
                    f"{_tls_scheme()}://{self.master}/cluster/stream")
                with urllib.request.urlopen(req, timeout=60) as r:
                    self._stream_live = True
                    for raw in r:
                        if self._stream_stop.is_set():
                            return
                        line = raw.strip()
                        if not line:
                            continue
                        ev = json.loads(line)
                        if "vid" not in ev:
                            continue  # ping / snapshot_end
                        urls = [l["url"] for l in ev.get("locations", [])]
                        if urls:
                            self._vid_cache[ev["vid"]] = \
                                (urls, time.time()
                                 + self.STREAM_ENTRY_HORIZON
                                 - self.vid_cache_ttl)
                        else:
                            self._vid_cache.pop(ev["vid"], None)
            except (OSError, ValueError):
                pass
            finally:
                self._stream_live = False
            if not self._stream_stop.is_set():
                # push entries go stale the moment the feed breaks: drop
                # them so lookups fall back to TTL polling, then reconnect
                self._vid_cache.clear()
                self._stream_stop.wait(1.0)

    # -- raw http ------------------------------------------------------

    def _master_json(self, path: str) -> dict:
        """GET a master endpoint over the keep-alive pool, following 409
        leader hints and rotating through the HA list on dead masters."""
        import http.client as _hc
        last: Exception | None = None
        for attempt in range(2 * max(1, len(self.masters))):
            try:
                status, _, body = self._http.request(
                    f"{_tls_scheme()}://{self.master}{path}",
                    timeout=self.timeout)
            except (_hc.HTTPException, OSError) as e:
                last = e
                if len(self.masters) > 1:
                    i = self.masters.index(self.master) \
                        if self.master in self.masters else -1
                    self.master = self.masters[(i + 1) % len(self.masters)]
                    continue
                break
            if status == 409:
                try:
                    parsed = json.loads(body)
                    leader = parsed.get("leader") \
                        if isinstance(parsed, dict) else None
                except ValueError:
                    leader = None
                if leader and leader != self.master:
                    self.master = leader
                    continue
                raise RuntimeError(f"master {path}: HTTP 409 (not leader)")
            if status >= 300:
                raise RuntimeError(f"master {path}: HTTP {status}")
            return json.loads(body)
        raise RuntimeError(f"no reachable master in {self.masters}: {last}")

    def _get_json(self, url: str) -> dict:
        status, _, body = self._http.request(f"{_tls_scheme()}://{url}",
                                             timeout=self.timeout)
        if status >= 300:
            raise RuntimeError(f"GET {url}: HTTP {status}")
        return json.loads(body)

    # -- master ops ----------------------------------------------------

    def assign(self, count: int = 1, collection: str = "",
               replication: str = "", ttl: str = "") -> dict:
        params = {"count": count}
        if collection:
            params["collection"] = collection
        if replication:
            params["replication"] = replication
        if ttl:
            params["ttl"] = ttl
        qs = urllib.parse.urlencode(params)
        r = self._master_json(f"/dir/assign?{qs}")
        if "error" in r:
            raise RuntimeError(f"assign failed: {r['error']}")
        return r

    def _lookup_master(self, vid: int) -> list[str]:
        """One real /dir/lookup.  404 ('volume id not found') returns []
        so the resolver caches it negatively; transport errors raise and
        stay uncached."""
        try:
            r = self._master_json(f"/dir/lookup?volumeId={vid}")
        except RuntimeError as e:
            if "HTTP 404" in str(e):
                return []
            raise
        return [l["url"] for l in r.get("locations", [])]

    def lookup(self, vid: int) -> list[str]:
        """Cached vid->locations: TTL hit, else negative-window hit, else
        a singleflighted master lookup (N concurrent misses on one vid
        cost one /dir/lookup; waiters share the result)."""
        return self._resolver.lookup(vid)

    # -- blob ops ------------------------------------------------------

    def upload(self, data: bytes, name: str = "", mime: str = "",
               collection: str = "", replication: str = "",
               ttl: str = "") -> str:
        """Assign + upload; returns the fid."""
        a = self.assign(collection=collection, replication=replication, ttl=ttl)
        fid, url = a["fid"], a["url"]
        self.upload_to(url, fid, data, name, mime, jwt=a.get("auth", ""))
        return fid

    def _auth_headers(self, fid: str, jwt: str = "") -> dict:
        token = jwt or (self.jwt_signer(fid) if self.jwt_signer else "")
        return {"Authorization": "Bearer " + token} if token else {}

    def upload_to(self, url: str, fid: str, data: bytes,
                  name: str = "", mime: str = "", jwt: str = "") -> None:
        headers = {"Content-Type": mime or "application/octet-stream"}
        headers.update(self._auth_headers(fid, jwt))
        if name:
            headers["X-File-Name"] = name
        status, _, _ = self._http.request(
            f"{_tls_scheme()}://{url}/{fid}", method="PUT", body=data,
            headers=headers, timeout=self.timeout)
        if status >= 300:
            raise RuntimeError(f"upload {fid} to {url}: HTTP {status}")

    def download(self, fid: str) -> bytes:
        import http.client as _hc
        vid = int(fid.partition(",")[0])
        headers = {}
        if self.jwt_read_signer:
            headers["Authorization"] = "Bearer " + self.jwt_read_signer(fid)
        last_err: Exception | None = None
        # two passes: the cached locations first, then — when EVERY
        # cached location failed — one fresh master lookup.  A volume
        # the autopilot moved or re-tiered between servers answers 404
        # at its old home for up to a cache TTL; the re-lookup makes
        # that window invisible instead of an error (the reference
        # wdclient invalidates and retries the same way).
        for attempt in range(2):
            for url in self.lookup(vid):
                try:
                    status, _, body = self._http.request(
                        f"{_tls_scheme()}://{url}/{fid}", headers=headers,
                        timeout=self.timeout)
                except (_hc.HTTPException, OSError) as e:
                    last_err = e
                    continue
                if status < 300:
                    return body
                last_err = RuntimeError(f"{url}/{fid}: HTTP {status}")
            if attempt == 0 and self._vid_cache.invalidate(vid):
                pass  # stale route dropped: re-ask the master once
            else:
                break
        raise RuntimeError(f"download {fid} failed: {last_err or 'no locations'}")

    def delete(self, fid: str) -> None:
        import http.client as _hc
        vid = int(fid.partition(",")[0])
        for url in self.lookup(vid):
            try:
                status, _, _ = self._http.request(
                    f"{_tls_scheme()}://{url}/{fid}", method="DELETE",
                    headers=self._auth_headers(fid), timeout=self.timeout)
            except (_hc.HTTPException, OSError):
                continue
            if status < 300:
                return
        raise RuntimeError(f"delete {fid} failed")
