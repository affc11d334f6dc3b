"""Shared vid->locations cache for every tier that resolves volumes.

Counterpart of `seaweedfs_tpu/utils/vid_cache.py`, whole.  The
reference keeps one implementation of this map, wdclient/vid_map.go,
and mounts it in the client, the filer and the s3 gateway alike:

- TTL'd positive entries (`WEEDTPU_VID_CACHE_TTL`, default 10s) with
  explicit overrides so push-fed entries (the master's /cluster/stream)
  can outlive the poll TTL,
- short negative caching (`WEEDTPU_VID_NEG_TTL`) so a missing vid
  cannot stampede the master with repeat lookups,
- the invalidate-once contract from the client's download path: when
  every cached location fails, drop the entry and re-ask exactly once,
- a singleflight resolver for the thread-world client
  (`SyncVidResolver`) and one for asyncio callers (`AsyncVidResolver`,
  the filer server's), so N concurrent misses on one vid issue one
  /dir/lookup with N-1 waiters: the wdclient's singleflight.Group
  around LookupVolumeIds.

The cache doubles as a plain dict facade over {vid: (urls, ts)} because
that is the shape the client exposes (tests introspect
`client._vid_cache[vid][0]` and `.clear()` it to force re-lookups).

Knobs: `WEEDTPU_VID_CACHE_TTL` and `WEEDTPU_VID_NEG_TTL`, seconds, read
when a cache is built.  A value that is not a number raises ValueError,
where the reference falls back to the default.
"""

from __future__ import annotations

import threading
import time

from seaweedfs_tpu_torch.utils.resilience import _env_float


DEFAULT_TTL = 10.0
DEFAULT_NEG_TTL = 1.5


class VidCache:
    """TTL'd vid -> (location urls, inserted-at) map with negative
    entries and hit/miss accounting.  Thread-safe; all mutators take the
    internal lock, the dict facade included."""

    def __init__(self, ttl: float | None = None,
                 negative_ttl: float | None = None):
        self.ttl = ttl if ttl is not None else \
            _env_float("WEEDTPU_VID_CACHE_TTL", DEFAULT_TTL)
        self.negative_ttl = negative_ttl if negative_ttl is not None else \
            _env_float("WEEDTPU_VID_NEG_TTL", DEFAULT_NEG_TTL)
        self._map: dict[int, tuple[list[str], float]] = {}
        self._neg: dict[int, float] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.negative_hits = 0
        self.invalidations = 0

    # -- cache core ----------------------------------------------------

    def fresh(self, vid: int) -> list[str] | None:
        """Locations for `vid` if cached and inside TTL, else None."""
        with self._lock:
            ent = self._map.get(vid)
            if ent is not None and time.time() - ent[1] < self.ttl:
                self.hits += 1
                return ent[0]
            self.misses += 1
            return None

    def negative(self, vid: int) -> bool:
        """True while `vid` sits in the negative window: the master said
        'volume id not found' recently enough that asking again would
        only stampede it."""
        with self._lock:
            ts = self._neg.get(vid)
            if ts is not None and time.time() - ts < self.negative_ttl:
                self.negative_hits += 1
                return True
            if ts is not None:
                self._neg.pop(vid, None)
            return False

    def put(self, vid: int, urls: list[str], ts: float | None = None) -> None:
        """Cache locations.  `ts` overrides the insert stamp — stream-fed
        entries pass a future-shifted stamp so they survive past the poll
        TTL up to the push horizon."""
        with self._lock:
            self._map[vid] = (list(urls), time.time() if ts is None else ts)
            self._neg.pop(vid, None)

    def put_negative(self, vid: int) -> None:
        with self._lock:
            self._neg[vid] = time.time()

    def invalidate(self, vid: int) -> bool:
        """Drop both polarities for `vid` (the re-lookup-on-failure
        contract).  Returns True when a positive entry was dropped."""
        with self._lock:
            had = self._map.pop(vid, None) is not None
            self._neg.pop(vid, None)
            if had:
                self.invalidations += 1
            return had

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._map), "negative": len(self._neg),
                    "hits": self.hits, "misses": self.misses,
                    "negative_hits": self.negative_hits,
                    "invalidations": self.invalidations,
                    "ttl_s": self.ttl, "negative_ttl_s": self.negative_ttl}

    # -- dict facade (legacy client shape) ------------------------------

    def get(self, vid, default=None):
        with self._lock:
            return self._map.get(vid, default)

    def pop(self, vid, *default):
        with self._lock:
            return self._map.pop(vid, *default)

    def clear(self) -> None:
        with self._lock:
            self._map.clear()
            self._neg.clear()

    def __getitem__(self, vid):
        with self._lock:
            return self._map[vid]

    def __setitem__(self, vid, ent) -> None:
        urls, ts = ent
        self.put(vid, urls, ts)

    def __delitem__(self, vid) -> None:
        with self._lock:
            del self._map[vid]
            self._neg.pop(vid, None)

    def __contains__(self, vid) -> bool:
        with self._lock:
            return vid in self._map

    def __len__(self) -> int:
        with self._lock:
            return len(self._map)

    # snapshots, not live views: dict(cache) / iteration must not race
    # the stream thread that mutates the map concurrently
    def keys(self):
        with self._lock:
            return list(self._map)

    def values(self):
        with self._lock:
            return list(self._map.values())

    def items(self):
        with self._lock:
            return list(self._map.items())

    def __iter__(self):
        return iter(self.keys())


class _Flight:
    __slots__ = ("event", "urls", "err")

    def __init__(self):
        self.event = threading.Event()
        self.urls: list[str] = []
        self.err: BaseException | None = None


class SyncVidResolver:
    """Singleflighted lookup for thread-world callers (WeedClient).

    `fetch(vid) -> list[str]` hits the master; an empty list means the
    master answered 'not found' (cached negatively), an exception means
    the master was unreachable (NOT cached — the next caller retries).
    """

    def __init__(self, cache: VidCache, fetch):
        self.cache = cache
        self._fetch = fetch
        self._flights: dict[int, _Flight] = {}
        self._lock = threading.Lock()
        self.upstream_lookups = 0
        self.joined = 0

    def lookup(self, vid: int) -> list[str]:
        urls = self.cache.fresh(vid)
        if urls is not None:
            return urls
        if self.cache.negative(vid):
            return []
        with self._lock:
            fl = self._flights.get(vid)
            leader = fl is None
            if leader:
                fl = self._flights[vid] = _Flight()
        if not leader:
            self.joined += 1
            fl.event.wait()
            if fl.err is not None:
                raise fl.err
            return fl.urls
        try:
            self.upstream_lookups += 1
            urls = self._fetch(vid)
            fl.urls = urls
            if urls:
                self.cache.put(vid, urls)
            else:
                self.cache.put_negative(vid)
        except BaseException as e:
            fl.err = e
            raise
        finally:
            with self._lock:
                self._flights.pop(vid, None)
            fl.event.set()
        return urls


class AsyncVidResolver:
    """Singleflighted lookup for asyncio callers (filer/s3 gateways).
    Same contract as SyncVidResolver; waiters shield the shared future
    so one cancelled request cannot poison the in-flight lookup."""

    def __init__(self, cache: VidCache, fetch):
        self.cache = cache
        self._fetch = fetch
        self._flights: dict = {}
        self.upstream_lookups = 0
        self.joined = 0

    async def lookup(self, vid: int) -> list[str]:
        import asyncio
        urls = self.cache.fresh(vid)
        if urls is not None:
            return urls
        if self.cache.negative(vid):
            return []
        fut = self._flights.get(vid)
        if fut is None:
            fut = self._flights[vid] = asyncio.ensure_future(
                self._resolve(vid))
            fut.add_done_callback(
                lambda _f, v=vid: self._flights.pop(v, None))
        else:
            self.joined += 1
        return await asyncio.shield(fut)

    async def _resolve(self, vid: int) -> list[str]:
        self.upstream_lookups += 1
        urls = await self._fetch(vid)
        if urls:
            self.cache.put(vid, urls)
        else:
            self.cache.put_negative(vid)
        return urls
