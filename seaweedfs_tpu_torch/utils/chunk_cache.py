"""Tiered chunk cache: RAM LRU + size-bucketed on-disk layers.

Counterpart of `seaweedfs_tpu/utils/chunk_cache.py`, whole.

Reference: weed/util/chunk_cache/chunk_cache.go:19-38 — a memory cache in
front of three on-disk volumes bucketed by chunk size (<=1MB, <=4MB,
bigger), so hot small chunks stay in RAM while larger ones spill to disk
with LRU eviction.  Used by the filer read path and the mount client.
"""

from __future__ import annotations

import hashlib
import os
import threading
from collections import OrderedDict

MEM_LIMIT_DEFAULT = 64 * 1024 * 1024
DISK_LIMIT_DEFAULT = 1024 * 1024 * 1024
ON_DISK_SIZE_BUCKETS = (1 << 20, 4 << 20)  # like the reference's tiers


class MemLRU:
    def __init__(self, limit_bytes: int):
        self.limit = limit_bytes
        self.used = 0
        self._d: OrderedDict[str, bytes] = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key: str) -> bytes | None:
        with self._lock:
            v = self._d.get(key)
            if v is not None:
                self._d.move_to_end(key)
            return v

    def put(self, key: str, data: bytes) -> None:
        if len(data) > self.limit:
            return
        with self._lock:
            old = self._d.pop(key, None)
            if old is not None:
                self.used -= len(old)
            self._d[key] = data
            self.used += len(data)
            while self.used > self.limit and self._d:
                _, evicted = self._d.popitem(last=False)
                self.used -= len(evicted)


class DiskTier:
    """One on-disk layer: files named by key hash, LRU-evicted by mtime."""

    def __init__(self, directory: str, limit_bytes: int):
        self.dir = directory
        self.limit = limit_bytes
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        # running byte total so put() is O(1) until actually over limit
        self._used = sum(
            st.st_size for st in (
                os.stat(os.path.join(directory, n))
                for n in os.listdir(directory) if not n.endswith(".tmp")))

    def _p(self, key: str) -> str:
        h = hashlib.sha1(key.encode()).hexdigest()
        return os.path.join(self.dir, h)

    def get(self, key: str) -> bytes | None:
        p = self._p(key)
        try:
            with open(p, "rb") as f:
                data = f.read()
            os.utime(p)  # LRU touch
            return data
        except OSError:
            return None

    def put(self, key: str, data: bytes) -> None:
        with self._lock:
            p = self._p(key)
            tmp = p + ".tmp"
            try:
                old = os.path.getsize(p) if os.path.exists(p) else 0
                with open(tmp, "wb") as f:
                    f.write(data)
                os.replace(tmp, p)
            except OSError:
                # a failed write after open() leaves a stale .tmp that
                # would sit in the directory (and, pre-fix, inflate the
                # evictor's totals) forever
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                return
            self._used += len(data) - old
            if self._used > self.limit:
                self._evict_locked()

    def _evict_locked(self) -> None:
        entries = []
        total = 0
        try:
            for name in os.listdir(self.dir):
                if name.endswith(".tmp"):
                    continue  # in-flight (or stale) temp: not cached bytes
                p = os.path.join(self.dir, name)
                try:
                    st = os.stat(p)
                except OSError:
                    continue
                entries.append((st.st_mtime, st.st_size, p))
                total += st.st_size
        except OSError:
            return
        self._used = total
        if total <= self.limit:
            return
        for _, size, p in sorted(entries):
            try:
                os.remove(p)
            except OSError:
                continue
            total -= size
            self._used = total
            if total <= self.limit:
                break


class ChunkCache:
    """The tiered composite (reference: NewTieredChunkCache)."""

    def __init__(self, mem_limit: int = MEM_LIMIT_DEFAULT,
                 disk_dir: str | None = None,
                 disk_limit: int = DISK_LIMIT_DEFAULT):
        self.mem = MemLRU(mem_limit)
        self.tiers: list[DiskTier] = []
        if disk_dir:
            per = disk_limit // (len(ON_DISK_SIZE_BUCKETS) + 1)
            for i in range(len(ON_DISK_SIZE_BUCKETS) + 1):
                self.tiers.append(
                    DiskTier(os.path.join(disk_dir, f"tier{i}"), per))
        self.hits = 0
        self.misses = 0

    def _tier_for(self, size: int) -> DiskTier | None:
        if not self.tiers:
            return None
        for i, bound in enumerate(ON_DISK_SIZE_BUCKETS):
            if size <= bound:
                return self.tiers[i]
        return self.tiers[-1]

    def get(self, key: str) -> bytes | None:
        data = self.mem.get(key)
        if data is None and self.tiers:
            for tier in self.tiers:
                data = tier.get(key)
                if data is not None:
                    self.mem.put(key, data)
                    break
        if data is None:
            self.misses += 1
        else:
            self.hits += 1
        return data

    def put(self, key: str, data: bytes) -> None:
        self.mem.put(key, data)
        tier = self._tier_for(len(data))
        if tier is not None:
            tier.put(key, data)

    def stats(self) -> dict[str, int]:
        """Hit/miss counters and per-tier byte usage, for /metrics."""
        st = {"hits": self.hits, "misses": self.misses,
              "mem_bytes": self.mem.used, "mem_limit": self.mem.limit}
        for i, tier in enumerate(self.tiers):
            st[f"tier{i}_bytes"] = tier._used
        return st
