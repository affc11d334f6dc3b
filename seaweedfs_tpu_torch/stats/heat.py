"""Workload heat analytics: streaming heavy-hitters with time decay.

Counterpart of `seaweedfs_tpu/stats/heat.py`.  Which objects are hot,
which tenants drive the load, and which volumes serve reads by
reconstruction, kept in O(1) memory:

- **Space-Saving top-K** (Metwally et al.): at most `HEAT_K` counters
  per dimension; a new key evicts the minimum counter and inherits its
  count as its error bound, so ``est >= true`` and ``est - err <= true``
  for every tracked key.
- **Count-Min sketch**: a depth x width matrix of counters under
  deterministic crc32 hashes (Python's ``hash()`` is salted per process
  and would break merging across nodes).

Both decay exponentially (half-life `HALFLIFE_S`) by a lazy
multiplicative sweep, and `serialize` is a node's mergeable form.
Dimensions: ``chunk``, ``volume``, ``tenant``.  The port's data plane
records a ``degraded`` event on a volume whenever an EC read
reconstructs (`ec_volume.EcVolume`), under foreground traffic only
(`ambient_is_data`).  The tenant a request carries (`TENANT_HEADER`)
rides a contextvar that the servers' middleware sets and their clients
forward (`inject`).  `/heat` (`handle_heat`) serves `serialize()`, the
form the master's /cluster/heat fan-out merges (`merge_serialized`:
Space-Saving and Count-Min merges, decay-adjusted to the merger's
clock).  The reference's defaults are constants here (the switch, top-K
size and half-life knobs); tenant resolution at the edge comes with the
S3 gateway (ROADMAP 1.21).
"""

from __future__ import annotations

import math
import threading
import time
import uuid
import zlib
from contextvars import ContextVar

from seaweedfs_tpu_torch.stats import netflow

DIMS = ("chunk", "volume", "tenant")

# ops recorded per key; "degraded" marks an EC read that reconstructed
OPS = ("read", "write", "degraded")

CMS_WIDTH = 512
CMS_DEPTH = 4

# sweep cadence of the lazy decay (seconds), and the floor below which a
# decayed Space-Saving entry is dropped
DECAY_TICK = 1.0
EPS = 1e-3

# the reference's defaults: counters per dimension, and the half-life
HEAT_K = 64
HALFLIFE_S = 300.0

LN2 = math.log(2.0)

TENANT_HEADER = "X-Weedtpu-Tenant"


def ambient_is_data(include_readahead: bool = False) -> bool:
    """True when the ambient netflow class is foreground data, so that
    the cluster's own traffic (scrub, repair, conversion) never skews the
    sketches."""
    cls = netflow.current_class()
    return cls in (None, "data") or \
        (include_readahead and cls == "readahead")


# per-row crc32 seeds: deterministic and process-independent, so the same
# key lands in the same Count-Min cells on every node
_CMS_SEEDS = tuple((d * 0x9E3779B1) & 0xFFFFFFFF
                   for d in range(CMS_DEPTH))


def _cells(key: str, width: int, depth: int) -> list[int]:
    """The key's cell in each row."""
    kb = key.encode("utf-8", "replace")
    crc = zlib.crc32
    return [crc(kb, _CMS_SEEDS[d]) % width for d in range(depth)]


class SpaceSaving:
    """Decayed Space-Saving heavy-hitter summary.

    ``entries`` maps key -> [count, err, aux, first_seen]: ``aux`` holds
    decayed per-key sub-counters (bytes, per-op counts) that die with the
    entry, and ``first_seen`` is the wall time the entry was created
    (never decayed; an evicted key's replacement starts a fresh clock).
    Not thread-safe by itself: HeatTracker serialises each dimension."""

    __slots__ = ("k", "halflife", "entries", "total", "_now", "_last")

    def __init__(self, k: int, halflife: float, now_fn=time.time):
        self.k = k
        self.halflife = halflife
        self.entries: dict[str, list] = {}
        self.total = 0.0
        self._now = now_fn
        self._last = now_fn()

    def _decay(self, now: float) -> None:
        dt = now - self._last
        if dt < DECAY_TICK:
            return
        self._last = now
        f = 0.5 ** (dt / self.halflife)
        self.total *= f
        drop = []
        for key, ent in self.entries.items():
            ent[0] *= f
            ent[1] *= f
            aux = ent[2]
            for a in aux:
                aux[a] *= f
            if ent[0] < EPS:
                drop.append(key)
        for key in drop:
            del self.entries[key]

    def offer(self, key: str, weight: float = 1.0,
              aux: dict | None = None) -> None:
        """`weight=0` is an aux-only update (an event annotated onto a key
        without counting a second request): it never evicts, and creates
        an entry only where there is free room."""
        now = self._now()
        self._decay(now)
        self.total += weight
        ent = self.entries.get(key)
        if ent is None:
            if len(self.entries) < self.k:
                ent = self.entries[key] = [0.0, 0.0, {}, now]
            elif weight <= 0:
                return  # not worth an eviction for an annotation
            else:
                # evict the minimum counter; the newcomer inherits its
                # count as the error bound, but not its tenure
                victim = min(self.entries, key=lambda q:
                             self.entries[q][0])
                vcount = self.entries.pop(victim)[0]
                ent = self.entries[key] = [vcount, vcount, {}, now]
        ent[0] += weight
        if aux:
            a = ent[2]
            for name, v in aux.items():
                a[name] = a.get(name, 0.0) + v

    def min_count(self) -> float:
        """The floor a key not in the summary could hide beneath: the
        minimum tracked counter once full, else 0."""
        if len(self.entries) < self.k:
            return 0.0
        return min(e[0] for e in self.entries.values())

    def snapshot(self) -> dict:
        """Serialised, mergeable form (counts as of ``ts``)."""
        now = self._now()
        self._decay(now)
        return {"ts": now, "k": self.k, "halflife": self.halflife,
                "total": self.total, "min": self.min_count(),
                "entries": [[key, ent[0], ent[1], dict(ent[2]), ent[3]]
                            for key, ent in self.entries.items()]}

    @staticmethod
    def merge(snaps: list[dict], k: int, halflife: float,
              now: float | None = None) -> dict:
        """Fold node snapshots into one summary dict.  A key absent from
        one node's summary contributes that node's minimum counter to
        both est and err (it may have been evicted there holding up to
        min), preserving ``est >= true`` and ``est - err <= true`` over
        the union stream."""
        if now is None:
            now = time.time()
        keys: set[str] = set()
        adj = []
        for s in snaps:
            f = 0.5 ** (max(0.0, now - s.get("ts", now)) / halflife)
            ents = {e[0]: e for e in s.get("entries", [])}
            adj.append((f, ents, s.get("min", 0.0) * f))
            keys.update(ents)
        total = sum(s.get("total", 0.0) *
                    0.5 ** (max(0.0, now - s.get("ts", now)) / halflife)
                    for s in snaps)
        merged = []
        for key in keys:
            est = err = 0.0
            aux: dict[str, float] = {}
            # fleet first_seen = the earliest sighting over the nodes
            # that track the key (absent nodes' min contributions carry
            # no tenure); adding a node can only move it earlier
            first_seen: float | None = None
            for f, ents, minc in adj:
                ent = ents.get(key)
                if ent is None:
                    est += minc
                    err += minc
                    continue
                est += ent[1] * f
                err += ent[2] * f
                for name, v in (ent[3] or {}).items():
                    aux[name] = aux.get(name, 0.0) + v * f
                if len(ent) > 4 and ent[4] is not None:
                    fs = float(ent[4])
                    if first_seen is None or fs < first_seen:
                        first_seen = fs
            merged.append([key, est, err, aux, first_seen])
        merged.sort(key=lambda e: e[1], reverse=True)
        return {"ts": now, "k": k, "halflife": halflife, "total": total,
                "min": 0.0, "entries": merged[:k]}


class CountMin:
    """Decayed Count-Min sketch over float counters, in plain lists: the
    hot path is one cell update per row, which a list does faster than
    numpy scalar indexing."""

    __slots__ = ("width", "depth", "halflife", "rows", "_now", "_last")

    def __init__(self, halflife: float, now_fn=time.time):
        # the layout is fixed: every node must hash into the same cells
        self.width = CMS_WIDTH
        self.depth = CMS_DEPTH
        self.halflife = halflife
        self.rows = [[0.0] * self.width for _ in range(self.depth)]
        self._now = now_fn
        self._last = now_fn()

    def _decay(self, now: float) -> None:
        dt = now - self._last
        if dt < DECAY_TICK:
            return
        self._last = now
        f = 0.5 ** (dt / self.halflife)
        for row in self.rows:
            for i, v in enumerate(row):
                row[i] = v * f

    def add(self, key: str, weight: float = 1.0) -> None:
        self._decay(self._now())
        for d, i in enumerate(_cells(key, self.width, self.depth)):
            self.rows[d][i] += weight

    def estimate(self, key: str) -> float:
        self._decay(self._now())
        return min(self.rows[d][i]
                   for d, i in enumerate(_cells(key, self.width,
                                                self.depth)))

    def snapshot(self) -> dict:
        now = self._now()
        self._decay(now)
        return {"ts": now, "width": self.width, "depth": self.depth,
                "halflife": self.halflife,
                "rows": [[round(v, 6) for v in row]
                         for row in self.rows]}

    @staticmethod
    def merge(snaps: list[dict], halflife: float,
              now: float | None = None):
        if now is None:
            now = time.time()
        m = CountMin(halflife)
        m._last = now
        for s in snaps:
            if s.get("width") != CMS_WIDTH or s.get("depth") != CMS_DEPTH:
                continue  # layout mismatch: skip rather than corrupt
            f = 0.5 ** (max(0.0, now - s.get("ts", now)) / halflife)
            rows = s.get("rows", [])
            if len(rows) != CMS_DEPTH or \
                    any(len(r) != CMS_WIDTH for r in rows):
                continue
            for d in range(CMS_DEPTH):
                out = m.rows[d]
                for i, v in enumerate(rows[d]):
                    out[i] += v * f
        return m


class HeatTracker:
    """One Space-Saving and one Count-Min per dimension, one lock per
    dimension."""

    def __init__(self, k: int | None = None,
                 halflife: float | None = None, now_fn=time.time):
        self.k = k if k is not None else HEAT_K
        self.halflife = halflife if halflife is not None else HALFLIFE_S
        # names this tracker in its serialised form, so a fleet merge
        # counts a tracker shared by co-hosted servers once
        self.tracker_id = uuid.uuid4().hex
        self._now = now_fn
        self._locks = {dim: threading.Lock() for dim in DIMS}
        self._top = {dim: SpaceSaving(self.k, self.halflife, now_fn)
                     for dim in DIMS}
        self._cms = {dim: CountMin(self.halflife, now_fn=now_fn)
                     for dim in DIMS}

    def record(self, dim: str, key: str, nbytes: int = 0,
               op: str = "read", weight: float = 1.0) -> None:
        """`weight=0` annotates without counting: the event bumps the
        key's aux sub-counters but adds nothing to its request estimate
        or the Count-Min frequencies (a degraded read is the same request
        its read record already counted)."""
        if not key or dim not in self._locks:
            return
        if op not in OPS:
            op = "read"
        aux = {"bytes": float(nbytes), op: 1.0} if nbytes \
            else {op: 1.0}
        with self._locks[dim]:
            self._top[dim].offer(key, weight, aux)
            if weight:
                self._cms[dim].add(key, weight)

    def estimate(self, dim: str, key: str) -> float:
        with self._locks[dim]:
            return self._cms[dim].estimate(key)

    def serialize(self) -> dict:
        dims = {}
        cms = {}
        for dim in DIMS:
            with self._locks[dim]:
                dims[dim] = self._top[dim].snapshot()
                cms[dim] = self._cms[dim].snapshot()
        return {"ts": self._now(), "id": self.tracker_id, "k": self.k,
                "halflife": self.halflife, "dims": dims, "cms": cms}

    def reset(self) -> None:
        for dim in DIMS:
            with self._locks[dim]:
                self._top[dim] = SpaceSaving(self.k, self.halflife,
                                             self._now)
                self._cms[dim] = CountMin(self.halflife,
                                          now_fn=self._now)


TRACKER = HeatTracker()


def record(dim: str, key: str, nbytes: int = 0, op: str = "read",
           weight: float = 1.0) -> None:
    """Record into the process's tracker."""
    TRACKER.record(dim, key, nbytes, op, weight)


def reset() -> None:
    TRACKER.reset()


def serialize() -> dict:
    return TRACKER.serialize()


# -- fleet merge (the master's /cluster/heat) ----------------------------

def _entry_view(ent: list, halflife: float,
                now: float | None = None) -> dict:
    """One merged Space-Saving entry -> the operator-facing record.
    RPS and byte rate invert the decay equilibrium (a steady rate r
    settles at r * H/ln2), so they read as recent-rate estimates."""
    key, est, err, aux = ent[:4]
    first_seen = ent[4] if len(ent) > 4 else None
    rate = LN2 / halflife
    reads = aux.get("read", 0.0)
    writes = aux.get("write", 0.0)
    degraded = aux.get("degraded", 0.0)
    rec = {"key": key, "est": round(est, 3), "err": round(err, 3),
           "rps": round(est * rate, 3),
           "bytes_rate": round(aux.get("bytes", 0.0) * rate, 1),
           "reads": round(reads, 2), "writes": round(writes, 2)}
    if first_seen is not None:
        if now is None:
            now = time.time()
        # how long this key has continuously been tracked (an eviction
        # resets the clock)
        rec["sustained_s"] = round(max(0.0, now - first_seen), 1)
    rw = reads + writes
    if rw > 0:
        rec["read_fraction"] = round(reads / rw, 4)
    if degraded > 0:
        rec["degraded"] = round(degraded, 2)
        if reads > 0:
            rec["degraded_fraction"] = round(min(1.0, degraded / reads), 4)
    return rec


def merge_serialized(snaps: list[dict], k: int | None = None,
                     halflife: float | None = None,
                     now: float | None = None) -> dict:
    """Node tracker serializations -> the fleet /cluster/heat body:
    per-dimension top-K with decayed rate estimates, plus the merge
    bookkeeping the error bounds are checked against."""
    if now is None:
        now = time.time()
    k = k if k is not None else HEAT_K
    halflife = halflife if halflife is not None else HALFLIFE_S
    out: dict = {"ts": now, "k": k, "halflife_s": halflife,
                 "nodes": len(snaps)}
    for dim in DIMS:
        merged = SpaceSaving.merge(
            [s.get("dims", {}).get(dim, {}) for s in snaps],
            k, halflife, now)
        name = {"chunk": "chunks", "volume": "volumes",
                "tenant": "tenants"}[dim]
        out[name] = {
            "total_rps": round(merged["total"] * LN2 / halflife, 3),
            "top": [_entry_view(e, halflife, now)
                    for e in merged["entries"]],
        }
    return out


def merged_estimate(snaps: list[dict], dim: str, key: str,
                    now: float | None = None) -> float:
    """Count-Min point estimate for one key over the merged fleet.
    Reads the merged cells directly (estimate() would re-decay against
    the real clock, which is wrong for as-of-`now` snapshots)."""
    cms = CountMin.merge([s.get("cms", {}).get(dim, {}) for s in snaps],
                         HALFLIFE_S, now)
    return float(min(cms.rows[d][i]
                     for d, i in enumerate(_cells(key, cms.width,
                                                  cms.depth))))


async def handle_heat(req):
    """`/heat`: this process's serialized tracker, which the master's
    /cluster/heat fan-out merges.  Open on cluster-internal servers, as
    the `/admin` routes are."""
    from aiohttp import web
    return web.json_response(serialize())


# -- tenant identity -----------------------------------------------------

_tenant: ContextVar[str | None] = ContextVar("weedtpu_tenant",
                                             default=None)


def set_tenant(tenant: str | None):
    """Raw contextvar set -> reset token (the server middleware's
    seam)."""
    return _tenant.set(tenant)


def reset_tenant(token) -> None:
    _tenant.reset(token)


def inject(headers: dict) -> dict:
    """Stamp the ambient tenant on an outgoing header dict, in place, so
    the next hop attributes its work to the tenant the edge resolved."""
    tenant = _tenant.get()
    if tenant:
        headers[TENANT_HEADER] = tenant
    return headers
