"""Historical telemetry plane: an embedded multi-resolution TSDB on the
master, plus the alert-rule engine and capacity forecaster built on it.

Counterpart of `seaweedfs_tpu/stats/history.py`, whole.  Every other observability surface (/cluster/metrics federation,
/cluster/slo burn rates, heat sketches, the canary) is point-in-time:
once a scrape ages out the cluster forgets it, so "when did degraded-read
p99 start climbing?" and "how long until this disk fills?" were
unanswerable.  The 1309.0186 lesson is that fleet EC operations are
driven by TRENDS — repair-backlog growth, capacity fill, hot-spot drift —
not instants; this module is the retention layer that exposes them.

Three pieces, all fixed-memory:

- **HistoryStore** — records every federated series from each
  ClusterAggregator tick into per-series multi-resolution ring buffers
  (raw tick cadence -> 10s -> 1m, ``RESOLUTIONS``).
  Each downsampled slot keeps min/max/last/sum/count so every later
  aggregation is exact for its window.  Counters (histogram buckets
  included) are delta'd PER NODE before the cross-node merge, exactly
  like the SLOEngine: a restarted node's counter reset contributes its
  post-restart value, never a negative or clamped-to-zero delta.  Total
  cardinality is bounded (``MAX_SERIES``): series past
  the bound are dropped and counted on
  ``weedtpu_history_evicted_total`` — the store can never grow without
  bound (a DEAD series, one whose fleet series vanished for
  ``EVICT_IDLE_S``, is evicted in favor of a live newcomer).  Ring
  slots are preallocated ``array('d')`` columns, so the worst-case
  footprint is exactly ``max_series x sum(ring capacities) x 56
  bytes``.

- **AlertEngine** — ``WEEDTPU_ALERT_RULES`` (';'-separated)::

      name=threshold,series=S[,label.k=v],agg=max|min|avg|last|sum|rate,
          window=60,op=gt|lt,value=X[,for=30][,clear_for=30]
      name=rate,series=S[,label.k=v],window=60,op=gt,value=X[,for=...]
      name=absence,series=S[,label.k=v],window=120[,for=...]

  ``threshold`` compares a window aggregate; ``rate`` the per-second
  rate of change over the window (counters: sum of deltas / window;
  gauges: last-first over their span); ``absence`` fires when a series
  match stops reporting for the window (or never existed).  Every rule
  carries for-duration hysteresis: the predicate must hold for ``for``
  seconds before the alert FIRES (a one-tick flap never fires) and must
  stay false for ``clear_for`` (default: ``for``) before a firing alert
  RESOLVES.  When the triggering series carries an OpenMetrics exemplar,
  the engine pins its trace id so the waterfall is ready when the
  operator arrives.

- **CapacityForecaster** — linear fill-rate regression over history for
  every data dir (``weedtpu_disk_bytes{vs,dir,kind}``) and growing
  volume (``weedtpu_volume_size_bytes{vid}``), surfacing
  ``weedtpu_predicted_full_seconds{vs,dir}`` gauges (capped at ~10 years
  when not filling) that the default ``disk_full_soon`` alert rule and
  the repair planner's urgency ordering consume.

The query surface is ``GET /cluster/history?series=&labels=&range=&step=
&agg=`` (server/master.py) returning aligned range vectors; ``agg=pNN``
computes ``histogram_quantile`` over time by re-merging the stored
per-``le`` bucket deltas with stats/aggregate.py's quantile math.  The
self-contained ``/cluster/dashboard`` HTML page (loopback-gated, zero
external assets) renders inline SVG sparklines from the same store.

Knobs: ``WEEDTPU_HISTORY`` (0 or 1, re-read live) and
``WEEDTPU_ALERT_RULES``.  A malformed value or rule raises ValueError,
where the reference falls back or drops the rule; the master reads both
at construction, before its socket binds.  The reference's ring layout,
series bound and forecast window knobs, which nothing sets to a second
value, are the constants ``RESOLUTIONS``, ``MAX_SERIES`` and
``FORECAST_WINDOW_S``.
"""

from __future__ import annotations

import array
import math
import os
import re
import threading
import time

from seaweedfs_tpu_torch.stats import metrics
from seaweedfs_tpu_torch.utils import weedlog
from seaweedfs_tpu_torch.utils.resilience import env_switch

FORECAST_CAP_S = 3.156e8  # ~10 years: the "not filling" sentinel
# [(resolution seconds, ring capacity)] finest first; resolution 0 means
# "one slot per aggregator tick" (raw)
RESOLUTIONS = [(0.0, 240), (10.0, 360), (60.0, 720)]
MAX_SERIES = 1024
FORECAST_WINDOW_S = 600.0  # the fill-rate regression's window


# -- knobs ----------------------------------------------------------------

_enabled_cache: tuple[float, bool] = (0.0, True)


def history_enabled() -> bool:
    """WEEDTPU_HISTORY: "0" off, "1" or unset on; cached ~0.5s so the
    per-tick check costs a tuple compare, yet flipping the env
    retargets a live master."""
    global _enabled_cache
    now = time.monotonic()
    ts, val = _enabled_cache
    if now - ts > 0.5:
        val = env_switch("WEEDTPU_HISTORY")
        _enabled_cache = (now, val)
    return val


# -- fixed-memory rings ---------------------------------------------------

class _Ring:
    """Fixed-capacity rollup ring: parallel preallocated float columns.
    One slot per aligned ``res`` bucket (or per append when res==0); a
    slot folds every point that lands in its bucket into
    min/max/last/sum/count, so downstream window aggregation is exact."""

    __slots__ = ("res", "cap", "n", "head", "ts", "vmin", "vmax", "vlast",
                 "vsum", "vcount", "vfirst")

    def __init__(self, res: float, cap: int):
        self.res, self.cap = float(res), int(cap)
        self.n = 0      # filled slots
        self.head = 0   # next write index
        zero = bytes(8 * self.cap)
        self.ts = array.array("d", zero)
        self.vmin = array.array("d", zero)
        self.vmax = array.array("d", zero)
        self.vlast = array.array("d", zero)
        self.vsum = array.array("d", zero)
        self.vcount = array.array("d", zero)
        self.vfirst = array.array("d", zero)

    def _last_idx(self) -> int:
        return (self.head - 1) % self.cap

    def append(self, ts: float, v: float) -> None:
        bucket = ts if self.res <= 0 else ts - (ts % self.res)
        if self.n:
            li = self._last_idx()
            last_ts = self.ts[li]
            # merge into the open slot: same aligned bucket, or an
            # out-of-order point from a racing scrape (never write a slot
            # whose ts would run backwards — readers assume monotone ts)
            if (self.res > 0 and last_ts == bucket) or bucket < last_ts:
                if v < self.vmin[li]:
                    self.vmin[li] = v
                if v > self.vmax[li]:
                    self.vmax[li] = v
                self.vlast[li] = v
                self.vsum[li] += v
                self.vcount[li] += 1
                return
        i = self.head
        self.ts[i] = bucket
        self.vmin[i] = self.vmax[i] = self.vlast[i] = self.vsum[i] = \
            self.vfirst[i] = v
        self.vcount[i] = 1
        self.head = (self.head + 1) % self.cap
        if self.n < self.cap:
            self.n += 1

    def slots(self, start: float = -math.inf, end: float = math.inf):
        """Yield (ts, min, max, last, sum, count, first) oldest->newest
        with ``start < ts <= end`` (half-open on the left, like a
        Prometheus range step)."""
        base = (self.head - self.n) % self.cap
        for k in range(self.n):
            i = (base + k) % self.cap
            t = self.ts[i]
            if t <= start:
                continue
            if t > end:
                break
            yield (t, self.vmin[i], self.vmax[i], self.vlast[i],
                   self.vsum[i], self.vcount[i], self.vfirst[i])

    def oldest_ts(self) -> float | None:
        if not self.n:
            return None
        return self.ts[(self.head - self.n) % self.cap]

    def latest_ts(self) -> float | None:
        if not self.n:
            return None
        return self.ts[self._last_idx()]


class _Series:
    __slots__ = ("name", "labels", "kind", "rings", "exemplar")

    def __init__(self, name: str, labels: tuple, kind: str,
                 resolutions: list[tuple[float, int]]):
        self.name = name
        self.labels = labels  # sorted (k, v) pairs, node excluded
        self.kind = kind      # "counter" (value = per-tick delta) | "gauge"
        self.rings = [_Ring(res, cap) for res, cap in resolutions]
        self.exemplar: tuple[str, float] | None = None  # (trace_id, ts)

    def append(self, ts: float, v: float) -> None:
        for ring in self.rings:
            ring.append(ts, v)


def _lkey(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _match(lkey: tuple, want: dict) -> bool:
    if not want:
        return True
    d = dict(lkey)
    return all(d.get(k) == v for k, v in want.items())


# -- the store ------------------------------------------------------------

class HistoryStore:
    """Fixed-memory multi-resolution store over federated series.

    ``record(ts, per_node)`` consumes the aggregator's parsed per-node
    expositions ({node: families} as parse_exposition returns them, plus
    the aggregator's synthetic ``__aggregator__`` pseudo-node).  Series
    identity is (sample name, labels) with the node dimension merged
    away: gauges sum across nodes, counters (and histogram _bucket/_sum/
    _count samples) take a per-node delta against that node's previous
    scrape FIRST — a restarted node counts from zero instead of clamping
    the merged delta (the SLOEngine rule) — and the deltas then sum."""

    # a series with no point for this long is dead (its fleet series
    # vanished — live-but-quiet counters still append zero deltas) and
    # may be evicted when a new series needs the slot
    EVICT_IDLE_S = 600.0

    def __init__(self, resolutions: list[tuple[float, int]] | None = None,
                 max_series: int | None = None):
        self.resolutions = list(resolutions if resolutions is not None
                                else RESOLUTIONS)
        self.max_series = max_series if max_series is not None \
            else MAX_SERIES
        self._series: dict[tuple, _Series] = {}
        # node -> (last seen ts, {counter key: value}): the delta
        # baselines survive a transiently-failing scrape (kept up to
        # EVICT_IDLE_S), so a node missing one tick books its growth
        # across the gap instead of being re-baselined at first-sight
        self._prev: dict[str, tuple[float, dict[tuple, float]]] = {}
        self._lock = threading.Lock()
        self.evicted = 0
        self.ticks = 0
        self.last_ts = 0.0

    # hard memory bound, in slots: rings are preallocated per series, so
    # the store can never exceed this no matter what the fleet exposes
    def slot_capacity(self) -> int:
        return self.max_series * sum(cap for _, cap in self.resolutions)

    def series_count(self) -> int:
        with self._lock:
            return len(self._series)

    # -- ingest ---------------------------------------------------------

    def record(self, ts: float, per_node: dict[str, dict]) -> None:
        if not history_enabled():
            # drop the per-node counter baselines: frozen baselines would
            # book the whole disabled window's counter growth as ONE
            # tick's delta on re-enable — a spurious rate spike (and a
            # false rate-rule alert); re-enabling restarts at first-sight
            if self._prev:
                with self._lock:
                    self._prev = {}
            return
        with self._lock:
            acc: dict[tuple, float] = {}
            kinds: dict[tuple, str] = {}
            exemplars: dict[tuple, str] = {}
            new_prev: dict[str, dict[tuple, float]] = {}
            for node, fams in per_node.items():
                prev_entry = self._prev.get(node)
                prev = prev_entry[1] if prev_entry else {}
                cur: dict[tuple, float] = {}
                for fname, fam in fams.items():
                    counterish = fam.get("type") in ("counter", "histogram")
                    exs = fam.get("exemplars") or {}
                    # exemplars live on _bucket samples, but alert rules
                    # usually watch _sum/_count/rate: the family's newest
                    # exemplar backs any sibling series without its own
                    fam_ex = next(reversed(exs.values())) if exs else None
                    for name, labels, value in fam["samples"]:
                        if value != value:  # NaN never enters a ring
                            continue
                        lk = tuple(labels.items()) if len(labels) < 2 \
                            else tuple(sorted(labels.items()))
                        key = (name, lk)
                        if counterish:
                            base = prev.get(key)
                            cur[key] = value
                            if base is None:
                                # first sight of this node's counter: no
                                # window to delta over — contribute 0, not
                                # the process-lifetime total
                                d = 0.0
                            elif value >= base:
                                d = value - base
                            else:
                                d = value  # reset: count from zero
                            if d == 0.0 and key not in acc and \
                                    key not in self._series:
                                # a counter that has never moved never
                                # becomes a series: registries are
                                # dominated by zero histogram buckets,
                                # and recording them would cost slots and
                                # per-tick work for flat lines
                                continue
                            acc[key] = acc.get(key, 0.0) + d
                            kinds[key] = "counter"
                        else:
                            acc[key] = acc.get(key, 0.0) + value
                            kinds[key] = "gauge"
                        if exs or fam_ex:
                            ex = exs.get(key) or fam_ex
                            if ex:
                                exemplars[key] = ex
                new_prev[node] = (ts, cur)
            # nodes missing from THIS tick (a scrape timeout, exactly
            # when incidents happen) keep their baselines for a while;
            # truly departed nodes age out after EVICT_IDLE_S
            for node, entry in self._prev.items():
                if node not in new_prev and ts - entry[0] < \
                        self.EVICT_IDLE_S:
                    new_prev[node] = entry
            self._prev = new_prev
            self.ticks += 1
            self.last_ts = ts
            stale_pool: list[tuple] | None = None  # lazily built, sorted
            for key, v in acc.items():
                s = self._series.get(key)
                if s is None:
                    if len(self._series) >= self.max_series:
                        # at the cap, prefer evicting a DEAD series (no
                        # point for EVICT_IDLE_S — its fleet series is
                        # gone) over refusing the live newcomer: label
                        # churn (deleted volumes, departed nodes) must
                        # not permanently blind the plane to new ones
                        if stale_pool is None:
                            horizon = ts - self.EVICT_IDLE_S
                            stale_pool = sorted(
                                (k for k, sr in self._series.items()
                                 if (sr.rings[0].latest_ts() or 0.0)
                                 < horizon),
                                key=lambda k: self._series[k].rings[
                                    0].latest_ts() or 0.0)
                        if not stale_pool:
                            self.evicted += 1
                            metrics.HISTORY_EVICTED.labels().inc()
                            continue
                        del self._series[stale_pool.pop(0)]
                        self.evicted += 1
                        metrics.HISTORY_EVICTED.labels().inc()
                    s = _Series(key[0], key[1], kinds[key],
                                self.resolutions)
                    self._series[key] = s
                s.append(ts, v)
                ex = exemplars.get(key)
                if ex:
                    s.exemplar = (ex, ts)
            metrics.HISTORY_SERIES.labels().set(len(self._series))

    # -- queries --------------------------------------------------------

    def _matching(self, name: str, want: dict) -> list[_Series]:
        return [s for (n, lk), s in self._series.items()
                if n == name and _match(lk, want)]

    def _pick_ring(self, series: list[_Series], start: float) -> int:
        """Finest resolution whose retention still covers ``start`` for
        every matching series (a ring that isn't full covers everything
        it ever saw); the coarsest ring answers what nothing covers."""
        for i in range(len(self.resolutions)):
            ok = True
            for s in series:
                ring = s.rings[i]
                oldest = ring.oldest_ts()
                if ring.n >= ring.cap and oldest is not None \
                        and oldest > start:
                    ok = False
                    break
            if ok:
                return i
        return len(self.resolutions) - 1

    @staticmethod
    def _agg_bucket(kind: str, agg: str, slots: list[tuple]
                    ) -> float | None:
        if not slots:
            return None
        if agg == "min":
            return min(sl[1] for sl in slots)
        if agg == "max":
            return max(sl[2] for sl in slots)
        if agg == "last":
            return slots[-1][3]
        if agg in ("sum", "increase"):
            return sum(sl[4] for sl in slots)
        if agg == "avg":
            cnt = sum(sl[5] for sl in slots)
            return sum(sl[4] for sl in slots) / cnt if cnt else None
        return None  # rate handled by caller (needs the step span)

    def query(self, name: str, labels: dict | None = None,
              range_s: float = 600.0, step: float | None = None,
              agg: str | None = None, now: float | None = None) -> dict:
        """Aligned range vectors.  ``agg``: min/max/last/sum/avg/rate
        (default: rate for counters, last for gauges) or ``pNN`` —
        histogram-quantile-over-time for a histogram family ``name``
        (the stored per-le bucket deltas re-merge into a windowed
        cumulative histogram per step, then aggregate.histogram_quantile
        reads the estimate — the same bucket-merge math /cluster/slo
        uses)."""
        want = dict(labels or {})
        now = time.time() if now is None else now
        range_s = max(1.0, float(range_s))
        if step is None or step <= 0:
            step = max(1.0, range_s / 60.0)
        step = float(step)
        # ceil-align: the newest (possibly partial) bucket must contain
        # `now`, or the freshest tick would be invisible for up to a step
        end = math.ceil(now / step) * step
        n_steps = max(1, int(range_s / step))
        grid = [end - (n_steps - 1 - i) * step for i in range(n_steps)]
        start = grid[0] - step
        qm = re.fullmatch(r"p(\d{1,2}(?:\.\d+)?)", agg or "")
        with self._lock:
            if qm:
                q = float(qm.group(1)) / 100.0
                vectors = self._quantile_vectors(name, want, grid, step, q,
                                                 start)
                res_i = None
            else:
                series = self._matching(name, want)
                res_i = self._pick_ring(series, start) if series else 0
                vectors = []
                for s in sorted(series, key=lambda s: s.labels):
                    eff = agg or ("rate" if s.kind == "counter" else "last")
                    ring = s.rings[res_i]
                    pts = []
                    for t in grid:
                        slots = list(ring.slots(t - step, t))
                        if eff == "rate":
                            v = (sum(sl[4] for sl in slots) / step
                                 if slots and s.kind == "counter" else
                                 ((slots[-1][3] - slots[0][6]) / step
                                  if slots else None))
                        else:
                            v = self._agg_bucket(s.kind, eff, slots)
                        if v is not None and not math.isfinite(v):
                            v = None  # +Inf staleness markers stay queryable
                        pts.append([t, v])  # but JSON output is strict
                    vectors.append({"labels": dict(s.labels),
                                    "kind": s.kind, "points": pts})
        out = {"series": name, "agg": agg or "auto", "start": grid[0],
               "end": end, "step": step, "vectors": vectors}
        if res_i is not None and self.resolutions:
            out["resolution_s"] = self.resolutions[res_i][0]
        return out

    def _quantile_vectors(self, family: str, want: dict, grid, step: float,
                          q: float, start: float) -> list[dict]:
        from seaweedfs_tpu_torch.stats.aggregate import histogram_quantile
        bname = family if family.endswith("_bucket") else family + "_bucket"
        want = {k: v for k, v in want.items() if k != "le"}
        groups: dict[tuple, list[_Series]] = {}
        for (n, lk), s in self._series.items():
            if n != bname or not _match(lk, want):
                continue
            gkey = tuple((k, v) for k, v in lk if k != "le")
            groups.setdefault(gkey, []).append(s)
        res_i = self._pick_ring([s for ss in groups.values() for s in ss],
                                start) if groups else 0
        vectors = []
        for gkey, ss in sorted(groups.items()):
            pts = []
            for t in grid:
                buckets: dict[float, float] = {}
                for s in ss:
                    le_s = dict(s.labels).get("le", "+Inf")
                    le = math.inf if le_s == "+Inf" else float(le_s)
                    inc = sum(sl[4] for sl in
                              s.rings[res_i].slots(t - step, t))
                    buckets[le] = buckets.get(le, 0.0) + inc
                v = histogram_quantile(buckets, q)
                if v is not None and not math.isfinite(v):
                    v = None
                pts.append([t, v])
            vectors.append({"labels": dict(gkey), "kind": "histogram",
                            "points": pts})
        return vectors

    # -- direct window reads (alert engine / forecaster) -----------------

    def window_groups(self, name: str, want: dict, window: float,
                      now: float | None = None) -> list[dict]:
        """Per matching series: its window slots folded into every basic
        aggregate, plus staleness info — one store pass serves whichever
        predicate a rule asks for."""
        now = time.time() if now is None else now
        start = now - window
        out = []
        with self._lock:
            series = self._matching(name, want)
            res_i = self._pick_ring(series, start) if series else 0
            for s in series:
                ring = s.rings[res_i]
                slots = list(ring.slots(start, now))
                rec: dict = {"labels": dict(s.labels), "kind": s.kind,
                             "last_ts": ring.latest_ts(),
                             "exemplar": s.exemplar[0] if s.exemplar
                             else None}
                if slots:
                    rec.update({
                        "min": min(sl[1] for sl in slots),
                        "max": max(sl[2] for sl in slots),
                        "last": slots[-1][3],
                        "sum": sum(sl[4] for sl in slots),
                        "count": sum(sl[5] for sl in slots),
                        "first": slots[0][6],
                        "span": max(slots[-1][0] - slots[0][0], 0.0),
                    })
                out.append(rec)
        return out

    def series_points(self, name: str, want: dict, window: float,
                      now: float | None = None
                      ) -> list[tuple[dict, list[tuple[float, float]]]]:
        """Raw (ts, last-value) points per matching series over the
        window, from the finest covering ring — regression input."""
        now = time.time() if now is None else now
        start = now - window
        out = []
        with self._lock:
            series = self._matching(name, want)
            res_i = self._pick_ring(series, start) if series else 0
            for s in series:
                pts = [(sl[0], sl[3])
                       for sl in s.rings[res_i].slots(start, now)]
                if pts:
                    out.append((dict(s.labels), pts))
        return out

    def status(self) -> dict:
        with self._lock:
            return {"series": len(self._series),
                    "max_series": self.max_series,
                    "evicted": self.evicted, "ticks": self.ticks,
                    "last_ts": self.last_ts,
                    "resolutions": [{"res_s": r, "slots": c}
                                    for r, c in self.resolutions],
                    "slot_capacity": self.slot_capacity()}


# -- alert rules ----------------------------------------------------------

_DEFAULT_ALERT_RULES = (
    # staleness: a node the aggregator cannot scrape — its age grows, and
    # a NEVER-scraped node reports +Inf (stats/aggregate.py), so max()
    # catches both
    "node_scrape_stale=threshold,series=weedtpu_agg_scrape_age_seconds,"
    "agg=max,window=120,op=gt,value=60,for=30;"
    # absence: the scrape-age series going completely dark means the
    # federation plane itself stopped — the watcher needs a watcher
    "scrape_age_absent=absence,series=weedtpu_agg_scrape_age_seconds,"
    "window=120,for=60;"
    # capacity: any data dir predicted to fill within a day (fed by the
    # forecaster's gauges one tick after it computes them)
    "disk_full_soon=threshold,series=weedtpu_predicted_full_seconds,"
    "agg=min,window=120,op=lt,value=86400,for=60;"
    # interference observatory (stats/interference.py): background work
    # is costing foreground reads more than 50% p99 inflation on some
    # node.  The governor reacts at 0.25, so by the time this fires
    # pacing is already fully engaged; a fire that PERSISTS means
    # backoff alone is not containing the impact and an operator should
    # look (runbook: cluster.interference — is the rate [AT FLOOR]? —
    # then cluster.trace of the latest retune decision)
    "interference_high=threshold,series=weedtpu_interference_index,"
    "agg=max,window=120,op=gt,value=0.5,for=30;"
    # tile-drift sentinel: the pinned tile no longer wins its own
    # micro-sweep by >10%.  The port's sentinel comes with the launch
    # pin (ROADMAP 1.7); until then the rule sees no series.  It watches
    # the EXCESS series (best/pinned - 1) rather than the companion
    # ratio gauge: federated gauges sum across nodes, and a healthy
    # fleet must sum to zero at any size
    "tile_pin_stale=threshold,series=weedtpu_tile_drift,"
    "agg=max,window=120,op=gt,value=0.1,for=30;"
    # control-plane observatory (stats/loops.py): a master loop whose
    # tick wall time exceeds its own interval can no longer hold its
    # cadence — the scrape/repair/alert plane is silently falling
    # behind.  Fires on the worst loop's last-tick ratio staying >1
    # (runbook: cluster.loops — which loop, how far over, and is the
    # cost tracking node count? — then WEEDTPU_FANOUT_POOL or the
    # loop's own interval knob)
    "loop_overrun=threshold,series=weedtpu_loop_overrun_ratio,"
    "agg=max,window=120,op=gt,value=1,for=30;"
    # geo observatory (replication/filer_sync.py): a sync pump that is
    # erroring AND hasn't applied anything for WEEDTPU_SYNC_STALL_AFTER
    # seconds marks itself stalled; the rule thresholds the master's
    # MAX-across-nodes synthesis of that flag.  Lag alone can't fire
    # this — a quiet WAN link has high "lag" but nothing to ship
    # (runbook: cluster.geo — which direction, backlog depth? — then
    # cluster.trace of its last_trace_id)
    "replication_stalled=threshold,series=geo_replication_stalled,"
    "agg=max,window=60,op=gt,value=0,for=10,clear_for=10;"
    # geo lag: events are flowing but the remote region is more than a
    # minute behind — WAN latency injection or a saturated sink.  Uses
    # the __geo__ synthesized series (max across pump directions), so
    # N nodes sharing a registry can't inflate it
    "replication_lag_high=threshold,series=geo_replication_lag_s,"
    "agg=max,window=120,op=gt,value=60,for=30")


def parse_alert_rules(spec: str | None = None) -> list[dict]:
    if spec is None:
        spec = os.environ.get("WEEDTPU_ALERT_RULES") or _DEFAULT_ALERT_RULES
    rules: list[dict] = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        name, _, rest = part.partition("=")
        fields = rest.split(",")
        rule: dict = {"name": name.strip(), "kind": fields[0].strip(),
                      "labels": {}}
        ok = "=" in part and \
            rule["kind"] in ("threshold", "rate", "absence")
        for f in fields[1:]:
            k, _, v = f.partition("=")
            k, v = k.strip(), v.strip()
            if k.startswith("label."):
                rule["labels"][k[6:]] = v
            elif k in ("window", "value", "for", "clear_for"):
                try:
                    rule["for_s" if k == "for" else k] = float(v)
                except ValueError:
                    ok = False
            elif k:
                rule[k] = v
        if not rule.get("series"):
            ok = False
        if rule.get("op", "gt") not in ("gt", "lt"):
            ok = False
        if not ok:
            raise ValueError(f"bad alert rule {part!r} "
                             f"(WEEDTPU_ALERT_RULES)")
        rule.setdefault("window", 60.0)
        rule.setdefault("for_s", 0.0)
        rule.setdefault("clear_for", rule["for_s"])
        rule.setdefault("op", "gt")
        if rule["kind"] == "threshold":
            rule.setdefault("agg", "max")
            rule.setdefault("value", 0.0)
        elif rule["kind"] == "rate":
            rule.setdefault("value", 0.0)
        rules.append(rule)
    return rules


class AlertEngine:
    """Evaluate alert rules against the HistoryStore with for-duration
    hysteresis, tracking state PER (rule, label set): ok -> pending (the
    predicate just turned true) -> firing (held true for ``for``
    seconds) -> back to ok only after ``clear_for`` seconds of false.  A
    flap — true on one evaluation, false on the next — never leaves
    pending, so it never fires and never pages.  Evaluation runs on
    every aggregator tick (the master wires it as a scrape observer)."""

    MAX_GROUPS = 128  # per rule: label sets beyond this are dropped

    def __init__(self, store: HistoryStore,
                 rules: list[dict] | None = None, pin_fn=None):
        self.store = store
        self.rules = rules if rules is not None else parse_alert_rules()
        self.pin_fn = pin_fn  # called with an exemplar trace id on fire
        self._state: dict[str, dict[tuple, dict]] = {}
        self._lock = threading.Lock()
        self.last_eval = 0.0

    # -- predicates ------------------------------------------------------

    def _groups(self, rule: dict, now: float) -> list[tuple[tuple, bool,
                                                            float | None,
                                                            str | None]]:
        """-> [(labels key, predicate true?, observed value, exemplar)]"""
        recs = self.store.window_groups(rule["series"], rule["labels"],
                                        rule["window"], now)
        out = []
        if rule["kind"] == "absence":
            if not recs:
                # nothing matches at all: the series is absent, which is
                # exactly what this rule watches for
                return [((), True, None, None)]
            for rec in recs:
                stale = rec["last_ts"] is None or \
                    rec["last_ts"] < now - rule["window"]
                out.append((_lkey(rec["labels"]), stale, rec["last_ts"],
                            rec.get("exemplar")))
            return out
        for rec in recs:
            if "sum" not in rec:  # no points inside the window
                continue
            if rule["kind"] == "rate":
                if rec["kind"] == "counter":
                    v = rec["sum"] / rule["window"]
                else:
                    span = rec["span"]
                    v = (rec["last"] - rec["first"]) / span if span > 0 \
                        else 0.0
            else:
                agg = rule.get("agg", "max")
                if agg == "rate":
                    v = rec["sum"] / rule["window"]
                elif agg == "avg":
                    v = rec["sum"] / rec["count"] if rec["count"] else None
                else:
                    v = rec.get(agg)
            if v is None:
                continue
            pred = v > rule["value"] if rule["op"] == "gt" \
                else v < rule["value"]
            out.append((_lkey(rec["labels"]), pred, v,
                        rec.get("exemplar")))
        return out

    # -- state machine ---------------------------------------------------

    def evaluate(self, now: float | None = None) -> dict:
        if not history_enabled():
            return self.status()
        now = time.time() if now is None else now
        with self._lock:
            for rule in self.rules:
                states = self._state.setdefault(rule["name"], {})
                seen: set = set()
                try:
                    groups = self._groups(rule, now)
                except Exception as e:  # a bad rule must not kill the tick
                    weedlog.V(1, "history").infof(
                        "alert rule %s failed: %s", rule["name"], e)
                    continue
                for lkey, pred, value, exemplar in groups:
                    seen.add(lkey)
                    st = states.get(lkey)
                    if st is None:
                        if len(states) >= self.MAX_GROUPS:
                            continue
                        st = states[lkey] = {"state": "ok", "since": now}
                    st["value"] = value
                    if pred:
                        st.pop("clear_since", None)
                        if st["state"] == "ok":
                            st["state"] = "pending"
                            st["since"] = now
                        if st["state"] == "pending" and \
                                now - st["since"] >= rule["for_s"]:
                            st["state"] = "firing"
                            st["fired_at"] = now
                            if exemplar:
                                st["exemplar"] = exemplar
                                if self.pin_fn is not None:
                                    try:
                                        self.pin_fn(exemplar)
                                    except Exception:
                                        pass
                            weedlog.warning(
                                "alert %s FIRING %s value=%s",
                                rule["name"], dict(lkey), value,
                                name="history")
                    else:
                        if st["state"] == "pending":
                            # a flap never fires
                            st["state"] = "ok"
                            st["since"] = now
                        elif st["state"] == "firing":
                            cs = st.setdefault("clear_since", now)
                            if now - cs >= rule["clear_for"]:
                                st["state"] = "ok"
                                st["since"] = now
                                st.pop("clear_since", None)
                                st.pop("fired_at", None)
                                weedlog.info(
                                    "alert %s resolved %s",
                                    rule["name"], dict(lkey),
                                    name="history")
                for lkey in [k for k in states if k not in seen]:
                    # series gone entirely: a firing threshold/rate group
                    # follows the clear path (its evidence left with it);
                    # absence groups are produced above even when stale
                    st = states[lkey]
                    if st["state"] == "firing":
                        cs = st.setdefault("clear_since", now)
                        if now - cs >= rule["clear_for"]:
                            states.pop(lkey)
                    else:
                        states.pop(lkey)
                n_firing = sum(1 for st in states.values()
                               if st["state"] == "firing")
                metrics.ALERTS_FIRING.labels(rule["name"]).set(n_firing)
            self.last_eval = now
        return self.status()

    def status(self) -> dict:
        order = {"firing": 2, "pending": 1, "ok": 0}
        with self._lock:
            rules_out = []
            worst = "ok"
            for rule in self.rules:
                states = self._state.get(rule["name"], {})
                groups = []
                rstate = "ok"
                for lkey, st in sorted(states.items()):
                    g = {"labels": dict(lkey), "state": st["state"],
                         "since": round(st.get("since", 0.0), 3)}
                    v = st.get("value")
                    if v is not None and math.isfinite(v):
                        g["value"] = round(v, 6)
                    elif v is not None:
                        g["stale"] = True  # +Inf scrape age etc.
                    if "fired_at" in st:
                        g["fired_at"] = round(st["fired_at"], 3)
                    if "exemplar" in st:
                        g["exemplar"] = st["exemplar"]
                    groups.append(g)
                    if order[st["state"]] > order[rstate]:
                        rstate = st["state"]
                if order[rstate] > order[worst]:
                    worst = rstate
                rules_out.append({
                    "name": rule["name"], "kind": rule["kind"],
                    "series": rule["series"], "window_s": rule["window"],
                    "for_s": rule["for_s"], "state": rstate,
                    "groups": groups})
            return {"state": worst, "rules": rules_out,
                    "last_eval": self.last_eval}


# -- capacity forecasting -------------------------------------------------

def _linreg_slope(pts: list[tuple[float, float]]) -> float:
    """Least-squares slope (units/second) of (ts, value) points."""
    n = len(pts)
    if n < 2:
        return 0.0
    t0 = pts[0][0]
    sx = sy = sxx = sxy = 0.0
    for t, v in pts:
        x = t - t0
        sx += x
        sy += v
        sxx += x * x
        sxy += x * v
    denom = n * sxx - sx * sx
    if denom <= 0:
        return 0.0
    return (n * sxy - sx * sy) / denom


class CapacityForecaster:
    """Fill-rate linear regression over history for every data dir and
    volume, surfaced as ``predicted_full_seconds`` gauges.  Disk math is
    ratio-invariant to the in-process test quirk where N federated
    "nodes" share one registry (used, free, and slope all scale by the
    same factor).  Volumes predicted to fill before the cap also get a
    gauge; the rest stay JSON-only so the gauge cardinality tracks the
    problem, not the fleet size."""

    CAP = FORECAST_CAP_S

    def __init__(self, store: HistoryStore, window: float | None = None,
                 min_points: int = 2):
        if window is None:
            window = FORECAST_WINDOW_S
        self.store = store
        self.window = window
        self.min_points = min_points
        self._lock = threading.Lock()
        self.disks: dict[tuple[str, str], dict] = {}
        self.volumes: dict[str, dict] = {}

    def update(self, now: float | None = None,
               volume_size_limit: int | None = None) -> None:
        if not history_enabled():
            return
        now = time.time() if now is None else now
        used = self.store.series_points("weedtpu_disk_bytes",
                                        {"kind": "used"}, self.window, now)
        totals = {(lab.get("vs", ""), lab.get("dir", "")): pts[-1][1]
                  for lab, pts in self.store.series_points(
                      "weedtpu_disk_bytes", {"kind": "total"},
                      self.window, now)}
        disks: dict[tuple[str, str], dict] = {}
        for lab, pts in used:
            key = (lab.get("vs", ""), lab.get("dir", ""))
            if len(pts) < self.min_points:
                continue
            slope = _linreg_slope(pts)
            u_last = pts[-1][1]
            total = totals.get(key)
            free = max(total - u_last, 0.0) if total else 0.0
            secs = self.CAP
            if slope > 1e-9 and total:
                secs = min(free / slope, self.CAP)
            metrics.PREDICTED_FULL.labels(*key).set(round(secs, 3))
            disks[key] = {"used": u_last, "total": total,
                          "fill_bps": round(slope, 3),
                          "predicted_full_seconds": round(secs, 3)}
        vols: dict[str, dict] = {}
        if volume_size_limit:
            for lab, pts in self.store.series_points(
                    "weedtpu_volume_size_bytes", {}, self.window, now):
                vid = lab.get("vid", "")
                if not vid or len(pts) < self.min_points:
                    continue
                slope = _linreg_slope(pts)
                left = max(volume_size_limit - pts[-1][1], 0.0)
                secs = min(left / slope, self.CAP) if slope > 1e-9 \
                    else self.CAP
                prev = vols.get(vid)
                # one series per replica (the vs label): the soonest-
                # full replica is the volume's forecast
                if prev is None or secs < prev["predicted_full_seconds"]:
                    vols[vid] = {"size": pts[-1][1],
                                 "fill_bps": round(slope, 3),
                                 "predicted_full_seconds": round(secs, 3)}
        with self._lock:
            # RETIRE gauges for keys that vanished (node evicted, disk
            # history aged out) — pinning them at the cap forever was a
            # per-node series leak under churn: 500 joining/leaving
            # nodes each left a (vs, dir) child behind.  A key that
            # merely stopped filling is still in `disks` with a CAP
            # forecast, so its gauge stays and reads un-alarming.
            for key in self.disks:
                if key not in disks:
                    metrics.PREDICTED_FULL.remove_matching(
                        vs=key[0], dir=key[1])
            for vid in self.volumes:
                if vid not in vols or \
                        vols[vid]["predicted_full_seconds"] >= self.CAP:
                    metrics.VOLUME_PREDICTED_FULL.remove_matching(vid=vid)
            for vid, rec in vols.items():
                if rec["predicted_full_seconds"] < self.CAP:
                    metrics.VOLUME_PREDICTED_FULL.labels(vid).set(
                        rec["predicted_full_seconds"])
            self.disks = disks
            self.volumes = vols

    def filling_nodes(self, horizon_s: float) -> set[str]:
        """Volume-server urls with any data dir predicted to fill within
        ``horizon_s`` — the repair planner's forward-looking urgency
        input."""
        with self._lock:
            return {vs for (vs, _d), rec in self.disks.items()
                    if rec["predicted_full_seconds"] < horizon_s}

    def snapshot(self) -> dict:
        with self._lock:
            disks = sorted(
                ({"vs": vs, "dir": d, **rec}
                 for (vs, d), rec in self.disks.items()),
                key=lambda r: r["predicted_full_seconds"])
            vols = sorted(
                ({"vid": vid, **rec} for vid, rec in self.volumes.items()),
                key=lambda r: r["predicted_full_seconds"])
        return {"window_s": self.window, "disks": disks,
                "volumes": vols[:20]}


# -- dashboard ------------------------------------------------------------

def _svg_sparkline(points: list, w: int = 260, h: int = 44) -> str:
    """Inline SVG polyline over [ts, value|None] points — no external
    assets, no scripts.  Gaps (None) break the line."""
    vals = [v for _, v in points if v is not None]
    if not vals:
        return (f'<svg width="{w}" height="{h}" class="spark">'
                f'<text x="4" y="{h - 6}" class="mut">no data</text></svg>')
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    n = max(len(points) - 1, 1)
    segs: list[list[str]] = [[]]
    for i, (_, v) in enumerate(points):
        if v is None:
            if segs[-1]:
                segs.append([])
            continue
        x = 4 + (w - 8) * i / n
        y = 4 + (h - 8) * (1.0 - (v - lo) / span)
        segs[-1].append(f"{x:.1f},{y:.1f}")
    polys = "".join(
        f'<polyline points="{" ".join(seg)}" fill="none" '
        f'stroke="currentColor" stroke-width="1.5"/>'
        for seg in segs if len(seg) > 1)
    dots = "".join(
        f'<circle cx="{seg[0].split(",")[0]}" cy="{seg[0].split(",")[1]}"'
        f' r="1.5" fill="currentColor"/>'
        for seg in segs if len(seg) == 1)
    return (f'<svg width="{w}" height="{h}" class="spark" '
            f'viewBox="0 0 {w} {h}">{polys}{dots}</svg>')


def _h(v) -> str:
    """HTML-escape anything interpolated into the dashboard: label
    values, node urls, and dir names come from federated /metrics bodies
    a compromised node controls, and the page renders on the loopback
    origin that passes every debug gate."""
    import html
    return html.escape(str(v), quote=True)


def _fmt_val(v: float | None) -> str:
    if v is None:
        return "-"
    a = abs(v)
    for unit, div in (("G", 1e9), ("M", 1e6), ("k", 1e3)):
        if a >= div:
            return f"{v / div:.2f}{unit}"
    return f"{v:.3g}"


def _fmt_secs(s: float | None) -> str:
    if s is None:
        return "-"
    if s >= FORECAST_CAP_S:
        return "&gt;10y"
    for unit, div in (("d", 86400.0), ("h", 3600.0), ("m", 60.0)):
        if s >= div:
            return f"{s / div:.1f}{unit}"
    return f"{s:.1f}s"


def _spark_row(store: HistoryStore, title: str, name: str,
               labels: dict | None, agg: str | None,
               range_s: float, step: float, scale: float = 1.0,
               combine: str | None = None) -> str:
    """One dashboard row: label, sparkline, last value.  ``combine``
    groups vectors by that label and sums them (net-flow classes)."""
    res = store.query(name, labels, range_s, step, agg)
    vectors = res["vectors"]
    if combine:
        by: dict[str, list] = {}
        for vec in vectors:
            key = vec["labels"].get(combine, "?")
            pts = by.setdefault(key, [[t, None] for t, _ in vec["points"]])
            for i, (_, v) in enumerate(vec["points"]):
                if v is not None:
                    pts[i][1] = (pts[i][1] or 0.0) + v
        vectors = [{"labels": {combine: k}, "points": pts}
                   for k, pts in sorted(by.items())]
    rows = []
    for vec in vectors[:12]:
        pts = [[t, None if v is None else v * scale]
               for t, v in vec["points"]]
        lbl = ",".join(f"{k}={v}" for k, v in sorted(
            vec["labels"].items()) if k != "le") or title
        last = next((v for _, v in reversed(pts) if v is not None), None)
        rows.append(f"<tr><td>{_h(lbl)}</td>"
                    f"<td>{_svg_sparkline(pts)}</td>"
                    f"<td class='num'>{_fmt_val(last)}</td></tr>")
    if not rows:
        rows.append(f"<tr><td>{_h(title)}</td>"
                    f"<td colspan='2' class='mut'>no data yet</td></tr>")
    return "".join(rows)


def render_dashboard(master) -> str:
    """Self-contained /cluster/dashboard HTML: SLO + alerts headline,
    canary latency, net-flow classes, repair backlog, and capacity
    forecasts — every sparkline served out of the history store, zero
    external assets (loopback-gated by the caller)."""
    store: HistoryStore = master.history
    rng, step = 1800.0, 60.0
    try:
        slo = master.aggregator.slo_status()
    except Exception:
        slo = {"state": "unknown", "rules": []}
    alerts = master.alerts.status()
    cap = master.forecaster.snapshot()
    badge = {"ok": "ok", "warn": "warn", "violated": "bad",
             "firing": "bad", "pending": "warn"}

    def sect(title: str, body: str) -> str:
        return f"<section><h2>{title}</h2>{body}</section>"

    slo_rows = "".join(
        f"<tr><td>{_h(r['name'])}</td>"
        f"<td class='badge {badge.get(r['state'], '')}'>"
        f"{_h(r['state'])}</td>"
        f"</tr>" for r in slo.get("rules", []))
    alert_rows = "".join(
        f"<tr><td>{_h(r['name'])}</td>"
        f"<td class='badge {badge.get(r['state'], '')}'>"
        f"{_h(r['state'])}</td>"
        f"<td class='mut'>{len([g for g in r['groups'] if g['state'] == 'firing'])} firing</td></tr>"
        for r in alerts.get("rules", []))
    disk_rows = "".join(
        f"<tr><td>{_h(d['vs'])}</td><td>{_h(d['dir'])}</td>"
        f"<td class='num'>{_fmt_val(d['used'])}/{_fmt_val(d['total'])}</td>"
        f"<td class='num'>{_fmt_val(d['fill_bps'])}/s</td>"
        f"<td class='num'>{_fmt_secs(d['predicted_full_seconds'])}</td>"
        f"</tr>" for d in cap.get("disks", [])) or \
        "<tr><td colspan='5' class='mut'>no disk history yet</td></tr>"
    hist = store.status()
    html = f"""<!doctype html><html><head><meta charset="utf-8">
<title>weedtpu cluster dashboard</title><style>
body{{font:13px/1.45 system-ui,sans-serif;margin:1.2em;color:#1a2b3c;
background:#fafbfc}}h1{{font-size:1.25em}}h2{{font-size:1em;
border-bottom:1px solid #d8dee4;padding-bottom:2px}}section{{margin:1em 0}}
table{{border-collapse:collapse}}td{{padding:2px 10px 2px 0;
vertical-align:middle}}.num{{text-align:right;font-variant-numeric:
tabular-nums}}.mut{{color:#7a8a99}}.spark{{color:#2563eb}}
.badge{{font-weight:600}}.badge.ok{{color:#15803d}}
.badge.warn{{color:#b45309}}.badge.bad{{color:#b91c1c}}
</style></head><body>
<h1>weedtpu cluster dashboard <span class="mut">master {_h(master.url)}</span></h1>
<p class="mut">history: {hist['series']}/{hist['max_series']} series,
{hist['ticks']} ticks, {hist['evicted']} evicted ·
slo: <span class="badge {badge.get(slo.get('state', ''), '')}">{_h(slo.get('state'))}</span> ·
alerts: <span class="badge {badge.get(alerts.get('state', ''), '')}">{_h(alerts.get('state'))}</span></p>
{sect("SLO rules", f"<table>{slo_rows}</table>")}
{sect("Alert rules", f"<table>{alert_rows}</table>")}
{sect("Canary p99 latency (ms)", "<table>" + _spark_row(
    store, "canary", "weedtpu_canary_latency_seconds",
    {"quantile": "0.99"}, "last", rng, step, scale=1000.0) + "</table>")}
{sect("Net flow by class (B/s sent)", "<table>" + _spark_row(
    store, "netflow", "weedtpu_net_bytes_total", {"direction": "sent"},
    "rate", rng, step, combine="class") + "</table>")}
{sect("Pipeline occupancy (busy-s/s by stage; 1.0 = saturated)",
      "<table>" + _spark_row(
          store, "pipeline", "weedtpu_pipeline_stage_seconds_total",
          None, "rate", rng, step, combine="stage") + "</table>")}
{sect("Roofline fraction (achieved / measured ceiling by resource)",
      "<table>" + _spark_row(
          store, "roofline", "weedtpu_roofline_frac", None, "last",
          rng, step) + "</table>"
      "<table>" + _spark_row(
          store, "tile drift", "weedtpu_tile_drift", None, "last",
          rng, step) + "</table>")}
{sect("Interference (foreground p99 inflation by class / governed rates)",
      "<table>" + _spark_row(
          store, "interference", "weedtpu_interference_index", None,
          "max", rng, step) + "</table>"
      "<table>" + _spark_row(
          store, "governor", "weedtpu_governor_rate", None, "last",
          rng, step) + "</table>")}
{sect("Repair backlog (unhealthy volumes)", "<table>" + _spark_row(
    store, "backlog", "weedtpu_volume_health", None, "max", rng, step)
    + "</table>")}
{sect("Geo replication (lag s / backlog events / WAN B/s / divergence)",
      "<table>" + _spark_row(
          store, "lag", "geo_replication_lag_s", None, "max",
          rng, step) + "</table>"
      "<table>" + _spark_row(
          store, "backlog", "weedtpu_replication_backlog_events", None,
          "max", rng, step) + "</table>"
      "<table>" + _spark_row(
          store, "wan", "weedtpu_wan_bytes_total", {"direction": "sent"},
          "rate", rng, step, combine="region") + "</table>"
      "<table>" + _spark_row(
          store, "divergence", "weedtpu_geo_divergence", None, "max",
          rng, step) + "</table>")}
{sect("Capacity forecasts",
      "<table><tr class='mut'><td>node</td><td>dir</td><td>used/total</td>"
      f"<td>fill rate</td><td>full in</td></tr>{disk_rows}</table>"
      "<table>" + _spark_row(store, "disk used",
                             "weedtpu_disk_bytes", {"kind": "used"},
                             "last", rng, step) + "</table>")}
<p class="mut">range {int(rng)}s · step {int(step)}s · rendered from
/cluster/history (same data: <code>cluster.history</code> in the shell)</p>
</body></html>"""
    return html
