"""Live interference observatory + the governor that obeys it.

Counterpart of `seaweedfs_tpu/stats/interference.py`, whole: the
observatory and the governor with all its targets.  Background
work's foreground cost is nonlinear and device-local (the SSD-array
study, arXiv 1709.05365) and concentrates on the hot nodes (the
warehouse study, arXiv 1309.0186), so the throttle is a live, per-node
measurement, not a constant somebody tuned once.

- **InterferenceObservatory** — an aggregator scrape observer (the same
  seam the history store rides).  Per node and per tick it deltas the
  foreground latency histogram (``weedtpu_volume_request_seconds
  {type=read}``) and the background byte counters
  (``weedtpu_net_bytes_total`` for classes repair / convert / rebalance
  / scrub / replication / readahead).  Ticks where every background
  class is quiet (under ``QUIET_BPS``) update a quiet p99 baseline
  (EWMA); ticks with background flow compare their p99 against it and
  attribute the fractional inflation to the active classes by byte
  share.  The per-class EWMA is the **foreground-impact index**,
  ``weedtpu_interference_index{node,class}`` (0 = none, 1.0 = p99
  doubled).  It decays on quiet ticks, so recovery shows within a few
  ticks of the load stopping.

- **Governor** — closes the loop each aggregator tick.  Its targets are
  the repair planner's cross-rack byte budget (``repair_xrack``, class
  ``repair``), the conversion scheduler's pacing bucket (``convert``),
  the autopilot's plan buckets (``autopilot_tier``, class ``convert``;
  ``autopilot_balance``, ``rebalance``; ``autopilot_chunk``,
  ``readahead``) and the fleet scrub rate (``scrub``, MB/s), which is
  pushed to every volume server's ``/admin/scrub_rate`` as a fraction of
  its ceiling (``WEEDTPU_SCRUB_MBPS``).  Each ceiling is the configured
  static rate.  Per target the governor reads the fleet index of its
  class (max over nodes: the worst node binds) and retunes between
  ``FLOOR_FRAC`` x ceiling and the ceiling: over ``TARGET`` the rate
  scales by target/index; at or under it the rate ramps back by
  ``STEP``.  Every retune is a traced, pinned event: a
  ``governor.retune`` span under its own root, a decision record in
  ``/cluster/interference``, and the ``weedtpu_governor_rate{target}``
  and ``weedtpu_governor_retunes_total{target,direction}`` series.
  ``WEEDTPU_GOVERNOR=0`` restores every ceiling once.

Knobs: ``WEEDTPU_INTERFERENCE`` and ``WEEDTPU_GOVERNOR`` (0 or 1,
re-read live), ``WEEDTPU_INTERF_MIN_SAMPLES`` and
``WEEDTPU_INTERF_ALPHA``.  A malformed value raises ValueError where the
reference falls back; the master reads them at construction, before its
socket binds.  The reference's quiet threshold and control-law knobs,
which nothing sets to a second value, are the constants ``QUIET_BPS``,
``TARGET``, ``FLOOR_FRAC`` and ``STEP``.
"""

from __future__ import annotations

import json
import math
import threading
import time

from seaweedfs_tpu_torch.stats import metrics, trace
from seaweedfs_tpu_torch.utils import weedlog
from seaweedfs_tpu_torch.utils.resilience import _env_float, env_switch

# background traffic classes the observatory attributes impact to (the
# netflow ledger's classes minus data/internal, which ARE the foreground)
BG_CLASSES = ("repair", "convert", "rebalance", "scrub", "replication",
              "readahead")

# foreground signal: the volume servers' serving-path read latency
FG_FAMILY = "weedtpu_volume_request_seconds"
FG_LABELS = {"type": "read"}

NET_FAMILY = "weedtpu_net_bytes_total"

QUIET_BPS = 64 * 1024  # background bytes/s below which a class is quiet
TARGET = 0.25      # the index the governor holds each class under
FLOOR_FRAC = 0.1   # the governed rate's floor, a fraction of its ceiling
STEP = 1.25        # recovery factor per tick at or under the target


_enabled_cache: tuple[float, bool] = (0.0, True)


def interference_enabled() -> bool:
    """WEEDTPU_INTERFERENCE (default on), cached ~0.5s so the per-tick
    check is a tuple compare yet flipping the env retargets a live
    master."""
    global _enabled_cache
    now = time.monotonic()
    ts, val = _enabled_cache
    if now - ts > 0.5:
        val = env_switch("WEEDTPU_INTERFERENCE")
        _enabled_cache = (now, val)
    return val


def governor_enabled() -> bool:
    """WEEDTPU_GOVERNOR (default on): live pacing of background work off
    the interference index.  =0 restores the static ceiling."""
    return env_switch("WEEDTPU_GOVERNOR") and interference_enabled()


class _NodeState:
    """Per-node EWMA state: the quiet-window p99 baseline and the
    per-class impact index, plus the previous tick's counter values for
    delta'ing (reset -> count from zero, the SLOEngine rule)."""

    __slots__ = ("prev_ts", "prev_buckets", "prev_count", "prev_bytes",
                 "quiet_p99", "last_p99", "index", "bg_bps", "ticks",
                 "quiet_ticks", "busy_ticks", "last_seen")

    def __init__(self):
        self.prev_ts = 0.0
        self.prev_buckets: dict[float, float] = {}
        self.prev_count = 0.0
        self.prev_bytes: dict[str, float] = {}
        self.quiet_p99: float | None = None
        self.last_p99: float | None = None
        self.index: dict[str, float] = {}
        self.bg_bps: dict[str, float] = {}
        self.ticks = 0
        self.quiet_ticks = 0
        self.busy_ticks = 0
        self.last_seen = 0.0


class InterferenceObservatory:
    """Per-node foreground-impact index over the aggregator's raw-tick
    windows.  ``observe(ts, per_node)`` consumes the same parsed
    per-node expositions the history store records; ``snapshot()``
    serves /cluster/interference."""

    EVICT_IDLE_S = 600.0  # nodes silent this long drop their series

    def __init__(self, quiet_bps: float | None = None,
                 min_samples: int | None = None,
                 alpha: float | None = None):
        self.quiet_bps = quiet_bps if quiet_bps is not None else QUIET_BPS
        self.min_samples = int(min_samples if min_samples is not None
                               else _env_float("WEEDTPU_INTERF_MIN_SAMPLES",
                                               8))
        self.alpha = alpha if alpha is not None else \
            _env_float("WEEDTPU_INTERF_ALPHA", 0.3)
        self._nodes: dict[str, _NodeState] = {}
        self._lock = threading.Lock()
        self.ticks = 0

    # -- per-tick ingest -------------------------------------------------

    @staticmethod
    def _fg_hist(fams: dict) -> tuple[dict[float, float], float] | None:
        """The node's foreground latency histogram as cumulative
        {le: count} + total count, or None when it serves no volumes."""
        fam = fams.get(FG_FAMILY)
        if fam is None:
            return None
        buckets: dict[float, float] = {}
        count = 0.0
        for name, labels, value in fam["samples"]:
            if any(labels.get(k) != v for k, v in FG_LABELS.items()):
                continue
            if name.endswith("_bucket"):
                le_s = labels.get("le", "+Inf")
                le = math.inf if le_s == "+Inf" else float(le_s)
                buckets[le] = buckets.get(le, 0.0) + value
            elif name.endswith("_count"):
                count += value
        if not buckets:
            return None
        return buckets, count

    @staticmethod
    def _bg_bytes(fams: dict) -> dict[str, float]:
        """Background byte totals per class (sent+recv summed: a node
        doing repair work both pulls survivors and ships partials)."""
        fam = fams.get(NET_FAMILY)
        out = {c: 0.0 for c in BG_CLASSES}
        if fam is None:
            return out
        for _name, labels, value in fam["samples"]:
            cls = labels.get("class")
            if cls in out:
                out[cls] += value
        return out

    def observe(self, ts: float, per_node: dict[str, dict]) -> None:
        """One aggregator tick.  Runs on the aggregator thread (observer
        seam); must never raise into the scrape loop."""
        if not interference_enabled():
            # retire the index series instead of freezing them at their
            # last values: a frozen >threshold gauge would keep the
            # interference_high alert firing forever while nothing is
            # being measured (re-enabling restarts from first-sight)
            if self._nodes:
                self.close()
            return
        with self._lock:
            self.ticks += 1
            seen: set[str] = set()
            for node, fams in per_node.items():
                if node == "__aggregator__":
                    continue
                fg = self._fg_hist(fams)
                if fg is None:
                    continue  # not a serving node (filer/gateway/master)
                seen.add(node)
                st = self._nodes.get(node)
                if st is None:
                    st = self._nodes[node] = _NodeState()
                self._tick_node(st, ts, fg, self._bg_bytes(fams))
                st.last_seen = ts
                for cls, idx in st.index.items():
                    metrics.INTERFERENCE_INDEX.labels(node, cls).set(
                        round(idx, 6))
            horizon = ts - self.EVICT_IDLE_S
            for node in [n for n in self._nodes if n not in seen]:
                st = self._nodes[node]
                if st.last_seen < horizon:
                    # gone long enough: lose the state AND the gauge
                    # series (label churn must not pin stale values)
                    del self._nodes[node]
                    metrics.INTERFERENCE_INDEX.remove_matching(node=node)
                    continue
                # a node missing from this tick (crashed, partitioned,
                # decommissioned) stops generating interference the
                # moment it stops serving: decay its index like a quiet
                # tick, or its frozen last value would keep steering
                # fleet_index()'s max — and the governed floors — for
                # the whole eviction window
                for cls in list(st.index):
                    st.index[cls] *= (1 - self.alpha)
                    metrics.INTERFERENCE_INDEX.labels(node, cls).set(
                        round(st.index[cls], 6))

    def _tick_node(self, st: _NodeState, ts: float,
                   fg: tuple[dict[float, float], float],
                   bg_totals: dict[str, float]) -> None:
        from seaweedfs_tpu_torch.stats.aggregate import histogram_quantile
        buckets, count = fg
        span = ts - st.prev_ts if st.prev_ts else 0.0
        first = not st.prev_buckets and st.prev_count == 0.0
        # per-tick deltas; a restarted node (counter went down) counts
        # from zero instead of clamping the whole tick to nothing
        if count >= st.prev_count:
            d_buckets = {le: max(0.0, c - st.prev_buckets.get(le, 0.0))
                         for le, c in buckets.items()}
            d_count = count - st.prev_count
        else:
            d_buckets, d_count = dict(buckets), count
        bps: dict[str, float] = {}
        for cls in BG_CLASSES:
            cur = bg_totals.get(cls, 0.0)
            prev = st.prev_bytes.get(cls, 0.0)
            d = cur - prev if cur >= prev else cur
            bps[cls] = d / span if span > 0 else 0.0
        st.prev_ts = ts
        st.prev_buckets = buckets
        st.prev_count = count
        st.prev_bytes = bg_totals
        if first:
            return  # no window to delta over yet
        st.ticks += 1
        st.bg_bps = {c: round(v, 1) for c, v in bps.items()}
        active = {c: v for c, v in bps.items() if v > self.quiet_bps}
        tick_p99 = histogram_quantile(d_buckets, 0.99) \
            if d_count >= self.min_samples else None
        if tick_p99 is not None:
            st.last_p99 = tick_p99
        a = self.alpha
        if not active:
            st.quiet_ticks += 1
            if tick_p99 is not None:
                st.quiet_p99 = tick_p99 if st.quiet_p99 is None else \
                    (1 - a) * st.quiet_p99 + a * tick_p99
            # no background flow this window: whatever impact the index
            # carried is aging out — decay toward zero so recovery is
            # visible within a few ticks of the load stopping
            for cls in list(st.index):
                st.index[cls] *= (1 - a)
            return
        st.busy_ticks += 1
        if tick_p99 is None or st.quiet_p99 is None or st.quiet_p99 <= 0:
            return  # not enough foreground traffic, or no baseline yet
        inflation = max(0.0, tick_p99 / st.quiet_p99 - 1.0)
        total = sum(active.values())
        for cls in BG_CLASSES:
            share = active.get(cls, 0.0) / total
            contrib = inflation * share
            prev = st.index.get(cls, 0.0)
            st.index[cls] = (1 - a) * prev + a * contrib

    # -- views -----------------------------------------------------------

    def close(self) -> None:
        """Retire this observatory's per-node gauge series (master
        stop()): a long-lived process cycling clusters — the test
        suite, an embedded all-in-one — must not accumulate dead
        node label sets forever."""
        with self._lock:
            for node in self._nodes:
                metrics.INTERFERENCE_INDEX.remove_matching(node=node)
            self._nodes.clear()

    def fleet_index(self) -> dict[str, dict]:
        """Per class: the fleet index (max over nodes — interference is
        device-local, so the worst node binds) and which node it is."""
        with self._lock:
            out: dict[str, dict] = {}
            for node, st in self._nodes.items():
                for cls, idx in st.index.items():
                    cur = out.get(cls)
                    if cur is None or idx > cur["index"]:
                        out[cls] = {"index": round(idx, 4), "node": node}
            return out

    def snapshot(self) -> dict:
        with self._lock:
            nodes = {
                node: {
                    "quiet_p99_ms": None if st.quiet_p99 is None
                    else round(st.quiet_p99 * 1000.0, 3),
                    "last_p99_ms": None if st.last_p99 is None
                    else round(st.last_p99 * 1000.0, 3),
                    "index": {c: round(v, 4)
                              for c, v in sorted(st.index.items())},
                    "bg_bps": dict(st.bg_bps),
                    "ticks": st.ticks,
                    "quiet_ticks": st.quiet_ticks,
                    "busy_ticks": st.busy_ticks,
                } for node, st in sorted(self._nodes.items())}
        return {"enabled": interference_enabled(),
                "quiet_bps": self.quiet_bps,
                "min_samples": self.min_samples,
                "alpha": self.alpha,
                "ticks": self.ticks,
                "classes": self.fleet_index(),
                "nodes": nodes}


# -- the governor ---------------------------------------------------------

class Governor:
    """Retune the background-work rate limiters each aggregator tick,
    proportionally to the live interference index, between a floor and
    the configured (static-knob) ceiling.

    Targets:

    - ``repair_xrack`` — the repair planner's cross-rack byte budget
      (bytes/s), class ``repair``;
    - ``convert`` — the conversion scheduler's pacing bucket
      (volumes/s), class ``convert``;
    - ``scrub`` — the fleet scrub rate (MB/s), class ``scrub``, pushed
      to every volume server's ``/admin/scrub_rate`` when it changes
      (skipped entirely when WEEDTPU_SCRUB_MBPS <= 0: scrub is off);
    - ``autopilot_tier`` / ``autopilot_balance`` / ``autopilot_chunk`` —
      the autopilot's per-policy plan buckets
      (maintenance/autopilot.py), classes ``convert``, ``rebalance``
      and ``readahead``: placement decisions back off with the same
      law as the work they schedule.

    Control law, per target with index ``i`` and target ``t``
    (``TARGET``): ``i > t`` -> rate x t/i (proportional backoff,
    floored at ``FLOOR_FRAC`` x ceiling); ``i <= t`` -> rate x
    ``STEP``, capped at the ceiling.  Retunes smaller than 5% are
    skipped (a deadband, so a hovering index does not generate a
    decision per tick)."""

    DEADBAND = 0.05
    INTERFERENCE_ALERT = "interference_high"  # the pause rule we replace
    PIN_INTERVAL_S = 60.0  # pinned-retune-trace rate limit per target
    # while the fleet scrub rate sits away from its ceiling, re-push it
    # this often even without a new decision: a volume server that
    # restarts mid-engagement re-inits its scrubber at the env ceiling
    # and must converge back onto the governed rate
    REPUSH_S = 30.0

    def __init__(self, master, observatory: InterferenceObservatory):
        self.master = master
        self.obs = observatory
        self.target = TARGET
        self.floor_frac = FLOOR_FRAC
        self.step = STEP
        # ceilings are the CONFIGURED static rates, captured once: the
        # governor moves rates below them, never above
        self.ceilings = {
            "repair_xrack": master.maintenance.xrack_bucket.rate,
            "convert": master.convert.bucket.rate,
            "scrub": _env_float("WEEDTPU_SCRUB_MBPS", 8.0),
        }
        self.classes = {"repair_xrack": "repair", "convert": "convert",
                        "scrub": "scrub"}
        # the autopilot's per-policy pacing buckets are governed like
        # any other background work: tiering plans feed the convert
        # plane, balance moves are their own rebalance class
        ap = getattr(master, "autopilot", None)
        if ap is not None:
            self.ceilings["autopilot_tier"] = ap.buckets["tiering"].rate
            self.ceilings["autopilot_balance"] = \
                ap.buckets["balance"].rate
            self.classes["autopilot_tier"] = "convert"
            self.classes["autopilot_balance"] = "rebalance"
            # chunk promotion's seed pull-throughs book as readahead
            if "chunk" in ap.buckets:
                self.ceilings["autopilot_chunk"] = ap.buckets["chunk"].rate
                self.classes["autopilot_chunk"] = "readahead"
        self._scrub_rate = self.ceilings["scrub"]
        self._last_push = 0.0
        # a fresh master does not know what rate the fleet's scrubbers
        # run at (a predecessor may have governed them down): converge
        # them onto this governor's view with one push on the first
        # enabled tick that sees nodes
        self._converged = False
        # pin at most one retune trace per target per PIN_INTERVAL_S, so
        # a long engagement's sawtooth does not churn the shared 64-slot
        # pinned-trace FIFO (every retune is still traced into the ring
        # and recorded as a decision)
        self._last_pin: dict[str, float] = {}
        self._was_enabled = governor_enabled()
        self._lock = threading.Lock()
        self.decisions: list[dict] = []
        self.retunes = 0
        for name in self.ceilings:
            metrics.GOVERNOR_RATE.labels(name).set(
                self._current_rate(name))

    # -- rate plumbing ---------------------------------------------------

    def _bucket(self, name: str):
        """The governed TokenBucket for a target, None for scrub (whose
        'rate' is the fleet MB/s pushed over HTTP, not a bucket)."""
        if name == "repair_xrack":
            return self.master.maintenance.xrack_bucket
        if name == "convert":
            return self.master.convert.bucket
        if name == "autopilot_tier":
            return self.master.autopilot.buckets["tiering"]
        if name == "autopilot_balance":
            return self.master.autopilot.buckets["balance"]
        if name == "autopilot_chunk":
            return self.master.autopilot.buckets["chunk"]
        return None

    def _current_rate(self, name: str) -> float:
        b = self._bucket(name)
        return b.rate if b is not None else self._scrub_rate

    def _apply_rate(self, name: str, rate: float) -> None:
        """Apply a bucket rate.  Scrub only records the new fleet rate
        here — the HTTP fan-out happens AFTER the governor lock drops
        (tick()), so status() readers and the scrape cadence never
        block behind a partitioned node's connect timeout."""
        b = self._bucket(name)
        if b is not None:
            b.set_rate(rate)
        else:
            self._scrub_rate = rate

    def _push_scrub_rate(self, mbps: float) -> None:
        """Fan the new scrub rate out to every volume server over the
        aggregator's (thread-safe) pool, concurrently — a few
        partitioned nodes cost max-of not sum-of their timeouts (the
        scrape loop's own rule).  A node that misses a push converges
        on the next retune; failures are logged, never raised into the
        tick.  Called WITHOUT self._lock held."""
        import concurrent.futures

        from seaweedfs_tpu_torch.security.tls import scheme as _tls_scheme
        with self.master.topo._lock:
            nodes = [n.url for n in self.master.topo.nodes.values()]
        if not nodes:
            return
        # pushed as a FRACTION of the master's ceiling, applied by each
        # node against its OWN configured rate: a node deliberately
        # started slower than the fleet default is scaled, never raised
        # to someone else's ceiling.  governed=True implicitly: a node
        # whose operator explicitly paused scrubbing ({"mbps": 0})
        # ignores these until the operator resumes — pacing must never
        # override a human stop
        scale = mbps / self.ceilings["scrub"] \
            if self.ceilings["scrub"] > 0 else 1.0
        body = json.dumps({"scale": round(scale, 6)}).encode()

        def push(url: str) -> None:
            try:
                self.master.aggregator.pool.request(
                    f"{_tls_scheme()}://{url}/admin/scrub_rate",
                    method="POST", body=body,
                    headers={"Content-Type": "application/json"},
                    timeout=2.0)
            except Exception as e:
                weedlog.V(1, "governor").infof(
                    "scrub-rate push to %s failed: %s", url, e)

        from seaweedfs_tpu_torch.utils import fanout
        with concurrent.futures.ThreadPoolExecutor(
                fanout.workers(len(nodes)), "scrub-push") as ex:
            list(ex.map(push, nodes))

    # -- the tick --------------------------------------------------------

    def tick(self, ts: float | None = None) -> list[dict]:
        """One retune pass (aggregator thread).  Returns the decisions
        made this tick (empty inside the deadband)."""
        ts = time.time() if ts is None else ts
        enabled = governor_enabled()
        made: list[dict] = []
        with self._lock:
            if not enabled:
                if self._was_enabled:
                    # restore the static ceilings ONCE on disable: a
                    # switched-off governor must not strand a
                    # backed-off rate
                    for name, ceiling in self.ceilings.items():
                        if self._current_rate(name) != ceiling:
                            made.append(self._retune(ts, name, None,
                                                     ceiling,
                                                     reason="disabled"))
                    self._was_enabled = False
            else:
                self._was_enabled = True
                fleet = self.obs.fleet_index()
                for name, ceiling in self.ceilings.items():
                    if ceiling <= 0:
                        continue  # the static knob disabled this class
                    rec = fleet.get(self.classes[name])
                    idx = rec["index"] if rec else 0.0
                    cur = self._current_rate(name)
                    floor = ceiling * self.floor_frac
                    if idx > self.target:
                        want = max(floor,
                                   cur * self.target / max(idx, 1e-9))
                    else:
                        want = min(ceiling, cur * self.step)
                    if want == cur:
                        continue  # already pinned at floor/ceiling
                    # deadband, EXEMPTING moves that land exactly on
                    # the floor or ceiling: the last recovery step from
                    # 0.96x ceiling is under 5% but must not strand the
                    # rate just below its configured static value
                    if want not in (ceiling, floor) and cur > 0 and \
                            abs(want - cur) / cur < self.DEADBAND:
                        # no retune, but keep the exported series
                        # stamped with the rate actually in force
                        metrics.GOVERNOR_RATE.labels(name).set(
                            round(cur, 3))
                        continue
                    made.append(self._retune(ts, name, idx, want,
                                             node=(rec or {}).get(
                                                 "node")))
        # HTTP fan-out OUTSIDE the lock: a partitioned node's connect
        # timeout must not block status() readers or the scrape
        # cadence.  Push on every scrub decision, plus periodically
        # while the rate sits away from its ceiling — a restarted
        # volume server (scrubber re-inited at the env ceiling) must
        # converge back onto the governed rate mid-engagement
        need_push = any(d["target"] == "scrub" for d in made)
        if not need_push and not enabled and self.ceilings["scrub"] > 0 \
                and ts - self._last_push >= self.REPUSH_S:
            # disabled: keep re-asserting the full configured rate at
            # the re-push cadence — the one-shot restore push can miss
            # a briefly-partitioned node, and with the governor off no
            # retune would ever retry it; these idempotent scale-1.0
            # pushes guarantee the "restores every ceiling" contract
            need_push = True
        if not need_push and enabled and self.ceilings["scrub"] > 0:
            if not self._converged:
                # first enabled tick with nodes: a predecessor master
                # may have governed the fleet down and then died — push
                # this governor's rate once so the fleet and its view
                # agree (re-backoff follows within ticks if the
                # interference persists)
                with self.master.topo._lock:
                    have_nodes = bool(self.master.topo.nodes)
                need_push = have_nodes
            elif self._scrub_rate != self.ceilings["scrub"] and \
                    ts - self._last_push >= self.REPUSH_S:
                # governed away from ceiling: re-push periodically so a
                # volume server that restarted (scrubber re-inited at
                # the env ceiling) converges back mid-engagement
                need_push = True
        if need_push:
            self._converged = True
            self._last_push = ts
            self._push_scrub_rate(self._scrub_rate)
        return made

    def _retune(self, ts: float, name: str, index: float | None,
                rate: float, node: str | None = None,
                reason: str | None = None) -> dict:
        """Apply one rate change and make it an auditable event: a
        pinned ``governor.retune`` trace, a decision record, and the
        retune counter/gauge series the history store retains."""
        old = self._current_rate(name)
        direction = "up" if rate > old else "down"
        root = trace.new_root(sampled=True)
        if ts - self._last_pin.get(name, 0.0) >= self.PIN_INTERVAL_S:
            # rate-limited pinning: the ring keeps recent retunes
            # regardless; pinning guards the engagement's evidence past
            # ring wrap without flushing the shared pin store
            self._last_pin[name] = ts
            trace.pin_trace(root.trace_id)
        with trace.span("governor.retune", parent=root, target=name,
                        cls=self.classes[name],
                        index=round(index, 4) if index is not None
                        else "",
                        from_rate=round(old, 3),
                        to_rate=round(rate, 3),
                        direction=direction,
                        reason=reason or "interference"):
            self._apply_rate(name, rate)
        metrics.GOVERNOR_RATE.labels(name).set(round(rate, 3))
        metrics.GOVERNOR_RETUNES.labels(name, direction).inc()
        self.retunes += 1
        d = {"ts": round(ts, 3), "target": name,
             "class": self.classes[name],
             "index": None if index is None else round(index, 4),
             "from": round(old, 3), "to": round(rate, 3),
             "direction": direction, "trace_id": root.trace_id}
        if node:
            d["node"] = node
        if reason:
            d["reason"] = reason
        self.decisions.append(d)
        del self.decisions[:-50]
        weedlog.info(
            "governor: %s %s %.3g -> %.3g (index=%s) trace=%s", name,
            direction, old, rate,
            "-" if index is None else f"{index:.3f}", root.trace_id,
            name="governor")
        return d

    def status(self) -> dict:
        with self._lock:
            fleet = self.obs.fleet_index()
            targets = {}
            for name, ceiling in self.ceilings.items():
                if ceiling <= 0:
                    # the static knob disabled this work class: tick()
                    # never governs it, and rendering {rate: 0, floor:
                    # 0} would read as "[AT FLOOR]" — the exact flag
                    # the interference_high runbook sends operators
                    # hunting for
                    continue
                rec = fleet.get(self.classes[name])
                targets[name] = {
                    "class": self.classes[name],
                    "rate": round(self._current_rate(name), 3),
                    "ceiling": ceiling,
                    "floor": round(ceiling * self.floor_frac, 3),
                    "index": rec["index"] if rec else 0.0,
                }
            return {"enabled": governor_enabled(),
                    "target_index": self.target,
                    "floor_frac": self.floor_frac,
                    "step": self.step,
                    "retunes": self.retunes,
                    "targets": targets,
                    "decisions": self.decisions[-20:]}
