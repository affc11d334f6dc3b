"""Prometheus-style metrics: counters, gauges, histograms and their text
exposition.

Counterpart of `seaweedfs_tpu/stats/metrics.py` (reference:
weed/stats/metrics.go), cut to what the port's data plane touches: the
metric classes, the registry and its exposition format 0.0.4 (OpenMetrics
on request) with its own size (`series_count`, `weedtpu_metric_series`),
the families the port's telemetry, its volume server, its master, the
master's planes, its maintenance plane, its filer server and its S3
gateway book into, under the reference's names, labels and buckets, and the servers' `/metrics` response (`scrape_response`).  The
push-gateway loop (`MetricsPusher`) is left out for want of a caller;
the other servers' families come with those servers.
"""

from __future__ import annotations

import threading
import time

from seaweedfs_tpu_torch.stats import trace as _trace

_DEFAULT_BUCKETS = (0.0001, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _esc(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(labels: tuple[tuple[str, str], ...], extra: str = "") -> str:
    parts = [f'{k}="{_esc(v)}"' for k, v in labels]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _Metric:
    kind = "untyped"
    # cardinality bound: past this many label sets, samples collapse into
    # one "__other__" series instead of growing memory without bound
    MAX_CHILDREN = 1000

    def __init__(self, name: str, help_text: str, label_names: tuple[str, ...]):
        self.name, self.help, self.label_names = name, help_text, label_names
        self._children: dict[tuple[str, ...], object] = {}
        self._lock = threading.Lock()

    def remove_matching(self, **by_label) -> int:
        """Drop every child whose labels match the given values: a server
        retires its own per-instance series (disk dirs, hosted volumes)
        at stop()."""
        idx = {self.label_names.index(k): str(v)
               for k, v in by_label.items()}
        with self._lock:
            dead = [vals for vals in self._children
                    if all(vals[i] == v for i, v in idx.items())]
            for vals in dead:
                del self._children[vals]
        return len(dead)

    def labels(self, *values: str):
        values = tuple(str(v) for v in values)
        if len(values) != len(self.label_names):
            raise ValueError(f"{self.name}: want {len(self.label_names)} labels")
        with self._lock:
            child = self._children.get(values)
            if child is None:
                if len(self._children) >= self.MAX_CHILDREN:
                    values = ("__other__",) * len(self.label_names)
                    child = self._children.get(values)
                    if child is not None:
                        return child
                child = self._new_child()
                self._children[values] = child
            return child

    def _pairs(self):
        with self._lock:
            items = list(self._children.items())
        for values, child in items:
            yield tuple(zip(self.label_names, values)), child


class _CounterValue:
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount


class Counter(_Metric):
    kind = "counter"
    _new_child = staticmethod(_CounterValue)

    def render(self, openmetrics: bool = False) -> list[str]:
        name = self.name
        if openmetrics:
            # OpenMetrics names the counter family without _total and the
            # samples with it
            family = name[:-6] if name.endswith("_total") else name
            out = [f"# HELP {family} {self.help}",
                   f"# TYPE {family} counter"]
            for labels, child in self._pairs():
                out.append(
                    f"{family}_total{_fmt_labels(labels)} {child.value}")
            return out
        out = [f"# HELP {name} {self.help}", f"# TYPE {name} counter"]
        for labels, child in self._pairs():
            out.append(f"{name}{_fmt_labels(labels)} {child.value}")
        return out


class _GaugeValue(_CounterValue):
    def set(self, value: float) -> None:
        with self._lock:
            self.value = value

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)


class Gauge(_Metric):
    kind = "gauge"
    _new_child = staticmethod(_GaugeValue)

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        for labels, child in self._pairs():
            out.append(f"{self.name}{_fmt_labels(labels)} {child.value}")
        return out


class _HistogramValue:
    __slots__ = ("buckets", "counts", "total", "count", "exemplars",
                 "_lock")

    def __init__(self, buckets=_DEFAULT_BUCKETS):
        self.buckets = buckets
        self.counts = [0] * len(buckets)
        self.total = 0.0
        self.count = 0
        # the last sampled-trace observation per bucket (+Inf last):
        # (value, trace_id, unix_ts), the exemplar linking a bucket to a
        # trace
        self.exemplars: list[tuple | None] = [None] * (len(buckets) + 1)
        self._lock = threading.Lock()

    def observe(self, value: float, trace_id: str | None = None) -> None:
        with self._lock:
            self.total += value
            self.count += 1
            slot = len(self.buckets)
            for i, b in enumerate(self.buckets):
                if value <= b:
                    self.counts[i] += 1
                    slot = i
                    break
            if trace_id is not None:
                self.exemplars[slot] = (value, trace_id, time.time())

    def time(self):
        return _Timer(self)


class _Timer:
    def __init__(self, hist: _HistogramValue):
        self._hist = hist

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._hist.observe(time.perf_counter() - self._t0,
                           _trace.current_exemplar())
        return False


def _exemplar_suffix(ex: tuple | None) -> str:
    """OpenMetrics exemplar: ` # {trace_id="..."} value timestamp`, the
    trace id escaped like a label value."""
    if ex is None:
        return ""
    value, trace_id, ts = ex
    return f' # {{trace_id="{_esc(str(trace_id))}"}} {value} {round(ts, 3)}'


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help_text, label_names, buckets=_DEFAULT_BUCKETS):
        super().__init__(name, help_text, label_names)
        self._buckets = buckets

    def _new_child(self):
        return _HistogramValue(self._buckets)

    def render(self, openmetrics: bool = False) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        for labels, child in self._pairs():
            cum = 0
            for i, (b, c) in enumerate(zip(child.buckets, child.counts)):
                cum += c
                le = f'le="{b}"'
                ex = _exemplar_suffix(child.exemplars[i]) \
                    if openmetrics else ""
                out.append(f"{self.name}_bucket"
                           f"{_fmt_labels(labels, le)} {cum}{ex}")
            inf = 'le="+Inf"'
            ex = _exemplar_suffix(child.exemplars[-1]) if openmetrics else ""
            out.append(f"{self.name}_bucket"
                       f"{_fmt_labels(labels, inf)} {child.count}{ex}")
            out.append(f"{self.name}_sum{_fmt_labels(labels)} {child.total}")
            out.append(f"{self.name}_count{_fmt_labels(labels)} {child.count}")
        return out


class Registry:
    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()
        # optional self-cost gauge, stamped with series_count() on every
        # render (the master's accounting reads the registry's size)
        self._series_gauge: "Gauge | None" = None

    def series_count(self) -> int:
        """Live label sets (children) across every family: what each
        scrape costs."""
        with self._lock:
            ms = list(self._metrics.values())
        return sum(len(m._children) for m in ms)

    def _register(self, metric: _Metric) -> _Metric:
        with self._lock:
            if metric.name in self._metrics:
                return self._metrics[metric.name]
            self._metrics[metric.name] = metric
            return metric

    def counter(self, name, help_text="", labels=()) -> Counter:
        return self._register(Counter(name, help_text, tuple(labels)))

    def gauge(self, name, help_text="", labels=()) -> Gauge:
        return self._register(Gauge(name, help_text, tuple(labels)))

    def histogram(self, name, help_text="", labels=(),
                  buckets=_DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram(name, help_text, tuple(labels), buckets))

    def render(self, openmetrics: bool = False) -> str:
        if self._series_gauge is not None:
            self._series_gauge.labels().set(self.series_count())
        with self._lock:
            metrics = list(self._metrics.values())
        lines: list[str] = []
        for m in metrics:
            if isinstance(m, (Histogram, Counter)):
                lines.extend(m.render(openmetrics))
            else:
                lines.extend(m.render())
        if openmetrics:
            lines.append("# EOF")
        return "\n".join(lines) + "\n"


REGISTRY = Registry()

# byte-flow ledger (stats/netflow.py): body bytes crossing a process
# boundary, by direction, traffic class and the peer's role
NET_BYTES = REGISTRY.counter(
    "weedtpu_net_bytes_total",
    "network body bytes by direction, traffic class, and peer role",
    ("direction", "class", "peer_role"))
# geo-replication observatory (replication/filer_sync.py): each sync
# pump's per-direction lag (now minus the last applied or confirmed
# source event's ts, refreshed by live-stream keepalives), backlog (source
# meta-log events newer than the resume offset), the stall flag the pump
# computes itself (no progress for WEEDTPU_SYNC_STALL_AFTER s while the
# stream errors), and its applied, skipped and error counts
REPLICATION_LAG = REGISTRY.gauge(
    "weedtpu_replication_lag_seconds",
    "per-direction replication lag: now minus last applied/confirmed "
    "source event timestamp", ("direction",))
REPLICATION_BACKLOG = REGISTRY.gauge(
    "weedtpu_replication_backlog_events",
    "per-direction replication backlog: source meta-log events newer "
    "than the resume offset", ("direction",))
REPLICATION_STALLED = REGISTRY.gauge(
    "weedtpu_replication_stalled",
    "1 while a sync direction has made no progress for the stall "
    "window despite errors or backlog, else 0", ("direction",))
REPLICATION_APPLIED = REGISTRY.counter(
    "weedtpu_replication_applied_total",
    "meta-log events applied to the remote filer", ("direction",))
REPLICATION_SKIPPED = REGISTRY.counter(
    "weedtpu_replication_skipped_total",
    "meta-log events skipped by signature loop-prevention",
    ("direction",))
REPLICATION_ERRORS = REGISTRY.counter(
    "weedtpu_replication_errors_total",
    "sync pump apply/stream errors", ("direction",))
# divergence auditor (stats/canary.py DivergenceAuditor): both filers'
# /__meta__/digest of a prefix, 0 when byte-identical, 1 when they differ
GEO_DIVERGENCE = REGISTRY.gauge(
    "weedtpu_geo_divergence",
    "1 while the two regions' subtree digests differ, 0 when "
    "byte-identical", ("prefix",))
GEO_AUDITS = REGISTRY.counter(
    "weedtpu_geo_audits_total",
    "divergence audit passes by outcome (clean/diverged/error)",
    ("outcome",))
# WAN ledger: the same bytes again while an ambient netflow.wan(region)
# names the remote region they cross to
WAN_BYTES = REGISTRY.counter(
    "weedtpu_wan_bytes_total",
    "body bytes crossing a region boundary by direction, traffic "
    "class, and remote region", ("direction", "class", "region"))
# pooled client (utils/http.py): requests on a warm keep-alive socket
# against fresh dials
HTTP_POOL_REUSE = REGISTRY.counter(
    "weedtpu_http_pool_reuse_total",
    "pooled-client requests served on a reused keep-alive connection")
HTTP_POOL_DIAL = REGISTRY.counter(
    "weedtpu_http_pool_dial_total",
    "pooled-client requests that dialed a fresh connection")
# resilience (utils/resilience.py): retry-budget spends and hedged
# degraded-read outcomes (storage/ec/ec_volume.py)
RETRY_TOTAL = REGISTRY.counter(
    "weedtpu_retry_total",
    "retry-budget spends by traffic class and outcome (allowed/denied)",
    ("class", "outcome"))
HEDGE_TOTAL = REGISTRY.counter(
    "weedtpu_hedge_total",
    "hedged degraded-read outcomes (fired / hedge_won / primary_rescued)",
    ("outcome",))
# degraded-read counters, mirrored from an EcVolume's read_stats
EC_DEGRADED_READ = REGISTRY.gauge(
    "weedtpu_ec_degraded_read", "EC degraded-read engine counters "
    "(shards fetched, intervals coalesced, reconstruct batches/intervals, "
    "cache hits)", ("stat",))
# needle-map integrity-repair drops (storage/needle_map.py)
NEEDLE_MAP_DROPS = REGISTRY.counter(
    "weedtpu_needle_map_integrity_drops_total",
    "needle-map entries discarded by integrity repair / .sdx rebuild",
    ("kind",))
SCRUB_BYTES = REGISTRY.counter(
    "weedtpu_scrub_bytes_total", "bytes verified by the background "
    "scrubber", ("kind",))
SCRUB_CORRUPTIONS = REGISTRY.counter(
    "weedtpu_scrub_corruptions_total",
    "corruptions found by the scrubber", ("kind",))
REPAIR_ACTIONS = REGISTRY.counter(
    "weedtpu_repair_actions_total",
    "automatic repair executions by outcome", ("kind", "outcome"))
REPAIR_BYTES = REGISTRY.counter(
    "weedtpu_repair_bytes_total",
    "repair bytes moved by locality class of the source "
    "(node/rack/dc/remote; reduced-path partials measured, naive "
    "survivor copies estimated)", ("locality",))
VOLUME_HEALTH = REGISTRY.gauge(
    "weedtpu_volume_health", "volumes per health-ledger state (master)",
    ("state",))
# data-plane observatory (stats/pipeline.py, stats/profile.py): busy
# seconds per pipeline stage (1 busy-second/second == a saturated stage),
# bytes per stage, and each kernel row's achieved fraction of the
# measured ceiling of the resource it exercises
PIPELINE_STAGE_SECONDS = REGISTRY.counter(
    "weedtpu_pipeline_stage_seconds_total",
    "busy seconds per data-plane pipeline stage (rate == occupancy)",
    ("kind", "stage"))
PIPELINE_STAGE_BYTES = REGISTRY.counter(
    "weedtpu_pipeline_stage_bytes_total",
    "bytes processed per data-plane pipeline stage", ("kind", "stage"))
ROOFLINE_FRAC = REGISTRY.gauge(
    "weedtpu_roofline_frac",
    "achieved throughput of a kernel as a fraction of the measured "
    "hardware ceiling of the resource it exercises",
    ("resource", "kernel"))
# every completed HTTP request by role/read-write/status class, counted in
# the trace middleware (stats/trace.py)
HTTP_REQUESTS = REGISTRY.counter(
    "weedtpu_http_requests_total",
    "completed requests by server role, read/write op, and status class",
    ("server", "op", "class"))
DEADLINE_TIMEOUTS = REGISTRY.counter(
    "weedtpu_deadline_timeouts_total",
    "requests aborted with 504 by an expired deadline budget",
    ("server",))
# the master's own families (server/master.py; stats/metrics.go:
# MasterReceivedHeartbeatCounter)
MASTER_RECEIVED_HEARTBEATS = REGISTRY.counter(
    "weedtpu_master_received_heartbeats_total",
    "Heartbeats received by master")
MASTER_ASSIGN_COUNTER = REGISTRY.counter(
    "weedtpu_master_assign_total", "fid assignments", ("collection",))
# the lookup fan-in the gateway vid caches absorb
MASTER_LOOKUPS = REGISTRY.counter(
    "weedtpu_master_lookup_total", "/dir/lookup requests served by the "
    "master — the fan-in the gateway vid caches absorb")
# the volume server's own families (server/volume_server.py)
VOLUME_REQUEST_COUNTER = REGISTRY.counter(
    "weedtpu_volume_request_total", "volume server requests", ("type",))
VOLUME_REQUEST_HISTOGRAM = REGISTRY.histogram(
    "weedtpu_volume_request_seconds", "volume request latency", ("type",))
VOLUME_COUNT_GAUGE = REGISTRY.gauge(
    "weedtpu_volumes", "volumes served", ("collection", "type"))
EC_ENCODE_BYTES = REGISTRY.counter(
    "weedtpu_ec_encode_bytes_total", "bytes EC-encoded", ("codec",))
# the filer server's own families (server/filer_server.py): requests,
# its chunk-cache counters (mirrored from ChunkCache at scrape time),
# streaming singleflight joins, the shared vid-cache counters and the
# hot tier's event ledger and ring size
FILER_REQUEST_COUNTER = REGISTRY.counter(
    "weedtpu_filer_request_total", "filer requests", ("type",))
FILER_REQUEST_HISTOGRAM = REGISTRY.histogram(
    "weedtpu_filer_request_seconds", "filer request latency", ("type",))
FILER_CHUNK_CACHE = REGISTRY.gauge(
    "weedtpu_filer_chunk_cache", "filer chunk cache counters "
    "(hits/misses/mem_bytes/tierN_bytes, cumulative where applicable)",
    ("stat",))
FILER_SINGLEFLIGHT_JOINED = REGISTRY.counter(
    "weedtpu_filer_chunk_singleflight_joined_total",
    "concurrent chunk fetches collapsed into an already in-flight one")
VID_CACHE = REGISTRY.gauge(
    "weedtpu_vid_cache", "shared vid->location cache counters "
    "(hits/misses/negative_hits/invalidations/entries)", ("stat",))
HOT_TIER_EVENTS = REGISTRY.gauge(
    "weedtpu_hot_tier_events", "cluster hot-tier event counters by kind "
    "(cumulative; mirrored from the filer's hot-tier ledger)", ("event",))
HOT_TIER_RING = REGISTRY.gauge(
    "weedtpu_hot_tier_ring_members", "live filers in the hot-tier "
    "rendezvous ring, as this node sees it")
S3_QOS = REGISTRY.counter(
    "weedtpu_s3_qos_total", "tenant QoS admission verdicts at the s3 "
    "edge", ("outcome",))
NEEDLE_CRC_MISMATCH = REGISTRY.counter(
    "weedtpu_needle_crc_mismatch_total",
    "store-volume reads that failed CRC verification")
DISK_BYTES = REGISTRY.gauge(
    "weedtpu_disk_bytes",
    "per-data-dir disk capacity by volume server, directory, and kind "
    "(total/used/free)", ("vs", "dir", "kind"))
VOLUME_SIZE = REGISTRY.gauge(
    "weedtpu_volume_size_bytes",
    "size of each locally served volume, per hosting server",
    ("vid", "vs"))
VOLUME_MOVES = REGISTRY.counter(
    "weedtpu_volume_moves_total",
    "volume rebalance moves driven through /admin/volume/move on this "
    "server, by outcome (ok/aborted)", ("outcome",))


# the master's planes (stats/canary.py, history.py, interference.py,
# loops.py): canary probes by path and status class (the class label
# lets the SLO engine's availability rules read them), the history
# store's size, alert groups firing, capacity forecasts, the
# interference index and the governor's rates, and every master loop's
# tick telemetry
CANARY_PROBES = REGISTRY.counter(
    "weedtpu_canary_probes_total",
    "canary probes by gateway path and status class", ("path", "class"))
CANARY_PROBE_SECONDS = REGISTRY.histogram(
    "weedtpu_canary_probe_seconds", "canary probe latency", ("path",))
# per-tenant accounting at the s3 gateway (the trace middleware's tenant
# edge, stats/heat.py's resolve_tenant): the request counter and the
# byte counter that conserves with the netflow ledger's data-class
# totals on the gateway that resolved the tenant
TENANT_REQUESTS = REGISTRY.counter(
    "weedtpu_tenant_requests_total",
    "completed gateway requests by tenant and read/write op",
    ("tenant", "op"))
TENANT_BYTES = REGISTRY.counter(
    "weedtpu_tenant_bytes_total",
    "body bytes moved for a tenant by direction and op",
    ("tenant", "direction", "op"))
PREDICTED_FULL = REGISTRY.gauge(
    "weedtpu_predicted_full_seconds",
    "seconds until a data dir is predicted to fill (linear fill-rate "
    "regression over /cluster/history; capped ~10y when not filling)",
    ("vs", "dir"))
VOLUME_PREDICTED_FULL = REGISTRY.gauge(
    "weedtpu_volume_predicted_full_seconds",
    "seconds until a growing volume is predicted to hit the size limit "
    "(only volumes actually filling get a series)", ("vid",))
HISTORY_SERIES = REGISTRY.gauge(
    "weedtpu_history_series",
    "series held by the master's history store (bounded by "
    "WEEDTPU_HISTORY_MAX_SERIES)")
HISTORY_EVICTED = REGISTRY.counter(
    "weedtpu_history_evicted_total",
    "series refused or evicted by the history store's cardinality bound")
ALERTS_FIRING = REGISTRY.gauge(
    "weedtpu_alerts_firing", "alert groups currently firing, per rule",
    ("rule",))
CANARY_LATENCY = REGISTRY.gauge(
    "weedtpu_canary_latency_seconds",
    "canary probe latency quantiles over the rolling window",
    ("path", "quantile"))
INTERFERENCE_INDEX = REGISTRY.gauge(
    "weedtpu_interference_index",
    "fractional foreground read-p99 inflation attributable to a "
    "background traffic class (per node, EWMA over aggregator ticks; "
    "0 = no measurable impact, 1.0 = p99 doubled)",
    ("node", "class"))
GOVERNOR_RATE = REGISTRY.gauge(
    "weedtpu_governor_rate",
    "current governed rate per background-work target (repair_xrack "
    "bytes/s, convert volumes/s, scrub MB/s)", ("target",))
GOVERNOR_RETUNES = REGISTRY.counter(
    "weedtpu_governor_retunes_total",
    "governor rate-retune decisions by target and direction (up/down)",
    ("target", "direction"))
# the master's maintenance plane (maintenance/convert.py,
# autopilot.py): volumes put back on the conversion queue, and the
# autopilot's plans per policy and executions per policy and outcome
CONVERT_REQUEUED = REGISTRY.counter(
    "weedtpu_convert_requeued_total",
    "fleet-conversion volumes re-queued (never dropped) by reason "
    "(node_error: the node call failed; skipped: the node answered "
    "but left the volume unconverted)", ("reason",))
AUTOPILOT_PLANS = REGISTRY.counter(
    "weedtpu_autopilot_plans_total",
    "autopilot action plans created, by policy "
    "(tiering_demote / tiering_promote / balance_move)", ("policy",))
AUTOPILOT_ACTIONS = REGISTRY.counter(
    "weedtpu_autopilot_actions_total",
    "autopilot plan executions by policy and outcome (done/aborted)",
    ("policy", "outcome"))
METRIC_SERIES = REGISTRY.gauge(
    "weedtpu_metric_series",
    "label sets live across all metric families in this registry")
REGISTRY._series_gauge = METRIC_SERIES
LOOP_TICK_SECONDS = REGISTRY.histogram(
    "weedtpu_loop_tick_seconds",
    "wall-clock seconds per master background-loop tick", ("loop",))
LOOP_CPU_SECONDS = REGISTRY.counter(
    "weedtpu_loop_cpu_seconds_total",
    "thread CPU seconds consumed by each master background loop "
    "(thread_time delta around the tick; awaits that migrate work to "
    "other threads are attributed to those threads' loops)", ("loop",))
LOOP_ITEMS = REGISTRY.counter(
    "weedtpu_loop_items_total",
    "items processed per master background loop (nodes scraped, plans "
    "made, actions launched, probes fired)", ("loop",))
LOOP_OVERRUNS = REGISTRY.counter(
    "weedtpu_loop_overruns_total",
    "ticks whose wall time exceeded the loop's own interval", ("loop",))
LOOP_ERRORS = REGISTRY.counter(
    "weedtpu_loop_errors_total",
    "ticks that raised; the exception is swallowed by the loop's own "
    "guard but recorded here and in /cluster/loops last_error", ("loop",))
LOOP_BACKLOG = REGISTRY.gauge(
    "weedtpu_loop_backlog",
    "queue/backlog depth behind each master background loop (convert "
    "queue, repair queue, ...; 0 for loops without a queue)", ("loop",))
LOOP_OVERRUN_RATIO = REGISTRY.gauge(
    "weedtpu_loop_overrun_ratio",
    "last tick wall seconds / loop interval (>1 = the loop can no "
    "longer hold its cadence; 0 when the loop has no fixed interval)",
    ("loop",))
SUBSYSTEM_ENTRIES = REGISTRY.gauge(
    "weedtpu_subsystem_entries",
    "live entries per stateful master subsystem (registry series, "
    "history series + counter baselines, alert-engine state groups, "
    "interference node states, heat tracker entries, pinned traces)",
    ("subsystem",))


def scrape_response(req):
    """The servers' aiohttp /metrics response with content negotiation:
    the OpenMetrics rendering (exemplars linking latency buckets to trace
    ids) when the scraper asks for it, Prometheus text 0.0.4 otherwise.
    Roofline fractions are re-derived from the live kernel profile here,
    so every scrape carries current achieved-vs-ceiling numbers."""
    from aiohttp import web

    from seaweedfs_tpu_torch.stats import profile
    profile.export_roofline()
    if "application/openmetrics-text" in req.headers.get("Accept", ""):
        return web.Response(text=REGISTRY.render(openmetrics=True),
                            content_type="application/openmetrics-text")
    return web.Response(text=REGISTRY.render(), content_type="text/plain")
