"""Prometheus-style metrics: counters, gauges, histograms and their text
exposition.

Counterpart of `seaweedfs_tpu/stats/metrics.py` (reference:
weed/stats/metrics.go), cut to what the port's data plane touches: the
metric classes, the registry and its exposition format 0.0.4 (OpenMetrics
on request), and the families the port's telemetry books into, under the
reference's names, labels and buckets.  The push-gateway loop, the
`/metrics` handler and every serving-plane family come with the servers
(ROADMAP 1.15a).
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
# WAN ledger: the same bytes again while an ambient netflow.wan(region)
# names the remote region they cross to
WAN_BYTES = REGISTRY.counter(
    "weedtpu_wan_bytes_total",
    "body bytes crossing a region boundary by direction, traffic "
    "class, and remote region", ("direction", "class", "region"))
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
