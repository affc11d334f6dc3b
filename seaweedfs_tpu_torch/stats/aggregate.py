"""Cluster-wide metrics aggregation + the SLO burn-rate engine.

Counterpart of `seaweedfs_tpu/stats/aggregate.py`, whole.  Fleet-level
observability (the arXiv:1309.0186 lesson: recovery and hot-path
regressions show up in aggregate, not on node dashboards):

- **Federation** — the master periodically pulls every known node's
  ``/metrics`` (volume servers from the topology, filers/gateways from
  the cluster-member registry, its own registry directly) over one
  shared PooledHTTP, parses the text exposition, and serves the union
  at ``/cluster/metrics`` with a ``node`` label stamped on every sample
  — one scrape target for the whole cluster.

- **Merging** — counters and histograms additionally merge across nodes
  (counters summed, histogram buckets summed per ``le``) into the
  windowed snapshots the SLO engine consumes; ``histogram_quantile``
  reads a p99 straight out of a merged bucket vector.

- **SLO engine** — rules (availability by request class, latency
  quantile from merged histograms, maintenance backlog) evaluated with
  multi-window burn rates: burn = (bad/total) / (1 - target) over each
  window; a rule is ``violated`` when every window burns > 1, ``warn``
  when only the short window does.  Surfaced at ``/cluster/slo`` and
  inside ``/maintenance/status``.

Rule syntax (``WEEDTPU_SLO_RULES``, ';'-separated, documented in the
README's Cluster observability section)::

    name=availability,op=read|write,target=0.999
    name=latency,family=<histogram>,label.<k>=<v>,ms=<thresh>,target=0.99
    name=backlog,family=<gauge>,label.<k>!=<v>

Windows come from ``WEEDTPU_SLO_WINDOWS`` (seconds, comma-separated,
default ``300,3600``); the pull cadence from ``WEEDTPU_AGG_INTERVAL``
(default 10s, <=0 disables the background loop — the endpoints then
scrape on demand).  A malformed rule, window or interval raises
ValueError, where the reference drops the rule or falls back to the
default; the master reads all three at construction, before its socket
binds.
"""

from __future__ import annotations

import math
import os
import re
import threading
import time
from collections import deque

from seaweedfs_tpu_torch.security.tls import scheme as _tls_scheme
from seaweedfs_tpu_torch.stats.metrics import _esc
from seaweedfs_tpu_torch.utils import weedlog

_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(-?[0-9.eE+-]+|NaN|'
    r'[+-]Inf)')
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unesc(v: str) -> str:
    return v.replace("\\n", "\n").replace('\\"', '"').replace("\\\\", "\\")


def _fmt_value(v: float) -> str:
    """Full-precision sample rendering for the federation output.  ':g'
    would round to 6 significant digits — a counter at 1.2e7 advancing
    100/s then renders the SAME value on consecutive scrapes and rate()
    over the federated data reads zero."""
    if v != v:
        return "NaN"
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


_EXEMPLAR_TID_RE = re.compile(r'trace_id="((?:[^"\\]|\\.)*)"')


def parse_exposition(text: str) -> dict[str, dict]:
    """Prometheus text 0.0.4 -> {family: {type, help, samples}} where
    samples is a list of (sample_name, labels dict, float value).
    Histogram ``_bucket``/``_sum``/``_count`` samples file under their
    family name.  OpenMetrics exemplar trace ids are captured into the
    family's ``exemplars`` map — {(sample_name, sorted label pairs):
    trace_id} — so the alert engine can pin the trace behind a
    triggering series; the suffix is otherwise dropped."""
    fams: dict[str, dict] = {}

    def fam(name: str) -> dict:
        return fams.setdefault(name, {"type": "untyped", "help": "",
                                      "samples": []})

    for line in text.splitlines():
        line = line.strip()
        if not line or line == "# EOF":
            continue
        if line.startswith("# HELP "):
            parts = line.split(" ", 3)
            fam(parts[2])["help"] = parts[3] if len(parts) > 3 else ""
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ", 3)
            if len(parts) > 3:
                fam(parts[2])["type"] = parts[3]
            continue
        if line.startswith("#"):
            continue
        line, sep, exem = line.partition(" # ")  # exemplar suffix
        line = line.rstrip()
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        name, labels_raw, value_s = m.groups()
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[:-len(suffix)] in fams and \
                    fams[name[:-len(suffix)]]["type"] == "histogram":
                base = name[:-len(suffix)]
                break
        if base == name and name.endswith("_total") and \
                name not in fams and \
                fams.get(name[:-6], {}).get("type") == "counter":
            # OpenMetrics names the counter FAMILY without _total and
            # the samples WITH it.  Normalize to the 0.0.4 convention
            # (family named like its samples) so an OM node and a
            # plain-text node — a rolling upgrade — merge into ONE
            # family instead of duplicate TYPE blocks in the federation
            meta = fams[name[:-6]]
            f = fam(name)
            f["type"] = "counter"
            if not f["help"]:
                f["help"] = meta["help"]
        try:
            value = float(value_s)
        except ValueError:
            continue
        labels = {k: _unesc(v)
                  for k, v in _LABEL_RE.findall(labels_raw or "")}
        f = fam(base)
        f["samples"].append((name, labels, value))
        if sep:
            em = _EXEMPLAR_TID_RE.search(exem)
            if em:
                f.setdefault("exemplars", {})[
                    (name, _key(labels))] = _unesc(em.group(1))
    # drop meta-only families (an OM counter's sans-_total TYPE line
    # whose samples were refiled above): every consumer iterates samples
    return {name: f for name, f in fams.items() if f["samples"]}


def _key(labels: dict, drop: tuple = ()) -> tuple:
    return tuple(sorted((k, v) for k, v in labels.items()
                        if k not in drop))


def merge_counters(per_node: dict[str, dict]) -> dict[tuple, float]:
    """Sum counter (and gauge) samples across nodes by (family, labels).
    Key: (sample_name, sorted label pairs)."""
    out: dict[tuple, float] = {}
    for fams in per_node.values():
        for fname, fam in fams.items():
            if fam["type"] == "histogram":
                continue
            for name, labels, value in fam["samples"]:
                k = (name, _key(labels))
                out[k] = out.get(k, 0.0) + value
    return out


def merge_histograms(per_node: dict[str, dict]
                     ) -> dict[tuple, dict]:
    """Bucket-merge histogram families across nodes: cumulative counts
    summed per ``le`` (missing buckets on one node contribute that node's
    nearest lower bucket — in practice all nodes share the bucket layout,
    so this is a plain per-le sum), ``_sum``/``_count`` summed.
    Key: (family, sorted label pairs sans ``le``)."""
    out: dict[tuple, dict] = {}
    for fams in per_node.values():
        for fname, fam in fams.items():
            if fam["type"] != "histogram":
                continue
            for name, labels, value in fam["samples"]:
                k = (fname, _key(labels, drop=("le",)))
                rec = out.setdefault(k, {"buckets": {}, "count": 0.0,
                                         "sum": 0.0})
                if name.endswith("_bucket"):
                    le_s = labels.get("le", "+Inf")
                    le = math.inf if le_s == "+Inf" else float(le_s)
                    rec["buckets"][le] = rec["buckets"].get(le, 0.0) + value
                elif name.endswith("_count"):
                    rec["count"] += value
                elif name.endswith("_sum"):
                    rec["sum"] += value
    return out


def histogram_quantile(buckets: dict[float, float], q: float
                       ) -> float | None:
    """Prometheus-style quantile estimate from cumulative buckets:
    linear interpolation inside the bucket holding the rank; the +Inf
    bucket degrades to the previous bound."""
    if not buckets:
        return None
    les = sorted(buckets)
    cums = [buckets[le] for le in les]
    total = cums[-1]
    if total <= 0:
        return None
    rank = q * total
    prev_le, prev_cum = 0.0, 0.0
    for le, cum in zip(les, cums):
        if cum >= rank:
            if le == math.inf or cum <= prev_cum:
                return prev_le
            return prev_le + (le - prev_le) * (rank - prev_cum) / \
                (cum - prev_cum)
        prev_le, prev_cum = le, cum
    return prev_le


def _hist_delta(now: dict, then: dict | None) -> dict:
    """Per-NODE histogram window delta.  A counter reset (the node
    restarted: count went down) restarts the delta from zero — i.e. the
    node's whole current histogram counts, Prometheus rate() style."""
    if then is None or now["count"] < then.get("count", 0.0):
        return now
    buckets = {le: max(0.0, c - then.get("buckets", {}).get(le, 0.0))
               for le, c in now["buckets"].items()}
    return {"buckets": buckets,
            "count": now["count"] - then.get("count", 0.0),
            "sum": max(0.0, now["sum"] - then.get("sum", 0.0))}


# -- SLO rules -----------------------------------------------------------

def slo_windows() -> list[float]:
    """WEEDTPU_SLO_WINDOWS: seconds > 0, comma-separated."""
    spec = os.environ.get("WEEDTPU_SLO_WINDOWS", "").strip()
    if not spec:
        return [300.0, 3600.0]
    out = []
    for part in spec.split(","):
        try:
            w = float(part)
        except ValueError:
            w = 0.0
        if not w > 0:
            raise ValueError(f"WEEDTPU_SLO_WINDOWS={spec!r}: want seconds "
                             f"> 0, comma-separated")
        out.append(w)
    return sorted(out)


_DEFAULT_RULES = (
    "read_availability=availability,op=read,target=0.999;"
    "write_availability=availability,op=write,target=0.999;"
    "read_latency_p99=latency,family=weedtpu_volume_request_seconds,"
    "label.type=read,ms=500,target=0.99;"
    "repair_backlog=backlog,family=weedtpu_volume_health,"
    "label.state!=healthy;"
    # the canary prober's probes carry their status bucket in a `class`
    # label, so the stock availability machinery evaluates them: the SLO
    # stays live BETWEEN real requests (stats/canary.py)
    "canary_availability=availability,"
    "family=weedtpu_canary_probes_total,target=0.99")


def parse_rules(spec: str | None = None) -> list[dict]:
    if spec is None:
        spec = os.environ.get("WEEDTPU_SLO_RULES") or _DEFAULT_RULES
    rules: list[dict] = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        name, _, rest = part.partition("=")
        fields = rest.split(",")
        rule: dict = {"name": name.strip(), "kind": fields[0].strip(),
                      "labels": {}, "not_labels": {}}
        ok = "=" in part and \
            rule["kind"] in ("availability", "latency", "backlog")
        for f in fields[1:]:
            if "!=" in f:
                k, _, v = f.partition("!=")
                if k.startswith("label."):
                    rule["not_labels"][k[6:]] = v
                continue
            k, _, v = f.partition("=")
            k, v = k.strip(), v.strip()
            if k.startswith("label."):
                rule["labels"][k[6:]] = v
            elif k in ("target", "ms"):
                try:
                    rule[k] = float(v)
                except ValueError:
                    ok = False
            elif k:
                rule[k] = v
        if not ok:
            raise ValueError(f"bad SLO rule {part!r} (WEEDTPU_SLO_RULES)")
        rule.setdefault("target", 0.999)
        rules.append(rule)
    return rules


def _match(labels_key: tuple, want: dict, deny: dict) -> bool:
    labels = dict(labels_key)
    return all(labels.get(k) == v for k, v in want.items()) and \
        not any(labels.get(k) == v for k, v in deny.items())


class SLOEngine:
    """Evaluate burn-rate rules over a history of PER-NODE snapshots.

    ``history`` entries are ``(ts, {node: counters}, {node: hists})``
    with the inner dicts as produced by merge_counters/merge_histograms
    over one node.  Window deltas are taken per node and THEN summed
    (Prometheus rate()-before-sum): a node restart resets its counters,
    and a delta on the cluster-merged sum would clamp to zero and blind
    the SLO exactly when a node crashes — per-node deltas treat a reset
    as counting from zero instead.  The window edge is the OLDEST
    snapshot inside the window (a fresh process truncates long windows
    to its own lifetime rather than reporting nothing)."""

    def __init__(self, rules: list[dict] | None = None,
                 windows: list[float] | None = None):
        self.rules = rules if rules is not None else parse_rules()
        self.windows = windows if windows is not None else slo_windows()

    @staticmethod
    def _at(history, cutoff: float):
        """The snapshot serving as the window's left edge: the NEWEST one
        at or before `cutoff`, falling back to the oldest snapshot when
        history is shorter than the window (the window truncates to the
        process lifetime rather than reporting nothing).  None only when
        a single snapshot exists — the rule then reads lifetime totals."""
        prev = None
        for snap in list(history)[:-1]:
            if snap[0] <= cutoff:
                prev = snap
            else:
                break
        if prev is not None:
            return prev
        return history[0] if len(history) > 1 else None

    def _counter_delta(self, now_pn, then_pn, sample: str, want, deny
                       ) -> float:
        """Sum of per-node window deltas; a node whose counter went DOWN
        restarted — its delta restarts from the current value."""
        total = 0.0
        for node, counters in now_pn.items():
            then_c = (then_pn or {}).get(node) or {}
            for (name, lk), v in counters.items():
                if name != sample or not _match(lk, want, deny):
                    continue
                base = then_c.get((name, lk), 0.0)
                total += v - base if v >= base else v
        return total

    def _eval_rule(self, rule: dict, history) -> dict:
        now_ts, now_pn, now_ph = history[-1]
        res: dict = {"name": rule["name"], "kind": rule["kind"],
                     "target": rule.get("target"), "windows": {}}
        if rule["kind"] == "backlog":
            value = sum(v for counters in now_pn.values()
                        for (name, lk), v in counters.items()
                        if name == rule.get("family")
                        and _match(lk, rule["labels"], rule["not_labels"]))
            res["value"] = value
            res["state"] = "ok" if value <= 0 else "violated"
            res.pop("target")
            return res
        budget = max(1e-9, 1.0 - rule.get("target", 0.999))
        burns: list[float] = []
        for w in self.windows:
            prev = self._at(history, now_ts - w)
            then_pn = prev[1] if prev else None
            then_ph = prev[2] if prev else None
            span = now_ts - prev[0] if prev else 0.0
            if rule["kind"] == "availability":
                fam = rule.get("family", "weedtpu_http_requests_total")
                want = dict(rule["labels"])
                if rule.get("op"):
                    want["op"] = rule["op"]
                bad = self._counter_delta(
                    now_pn, then_pn, fam, {**want, "class": "5xx"},
                    rule["not_labels"])
                total = self._counter_delta(now_pn, then_pn, fam, want,
                                            rule["not_labels"])
                win: dict = {"bad": bad, "total": total}
            else:  # latency
                fam = rule.get("family", "weedtpu_volume_request_seconds")
                agg = {"buckets": {}, "count": 0.0, "sum": 0.0}
                for node, hists in now_ph.items():
                    then_h = (then_ph or {}).get(node) or {}
                    for (name, lk), rec in hists.items():
                        if name != fam or not _match(lk, rule["labels"],
                                                     rule["not_labels"]):
                            continue
                        d = _hist_delta(rec, then_h.get((name, lk)))
                        for le, c in d["buckets"].items():
                            agg["buckets"][le] = \
                                agg["buckets"].get(le, 0.0) + c
                        agg["count"] += d["count"]
                        agg["sum"] += d["sum"]
                thresh = rule.get("ms", 500.0) / 1000.0
                total = agg["count"]
                # snap the threshold DOWN to a bucket bound: with an
                # unaligned ms (say 200 against ...100,250... buckets)
                # requests in the straddling bucket count as BAD — the
                # conservative direction; snapping up would let a fleet
                # of 240ms requests pass a 200ms objective forever
                good = 0.0
                for le in sorted(agg["buckets"]):
                    if le <= thresh:
                        good = agg["buckets"][le]
                    else:
                        break
                bad = max(0.0, total - good)
                p99 = histogram_quantile(agg["buckets"], 0.99)
                win = {"bad": bad, "total": total,
                       "p99_ms": None if p99 is None
                       else round(p99 * 1000.0, 3)}
            ratio = (win["bad"] / win["total"]) if win["total"] else 0.0
            burn = ratio / budget
            win["ratio"] = round(ratio, 6)
            win["burn_rate"] = round(burn, 3)
            win["span_s"] = round(span, 1)
            res["windows"][f"{int(w)}s"] = win
            burns.append(burn)
        if all(b > 1.0 for b in burns):
            res["state"] = "violated"
        elif burns and burns[0] > 1.0:
            res["state"] = "warn"
        else:
            res["state"] = "ok"
        return res

    def evaluate(self, history) -> dict:
        if not history:
            return {"state": "unknown", "rules": [],
                    "windows_s": self.windows}
        rules = [self._eval_rule(r, history) for r in self.rules]
        order = {"violated": 3, "warn": 2, "unknown": 1, "ok": 0}
        worst = max((r["state"] for r in rules), default="ok",
                    key=lambda s: order.get(s, 0))
        return {"state": worst, "windows_s": self.windows, "rules": rules,
                "ts": history[-1][0]}


# -- the master's aggregator ---------------------------------------------

def agg_interval() -> float:
    """WEEDTPU_AGG_INTERVAL: seconds between scrapes (<= 0: on demand)."""
    raw = os.environ.get("WEEDTPU_AGG_INTERVAL", "").strip()
    if not raw:
        return 10.0
    try:
        return float(raw)
    except ValueError:
        raise ValueError(f"WEEDTPU_AGG_INTERVAL={raw!r}: want seconds") \
            from None


class ClusterAggregator:
    """Pull every node's /metrics, merge, keep windowed history, serve
    federation + SLO views.  One daemon thread (start()/stop());
    scrape_once() is also safe to call directly for on-demand refresh
    (the endpoints do, via asyncio.to_thread)."""

    def __init__(self, nodes_fn, local: tuple | None = None,
                 pool=None, rules: list[dict] | None = None,
                 windows: list[float] | None = None,
                 interval: float | None = None, monitor=None):
        from seaweedfs_tpu_torch.utils.http import PooledHTTP
        self.nodes_fn = nodes_fn  # () -> {node name: netloc}
        self.local = local        # (node name, Registry) served locally
        self.pool = pool or PooledHTTP(timeout=5.0,
                                       max_idle_per_host=2,
                                       role="master")
        self.interval = agg_interval() if interval is None else interval
        # optional stats.loops.LoopMonitor: every scrape reports wall/CPU
        # and node count as the "aggregator" loop
        self.monitor = monitor
        # persistent fan-out pool for _pull_node, sized with the fleet
        # (grow-only, capped by WEEDTPU_FANOUT_POOL); a fresh min(8,n)
        # pool per scrape serialized 500-node pulls into 500/8 RTTs
        self._pull_ex = None
        self._pull_ex_size = 0
        self.engine = SLOEngine(rules, windows)
        # (ts, {node: counters}, {node: hists}); trimmed to the longest
        # SLO window (+ slack) on every scrape
        self.history: deque = deque()
        self.per_node: dict[str, dict] = {}
        self.errors: dict[str, str] = {}
        self.last_scrape: float = 0.0
        # node -> ts of its last SUCCESSFUL pull: a dead node's age grows
        # visibly in /cluster/metrics instead of its last values sitting
        # there silently stale
        self.last_ok: dict[str, float] = {}
        # post-scrape hooks (ts, {node: families}) — the master wires the
        # history store / alert engine / capacity forecaster here so the
        # retention plane ticks exactly as often as federation does
        self.observers: list = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "ClusterAggregator":
        if self.interval <= 0 or self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._run,
                                        name="cluster-aggregator",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        with self._lock:
            ex, self._pull_ex, self._pull_ex_size = self._pull_ex, None, 0
        if ex is not None:
            ex.shutdown(wait=False)
        self.pool.close()

    def _run(self) -> None:
        from seaweedfs_tpu_torch.utils.resilience import Backoff
        bo = Backoff(base=self.interval, cap=max(self.interval * 8, 60.0))
        delay = self.interval
        while not self._stop.wait(delay):
            delay = self.interval
            try:
                self.scrape_once()
                bo.reset()
            except Exception as e:  # a bad node must not kill the loop
                # (per-node pull errors are folded into self.errors; a
                # raise here is the harness itself failing — back off
                # with jitter rather than spinning on it)
                delay = bo.next()
                weedlog.V(1, "aggregate").infof("scrape failed: %s", e)

    # -- scraping -------------------------------------------------------

    def _pull_node(self, netloc: str):
        """-> (families, None) or (None, error string).  Negotiates the
        OpenMetrics rendering so histogram exemplars (trace ids) ride
        along — the alert engine pins the trace behind a triggering
        series; a plain-text-only node still parses fine."""
        try:
            status, _, body = self.pool.request(
                f"{_tls_scheme()}://{netloc}/metrics",
                headers={"Accept": "application/openmetrics-text"},
                timeout=5.0)
            if status != 200:
                return None, f"HTTP {status}"
            return parse_exposition(body.decode("utf-8", "replace")), None
        except Exception as e:  # transport or parse: node marked down
            return None, str(e) or type(e).__name__

    def _pull_executor(self, n: int):
        """Persistent, grow-only fan-out pool sized min(n, cap) — see
        utils/fanout.py for why the pool must scale with the fleet."""
        import concurrent.futures
        from seaweedfs_tpu_torch.utils import fanout
        want = fanout.workers(n)
        with self._lock:
            if self._pull_ex is None or self._pull_ex_size < want:
                old = self._pull_ex
                self._pull_ex = concurrent.futures.ThreadPoolExecutor(
                    want, "agg-pull")
                self._pull_ex_size = want
                if old is not None:
                    old.shutdown(wait=False)
            return self._pull_ex

    def scrape_once(self) -> dict[str, dict]:
        if self.monitor is None:
            return self._scrape_once(None)
        iv = self.interval if self.interval > 0 else None
        with self.monitor.tick("aggregator", interval=iv) as t:
            return self._scrape_once(t)

    def _scrape_once(self, t) -> dict[str, dict]:
        nodes = dict(self.nodes_fn() or {})
        per_node: dict[str, dict] = {}
        errors: dict[str, str] = {}
        local_name = self.local[0] if self.local else None
        if self.local:
            per_node[local_name] = parse_exposition(
                self.local[1].render(openmetrics=True))
        remote = [(n, loc) for n, loc in nodes.items() if n != local_name]
        if remote:
            # fan the pulls out: a few partitioned nodes each cost a full
            # connect timeout, and paid serially that would stall the
            # scrape cadence (and every ?refresh=1 handler) for longer
            # than the aggregation interval
            for attempt in (0, 1):
                ex = self._pull_executor(len(remote))
                try:
                    results = list(ex.map(self._pull_node,
                                          [loc for _, loc in remote]))
                    break
                except RuntimeError:
                    # a concurrent scrape grew the pool and shut this one
                    # down mid-map; retry once against the new pool
                    if attempt:
                        raise
            for (name, _), (fams, err) in zip(remote, results):
                if err is not None:
                    errors[name] = err
                else:
                    per_node[name] = fams
        if t is not None:
            t.items = len(per_node)
            t.backlog = len(errors)
        ts = time.time()
        # snapshots stay PER NODE so the SLO engine can delta each node
        # separately (counter resets on a restarted node must not clamp
        # the whole cluster's window delta to zero)
        counters = {n: merge_counters({n: fams})
                    for n, fams in per_node.items()}
        hists = {n: merge_histograms({n: fams})
                 for n, fams in per_node.items()}
        with self._lock:
            self.per_node = per_node
            self.errors = errors
            self.last_scrape = ts
            for n in per_node:
                self.last_ok[n] = ts
            # forget nodes that left the topology entirely (still listed
            # while erroring: an operator needs to SEE the gap grow)
            known = set(per_node) | set(errors)
            for n in [n for n in self.last_ok if n not in known]:
                del self.last_ok[n]
            self.history.append((ts, counters, hists))
            horizon = ts - (max(self.engine.windows) + 2 * max(
                self.interval, 1.0))
            while len(self.history) > 2 and self.history[0][0] < horizon:
                self.history.popleft()
        if self.observers:
            # the synthesized staleness/up gauges ride along as a pseudo
            # node so the history store records them like any federated
            # series (they exist only at render time otherwise)
            payload = dict(per_node)
            payload["__aggregator__"] = self._synth_families()
            for ob in list(self.observers):
                try:
                    ob(ts, payload)
                except Exception as e:  # an observer must not kill scrapes
                    weedlog.warning(
                        "scrape observer failed: %s", e,
                        name="aggregate", exc_info=True)
        return per_node

    def _synth_families(self) -> dict[str, dict]:
        """The render()-synthesized per-node gauges in parsed-exposition
        shape: node up/down and scrape age — with a NEVER-successfully-
        scraped node reporting +Inf age, not absent/fresh, so staleness
        rules catch it from its very first failed pull."""
        with self._lock:
            per_node = sorted(self.per_node)
            errors = sorted(self.errors)
            last_ok = dict(self.last_ok)
        now = time.time()
        up = {"type": "gauge", "help": "last /metrics pull succeeded",
              "samples": [("weedtpu_cluster_node_up", {"node": n}, 1.0)
                          for n in per_node] +
                         [("weedtpu_cluster_node_up", {"node": n}, 0.0)
                          for n in errors]}
        age_samples = [("weedtpu_agg_scrape_age_seconds", {"node": n},
                        max(0.0, now - ts))
                       for n, ts in sorted(last_ok.items())]
        age_samples += [("weedtpu_agg_scrape_age_seconds", {"node": n},
                         math.inf)
                        for n in errors if n not in last_ok]
        return {"weedtpu_cluster_node_up": up,
                "weedtpu_agg_scrape_age_seconds": {
                    "type": "gauge",
                    "help": "seconds since this node's last successful "
                            "/metrics pull",
                    "samples": age_samples}}

    def ensure_fresh(self, max_age: float | None = None) -> None:
        age = time.time() - self.last_scrape
        if max_age is None:
            max_age = max(self.interval, 1.0) * 2 if self.interval > 0 \
                else 0.0
        if age > max_age or not self.history:
            self.scrape_once()

    # -- views ----------------------------------------------------------

    def render(self) -> str:
        """Federation exposition: every node's families with a ``node``
        label stamped on each sample, plus the aggregator's own per-node
        up/error gauge.  One HELP/TYPE per family."""
        with self._lock:
            per_node = dict(self.per_node)
            errors = dict(self.errors)
            last_ok = dict(self.last_ok)
        fams: dict[str, dict] = {}
        for node, nf in per_node.items():
            for fname, fam in nf.items():
                rec = fams.setdefault(fname, {"type": fam["type"],
                                              "help": fam["help"],
                                              "lines": []})
                for name, labels, value in fam["samples"]:
                    pairs = [f'node="{_esc(node)}"'] + [
                        f'{k}="{_esc(v)}"'
                        for k, v in sorted(labels.items())]
                    rec["lines"].append(
                        f"{name}{{{','.join(pairs)}}} {_fmt_value(value)}")
        out: list[str] = []
        for fname in sorted(fams):
            rec = fams[fname]
            out.append(f"# HELP {fname} {rec['help']}")
            out.append(f"# TYPE {fname} {rec['type']}")
            out.extend(rec["lines"])
        out.append("# HELP weedtpu_cluster_node_up "
                   "last /metrics pull succeeded")
        out.append("# TYPE weedtpu_cluster_node_up gauge")
        for node in sorted(per_node):
            out.append(f'weedtpu_cluster_node_up{{node="{_esc(node)}"}} 1')
        for node in sorted(errors):
            out.append(f'weedtpu_cluster_node_up{{node="{_esc(node)}"}} 0')
        # per-node scrape staleness: a dead node's age keeps growing
        # (its last successful pull recedes) — the visible gap that
        # distinguishes "node quiet" from "values silently stale"
        now = time.time()
        out.append("# HELP weedtpu_agg_scrape_age_seconds seconds since "
                   "this node's last successful /metrics pull")
        out.append("# TYPE weedtpu_agg_scrape_age_seconds gauge")
        for node in sorted(last_ok):
            age = max(0.0, now - last_ok[node])
            out.append(f'weedtpu_agg_scrape_age_seconds'
                       f'{{node="{_esc(node)}"}} {round(age, 3)}')
        # a node that has NEVER been scraped successfully is maximally
        # stale, not fresh: +Inf (valid exposition) so staleness alerts
        # and dashboards see it without special-casing absence
        for node in sorted(errors):
            if node not in last_ok:
                out.append(f'weedtpu_agg_scrape_age_seconds'
                           f'{{node="{_esc(node)}"}} +Inf')
        return "\n".join(out) + "\n"

    def slo_status(self) -> dict:
        with self._lock:
            history = list(self.history)
            errors = dict(self.errors)
            nodes = sorted(self.per_node)
        status = self.engine.evaluate(history)
        status["nodes"] = nodes
        status["scrape_errors"] = errors
        status["interval_s"] = self.interval
        return status
