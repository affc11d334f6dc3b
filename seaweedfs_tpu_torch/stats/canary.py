"""Always-on canary probes: synthetic traffic through every gateway path.

Counterpart of `seaweedfs_tpu/stats/canary.py`, whole: the
`CanaryProber` and the geo plane's `DivergenceAuditor` (at the end).  The SLO engine (stats/aggregate.py) is availability-blind between real
requests — a cluster serving nobody reports "ok" right up until the
first user request fails.  The canary closes that gap: a background loop
on the master writes, reads back (byte-compared), and deletes sentinel
blobs through each data path —

- ``blob``     master assign -> volume PUT/GET/DELETE (the raw path)
- ``s3``       PUT/GET/DELETE an object through a registered s3 gateway
- ``filer``    PUT/GET/DELETE a file through a registered filer
- ``degraded`` a reconstruction read: the volume server's
  ``/admin/ec/probe_read`` reads a real needle from an EC volume with
  one present shard DELIBERATELY skipped, exercising the decode path
  the cluster will need on its worst day

Each probe runs under its own **pinned, sampled trace id** (stats/trace
``pin_trace``), so a failed probe arrives with a ready-made cross-node
waterfall — ``/cluster/trace/<tid>`` stitches it without hoping the
sampler kept the spans.  Outcomes feed
``weedtpu_canary_probes_total{path,class}`` (class = 2xx/5xx) which the
default ``canary_availability`` SLO rule consumes, plus a per-path
latency histogram.  Probe bytes are classed ``internal`` in the netflow
ledger — synthetic traffic must not pollute the data-plane byte counts.

Knob: ``WEEDTPU_CANARY_INTERVAL`` seconds between probe rounds (default
30, <=0 disables the loop — probes then run only on demand); a malformed
value raises ValueError where the reference falls back, and the master
reads it at construction, before its socket binds.  A round probes every
path of ``ALL_PATHS`` (the reference's WEEDTPU_CANARY_PATHS, which
nothing sets to a second value); ``run_once(paths)`` probes a subset.
Without an s3 gateway or a filer among the master's members those
probes skip, as the reference's do.
"""

from __future__ import annotations

import asyncio
import os
import random
import time
from collections import deque

from seaweedfs_tpu_torch.security.tls import scheme as _tls_scheme
from seaweedfs_tpu_torch.stats import metrics, netflow, trace
from seaweedfs_tpu_torch.utils import weedlog

ALL_PATHS = ("blob", "s3", "filer", "degraded")

_PAYLOAD = bytes(random.Random(0x5EED).getrandbits(8)
                 for _ in range(4096))


def canary_interval() -> float:
    """WEEDTPU_CANARY_INTERVAL: seconds between rounds (<= 0: off)."""
    raw = os.environ.get("WEEDTPU_CANARY_INTERVAL", "").strip()
    if not raw:
        return 30.0
    try:
        return float(raw)
    except ValueError:
        raise ValueError(f"WEEDTPU_CANARY_INTERVAL={raw!r}: want seconds") \
            from None


class ProbeFailure(Exception):
    pass


class CanaryProber:
    """One prober per master; probes run on the master's event loop via
    its ClientSession (so trace propagation and byte accounting come for
    free).  ``run_once()`` is the deterministic hook tests and
    chip_smoke.py drive; the background loop just calls it on a
    timer."""

    LATENCY_WINDOW = 256  # per-path rolling latencies for p50/p99

    def __init__(self, master):
        self.master = master
        self._task: asyncio.Task | None = None
        self._seq = 0
        # path -> {outcome, ms, trace_id, ts, error, fails, waterfall}
        self.state: dict[str, dict] = {}
        self._lat: dict[str, deque] = {}

    # -- lifecycle -------------------------------------------------------

    def start(self, interval: float | None = None) -> "CanaryProber":
        """Start the probe loop (call on the master's event loop)."""
        iv = canary_interval() if interval is None else interval
        if iv > 0 and self._task is None:
            self._task = asyncio.get_running_loop().create_task(
                self._run(iv))
        return self

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def _run(self, interval: float) -> None:
        from seaweedfs_tpu_torch.utils.resilience import Backoff
        bo = Backoff(base=interval, cap=max(interval * 8, 60.0))
        delay = interval
        while True:
            await asyncio.sleep(delay)
            delay = interval
            if not self.master.is_leader or not self.master.topo.nodes:
                continue  # nothing to probe (or not our job)
            try:
                await self.run_once()
                bo.reset()
            except Exception as e:  # the loop must survive anything;
                # a HARNESS failure (not a probe outcome — those are
                # state) backs off with jitter instead of hammering a
                # cluster that is clearly having a bad day
                delay = bo.next()
                weedlog.V(1, "canary").infof(
                    "probe round failed: %s: %s", type(e).__name__, e,
                    exc_info=True)

    # -- probing ---------------------------------------------------------

    async def run_once(self, paths: tuple[str, ...] | None = None) -> dict:
        paths = tuple(paths or ALL_PATHS)
        monitor = getattr(self.master, "loops", None)
        if monitor is None:
            for path in paths:
                await self._probe(path)
            return self.status()
        iv = canary_interval()
        with monitor.tick("canary", interval=iv if iv > 0 else None) as lt:
            lt.items = len(paths)
            for path in paths:
                await self._probe(path)
        return self.status()

    async def _probe(self, path: str) -> None:
        """One probe under its own pinned, sampled root trace.  Outcome
        accounting: ok -> 2xx, failure -> 5xx, skip (path not wired in
        this cluster: no s3 member, auth wall, no EC volume) -> state
        only, never an SLO event."""
        fn = getattr(self, f"_probe_{path}")
        root = trace.new_root(sampled=True)
        trace.pin_trace(root.trace_id)
        tok = trace._current.set(root)
        t0 = time.perf_counter()
        outcome, err = "ok", ""
        try:
            with netflow.flow("internal"), \
                    trace.span(f"canary.{path}") as sp:
                skipped = await fn()
                if skipped:
                    outcome = "skip"
                    sp.set(skipped=True)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            outcome, err = "fail", f"{type(e).__name__}: {e}"
        finally:
            trace._current.reset(tok)
        ms = (time.perf_counter() - t0) * 1000.0
        if outcome != "skip":
            metrics.CANARY_PROBES.labels(
                path, "2xx" if outcome == "ok" else "5xx").inc()
            metrics.CANARY_PROBE_SECONDS.labels(path).observe(
                ms / 1000.0, root.trace_id)
            lat = self._lat.setdefault(
                path, deque(maxlen=self.LATENCY_WINDOW))
            lat.append(ms)
            # rolling-window quantiles as direct gauges: the history
            # plane records them per tick, so /cluster/dashboard gets
            # per-path latency trends without histogram-bucket math
            win = list(lat)
            for q, qs in ((0.50, "0.5"), (0.99, "0.99")):
                v = self._quantile(win, q)
                if v is not None:
                    metrics.CANARY_LATENCY.labels(path, qs).set(
                        round(v / 1000.0, 6))
        prev = self.state.get(path, {})
        rec = {"outcome": outcome, "ms": round(ms, 3),
               "trace_id": root.trace_id, "ts": time.time(),
               "fails": 0 if outcome != "fail"
               else prev.get("fails", 0) + 1}
        if err:
            rec["error"] = err
        if outcome == "fail":
            weedlog.info("canary %s probe FAILED (%s) trace=%s", path,
                         err, root.trace_id, name="canary")
            # the ready-made waterfall: assemble (and thereby pin on
            # every hop) while the spans are certainly still in the
            # rings
            try:
                rec["waterfall"] = await asyncio.to_thread(
                    self.master.collect_trace, root.trace_id)
            except Exception:
                pass
        self.state[path] = rec

    def _member(self, kind: str) -> str | None:
        horizon = time.time() - 30.0
        members = self.master.cluster_members.get(kind, {})
        fresh = sorted(a for a, ts in members.items() if ts > horizon)
        return fresh[0] if fresh else None

    def _sentinel(self) -> str:
        self._seq += 1
        return f"canary-{os.getpid()}-{self._seq}"

    async def _probe_blob(self) -> bool:
        s = self.master._session
        scheme = _tls_scheme()
        async with s.get(f"{scheme}://{self.master.url}/dir/assign") as r:
            if r.status != 200:
                raise ProbeFailure(f"assign HTTP {r.status}")
            a = await r.json()
            if "error" in a:
                raise ProbeFailure(f"assign: {a['error']}")
        url = f"{scheme}://{a['url']}/{a['fid']}"
        headers = {"Content-Type": "application/octet-stream"}
        if a.get("auth"):
            headers["Authorization"] = "Bearer " + a["auth"]
        async with s.put(url, data=_PAYLOAD, headers=headers) as r:
            if r.status >= 300:
                raise ProbeFailure(f"blob PUT HTTP {r.status}")
        async with s.get(url, headers=headers) as r:
            if r.status != 200:
                raise ProbeFailure(f"blob GET HTTP {r.status}")
            body = await r.read()
        if body != _PAYLOAD:
            raise ProbeFailure(
                f"blob readback mismatch ({len(body)} bytes)")
        async with s.delete(url, headers=headers) as r:
            if r.status >= 300:
                raise ProbeFailure(f"blob DELETE HTTP {r.status}")
        return False

    async def _probe_s3(self) -> bool:
        gw = self._member("s3")
        if gw is None:
            return True
        s = self.master._session
        base = f"{_tls_scheme()}://{gw}"
        key = self._sentinel()
        # ensure the probe bucket exists (409 = already ours)
        async with s.put(f"{base}/canary-probe") as r:
            if r.status in (401, 403):
                return True  # auth wall, no canary creds: not an outage
            if r.status >= 300 and r.status != 409:
                raise ProbeFailure(f"s3 bucket PUT HTTP {r.status}")
        async with s.put(f"{base}/canary-probe/{key}",
                         data=_PAYLOAD) as r:
            if r.status >= 300:
                raise ProbeFailure(f"s3 PUT HTTP {r.status}")
        async with s.get(f"{base}/canary-probe/{key}") as r:
            if r.status != 200:
                raise ProbeFailure(f"s3 GET HTTP {r.status}")
            body = await r.read()
        if body != _PAYLOAD:
            raise ProbeFailure(f"s3 readback mismatch ({len(body)} bytes)")
        async with s.delete(f"{base}/canary-probe/{key}") as r:
            if r.status >= 300:
                raise ProbeFailure(f"s3 DELETE HTTP {r.status}")
        return False

    async def _probe_filer(self) -> bool:
        filer = self._member("filer")
        if filer is None:
            return True
        s = self.master._session
        url = f"{_tls_scheme()}://{filer}/.canary/{self._sentinel()}"
        async with s.put(url, data=_PAYLOAD) as r:
            if r.status in (401, 403):
                return True  # filer JWT wall: not an outage
            if r.status >= 300:
                raise ProbeFailure(f"filer PUT HTTP {r.status}")
        async with s.get(url) as r:
            if r.status != 200:
                raise ProbeFailure(f"filer GET HTTP {r.status}")
            body = await r.read()
        if body != _PAYLOAD:
            raise ProbeFailure(
                f"filer readback mismatch ({len(body)} bytes)")
        async with s.delete(url) as r:
            if r.status >= 300:
                raise ProbeFailure(f"filer DELETE HTTP {r.status}")
        return False

    async def _probe_degraded(self) -> bool:
        """Reconstruction read: find any EC volume, ask a node holding
        shards of it to read a real needle with one present shard
        skipped.  No EC volume in the cluster -> skip."""
        target: tuple[str, int] | None = None
        with self.master.topo._lock:
            for node in self.master.topo.nodes.values():
                for vid, shards in node.ec_shards.items():
                    if shards:
                        target = (node.url, vid)
                        break
                if target:
                    break
        if target is None:
            return True
        node_url, vid = target
        s = self.master._session
        async with s.get(f"{_tls_scheme()}://{node_url}"
                         f"/admin/ec/probe_read",
                         params={"volume": str(vid)}) as r:
            body = await r.json()
            if r.status == 404 and body.get("error") == "no needles":
                return True  # empty EC volume: nothing to read
            if r.status != 200:
                raise ProbeFailure(
                    f"degraded read HTTP {r.status}: "
                    f"{body.get('error', '')}")
        if not body.get("bytes", 0):
            raise ProbeFailure("degraded read returned no bytes")
        return False

    # -- views -----------------------------------------------------------

    @staticmethod
    def _quantile(values: list[float], q: float) -> float | None:
        if not values:
            return None
        vs = sorted(values)
        return vs[min(len(vs) - 1, int(q * len(vs)))]

    def status(self) -> dict:
        paths = {}
        for path, rec in sorted(self.state.items()):
            lat = list(self._lat.get(path, ()))
            r = dict(rec)
            r["p50_ms"] = self._quantile(lat, 0.50)
            r["p99_ms"] = self._quantile(lat, 0.99)
            r["samples"] = len(lat)
            paths[path] = r
        return {"interval_s": canary_interval(),
                "enabled_paths": list(ALL_PATHS),
                "running": self._task is not None, "paths": paths}


# -- geo divergence auditor ---------------------------------------------

def geo_audit_interval() -> float:
    """WEEDTPU_GEO_AUDIT_INTERVAL: seconds between divergence audits
    (<= 0 turns the loop off; ``run_once()`` still works on demand).  A
    malformed value raises ValueError where the reference falls back to
    30; an auditor reads it when it is built."""
    raw = os.environ.get("WEEDTPU_GEO_AUDIT_INTERVAL", "").strip()
    if not raw:
        return 30.0
    try:
        return float(raw)
    except ValueError:
        raise ValueError(f"WEEDTPU_GEO_AUDIT_INTERVAL={raw!r}: want "
                         f"seconds") from None


class DivergenceAuditor:
    """Canary-style background prober for the geo-replication plane:
    pull ``/__meta__/digest?prefix=`` from BOTH filers of a FilerSync
    pair and publish ``weedtpu_geo_divergence{prefix}`` (0 = the
    subtree content digests are byte-identical, 1 = the regions have
    diverged).  Divergence is EXPECTED while replication is catching up
    — the signal that matters is the gauge returning to 0 after a heal,
    which is ROADMAP item 3's convergence proof.

    Thread-based (it lives beside the sync pumps, not on a server's
    event loop); probe traffic stays class=internal so the replication
    byte-conservation ledger holds pure data.  ``run_once()`` is the
    deterministic hook the chaos tests and the bench drive; the loop
    waits a full interval before its first probe so short-lived syncs
    never pay for it."""

    def __init__(self, filer_a: str, filer_b: str, prefix: str = "/",
                 region_a: str = "", region_b: str = "",
                 timeout: float = 30.0, http=None):
        import threading
        from seaweedfs_tpu_torch.utils.http import PooledHTTP
        geo_audit_interval()  # a malformed knob raises here
        self.filer_a, self.filer_b = filer_a, filer_b
        self.prefix = prefix
        self.region_a, self.region_b = region_a, region_b
        self.timeout = timeout
        self._own_http = http is None
        self.http = http or PooledHTTP(timeout=timeout, role="replicator")
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # last audit outcome: {outcome, diverged, digests, entries, ts}
        self.state: dict = {}
        self.audits = 0

    def start(self, interval: float | None = None) -> "DivergenceAuditor":
        import threading
        iv = geo_audit_interval() if interval is None else interval
        if iv > 0 and self._thread is None:
            self._thread = threading.Thread(
                target=self._run, args=(iv,), daemon=True,
                name=f"geo-audit-{self.prefix}")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        th, self._thread = self._thread, None
        if th is not None:
            th.join(2)
        if self._own_http:
            self.http.close()

    def _run(self, interval: float) -> None:
        while not self._stop.wait(interval):
            try:
                self.run_once()
            except Exception as e:  # must survive anything
                weedlog.V(1, "canary").infof(
                    "geo audit failed: %s: %s", type(e).__name__, e)

    def _digest(self, filer: str) -> dict:
        import json as _json
        import urllib.parse as _up
        url = (f"{_tls_scheme()}://{filer}/__meta__/digest?"
               + _up.urlencode({"prefix": self.prefix}))
        status, _, body = self.http.request(url, timeout=self.timeout)
        if status != 200:
            raise OSError(f"digest HTTP {status} from {filer}")
        return _json.loads(body)

    def run_once(self) -> dict:
        """One audit pass; returns (and stores) the outcome record."""
        self.audits += 1
        ts = time.time()
        try:
            da = self._digest(self.filer_a)
            db = self._digest(self.filer_b)
        except (OSError, ValueError) as e:
            # an unreachable filer is NOT divergence — the lag plane
            # owns that signal; the gauge keeps its last honest value
            metrics.GEO_AUDITS.labels("error").inc()
            self.state = {"outcome": "error", "ts": ts,
                          "error": f"{type(e).__name__}: {e}"}
            return self.state
        diverged = da.get("digest") != db.get("digest")
        metrics.GEO_DIVERGENCE.labels(self.prefix).set(
            1 if diverged else 0)
        metrics.GEO_AUDITS.labels(
            "diverged" if diverged else "clean").inc()
        self.state = {
            "outcome": "diverged" if diverged else "clean", "ts": ts,
            "diverged": diverged,
            "digests": {self.filer_a: da.get("digest"),
                        self.filer_b: db.get("digest")},
            "entries": {self.filer_a: da.get("entries"),
                        self.filer_b: db.get("entries")}}
        return self.state

    def status(self) -> dict:
        return {"prefix": self.prefix, "interval_s": geo_audit_interval(),
                "running": self._thread is not None,
                "audits": self.audits, "last": dict(self.state)}
