"""Pipeline occupancy accounting: the data plane's performance observatory.

Counterpart of `seaweedfs_tpu/stats/pipeline.py`:

- **PipelineJob**: stage accounting of one pipeline run (an encode, a
  rebuild, a fleet conversion) wrapped around the run's stats dict, whose
  ``<stage>_s`` seconds stay the source of stage time; the job adds
  bytes and items per stage, queue-depth high-water marks, blocked time,
  and a registry that makes the run observable while it runs.
  ``bottleneck()`` names the stage whose busy fraction bounds the run
  and, where the ceiling of that stage's resource is known
  (stats/profile.py), how close to it the stage ran.
- **FlowAccount**: the never-finishing twin for long-lived engines (the
  EC read path), whose stage counters' rates are stage occupancy.

``WEEDTPU_PERF_OBS=0`` turns the plane off: `track` then registers no
job and exports nothing, though the stats dict still gets its seconds.
`local_snapshot` is what the volume server serves at `/perf` (open, for
the master's /cluster/perf fan-out) and `/debug/pipeline` (loopback);
the master merges the fleet's payloads (`aggregate_fleet`) and ranks
the kernel rows furthest from their ceilings (`roofline_offenders`).
The tile-drift sentinel comes with the launch pin (ROADMAP 1.7).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
import uuid

from seaweedfs_tpu_torch.stats import metrics, profile

# -- knobs -----------------------------------------------------------------

_enabled_cache: tuple[float, bool] = (0.0, True)


def perf_obs_enabled() -> bool:
    """WEEDTPU_PERF_OBS != "0" (default on), cached ~0.5 s so a hot-path
    check costs a tuple compare."""
    global _enabled_cache
    now = time.monotonic()
    ts, val = _enabled_cache
    if now - ts > 0.5:
        val = os.environ.get("WEEDTPU_PERF_OBS", "1") != "0"
        _enabled_cache = (now, val)
    return val


# finished jobs kept for the snapshot, the reference's default
PERF_OBS_JOBS = 32


# -- the job registry ------------------------------------------------------

# one id per process, so a fleet view counts co-hosted nodes once
TRACKER_ID = uuid.uuid4().hex
_seq = itertools.count(1)
_reg_lock = threading.Lock()
_active: dict[int, "PipelineJob"] = {}
_recent: collections.deque = collections.deque(maxlen=PERF_OBS_JOBS)
_flows: dict[str, "FlowAccount"] = {}

# stages that are waiting, not working: left out of busy fractions and of
# the bottleneck verdict
IDLE_STAGES = ("stall", "blocked", "idle")

# stage -> the hardware resource whose ceiling (stats/profile.py) it is
# judged against
STAGE_RESOURCE = {
    "encode": "device", "reconstruct": "device", "d2h": "d2h",
    "read": "disk", "local_pread": "disk",
    "write": "disk", "write_data": "disk", "write_parity": "disk",
    # the write engine's finer cut of the write stages (storage/aio.py):
    # submission against completion reaping, the same disk
    "submit": "disk", "complete": "disk",
    "remote_fetch": "net",
}


class _StageTimer:
    __slots__ = ("_job", "_stage", "_nbytes", "_items", "_blocked", "_t0")

    def __init__(self, job, stage, nbytes, items, blocked):
        self._job = job
        self._stage = stage
        self._nbytes = nbytes
        self._items = items
        self._blocked = blocked

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._job._book(self._stage, time.perf_counter() - self._t0,
                        self._nbytes, self._items, self._blocked)
        return False


class PipelineJob:
    """Stage accounting of one pipeline run, wrapped around its stats
    dict (whose ``<stage>_s`` keys, writer-pool seconds included, stay
    the stage times); adds bytes and items per stage, queue depths,
    blocked time, liveness and registration."""

    def __init__(self, kind: str, stats: dict | None = None,
                 total_bytes: int = 0, meta: dict | None = None,
                 register: bool = True):
        self.kind = kind
        self.stats = stats if stats is not None else {}
        self.total_bytes = total_bytes
        self.meta = meta or {}
        self.started = time.time()
        self._t0 = time.perf_counter()
        self.wall_s: float | None = None
        self.state = "running"
        self.error: str | None = None
        self.job_id = next(_seq)
        self._lock = threading.Lock()
        # stage -> [busy_s, blocked_s, bytes, items]
        self._stages: dict[str, list[float]] = {}
        # queue -> [last, max, sum, samples, bound]
        self._queues: dict[str, list[float]] = {}
        self._registered = register and perf_obs_enabled()
        if self._registered:
            with _reg_lock:
                _active[self.job_id] = self

    # -- accounting --------------------------------------------------------

    def stage(self, name: str, nbytes: float = 0.0,
              items: float = 1.0) -> _StageTimer:
        """Context manager bracketing productive work of `name`."""
        return _StageTimer(self, name, nbytes, items, False)

    def blocked(self, name: str) -> _StageTimer:
        """Context manager bracketing time `name` spent backpressured on
        a downstream queue; never counted as busy."""
        return _StageTimer(self, name, 0.0, 0.0, True)

    def _book(self, name: str, secs: float, nbytes: float, items: float,
              blocked: bool) -> None:
        with self._lock:
            row = self._stages.get(name)
            if row is None:
                row = self._stages[name] = [0.0, 0.0, 0.0, 0.0]
            row[1 if blocked else 0] += secs
            row[2] += nbytes
            row[3] += items

    def add_bytes(self, name: str, nbytes: float,
                  items: float = 0.0) -> None:
        self._book(name, 0.0, nbytes, items, False)

    def queue(self, name: str, depth: int, bound: int = 0) -> None:
        """Sample a queue's depth (at its put or get site)."""
        with self._lock:
            q = self._queues.get(name)
            if q is None:
                q = self._queues[name] = [0.0, 0.0, 0.0, 0.0, float(bound)]
            q[0] = depth
            if depth > q[1]:
                q[1] = depth
            q[2] += depth
            q[3] += 1
            if bound:
                q[4] = float(bound)

    def finish(self, error: BaseException | str | None = None) -> None:
        """Seal the job: stamp the wall clock, book the stage seconds and
        bytes counters, move it from the active registry to the recent
        ring."""
        with self._lock:
            if self.state != "running":
                return
            self.wall_s = time.perf_counter() - self._t0
            self.state = "failed" if error else "done"
            if error:
                self.error = str(error) or type(error).__name__
        if self._registered:
            with _reg_lock:
                _active.pop(self.job_id, None)
                _recent.append(self)
            for stage, row in self.snapshot()["stages"].items():
                if row["busy_s"]:
                    # occupancy seconds: an N-worker stage's summed busy
                    # seconds divide by N, so a saturated stage's rate
                    # tops out at 1/s
                    metrics.PIPELINE_STAGE_SECONDS.labels(
                        self.kind, stage).inc(
                            row["busy_s"] / row.get("workers", 1))
                if row["bytes"]:
                    metrics.PIPELINE_STAGE_BYTES.labels(
                        self.kind, stage).inc(row["bytes"])

    def __enter__(self):
        return self

    def __exit__(self, etype, exc, tb):
        self.finish(exc)
        return False

    # -- rendering ---------------------------------------------------------

    def _stats_stage_seconds(self) -> dict[str, float]:
        """Stage seconds from the wrapped stats dict (`wall_s` is the
        clock)."""
        out: dict[str, float] = {}
        for key, v in list(self.stats.items()):
            if key.endswith("_s") and key != "wall_s" and \
                    isinstance(v, (int, float)):
                out[key[:-2]] = float(v)
        return out

    def snapshot(self) -> dict:
        with self._lock:
            stages_own = {k: list(v) for k, v in self._stages.items()}
            queues = {k: list(v) for k, v in self._queues.items()}
            # the stats dict's wall_s is the run's clock when the pipeline
            # stamped one; the job's own bracket includes set-up
            wall = self.stats.get("wall_s")
            if not isinstance(wall, (int, float)) or wall <= 0:
                wall = self.wall_s if self.wall_s is not None \
                    else time.perf_counter() - self._t0
            state, error = self.state, self.error
        merged: dict[str, dict] = {}
        for name, secs in self._stats_stage_seconds().items():
            merged[name] = {"busy_s": secs, "blocked_s": 0.0,
                            "bytes": 0.0, "items": 0.0}
        for name, (busy, blocked, nbytes, items) in stages_own.items():
            row = merged.setdefault(
                name, {"busy_s": 0.0, "blocked_s": 0.0, "bytes": 0.0,
                       "items": 0.0})
            # the stats dict's seconds win where both timed a stage
            if row["busy_s"] == 0.0:
                row["busy_s"] = busy
            row["blocked_s"] += blocked
            row["bytes"] += nbytes
            row["items"] += items
        # the idle stages are waiting, not work
        for name in list(merged):
            if name in IDLE_STAGES:
                row = merged.pop(name)
                merged.setdefault(
                    "_idle", {"busy_s": 0.0, "blocked_s": 0.0,
                              "bytes": 0.0, "items": 0.0})
                merged["_idle"]["blocked_s"] += row["busy_s"] + \
                    row["blocked_s"]
        idle = merged.pop("_idle", None)
        wall = max(wall, 1e-9)
        for name, row in merged.items():
            # a stage served by N parallel workers (`<stage>_workers`,
            # possibly fractional: a pool's threads split across its
            # stages by busy share) is judged on its occupancy
            w = self.stats.get(f"{name}_workers")
            if isinstance(w, (int, float)) and w > 1:
                row["workers"] = round(float(w), 2)
            else:
                w = 1
            row["busy_frac"] = round(row["busy_s"] / (w * wall), 4)
            for k in ("busy_s", "blocked_s", "bytes", "items"):
                row[k] = round(row[k], 6)
        snap = {
            "id": self.job_id, "kind": self.kind, "state": state,
            "started": round(self.started, 3), "wall_s": round(wall, 4),
            "bytes": self.total_bytes or self.stats.get("bytes", 0),
            "stages": merged,
            "queues": {k: {"last": int(q[0]), "max": int(q[1]),
                           "avg": round(q[2] / q[3], 2) if q[3] else 0.0,
                           "bound": int(q[4])}
                       for k, q in queues.items()},
        }
        if idle is not None:
            snap["blocked_s"] = round(idle["blocked_s"], 4)
        if error:
            snap["error"] = error
        if self.meta:
            snap["meta"] = dict(self.meta)
        bn = bottleneck(snap)
        if bn is not None:
            snap["bottleneck"] = bn
        return snap


class FlowAccount(PipelineJob):
    """A never-finishing PipelineJob for a long-lived engine (the EC
    degraded-read path): cumulative stage seconds and bytes, exported as
    they are booked, so the counters' rates are live occupancy.  One per
    (process, kind)."""

    def __init__(self, kind: str):
        super().__init__(kind, register=False)
        self.state = "flow"
        # per-stage (seconds, bytes) counter children, resolved once
        self._children: dict[str, tuple] = {}
        with _reg_lock:
            # the first registration wins; a racing creator books to the
            # same counters either way
            _flows.setdefault(kind, self)

    def _stage_counters(self, name: str) -> tuple:
        pair = self._children.get(name)
        if pair is None:
            pair = (metrics.PIPELINE_STAGE_SECONDS.labels(self.kind, name),
                    metrics.PIPELINE_STAGE_BYTES.labels(self.kind, name))
            self._children[name] = pair
        return pair

    def _book(self, name, secs, nbytes, items, blocked):
        super()._book(name, secs, nbytes, items, blocked)
        if blocked or not perf_obs_enabled():
            return
        pair = self._stage_counters(name)
        if secs:
            pair[0].inc(secs)
        if nbytes:
            pair[1].inc(nbytes)

    def stage(self, name, nbytes=0.0, items=1.0):
        if not perf_obs_enabled():
            return contextlib.nullcontext()
        return super().stage(name, nbytes, items)


def track(kind: str, stats: dict | None = None, total_bytes: int = 0,
          meta: dict | None = None) -> PipelineJob:
    """The job a pipeline wraps itself in::

        with pipeline.track("ec_encode", stats, dat_size) as job:
            ... job.queue("q_read", q.qsize()) ...

    With the observatory off the job is neither registered nor
    exported."""
    return PipelineJob(kind, stats, total_bytes, meta)


def flow(kind: str) -> FlowAccount:
    # no lock on the hit: dict.get is atomic, and this rides every read
    acct = _flows.get(kind)
    if acct is not None:
        return acct
    FlowAccount(kind)  # registers itself (the first one wins)
    return _flows[kind]


def jobs_snapshot(limit: int | None = None) -> list[dict]:
    """Recent and running jobs, newest first, then the flow accounts."""
    with _reg_lock:
        jobs = list(_active.values()) + list(_recent)
        flows = list(_flows.values())
    out = [j.snapshot() for j in jobs]
    out.sort(key=lambda s: -s["started"])
    if limit:
        out = out[:limit]
    return out + [f.snapshot() for f in flows]


def reset() -> None:
    """Drop every retained job and flow account."""
    global _recent
    with _reg_lock:
        _active.clear()
        _recent = collections.deque(maxlen=PERF_OBS_JOBS)
        _flows.clear()


# -- bottleneck attribution ------------------------------------------------

def bottleneck(snap: dict) -> dict | None:
    """The stage whose busy fraction bounds the job: stages run
    concurrently, so the wall clock cannot beat the most occupied one.
    Busy seconds break ties.  Where the stage moved bytes and maps to a
    resource with a measured ceiling (stats/profile.py), its achieved
    rate over that ceiling too."""
    stages = snap.get("stages") or {}
    best_name, best = None, None
    for name, row in stages.items():
        if name in IDLE_STAGES or row.get("busy_s", 0.0) <= 0:
            continue
        key = (row.get("busy_frac", 0.0), row["busy_s"])
        if best is None or key > best:
            best_name, best = name, key
    if best_name is None:
        return None
    row = stages[best_name]
    out = {"stage": best_name,
           "busy_frac": row.get("busy_frac", 0.0)}
    if row.get("bytes"):
        # N workers' summed seconds cover the bytes in busy_s / N of wall
        active = row["busy_s"] / row.get("workers", 1)
        gbps = row["bytes"] / 1e9 / max(active, 1e-9)
        out["achieved_gbps"] = round(gbps, 3)
        resource = STAGE_RESOURCE.get(best_name)
        if resource is not None:
            ceil = profile.ceilings().get(resource)
            if ceil:
                out["resource"] = resource
                out["ceiling_gbps"] = round(ceil, 3)
                out["ceiling_frac"] = round(min(gbps / ceil, 9.99), 3)
    return out


# -- fleet aggregation (master /cluster/perf) ------------------------------

def aggregate_fleet(per_node: list[tuple[str, dict]]) -> dict:
    """Merge per-node /debug/pipeline payloads into fleet occupancy:
    per (kind, stage) busy seconds / bytes / max busy fraction across
    every reporting node, the currently-running jobs, the worst
    bottleneck verdict per kind, and every node's tile-drift verdict.
    Payloads from nodes sharing one process (the all-in-one binary,
    in-process test clusters) carry the same tracker ``id`` and are
    merged once, not once per node."""
    occupancy: dict[str, dict[str, dict]] = {}
    running: list[dict] = []
    verdicts: dict[str, dict] = {}
    tiles: dict[str, dict] = {}
    seen: set[str] = set()
    nodes: list[str] = []
    for node, payload in per_node:
        tid = payload.get("id")
        if tid is not None and tid in seen:
            continue
        if tid is not None:
            seen.add(tid)
        nodes.append(node)
        tile = payload.get("tile")
        if tile:
            tiles[node] = tile
        for job in payload.get("jobs", []):
            kind = job.get("kind", "?")
            krow = occupancy.setdefault(kind, {})
            for stage, row in (job.get("stages") or {}).items():
                srow = krow.setdefault(
                    stage, {"busy_s": 0.0, "bytes": 0.0, "jobs": 0,
                            "max_busy_frac": 0.0})
                srow["busy_s"] = round(srow["busy_s"] + row["busy_s"], 4)
                srow["bytes"] += row.get("bytes", 0.0)
                srow["jobs"] += 1
                if row.get("busy_frac", 0.0) > srow["max_busy_frac"]:
                    srow["max_busy_frac"] = row["busy_frac"]
            if job.get("state") == "running":
                running.append({"node": node, **job})
            bn = job.get("bottleneck")
            if bn:
                prev = verdicts.get(kind)
                if prev is None or bn.get("busy_frac", 0.0) > \
                        prev.get("busy_frac", 0.0):
                    verdicts[kind] = {"node": node, **bn}
    return {"nodes": nodes, "occupancy": occupancy,
            "bottlenecks": verdicts, "running": running, "tiles": tiles}


def roofline_offenders(roofline: dict, limit: int = 5) -> list[dict]:
    """The busiest kernel/resource rows ranked by how far they run from
    their ceiling — the "what should the next perf round attack" list."""
    rows = [r for r in roofline.get("rows", [])
            if r.get("ceiling_frac") is not None and r.get("busy_s", 0.0)]
    rows.sort(key=lambda r: (r["ceiling_frac"], -r["busy_s"]))
    return rows[:limit]


def local_snapshot(limit: int = 16) -> dict:
    """What this process knows of its own data-plane performance: jobs
    and flows, and the kernel roofline."""
    return {"id": TRACKER_ID, "enabled": perf_obs_enabled(),
            "jobs": jobs_snapshot(limit),
            "roofline": profile.roofline_snapshot()}


async def handle_debug_pipeline(req):
    """``/debug/pipeline[?limit=N]``: `local_snapshot` as JSON, mounted
    loopback-gated by trace.debug_routes()."""
    from aiohttp import web
    try:
        limit = int(req.query.get("limit", "16"))
    except ValueError:
        limit = 16
    return web.json_response(local_snapshot(limit))


async def handle_perf(req):
    """``/perf``: the same payload, open on cluster-internal servers, for
    the master's /cluster/perf fan-out."""
    return await handle_debug_pipeline(req)
