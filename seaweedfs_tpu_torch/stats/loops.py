"""Control-plane observatory: per-tick telemetry for master loops.

Counterpart of `seaweedfs_tpu/stats/loops.py`, whole.  The master runs
a dozen background loops (aggregator scrape, history record, alert
evaluation, capacity forecast, interference observe, governor, canary,
membership expiry, the repair planner, convert scheduler and
autopilot).  Each was a black box: the only way to see one
falling behind was secondary damage (stale scrape-age alerts, repair
backlog).  `LoopMonitor` gives every loop the same four vital signs —
wall seconds, CPU seconds, items processed, backlog depth — plus
overrun detection (tick wall time > loop interval) and a last-error
slot, exported as bounded-cardinality metrics (the `loop` label is a
closed set of master loop names) and surfaced on /cluster/loops.

Usage::

    with monitor.tick("repair", interval=15.0) as t:
        actions = await planner.tick()
        t.items = len(actions)
        t.backlog = planner.queue_depth()

The tick context is exception-transparent: a raising tick is still
timed, its error recorded, and the exception re-raised so the loop's
own guard keeps its existing semantics.

CPU attribution caveat: CPU seconds are measured as the calling
thread's `thread_time` delta across the tick.  For loops that run on
their own thread (aggregator) this is exact; for asyncio loops that
await work dispatched to other threads (`to_thread`, executors) the
offloaded CPU is attributed to those threads, so the reported value is
the loop's *coordination* cost — which is precisely the part that can
stall the event loop.

Self-accounting: subsystems register cardinality providers
(`add_cardinality(name, fn)`); `refresh_accounting()` stamps
weedtpu_subsystem_entries{subsystem} so state growth (alert groups,
interference node states, registry series, ...) is a queryable series
rather than an RSS surprise.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

from seaweedfs_tpu_torch.stats import metrics
from seaweedfs_tpu_torch.utils import weedlog


class _Tick:
    """One in-flight tick; set ``items``/``backlog`` before exit."""

    __slots__ = ("monitor", "loop", "interval", "items", "backlog",
                 "_t0", "_c0")

    def __init__(self, monitor: "LoopMonitor", loop: str,
                 interval: float | None):
        self.monitor = monitor
        self.loop = loop
        self.interval = interval
        self.items: int | float = 0
        self.backlog: int | float = 0
        self._t0 = 0.0
        self._c0 = 0.0

    def __enter__(self) -> "_Tick":
        self._t0 = time.perf_counter()
        self._c0 = time.thread_time()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        wall = time.perf_counter() - self._t0
        cpu = max(0.0, time.thread_time() - self._c0)
        err = None
        if exc is not None:
            err = f"{exc_type.__name__}: {exc}"
        self.monitor._record(self.loop, wall, cpu, self.items,
                             self.backlog, self.interval, err)
        return False  # re-raise; the loop's own guard decides policy


class LoopMonitor:
    """Shared per-loop tick telemetry + subsystem cardinality accounting."""

    def __init__(self):
        self._lock = threading.Lock()
        self._loops: dict[str, dict] = {}
        self._providers: dict[str, Callable[[], int]] = {}
        self._closed = False

    # ---- tick path ----------------------------------------------------

    def tick(self, loop: str, interval: float | None = None) -> _Tick:
        """Context manager timing one tick of ``loop``.

        ``interval`` is the loop's cadence in seconds; overrun detection
        and the overrun ratio need it.  Pass None (or ≤0) for loops
        without a fixed cadence — they never count as overrunning.
        """
        return _Tick(self, loop, interval)

    def _record(self, loop: str, wall: float, cpu: float,
                items: float, backlog: float,
                interval: float | None, err: str | None) -> None:
        now = time.time()
        overrun = bool(interval and interval > 0 and wall > interval)
        ratio = (wall / interval) if interval and interval > 0 else 0.0
        with self._lock:
            st = self._loops.get(loop)
            if st is None:
                st = self._loops[loop] = {
                    "ticks": 0, "errors": 0, "overruns": 0,
                    "wall_total": 0.0, "cpu_total": 0.0, "items_total": 0.0,
                    "wall_last": 0.0, "wall_ema": 0.0, "wall_max": 0.0,
                    "backlog": 0.0, "interval": None,
                    "last_error": None, "last_ts": 0.0,
                }
            st["ticks"] += 1
            st["wall_total"] += wall
            st["cpu_total"] += cpu
            st["items_total"] += items
            st["wall_last"] = wall
            st["wall_ema"] = (wall if st["ticks"] == 1
                              else 0.8 * st["wall_ema"] + 0.2 * wall)
            st["wall_max"] = max(st["wall_max"], wall)
            st["backlog"] = backlog
            st["interval"] = interval if interval and interval > 0 else None
            st["last_ts"] = now
            if overrun:
                st["overruns"] += 1
            if err is not None:
                st["errors"] += 1
                st["last_error"] = {"ts": now, "error": err[:500]}
        metrics.LOOP_TICK_SECONDS.labels(loop).observe(wall)
        metrics.LOOP_CPU_SECONDS.labels(loop).inc(cpu)
        if items:
            metrics.LOOP_ITEMS.labels(loop).inc(items)
        metrics.LOOP_BACKLOG.labels(loop).set(backlog)
        metrics.LOOP_OVERRUN_RATIO.labels(loop).set(ratio)
        if overrun:
            metrics.LOOP_OVERRUNS.labels(loop).inc()
            weedlog.warn_ratelimited(
                f"loop-overrun-{loop}", 60.0,
                "loop %s overran: tick %.3fs > interval %.1fs",
                loop, wall, interval, name="loops")
        if err is not None:
            metrics.LOOP_ERRORS.labels(loop).inc()

    # ---- self-accounting ----------------------------------------------

    def add_cardinality(self, subsystem: str,
                        fn: Callable[[], int]) -> None:
        """Register a live-entry counter for a stateful subsystem."""
        with self._lock:
            self._providers[subsystem] = fn

    def refresh_accounting(self) -> dict[str, int]:
        """Poll every provider and stamp weedtpu_subsystem_entries."""
        with self._lock:
            providers = list(self._providers.items())
        out: dict[str, int] = {}
        for name, fn in providers:
            try:
                n = int(fn())
            except Exception as e:  # a broken provider must not kill a loop
                weedlog.V(1, "loops").infof(
                    "cardinality provider %s failed: %s", name, e)
                continue
            out[name] = n
            metrics.SUBSYSTEM_ENTRIES.labels(name).set(n)
        return out

    # ---- reporting ----------------------------------------------------

    def status(self) -> dict:
        """Snapshot for /cluster/loops and the shell."""
        with self._lock:
            loops = {name: dict(st) for name, st in self._loops.items()}
        for st in loops.values():
            st["wall_avg"] = (st["wall_total"] / st["ticks"]
                              if st["ticks"] else 0.0)
            iv = st["interval"]
            st["overrun_ratio"] = (st["wall_last"] / iv) if iv else 0.0
        return {"ts": time.time(), "loops": loops,
                "subsystems": self.refresh_accounting()}

    def headline(self) -> str:
        """One-line digest: slowest loop (by EMA wall) + any overrunning."""
        with self._lock:
            loops = {name: dict(st) for name, st in self._loops.items()}
        if not loops:
            return "no ticks yet"
        slowest = max(loops.items(), key=lambda kv: kv[1]["wall_ema"])
        over = sorted(name for name, st in loops.items()
                      if st["interval"] and st["wall_last"] > st["interval"])
        line = (f"slowest={slowest[0]} "
                f"ema={slowest[1]['wall_ema'] * 1000:.1f}ms")
        if over:
            line += " OVERRUN:" + ",".join(over)
        return line

    def close(self) -> None:
        """Retire this monitor's metric children (per-loop + subsystem)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            loops = list(self._loops)
            subs = list(self._providers)
            self._loops.clear()
            self._providers.clear()
        for name in loops:
            for m in (metrics.LOOP_TICK_SECONDS, metrics.LOOP_CPU_SECONDS,
                      metrics.LOOP_ITEMS, metrics.LOOP_OVERRUNS,
                      metrics.LOOP_ERRORS, metrics.LOOP_BACKLOG,
                      metrics.LOOP_OVERRUN_RATIO):
                m.remove_matching(loop=name)
        for name in subs:
            metrics.SUBSYSTEM_ENTRIES.remove_matching(subsystem=name)
