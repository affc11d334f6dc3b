"""Profiling: a signal-free sampling profiler, the kernel profile, and the
roofline.

Counterpart of `seaweedfs_tpu/stats/profile.py`:

- **Host stacks**: `SamplingProfiler` walks ``sys._current_frames()``
  from one daemon thread at `hz` and folds every other thread's stack
  into a collapsed-stack table (``frame;frame;frame count``) and a
  self/total table.  No signals and no profile hooks: the sampled
  threads pay nothing, and every thread is seen (pipeline readers,
  drains, writers), not only the main one.
- **Kernel profile**: `KERNELS`, one row per data-plane entry point and
  backend (``encode_parity[device]``, ``reconstruct[host]``, ...) fed by
  ops/dispatch.py, the native host paths and the shard writers: calls,
  host wall of the dispatch (`wall_s`), device time (`device_s`: on the
  card the wait on the dispatch's CUDA event), H2D and D2H seconds and
  bytes (the card books no H2D seconds), and payload bytes.
- **Roofline**: each row's achieved GB/s per resource over the measured
  ceiling of that resource (`set_ceiling`, `WEEDTPU_CEILINGS`),
  exported as ``weedtpu_roofline_frac{resource,kernel}``.  A
  ``[device]`` row gives its D2H share only; the card's kernel and H2D
  shares are read from a `torch.profiler` trace.

The process-wide continuous profiler (`ensure_started`, at
``WEEDTPU_PROFILE_HZ``; 0, the default, starts none) is shared by every
server of the process; `/debug/pprof` serves it, or samples a window of
its own (``?seconds=N``).
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time

from seaweedfs_tpu_torch.stats import metrics

_DEFAULT_HZ = 97  # prime: never phase-locks with 10 ms / 100 ms periodic work


def profile_hz() -> float:
    """The continuous profiler's rate from WEEDTPU_PROFILE_HZ (default 0:
    no background sampler, only `/debug/pprof?seconds=N`).  A value that
    is not a number, or is negative, raises ValueError (the reference
    reads 0)."""
    value = os.environ.get("WEEDTPU_PROFILE_HZ", "0")
    try:
        hz = float(value)
    except ValueError:
        raise ValueError(f"WEEDTPU_PROFILE_HZ={value!r} is not a "
                         f"number") from None
    if hz < 0 or hz != hz:
        raise ValueError(f"WEEDTPU_PROFILE_HZ={value!r} is negative")
    return hz


def _clamp_hz(hz: float) -> float:
    return max(1.0, min(float(hz), 1000.0))


def _frame_label(frame) -> str:
    """``module.function``, the module from the file's basename."""
    code = frame.f_code
    mod = os.path.basename(code.co_filename)
    if mod.endswith(".py"):
        mod = mod[:-3]
    return f"{mod}.{code.co_name}"


class SamplingProfiler:
    """Walk every thread's stack `hz` times a second into a collapsed
    stack table.  start() spawns one daemon thread; stop() joins it, so a
    stopped profiler owns no thread and can be read freely."""

    def __init__(self, hz: float = _DEFAULT_HZ):
        self.hz = _clamp_hz(hz)
        self.samples = 0
        self.started_at: float | None = None
        # collapsed stack (root, ..., leaf) -> sample count
        self._stacks: dict[tuple[str, ...], int] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "SamplingProfiler":
        if self._thread is not None:
            return self
        self.started_at = time.time()
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name="weedtpu-profiler",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        t = self._thread
        if t is None:
            return
        self._stop.set()
        t.join(timeout)
        self._thread = None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # -- sampling -------------------------------------------------------

    def _run(self) -> None:
        period = 1.0 / self.hz
        me = threading.get_ident()
        while not self._stop.wait(period):
            self._sample_once(me)

    def _sample_once(self, skip_ident: int | None = None) -> None:
        if skip_ident is None:
            skip_ident = threading.get_ident()
        frames = sys._current_frames()
        with self._lock:
            self.samples += 1
            for ident, frame in frames.items():
                if ident == skip_ident:
                    continue  # the sampler observing itself is noise
                stack: list[str] = []
                f = frame
                while f is not None:
                    stack.append(_frame_label(f))
                    f = f.f_back
                if not stack:
                    continue
                key = tuple(reversed(stack))  # root -> leaf
                self._stacks[key] = self._stacks.get(key, 0) + 1

    # -- rendering ------------------------------------------------------

    def stacks_snapshot(self) -> dict[tuple[str, ...], int]:
        with self._lock:
            return dict(self._stacks)

    def collapsed(self, limit: int = 0) -> str:
        """flamegraph.pl input: one ``root;child;leaf count`` line per
        distinct stack, heaviest first."""
        items = sorted(self.stacks_snapshot().items(),
                       key=lambda kv: -kv[1])
        if limit > 0:
            items = items[:limit]
        return "\n".join(f"{';'.join(stack)} {n}" for stack, n in items)

    def table(self, limit: int = 40) -> str:
        """Per-frame self (leaf) and total (anywhere on the stack) counts,
        heaviest total first, as shares of all thread-samples (each tick
        samples every live thread)."""
        snap = self.stacks_snapshot()
        self_n: dict[str, int] = {}
        total_n: dict[str, int] = {}
        for stack, n in snap.items():
            self_n[stack[-1]] = self_n.get(stack[-1], 0) + n
            for fr in set(stack):  # once even if recursive
                total_n[fr] = total_n.get(fr, 0) + n
        thread_samples = max(1, sum(snap.values()))
        rows = sorted(total_n.items(), key=lambda kv: -kv[1])[:limit]
        out = [f"samples={self.samples} hz={self.hz:g} "
               f"thread_samples={sum(snap.values())}",
               f"{'self':>8} {'self%':>7} {'total':>8} {'total%':>7}  frame"]
        for fr, tot in rows:
            s = self_n.get(fr, 0)
            out.append(f"{s:8d} {100.0 * s / thread_samples:6.1f}% "
                       f"{tot:8d} {100.0 * tot / thread_samples:6.1f}%  {fr}")
        return "\n".join(out)


# -- the process-wide continuous profiler ----------------------------------

_global_lock = threading.Lock()
_global: SamplingProfiler | None = None


def global_profiler() -> SamplingProfiler | None:
    return _global


def ensure_started() -> SamplingProfiler | None:
    """Start the continuous profiler when WEEDTPU_PROFILE_HZ asks for one,
    once per process: every server calls it at start, and co-hosted
    servers share it.  A running profiler at the same (clamped) rate is
    kept with its samples."""
    global _global
    hz = profile_hz()
    with _global_lock:
        if hz <= 0:
            return _global
        if _global is None or not _global.running or \
                _global.hz != _clamp_hz(hz):
            if _global is not None:
                _global.stop()
            _global = SamplingProfiler(hz).start()
        return _global


def shutdown() -> None:
    """Stop the continuous profiler (servers leave it running)."""
    global _global
    with _global_lock:
        if _global is not None:
            _global.stop()
            _global = None


# -- kernel profile (fed by ops/dispatch.py and the storage layer) --------

class KernelProfile:
    """Per-kernel host and device time and transfer accounting: one row
    per entry point and backend, accumulating calls, dispatch wall
    (`wall_s`), device time (`device_s`), H2D and D2H seconds and bytes,
    and payload bytes."""

    _FIELDS = ("calls", "wall_s", "device_s", "h2d_s", "d2h_s",
               "bytes", "h2d_bytes", "d2h_bytes")

    def __init__(self):
        self._rows: dict[str, dict[str, float]] = {}
        self._lock = threading.Lock()

    def record(self, kernel: str, backend: str = "host", *,
               calls: float = 1.0, wall_s: float = 0.0,
               device_s: float = 0.0, h2d_s: float = 0.0,
               d2h_s: float = 0.0, nbytes: float = 0.0,
               h2d_bytes: float = 0.0, d2h_bytes: float = 0.0) -> None:
        key = f"{kernel}[{backend}]"
        add = (calls, wall_s, device_s, h2d_s, d2h_s, nbytes, h2d_bytes,
               d2h_bytes)
        with self._lock:
            row = self._rows.get(key)
            if row is None:
                row = self._rows[key] = dict.fromkeys(self._FIELDS, 0.0)
            for f, v in zip(self._FIELDS, add):
                if v:
                    row[f] += v

    @contextlib.contextmanager
    def timed(self, kernel: str, backend: str = "host", *,
              nbytes: float = 0.0):
        """Bracket one call's wall time into `kernel`'s row.  Device paths
        with separate h2d / device / d2h phases call record()."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(kernel, backend,
                        wall_s=time.perf_counter() - t0, nbytes=nbytes)

    def snapshot(self) -> dict[str, dict[str, float]]:
        with self._lock:
            return {k: dict(v) for k, v in self._rows.items()}

    def reset(self) -> None:
        with self._lock:
            self._rows.clear()

    def table(self) -> str:
        snap = sorted(self.snapshot().items(),
                      key=lambda kv: -(kv[1]["wall_s"] + kv[1]["device_s"]
                                       + kv[1]["d2h_s"]))
        out = [f"{'calls':>7} {'wall_ms':>9} {'device_ms':>9} "
               f"{'h2d_ms':>8} {'d2h_ms':>8} {'MB':>9}  kernel"]
        for key, r in snap:
            out.append(
                f"{int(r['calls']):7d} {r['wall_s'] * 1e3:9.1f} "
                f"{r['device_s'] * 1e3:9.1f} {r['h2d_s'] * 1e3:8.1f} "
                f"{r['d2h_s'] * 1e3:8.1f} "
                f"{r['bytes'] / 1e6:9.1f}  {key}")
        return "\n".join(out)


KERNELS = KernelProfile()


# -- roofline accounting ---------------------------------------------------

_ceilings_lock = threading.Lock()
_ceilings_set: dict[str, float] = {}
_ceilings_cache: tuple[float, dict] | None = None


def set_ceiling(resource: str, gbps: float) -> None:
    """Record a measured hardware ceiling (GB/s) for a resource
    (device / h2d / d2h / disk / net).  WEEDTPU_CEILINGS overrides
    nothing set here."""
    global _ceilings_cache
    with _ceilings_lock:
        _ceilings_set[resource] = float(gbps)
        _ceilings_cache = None


def ceilings() -> dict[str, float]:
    """resource -> GB/s ceiling, from the WEEDTPU_CEILINGS environment
    ("resource=GBps,resource=GBps") overlaid by set_ceiling() calls;
    cached ~5 s.  Unlike the reference, no ``device`` ceiling comes from
    a launch pin: the port has none until ROADMAP 1.7, so the device
    ceiling is whatever a caller measured and set."""
    global _ceilings_cache
    now = time.monotonic()
    with _ceilings_lock:
        cached = _ceilings_cache
        if cached is not None and now - cached[0] < 5.0:
            return dict(cached[1])
        out: dict[str, float] = {}
        for part in os.environ.get("WEEDTPU_CEILINGS", "").split(","):
            k, sep, v = part.partition("=")
            if sep:
                try:
                    gbps = float(v)
                except ValueError:
                    continue
                if gbps > 0:
                    out[k.strip()] = gbps
        out.update(_ceilings_set)
        _ceilings_cache = (now, out)
        return dict(out)


# which (resource, seconds-field, bytes-field) pairs a kernel row feeds
# besides its compute: the transfers read their own columns
_ROOFLINE_TRANSFERS = (("h2d", "h2d_s", "h2d_bytes"),
                       ("d2h", "d2h_s", "d2h_bytes"))


def roofline_snapshot() -> dict:
    """Per-kernel achieved GB/s per resource, and the fraction of the
    measured ceiling where one is known.  Host rows read their wall time
    as compute (``host``); rows under 1 ms of time are skipped (a
    fraction over noise would jitter).

    Unlike the reference, a ``[device]`` row gives no ``device`` (compute)
    share: its `device_s` is the host's wait on the dispatch's event,
    which covers whatever of the copy and the kernel was still running,
    not the kernel's time, and the card's rows book no `h2d_s` at all
    (ops/dispatch.py).  The card's kernel and copy shares come from a
    `torch.profiler` trace instead (chip_smoke.py phase 13)."""
    ceil = ceilings()
    rows: list[dict] = []
    for key, r in KERNELS.snapshot().items():
        kernel, _, backend = key.partition("[")
        backend = backend.rstrip("]")
        candidates = [] if backend == "device" else \
            [("host", r["wall_s"], r["bytes"])]
        for resource, sfield, bfield in _ROOFLINE_TRANSFERS:
            candidates.append((resource, r[sfield], r[bfield]))
        if kernel == "shard_write":
            # the writer pool's disk seconds ride the wall/bytes columns
            candidates = [("disk", r["wall_s"], r["bytes"])]
        for resource, secs, nbytes in candidates:
            if secs < 1e-3 or nbytes <= 0:
                continue
            gbps = nbytes / 1e9 / secs
            row = {"kernel": kernel, "backend": backend,
                   "resource": resource, "busy_s": round(secs, 4),
                   "gbytes": round(nbytes / 1e9, 4),
                   "achieved_gbps": round(gbps, 3)}
            c = ceil.get(resource)
            if c:
                row["ceiling_gbps"] = round(c, 3)
                row["ceiling_frac"] = round(min(gbps / c, 9.99), 4)
            rows.append(row)
    rows.sort(key=lambda r: -r["busy_s"])
    return {"ceilings": {k: round(v, 3) for k, v in ceil.items()},
            "rows": rows}


def export_roofline() -> None:
    """Stamp weedtpu_roofline_frac{resource,kernel} from the live kernel
    profile (the servers call it on every /metrics render)."""
    # at call time: pipeline imports this module
    from seaweedfs_tpu_torch.stats import pipeline
    if not pipeline.perf_obs_enabled():
        return
    for row in roofline_snapshot()["rows"]:
        frac = row.get("ceiling_frac")
        if frac is not None:
            metrics.ROOFLINE_FRAC.labels(
                row["resource"], row["kernel"]).set(frac)


# -- /debug/pprof ----------------------------------------------------------

async def handle_debug_pprof(req):
    """An on-demand profile: ``?seconds=N`` samples for N seconds (at most
    120) at ``?hz=`` (default WEEDTPU_PROFILE_HZ, else 97) and returns
    collapsed stacks; without ``seconds`` the continuous profiler's
    cumulative view is served (400 when none runs).  ``?format=table``
    renders the self/total table and the kernel profile;
    ``?format=json`` all three views as JSON."""
    import asyncio

    from aiohttp import web

    try:
        seconds = float(req.query.get("seconds", "0"))
    except ValueError:
        seconds = 0.0
    seconds = min(seconds, 120.0)
    try:
        hz = float(req.query.get("hz", str(profile_hz() or _DEFAULT_HZ)))
    except ValueError:
        hz = _DEFAULT_HZ
    fmt = req.query.get("format", "collapsed")

    if seconds > 0:
        prof = SamplingProfiler(hz).start()
        try:
            await asyncio.sleep(seconds)
        finally:
            prof.stop()
    else:
        prof = global_profiler()
        if prof is None:
            return web.json_response(
                {"error": "no continuous profiler running; pass "
                          "?seconds=N or set WEEDTPU_PROFILE_HZ"},
                status=400)

    if fmt == "json":
        stacks = [{"stack": list(st), "count": n}
                  for st, n in sorted(prof.stacks_snapshot().items(),
                                      key=lambda kv: -kv[1])]
        return web.json_response({"samples": prof.samples, "hz": prof.hz,
                                  "stacks": stacks,
                                  "kernels": KERNELS.snapshot()})
    if fmt == "table":
        text = (prof.table() + "\n\n-- kernel profile (ops/dispatch) --\n"
                + KERNELS.table() + "\n")
    else:
        text = prof.collapsed() + "\n"
    return web.Response(text=text, content_type="text/plain")
