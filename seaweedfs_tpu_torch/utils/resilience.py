"""Resilience: deadlines, retry budgets, hedging, circuit breakers.

Counterpart of `seaweedfs_tpu/utils/resilience.py`, cut to what the EC
read engine (storage/ec/ec_volume.py) and the pooled client
(utils/http.py) call:

- **Deadline budgets**: a per-request absolute deadline in a contextvar,
  carried across processes as ``X-Weedtpu-Deadline`` (the remaining
  milliseconds, re-stamped at every hop).  Clients clamp their socket
  timeouts to what remains and refuse to start a call past it.
  ``WEEDTPU_DEADLINE_MS`` is the edge default for requests that arrive
  without one (0 = off, the default).
- **Retry budget**: one process-wide token bucket per traffic class
  (``WEEDTPU_RETRY_BUDGET`` = "rate:burst", default 2:8); every retry
  spends a token, booked into ``weedtpu_retry_total{class,outcome}``.
- **Hedged reads**: a rolling window of shard-fetch latencies
  (``SHARD_FETCH``) whose ``hedge_delay_s`` is the p-``WEEDTPU_HEDGE_PCT``
  (default 99) of recent completions, clamped to
  [``WEEDTPU_HEDGE_MIN_MS``, ``WEEDTPU_HEDGE_MAX_MS``] (25, 1000).  The EC
  read engine waits that long for remote fetches before reconstructing
  from other survivors.  ``PCT=0`` turns hedging off.
- **Circuit breakers**: one per peer, tripped by
  ``WEEDTPU_BREAKER_THRESHOLD`` (5) consecutive transport failures,
  half-open after ``WEEDTPU_BREAKER_COOLDOWN`` (2.0) seconds with ±25%
  jitter; ``WEEDTPU_BREAKER=0`` turns them off.

Every knob is read per call, under the reference's name and default.  A
malformed value raises ValueError, where the reference falls back to the
default.  `Backoff` and `backoff_delay` serve the master's daemon loops
(the aggregator's and the canary's) and the repair planner's and
conversion scheduler's per-volume backoffs; `retry_async` the
scheduler's node calls; `retry_call` the replication sinks' and the sync
pump's applies (replication/sink.py, replication/filer_sync.py).
"""

from __future__ import annotations

import os
import random
import threading
import time
from collections import deque
from contextvars import ContextVar

from seaweedfs_tpu_torch.stats import metrics

DEADLINE_HEADER = "X-Weedtpu-Deadline"  # remaining budget, milliseconds

_rand = random.Random()


def _env_float(name: str, default: float) -> float:
    """A float knob; a value that is not a number raises ValueError."""
    value = os.environ.get(name)
    if value is None:
        return default
    try:
        return float(value)
    except ValueError:
        raise ValueError(f"{name}={value!r}: want a number") from None


def env_switch(name: str) -> bool:
    """A 0/1 knob, on when unset; any other value raises ValueError."""
    raw = os.environ.get(name, "").strip()
    if raw not in ("", "0", "1"):
        raise ValueError(f"{name}={raw!r}: want 0 or 1")
    return raw != "0"


# -- deadlines -----------------------------------------------------------

class DeadlineExceeded(TimeoutError):
    """Raised when a call would start past its budget.  A TimeoutError,
    and so an OSError: transport error handlers treat it as one."""


_deadline: ContextVar[float | None] = ContextVar("weedtpu_deadline",
                                                 default=None)


def default_deadline_ms() -> float:
    """Edge default for data-plane requests that arrive without a
    deadline header (0 = off)."""
    return _env_float("WEEDTPU_DEADLINE_MS", 0.0)


def deadline() -> float | None:
    """The ambient absolute deadline (time.monotonic() clock), if any."""
    return _deadline.get()


def set_deadline(abs_monotonic: float | None):
    """Set the ambient deadline; returns the reset token."""
    return _deadline.set(abs_monotonic)


def reset_deadline(token) -> None:
    _deadline.reset(token)


def remaining() -> float | None:
    """Seconds left in the ambient budget (may be <= 0), or None when no
    deadline is set."""
    d = _deadline.get()
    if d is None:
        return None
    return d - time.monotonic()


def clamp_timeout(timeout: float, floor: float = 0.001) -> float:
    """min(timeout, remaining budget), floored so that a spent budget
    raises from the socket layer instead of passing it 0 or less."""
    rem = remaining()
    if rem is None:
        return timeout
    return max(floor, min(timeout, rem))


def check_deadline(what: str = "call") -> None:
    """Raise DeadlineExceeded when the ambient budget is spent."""
    rem = remaining()
    if rem is not None and rem <= 0:
        raise DeadlineExceeded(f"deadline exceeded before {what}")


def inject_deadline(headers: dict) -> dict:
    """Stamp the remaining budget (ms) onto outgoing headers: the wire
    carries a duration, not a timestamp, so clocks need not agree."""
    rem = remaining()
    if rem is not None:
        headers[DEADLINE_HEADER] = str(max(1, int(rem * 1000)))
    return headers


def extract_deadline_s(headers) -> float | None:
    """The incoming deadline header as remaining seconds, or None when it
    is absent or not a number."""
    raw = headers.get(DEADLINE_HEADER)
    if not raw:
        return None
    try:
        return max(0.0, float(raw) / 1000.0)
    except ValueError:
        return None


# -- retry budget --------------------------------------------------------

class RetryBudget:
    """Token bucket per traffic class: `rate` tokens/s refill up to
    `burst`.  With N callers retrying against a dead peer the extra load
    is rate * t + burst, whatever N is."""

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self._tokens: dict[str, tuple[float, float]] = {}  # cls -> (tokens, ts)
        self._lock = threading.Lock()

    def try_spend(self, cls: str, n: float = 1.0) -> bool:
        now = time.monotonic()
        with self._lock:
            tokens, last = self._tokens.get(cls, (self.burst, now))
            tokens = min(self.burst, tokens + (now - last) * self.rate)
            if tokens >= n:
                self._tokens[cls] = (tokens - n, now)
                return True
            self._tokens[cls] = (tokens, now)
            return False

    def snapshot(self) -> dict:
        now = time.monotonic()
        with self._lock:
            return {"rate": self.rate, "burst": self.burst,
                    "classes": {
                        cls: round(min(self.burst,
                                       tokens + (now - last) * self.rate), 2)
                        for cls, (tokens, last) in self._tokens.items()}}


_BUDGET: RetryBudget | None = None
_BUDGET_LOCK = threading.Lock()


def _parse_budget(spec: str) -> tuple[float, float]:
    """"rate:burst" (burst defaults to max(4, 4 * rate)); raises
    ValueError on anything else."""
    rate_s, _, burst_s = spec.partition(":")
    try:
        rate = float(rate_s)
        burst = float(burst_s) if burst_s else max(4.0, rate * 4)
    except ValueError:
        raise ValueError(f"WEEDTPU_RETRY_BUDGET={spec!r}: want "
                         f"'rate:burst'") from None
    return rate, burst


def retry_budget() -> RetryBudget:
    global _BUDGET
    b = _BUDGET
    if b is None:
        with _BUDGET_LOCK:
            b = _BUDGET
            if b is None:
                b = _BUDGET = RetryBudget(*_parse_budget(
                    os.environ.get("WEEDTPU_RETRY_BUDGET", "2:8")))
    return b


def reset_retry_budget() -> None:
    """Re-read WEEDTPU_RETRY_BUDGET on next use."""
    global _BUDGET
    with _BUDGET_LOCK:
        _BUDGET = None


def spend_retry(cls: str) -> bool:
    """One retry permit for traffic class `cls`, booked into
    weedtpu_retry_total{class,outcome} either way."""
    ok = retry_budget().try_spend(cls or "default")
    metrics.RETRY_TOTAL.labels(cls or "default",
                               "allowed" if ok else "denied").inc()
    return ok


# -- backoff -------------------------------------------------------------

def backoff_delay(attempt: int, base: float = 0.5, cap: float = 60.0,
                  rng: random.Random | None = None) -> float:
    """Stateless jitter for per-key retry maps: uniform(base,
    base * 3**attempt), capped.  attempt counts from 1."""
    r = rng or _rand
    hi = min(cap, base * (3.0 ** max(1, attempt)))
    return min(cap, r.uniform(base, max(base, hi)))


class Backoff:
    """Stateful decorrelated-jitter backoff for daemon loops
    (sleep_n+1 = min(cap, uniform(base, 3 * sleep_n))); reset() after a
    success restores the base delay."""

    def __init__(self, base: float = 0.5, cap: float = 60.0,
                 rng: random.Random | None = None):
        self.base = base
        self.cap = cap
        self._rng = rng or _rand
        self._sleep = 0.0

    def next(self) -> float:
        prev = self._sleep or self.base
        self._sleep = min(self.cap,
                          self._rng.uniform(self.base, prev * 3.0))
        return self._sleep

    def reset(self) -> None:
        self._sleep = 0.0


def retry_call(fn, *, attempts: int = 4, base: float = 0.5,
               cap: float = 30.0, cls: str = "default",
               retry_on: tuple = (OSError,), giveup=None,
               sleep=time.sleep):
    """Run `fn()` with budgeted, deadline-aware, jittered retries.

    The first attempt is free; each retry must win a token from the
    process-wide retry budget (spend_retry), and when the budget is dry
    the last error raises at once.  `giveup(exc) -> bool` short-circuits
    errors that will not heal by retrying (4xx-shaped failures).  An
    ambient deadline bounds the total: no retry starts after it, and no
    sleep runs past it."""
    bo = Backoff(base, cap)
    last: BaseException | None = None
    for attempt in range(max(1, attempts)):
        if attempt:
            rem = remaining()
            if rem is not None and rem <= 0:
                break
            if not spend_retry(cls):
                break
            delay = bo.next()
            if rem is not None:
                delay = min(delay, max(0.0, rem))
            sleep(delay)
        try:
            return fn()
        except retry_on as e:
            last = e
            if giveup is not None and giveup(e):
                raise
    assert last is not None
    raise last


async def retry_async(fn, *, attempts: int = 4, base: float = 0.5,
                      cap: float = 30.0, cls: str = "default",
                      retry_on: tuple = (OSError,), giveup=None):
    """Call the coroutine factory `fn` up to `attempts` times, retrying
    on `retry_on` (unless `giveup(e)` says not to) after a
    decorrelated-jitter sleep; each retry spends a permit of class
    `cls` from the retry budget and stops when none is left or the
    ambient deadline has passed.  The last error is raised."""
    import asyncio
    bo = Backoff(base, cap)
    last: BaseException | None = None
    for attempt in range(max(1, attempts)):
        if attempt:
            rem = remaining()
            if rem is not None and rem <= 0:
                break
            if not spend_retry(cls):
                break
            delay = bo.next()
            if rem is not None:
                delay = min(delay, max(0.0, rem))
            await asyncio.sleep(delay)
        try:
            return await fn()
        except retry_on as e:
            last = e
            if giveup is not None and giveup(e):
                raise
    assert last is not None
    raise last


# -- hedging -------------------------------------------------------------

class LatencyTracker:
    """Bounded rolling window of completion latencies.  Feed it only
    fetches that beat the hedge cutoff: the latencies of abandoned ones
    would teach it that slow is normal and switch hedging off where it
    pays."""

    def __init__(self, window: int = 256):
        self._lat: deque[float] = deque(maxlen=window)
        self._lock = threading.Lock()

    def observe(self, seconds: float) -> None:
        with self._lock:
            self._lat.append(seconds)

    def percentile(self, q: float) -> float | None:
        with self._lock:
            vals = sorted(self._lat)
        if not vals:
            return None
        return vals[min(len(vals) - 1, int(q * len(vals)))]

    def __len__(self) -> int:
        return len(self._lat)


# recent successful remote EC shard-fetch latencies (ec_volume feeds it)
SHARD_FETCH = LatencyTracker()


def reset_latency_trackers() -> None:
    """Forget the shard-fetch latency window."""
    with SHARD_FETCH._lock:
        SHARD_FETCH._lat.clear()


def hedge_pct() -> float:
    return _env_float("WEEDTPU_HEDGE_PCT", 99.0)


def hedge_delay_s(tracker: LatencyTracker | None = None) -> float | None:
    """How long to wait for a remote fetch before hedging, or None when
    hedging is off (WEEDTPU_HEDGE_PCT <= 0).  0.05 s without history."""
    pct = hedge_pct()
    if pct <= 0:
        return None
    lo = _env_float("WEEDTPU_HEDGE_MIN_MS", 25.0) / 1000.0
    hi = _env_float("WEEDTPU_HEDGE_MAX_MS", 1000.0) / 1000.0
    p = (tracker or SHARD_FETCH).percentile(min(1.0, pct / 100.0))
    if p is None:
        p = 0.05
    return max(lo, min(hi, p))


# -- circuit breakers ----------------------------------------------------

def breaker_enabled() -> bool:
    """WEEDTPU_BREAKER: "1" (default) or "0"; anything else raises."""
    value = os.environ.get("WEEDTPU_BREAKER", "1")
    if value not in ("0", "1"):
        raise ValueError(f"WEEDTPU_BREAKER={value!r}: want 0 or 1")
    return value == "1"


class CircuitBreaker:
    """Per-peer breaker: `threshold` consecutive transport failures trip
    it open; after `cooldown` (±25% jitter) one half-open probe goes
    through, and its success closes the breaker, its failure re-opens
    it.  HTTP error statuses are not failures (the peer answered)."""

    __slots__ = ("threshold", "cooldown", "state", "failures",
                 "_open_until", "_probing", "_probe_at", "_lock", "trips")

    def __init__(self, threshold: float | None = None,
                 cooldown: float | None = None):
        self.threshold = int(threshold if threshold is not None else
                             _env_float("WEEDTPU_BREAKER_THRESHOLD", 5))
        self.cooldown = (cooldown if cooldown is not None else
                         _env_float("WEEDTPU_BREAKER_COOLDOWN", 2.0))
        self.state = "closed"
        self.failures = 0
        self.trips = 0
        self._open_until = 0.0
        self._probing = False
        self._probe_at = 0.0
        self._lock = threading.Lock()

    def allow(self) -> bool:
        with self._lock:
            if self.state == "closed":
                return True
            now = time.monotonic()
            if self.state == "open":
                if now < self._open_until:
                    return False
                self.state = "half_open"
                self._probing = True
                self._probe_at = now
                return True
            # half open: one probe at a time; a probe whose caller never
            # recorded its outcome forfeits the slot after a cooldown
            if self._probing and now - self._probe_at < self.cooldown:
                return False
            self._probing = True
            self._probe_at = now
            return True

    def record(self, ok: bool) -> None:
        with self._lock:
            self._probing = False
            if ok:
                self.failures = 0
                self.state = "closed"
                return
            self.failures += 1
            if self.state == "half_open" or self.failures >= self.threshold:
                self.state = "open"
                self.trips += 1
                self._open_until = time.monotonic() + \
                    self.cooldown * _rand.uniform(0.75, 1.25)

    def snapshot(self) -> dict:
        with self._lock:
            snap = {"state": self.state, "failures": self.failures,
                    "trips": self.trips}
            if self.state == "open":
                snap["open_for_s"] = round(
                    max(0.0, self._open_until - time.monotonic()), 2)
            return snap


_breakers: dict[str, CircuitBreaker] = {}
_breakers_lock = threading.Lock()


def breaker_for(peer: str) -> CircuitBreaker:
    br = _breakers.get(peer)
    if br is None:
        with _breakers_lock:
            br = _breakers.get(peer)
            if br is None:
                br = _breakers[peer] = CircuitBreaker()
                # the key is caller-supplied: drop the oldest past a sane
                # fleet size
                while len(_breakers) > 1024:
                    _breakers.pop(next(iter(_breakers)))
    return br


def breakers_snapshot() -> dict[str, dict]:
    """Breakers that are not closed, or closed with failures or trips."""
    with _breakers_lock:
        items = list(_breakers.items())
    return {peer: br.snapshot() for peer, br in items
            if br.state != "closed" or br.failures or br.trips}


def reset_breakers() -> None:
    """Forget every peer's breaker state."""
    with _breakers_lock:
        _breakers.clear()
