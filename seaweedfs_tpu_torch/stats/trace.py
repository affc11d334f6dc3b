"""Tracing: context-propagated spans in a per-process ring buffer.

Counterpart of `seaweedfs_tpu/stats/trace.py`:

- a `Trace` (128-bit trace id, current span id, sampled flag) carried in
  a contextvar, so it follows work across `await`s; a contextvar does not
  cross into a thread, so spans recorded on a pipeline's own threads
  appear only where the caller's thread records them, as in the
  reference;
- `span(name, **attrs)` context managers recording finished spans into a
  ring of the reference's default size (`TRACE_BUF`).  Appends take no
  lock, and an unsampled trace allocates nothing: `span` returns a
  shared no-op.

Sampling (`WEEDTPU_TRACE_SAMPLE`, default 16: keep 1 root in 16; 0
disables local sampling) is the serving plane's choice; background work
and tools start a sampled root themselves with `new_root()`.  The
`X-Weedtpu-Trace` header propagation, pinned traces, the request
registry, the aiohttp middleware and the `/debug` routes come with the
servers (ROADMAP 1.15a).
"""

from __future__ import annotations

import itertools
import os
import random
import time
from contextvars import ContextVar

_rand = random.Random()


class Trace:
    """Immutable trace context: who we are inside which trace."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: str, span_id: str, sampled: bool):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled


_current: ContextVar[Trace | None] = ContextVar("weedtpu_trace",
                                                default=None)


def sample_rate() -> int:
    """1-in-N root sampling from WEEDTPU_TRACE_SAMPLE (default 16); 0
    disables local sampling (read per call).  A value that is not an
    integer raises ValueError."""
    value = os.environ.get("WEEDTPU_TRACE_SAMPLE", "16")
    try:
        return int(value)
    except ValueError:
        raise ValueError(f"WEEDTPU_TRACE_SAMPLE={value!r}: want an "
                         f"integer") from None


def _new_trace_id() -> str:
    return f"{_rand.getrandbits(128):032x}"


def _new_span_id() -> str:
    return f"{_rand.getrandbits(64):016x}"


def current() -> Trace | None:
    return _current.get()


def new_root(sampled: bool = True) -> Trace:
    """A fresh root context for work that starts outside any request
    (maintenance passes, tools): pass it as `span(..., parent=)` so the
    whole run is one trace."""
    return Trace(_new_trace_id(), _new_span_id(), sampled)


def current_exemplar() -> str | None:
    """Trace id for histogram exemplars: only sampled traces qualify."""
    t = _current.get()
    return t.trace_id if t is not None and t.sampled else None


# -- ring buffer ---------------------------------------------------------

# spans kept per process, the reference's default
TRACE_BUF = 4096


class _Ring:
    """Fixed-capacity overwrite-oldest span store.  append() is one
    atomic counter bump and one list-slot store; readers copy the slots."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._slots: list[dict | None] = [None] * capacity
        self._n = itertools.count()

    def append(self, rec: dict) -> None:
        self._slots[next(self._n) % self.capacity] = rec

    def snapshot(self) -> list[dict]:
        return [r for r in list(self._slots) if r is not None]

    def clear(self) -> None:
        self._slots = [None] * self.capacity
        self._n = itertools.count()


_ring = _Ring(TRACE_BUF)


def ring_snapshot() -> list[dict]:
    return _ring.snapshot()


def reset_ring() -> None:
    _ring.clear()


# -- spans ---------------------------------------------------------------

class _NoopSpan:
    """Shared do-nothing span for unsampled work: entering, exiting and
    set() cost nothing and allocate nothing."""

    __slots__ = ()
    trace = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("name", "trace", "parent_id", "attrs", "error",
                 "_t0", "_start", "_token")

    def __init__(self, name: str, parent: Trace, attrs: dict):
        self.name = name
        self.trace = Trace(parent.trace_id, _new_span_id(), True)
        self.parent_id = parent.span_id
        self.attrs = attrs
        self.error = False

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self):
        self._token = _current.set(self.trace)
        self._start = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter() - self._t0
        _current.reset(self._token)
        record_span(self.name, self.trace.trace_id, self.trace.span_id,
                    self.parent_id, self._start, dur * 1000.0,
                    self.attrs, self.error or exc_type is not None)
        return False


def span(name: str, parent: Trace | None = None, **attrs):
    """Span context manager under the ambient trace, or under `parent`
    when given.  Unsampled -> the shared no-op."""
    t = parent if parent is not None else _current.get()
    if t is None or not t.sampled:
        return _NOOP
    return _Span(name, t, attrs)


def record_span(name: str, trace_id: str, span_id: str,
                parent_id: str | None, start: float, ms: float,
                attrs: dict | None = None, error: bool = False) -> None:
    rec = {"name": name, "trace": trace_id, "span": span_id,
           "parent": parent_id, "start": start, "ms": round(ms, 3)}
    if attrs:
        rec["attrs"] = attrs
    if error:
        rec["error"] = True
    _ring.append(rec)


def traces(min_ms: float = 0.0, limit: int = 50,
           tid: str | None = None) -> list[dict]:
    """Recent traces in the ring, newest first: spans grouped by trace id
    in start order, each trace's duration the span envelope.  `tid`
    looks up that one trace."""
    by_trace: dict[str, list[dict]] = {}
    for rec in _ring.snapshot():
        if tid is None or rec["trace"] == tid:
            by_trace.setdefault(rec["trace"], []).append(rec)
    if tid is not None:
        min_ms = 0.0
    out = []
    for t_id, spans in by_trace.items():
        spans.sort(key=lambda r: r["start"])
        t0 = spans[0]["start"]
        t1 = max(r["start"] + r["ms"] / 1000.0 for r in spans)
        total = (t1 - t0) * 1000.0
        if total < min_ms:
            continue
        out.append({"trace_id": t_id, "start": t0,
                    "ms": round(total, 3),
                    "error": any(r.get("error") for r in spans),
                    "spans": spans})
    out.sort(key=lambda t: t["start"], reverse=True)
    return out[:max(1, limit)]


def assemble(spans: list[dict]) -> dict:
    """Stitch one trace's spans (possibly from several nodes, possibly
    overlapping) into a parent-ordered waterfall: deduped by span id,
    depth first with siblings by start time, each span stamped with its
    ``depth``.  A ``*.request`` span under its client's span gets the
    hop's ``net_ms`` (client duration minus server duration) and
    ``send_ms`` (server start minus client start).  Spans whose parent is
    missing become extra roots, counted in ``orphans``."""
    by_id: dict[str, dict] = {}
    for s in spans:
        by_id.setdefault(s["span"], dict(s))
    children: dict[str, list[dict]] = {}
    roots: list[dict] = []
    orphans = 0
    for s in by_id.values():
        pid = s.get("parent")
        if pid and pid in by_id:
            children.setdefault(pid, []).append(s)
        else:
            if pid:
                orphans += 1
            roots.append(s)
    for lst in children.values():
        lst.sort(key=lambda r: r["start"])
    roots.sort(key=lambda r: r["start"])
    out: list[dict] = []

    def emit(s: dict, depth: int) -> None:
        s["depth"] = depth
        parent = by_id.get(s.get("parent") or "")
        if parent is not None and s["name"].endswith(".request"):
            s["net_ms"] = round(max(0.0, parent["ms"] - s["ms"]), 3)
            s["send_ms"] = round((s["start"] - parent["start"]) * 1000.0, 3)
        out.append(s)
        for c in children.get(s["span"], []):
            emit(c, depth + 1)

    for r in roots:
        emit(r, 0)
    if not out:
        return {"spans": [], "span_count": 0, "servers": [], "nodes": [],
                "regions": []}
    t0 = min(s["start"] for s in out)
    t1 = max(s["start"] + s["ms"] / 1000.0 for s in out)
    servers = sorted({s.get("attrs", {}).get("server") for s in out
                      if s.get("attrs", {}).get("server")})
    nodes = sorted({s["node"] for s in out if s.get("node")})
    regions = sorted({s.get("attrs", {}).get("region") for s in out
                      if s.get("attrs", {}).get("region")})
    return {"trace_id": out[0]["trace"], "start": t0,
            "ms": round((t1 - t0) * 1000.0, 3),
            "error": any(s.get("error") for s in out),
            "span_count": len(out), "servers": servers, "nodes": nodes,
            "regions": regions, "orphans": orphans, "spans": out}
