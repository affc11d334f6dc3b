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
and tools start a sampled root themselves with `new_root()`.  A blocking
client carries the context to its peer in the `X-Weedtpu-Trace` header
(`inject`; `format_header`/`parse_header`: "<32 hex>-<16 hex>-<0|1>").
A server mounts `aiohttp_middleware`, which continues or starts the
trace per request, registers the request in flight, applies the deadline
budget and records the root span.  A pinned trace (`pin_trace`, what
the master's cross-node assembler asks for with ``pin=1``) keeps its
spans past the ring's wrap and samples on every hop.  `loopback_error`
gates the volume server's scrub and fault hooks and, wrapped as
`debug_guard`, the `/debug` routes every server mounts (`debug_routes`:
traces, in-flight requests, pprof, pipeline).
"""

from __future__ import annotations

import itertools
import os
import random
import time
from collections import OrderedDict
from contextvars import ContextVar

TRACE_HEADER = "X-Weedtpu-Trace"

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


def slow_ms() -> float:
    """Requests at least this slow (WEEDTPU_SLOW_MS, default 1000) get a
    root span even when sampled out, and a log line.  A value that is
    not a number raises ValueError."""
    value = os.environ.get("WEEDTPU_SLOW_MS", "1000")
    try:
        return float(value)
    except ValueError:
        raise ValueError(f"WEEDTPU_SLOW_MS={value!r}: want a number") \
            from None


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


def format_header(t: Trace) -> str:
    return f"{t.trace_id}-{t.span_id}-{1 if t.sampled else 0}"


def parse_header(value: str) -> Trace | None:
    """The header's trace context, or None when it is malformed."""
    parts = value.split("-")
    if len(parts) != 3 or len(parts[0]) != 32 or len(parts[1]) != 16:
        return None
    try:
        int(parts[0], 16), int(parts[1], 16)
    except ValueError:
        return None
    return Trace(parts[0], parts[1], parts[2] == "1")


def inject(headers: dict) -> dict:
    """Stamp the current trace context into an outgoing header dict."""
    t = _current.get()
    if t is not None:
        headers[TRACE_HEADER] = format_header(t)
    return headers


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

# pinned traces: span lists that survive the ring's wrap.  The master's
# cross-node assembler pins every trace id it is asked about, and
# record_span mirrors later spans of a pinned trace here.  A bounded FIFO
# of _PIN_CAP ids, each holding at most _PIN_SPAN_CAP spans
_PIN_CAP = 64
_PIN_SPAN_CAP = 512
_pinned: "OrderedDict[str, list[dict]]" = OrderedDict()


def pin_trace(trace_id: str) -> None:
    """Keep `trace_id`: copy its spans now in the ring into the pinned
    store and mirror its later ones there.  A request carrying a pinned
    id samples on every hop, whatever its header's flag."""
    spans = _pinned.get(trace_id)
    if spans is None:
        _pinned[trace_id] = spans = []
        while len(_pinned) > _PIN_CAP:
            _pinned.popitem(last=False)
    seen = {r["span"] for r in spans}
    for rec in _ring.snapshot():
        if rec["trace"] == trace_id and rec["span"] not in seen:
            spans.append(rec)
            seen.add(rec["span"])


def pinned_ids() -> list[str]:
    return list(_pinned)


def ring_snapshot() -> list[dict]:
    return _ring.snapshot()


def reset_ring() -> None:
    _ring.clear()
    _pinned.clear()


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
    if _pinned:  # one truthiness test on the hot path
        spans = _pinned.get(trace_id)
        if spans is not None and len(spans) < _PIN_SPAN_CAP:
            spans.append(rec)


def _trace_spans(tid: str) -> list[dict]:
    """Every known span of one trace: the ring and the pinned store,
    once each, in start order."""
    seen: set[str] = set()
    spans: list[dict] = []
    for rec in _ring.snapshot() + _pinned.get(tid, []):
        if rec["trace"] == tid and rec["span"] not in seen:
            seen.add(rec["span"])
            spans.append(rec)
    spans.sort(key=lambda r: r["start"])
    return spans


def traces(min_ms: float = 0.0, limit: int = 50,
           tid: str | None = None) -> list[dict]:
    """Recent traces, newest first: spans grouped by trace id in start
    order, each trace's duration the span envelope.  `tid` looks up that
    one trace, its pinned spans included."""
    by_trace: dict[str, list[dict]] = {}
    if tid is not None:
        spans = _trace_spans(tid)
        if spans:
            by_trace[tid] = spans
        min_ms = 0.0
    else:
        for rec in _ring.snapshot():
            by_trace.setdefault(rec["trace"], []).append(rec)
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


# -- in-flight request registry -----------------------------------------

_inflight: dict[int, dict] = {}
_inflight_seq = itertools.count(1)


def request_started(method: str, path: str, remote: str | None,
                    trace_id: str | None) -> int:
    rid = next(_inflight_seq)
    _inflight[rid] = {"id": rid, "method": method, "path": path,
                      "remote": remote or "", "trace_id": trace_id or "",
                      "start": time.time(), "_t0": time.perf_counter()}
    return rid


def request_finished(rid: int) -> None:
    _inflight.pop(rid, None)


def inflight() -> list[dict]:
    now = time.perf_counter()
    out = []
    for rec in list(_inflight.values()):
        r = {k: v for k, v in rec.items() if not k.startswith("_")}
        r["age_ms"] = round((now - rec["_t0"]) * 1000.0, 1)
        out.append(r)
    out.sort(key=lambda r: r["age_ms"], reverse=True)
    return out


# -- aiohttp server glue ------------------------------------------------

def aiohttp_middleware(role: str, slow_exempt: tuple = (),
                       trust_flow: bool | str = True, tenant_resolver=None,
                       region: str = ""):
    """Server-side half of the propagation: extract X-Weedtpu-Trace (or
    make a root sampling decision), register the request in the in-flight
    table, and on completion record the root span -- always for sampled
    requests, retroactively for unsampled ones that finished slow or
    errored (with a slow-request log line either way).  `slow_exempt`
    lists long-poll paths (the master's /cluster/stream) whose lifetime
    is their duration: they are never slow.  `region`, when set, is
    stamped on every span (the master's geo federation).  Client
    disconnects (CancelledError) are neither slow nor errored.

    `trust_flow` says whose X-Weedtpu-Class/-Role headers and tenant
    (X-Weedtpu-Tenant) are honoured.  Cluster-internal servers keep the
    default True: that propagation is how a repair's shard pulls book as
    repair two hops away.  The public S3 gateway passes "loopback": only a
    same-host caller (the master's canary) may declare them, so a remote
    client cannot move its failures out of the data-plane SLO, poison the
    repair-traffic ledger or bill another tenant.

    `tenant_resolver` makes this server a tenant edge: without a trusted
    tenant header it resolves the request's tenant once (`anonymous` if
    the resolver raises), the tenant rides the contextvar for the
    handler's downstream hops, and the per-tenant counters
    (weedtpu_tenant_requests_total, weedtpu_tenant_bytes_total, booked on
    success only, beside the byte ledger's booking) and the tenant heat
    dimension are booked here and nowhere else.

    The class becomes ambient for the handler;
    the request and reply bodies are booked into the byte ledger, and
    the request into weedtpu_http_requests_total{server,op,class}
    (op "internal" for cluster plumbing).  An incoming X-Weedtpu-Deadline,
    else the WEEDTPU_DEADLINE_MS edge default for data-plane requests,
    bounds the handler: at expiry it answers a fast 504."""
    import asyncio

    from aiohttp import web

    from seaweedfs_tpu_torch.stats import heat, metrics, netflow
    from seaweedfs_tpu_torch.utils import resilience, weedlog

    counter = itertools.count(1)

    @web.middleware
    async def middleware(req: web.Request, handler):
        hdr = req.headers.get(TRACE_HEADER)
        t_in = parse_header(hdr) if hdr else None
        rate = sample_rate()
        parent_id = None
        if t_in is not None:
            # continue the caller's trace under a fresh span id: the
            # header's span id is the caller's current span, our parent.
            # A pinned trace samples whatever the header's flag says
            parent_id = t_in.span_id
            sampled = t_in.sampled or (bool(_pinned)
                                       and t_in.trace_id in _pinned)
            t = Trace(t_in.trace_id, _new_span_id(), sampled)
        elif rate > 0 and next(counter) % rate == 0:
            t = Trace(_new_trace_id(), _new_span_id(), True)
        else:
            t = None
        token = _current.set(t) if t is not None else None
        trusted = trust_flow is True or \
            (trust_flow == "loopback" and req.remote in ("127.0.0.1",
                                                         "::1"))
        if trusted:
            flow_cls = netflow.extract_class(req.headers, req.path)
            flow_peer = req.headers.get(netflow.ROLE_HEADER, "client")
        else:
            flow_cls = netflow.classify(req.path)
            flow_peer = "client"
        # a declared-internal request must not inflate the data-plane
        # availability denominators
        if flow_cls == "internal" or netflow.is_internal(req.path):
            op = "internal"
        else:
            op = "read" if req.method in ("GET", "HEAD") else "write"
        # a trusted header wins (an inner hop inheriting the edge's
        # tenant); else the tenant edge resolves it from the request.
        # The header is caller-sized: the tenant becomes a metric label
        tenant = None
        hdr_tenant = req.headers.get(heat.TENANT_HEADER)
        if hdr_tenant and trusted:
            tenant = hdr_tenant[:64]
        elif tenant_resolver is not None:
            try:
                tenant = tenant_resolver(req)
            except Exception:
                tenant = "anonymous"
        tenant_token = heat.set_tenant(tenant) if tenant else None
        flow_token = netflow.set_class(flow_cls)
        deadline_s = resilience.extract_deadline_s(req.headers)
        if deadline_s is None and op != "internal":
            edge = resilience.default_deadline_ms()
            if edge > 0:
                deadline_s = edge / 1000.0
        dl_token = resilience.set_deadline(
            time.monotonic() + deadline_s) if deadline_s is not None \
            else None
        rid = request_started(req.method, req.path_qs, req.remote,
                              t.trace_id if t is not None else None)
        start = time.time()
        t0 = time.perf_counter()
        status = 500
        cancelled = False
        timed_out = False
        resp_obj = None
        try:
            if dl_token is not None:
                try:
                    resp = await asyncio.wait_for(handler(req),
                                                  timeout=deadline_s)
                except (asyncio.TimeoutError,
                        resilience.DeadlineExceeded) as te:
                    # only OUR budget expiring is a deadline 504: a
                    # timeout escaping the handler with budget still on
                    # the clock is that code path's own failure
                    rem = resilience.remaining()
                    if not isinstance(te, resilience.DeadlineExceeded) \
                            and rem is not None and rem > 0.01:
                        raise
                    timed_out = True
                    metrics.DEADLINE_TIMEOUTS.labels(role).inc()
                    if req.get(netflow.PREPARED_KEY):
                        # headers are on the wire: a fresh 504 cannot be
                        # delivered, so the connection goes down now
                        if req.transport is not None:
                            req.transport.close()
                        raise ConnectionResetError(
                            "deadline exceeded mid-stream") from None
                    resp = web.json_response(
                        {"error": "deadline exceeded",
                         "budget_ms": round(deadline_s * 1000.0, 1)},
                        status=504)
            else:
                resp = await handler(req)
            status = resp.status
            resp_obj = resp
            return resp
        except web.HTTPException as e:
            status = e.status
            resp_obj = e  # an HTTPException is a Response (has a body)
            raise
        except (asyncio.CancelledError, ConnectionResetError,
                BrokenPipeError):
            # the client hung up: a fact about the caller, not a server
            # error -- except the mid-stream deadline teardown above
            if timed_out:
                status = 504
            else:
                cancelled = True
            raise
        finally:
            ms = (time.perf_counter() - t0) * 1000.0
            request_finished(rid)
            if token is not None:
                _current.reset(token)
            if dl_token is not None:
                resilience.reset_deadline(dl_token)
            netflow.reset(flow_token)
            if tenant_token is not None:
                heat.reset_tenant(tenant_token)
            # chunked uploads have no Content-Length; the payload
            # StreamReader's total_bytes knows what actually arrived
            recv = req.content_length if req.content_length is not None \
                else getattr(req.content, "total_bytes", 0)
            sent = netflow.response_bytes(resp_obj)
            netflow.account("recv", flow_cls, flow_peer, recv or 0)
            netflow.account("sent", flow_cls, flow_peer, sent)
            if tenant and tenant_resolver is not None \
                    and op != "internal":
                # the counters book successes only: the tenant is read
                # before auth, and booking 4xx would let a caller mint a
                # label per random access key; rejected load still shows
                # in the bounded, decaying heat sketch
                if status < 400 and not cancelled:
                    metrics.TENANT_REQUESTS.labels(tenant, op).inc()
                    if recv:
                        metrics.TENANT_BYTES.labels(
                            tenant, "recv", op).inc(recv)
                    if sent:
                        metrics.TENANT_BYTES.labels(
                            tenant, "sent", op).inc(sent)
                heat.record("tenant", tenant, (recv or 0) + sent,
                            "write" if op == "write" else "read")
            if not cancelled:
                metrics.HTTP_REQUESTS.labels(
                    role, op, f"{status // 100}xx").inc()
            slow = ms >= slow_ms() and not cancelled and \
                req.path not in slow_exempt
            errored = status >= 500 and not cancelled
            if t is not None and t.sampled:
                attrs = {"method": req.method, "path": req.path,
                         "status": status, "server": role}
                if region:
                    attrs["region"] = region
                if cancelled:
                    attrs["cancelled"] = True
                if timed_out:
                    # the waterfall's "this hop ran out of budget" mark
                    attrs["op"] = "timeout"
                    attrs["budget_ms"] = round(deadline_s * 1000.0, 1)
                record_span(f"{role}.request", t.trace_id, t.span_id,
                            parent_id, start, ms, attrs, errored)
            elif rate > 0 and (slow or errored):
                # keep slow and errored requests even when sampled out:
                # a root span appears retroactively
                retro = t or Trace(_new_trace_id(), _new_span_id(), True)
                retro_attrs = {"method": req.method, "path": req.path,
                               "status": status, "server": role,
                               "retro": True}
                if region:
                    retro_attrs["region"] = region
                if timed_out:
                    retro_attrs["op"] = "timeout"
                record_span(f"{role}.request", retro.trace_id,
                            retro.span_id, None, start, ms,
                            retro_attrs, errored)
                t = retro
            if slow and rate > 0:
                weedlog.info(
                    "slow request: %s %s %s took %.1fms (status %d) "
                    "trace=%s", role, req.method, req.path_qs, ms,
                    status, t.trace_id if t is not None else "-",
                    name="trace")

    return middleware


async def handle_debug_traces(req):
    """``/debug/traces[?min_ms=&limit=&tid=&pin=1]``: recent traces of
    this process; with `tid` and `pin` that trace is pinned first."""
    from aiohttp import web
    try:
        min_ms = float(req.query.get("min_ms", "0"))
    except ValueError:
        min_ms = 0.0
    try:
        limit = int(req.query.get("limit", "50"))
    except ValueError:
        limit = 50
    tid = req.query.get("tid") or None
    if tid is not None and req.query.get("pin"):
        pin_trace(tid)
    return web.json_response({"sample_rate": sample_rate(),
                              "traces": traces(min_ms, limit, tid=tid)})


async def handle_debug_requests(req):
    """``/debug/requests``: the requests in flight, oldest first."""
    from aiohttp import web
    return web.json_response({"requests": inflight()})


def loopback_error(req):
    """None when the request comes from loopback; a 403 JSON response
    otherwise.  The one gate of the operator surfaces: the `/debug`
    routes and the volume server's `/admin/scrub` and `/admin/faults`."""
    from aiohttp import web
    if req.remote not in ("127.0.0.1", "::1"):
        return web.json_response({"error": "forbidden"}, status=403)
    return None


def debug_guard(handler):
    """`handler` behind `loopback_error`: the debug surface must not show
    request paths, query strings or stacks to a remote caller."""
    async def guarded(req):
        err = loopback_error(req)
        if err is not None:
            return err
        return await handler(req)
    return guarded


def debug_routes():
    """The routes every server mounts before any catch-all, loopback-gated
    as one: /debug/traces, /debug/requests, /debug/pprof,
    /debug/pipeline."""
    from aiohttp import web

    from seaweedfs_tpu_torch.stats import pipeline, profile
    return [web.get("/debug/traces", debug_guard(handle_debug_traces)),
            web.get("/debug/requests", debug_guard(handle_debug_requests)),
            web.get("/debug/pprof", debug_guard(profile.handle_debug_pprof)),
            web.get("/debug/pipeline",
                    debug_guard(pipeline.handle_debug_pipeline))]
