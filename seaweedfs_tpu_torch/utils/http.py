"""Blocking keep-alive HTTP/1.1 client for peer calls.

Counterpart of `seaweedfs_tpu/utils/http.py`, cut to `PooledHTTP` and the
raw codec under it (`_RawConn`), which the EC read engine's remote shard
fetches ride: keep-alive pools with idle pruning, one transparent
fresh-dial retry (idempotent methods, or a send the kernel refused, with
a retry-budget token), the per-peer circuit breaker, the ambient deadline
(checked, clamped into the socket timeout, forwarded in
``X-Weedtpu-Deadline``), the trace and traffic-class headers, TLS dials
(security/tls.py) and the reuse/dial counters.  The servers' aiohttp
client sessions mount `aiohttp_trace_config`, and the blob read path
parses `Range` with `parse_range`.  Both clients forward the ambient
tenant (stats/heat.py) and pass every dial through the network faults
(maintenance/faults.py: a partition refuses it, an error rate resets it,
a latency delays it) while one is armed.  `post_json` is the volume
move's call to its target's admin routes; `shutdown_response` cuts a
live feed a reader is blocked on.
"""

from __future__ import annotations

import http.client
import socket
import threading
import time
import urllib.parse

from seaweedfs_tpu_torch.stats import heat as _heat
from seaweedfs_tpu_torch.stats import metrics as _metrics
from seaweedfs_tpu_torch.stats import netflow as _netflow
from seaweedfs_tpu_torch.stats import trace as _trace
from seaweedfs_tpu_torch.utils import resilience as _res


class _BadResponse(http.client.HTTPException):
    pass


class _RawConn:
    """One raw keep-alive socket + a minimal HTTP/1.1 client codec.

    http.client parses response headers through email.feedparser — at
    benchmark request rates that parser (plus per-request settimeout
    syscalls and header-object churn) is a measurable share of CLIENT
    cpu, which on a small host competes with the very server being
    measured.  The repo's servers speak plain HTTP/1.1 with
    content-length or chunked bodies, which this codec covers; anything
    it cannot parse raises and the caller falls back to a fresh dial."""

    __slots__ = ("sock", "buf", "timeout")

    def __init__(self, sock: socket.socket, timeout: float):
        self.sock = sock
        self.buf = b""
        self.timeout = timeout

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    def _read_until(self, marker: bytes) -> bytes:
        """Consume through `marker`; returns everything before it."""
        while True:
            i = self.buf.find(marker)
            if i >= 0:
                out = self.buf[:i]
                self.buf = self.buf[i + len(marker):]
                return out
            chunk = self.sock.recv(65536)
            if not chunk:
                raise _BadResponse("connection closed mid-response")
            self.buf += chunk

    def _read_exact(self, n: int) -> bytes:
        parts = []
        if self.buf:
            take = self.buf[:n]
            parts.append(take)
            self.buf = self.buf[len(take):]
            n -= len(take)
        while n > 0:
            chunk = self.sock.recv(min(1 << 20, max(n, 65536)))
            if not chunk:
                raise _BadResponse("connection closed mid-body")
            if len(chunk) > n:
                parts.append(chunk[:n])
                self.buf += chunk[n:]
                n = 0
            else:
                parts.append(chunk)
                n -= len(chunk)
        return b"".join(parts)

    def _read_head(self) -> tuple[bytes, int, dict]:
        """One status-line + header block -> (http version, status,
        lowercased header dict)."""
        head = self._read_until(b"\r\n\r\n")
        lines = head.split(b"\r\n")
        parts = lines[0].split(None, 2)
        if len(parts) < 2 or not parts[0].startswith(b"HTTP/1."):
            raise _BadResponse(f"bad status line {lines[0]!r}")
        try:
            status = int(parts[1])
        except ValueError:
            raise _BadResponse(f"bad status line {lines[0]!r}") from None
        hdrs: dict = {}
        for line in lines[1:]:
            k, sep, v = line.partition(b":")
            if sep:
                hdrs[k.strip().lower().decode("latin-1")] = \
                    v.strip().decode("latin-1")
        return parts[0], status, hdrs

    def roundtrip(self, method: str, path: str, host: str, body,
                  headers: dict, timeout: float
                  ) -> tuple[int, dict, bytes, bool]:
        """-> (status, lowercased header dict, body, keep_alive)."""
        if timeout != self.timeout:
            self.sock.settimeout(timeout)
            self.timeout = timeout
        out = [f"{method} {path} HTTP/1.1\r\nHost: {host}\r\n"]
        has_cl = False
        for k, v in headers.items():
            lk = k.lower()
            if lk == "content-length":
                has_cl = True
            out.append(f"{k}: {v}\r\n")
        if body is not None and not has_cl:
            out.append(f"Content-Length: {len(body)}\r\n")
        elif body is None and method in ("POST", "PUT"):
            out.append("Content-Length: 0\r\n")
        out.append("\r\n")
        req = "".join(out).encode("latin-1")
        try:
            # one sendall for headers+body keeps small uploads to one
            # syscall
            self.sock.sendall(req + body if body is not None else req)
        except ConnectionError as e:
            # the kernel refused the send outright (EPIPE/ECONNRESET on
            # a connection the peer already closed): the request never
            # reached the peer application, so even a non-idempotent
            # replay is safe — PooledHTTP's retry logic keys off this.
            # A send TIMEOUT deliberately does NOT qualify: bytes may be
            # partially on the wire.
            e._weedtpu_send_phase = True  # type: ignore[attr-defined]
            raise
        version, status, hdrs = self._read_head()
        while status == 100:  # 100-continue: parse the real response
            version, status, hdrs = self._read_head()
        keep = version != b"HTTP/1.0" and \
            "close" not in hdrs.get("connection", "").lower()
        if method == "HEAD" or status in (204, 304):
            return status, hdrs, b"", keep
        if "chunked" in hdrs.get("transfer-encoding", "").lower():
            chunks = []
            while True:
                size_line = self._read_until(b"\r\n")
                size = int(size_line.split(b";")[0], 16)
                if size == 0:
                    # trailers (none from our servers) up to the blank line
                    while True:
                        line = self._read_until(b"\r\n")
                        if not line:
                            break
                    break
                chunks.append(self._read_exact(size))
                if self._read_exact(2) != b"\r\n":
                    raise _BadResponse("bad chunk terminator")
            return status, hdrs, b"".join(chunks), keep
        cl = hdrs.get("content-length")
        if cl is not None:
            return status, hdrs, self._read_exact(int(cl)), keep
        # no framing: body runs to EOF, connection not reusable
        parts_body = [self.buf]
        self.buf = b""
        while True:
            chunk = self.sock.recv(1 << 20)
            if not chunk:
                break
            parts_body.append(chunk)
        return status, hdrs, b"".join(parts_body), False


def shutdown_response(resp) -> None:
    """Cut an open urllib response's connection, waking a thread blocked
    in its read (shutdown acts on the connection, so a duplicate of the
    descriptor will do): how a mount's feed and a sync pump's live
    stream end at once."""
    try:
        s = socket.fromfd(resp.fileno(), socket.AF_INET, socket.SOCK_STREAM)
    except (OSError, ValueError, AttributeError):
        return  # already closed
    try:
        s.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    finally:
        s.close()


class PooledHTTP:
    """Keep-alive HTTP/1.1 connection pool keyed by (scheme, host).

    The Python analogue of the Go http.Client transport reuse the
    reference's `weed benchmark` leans on: without it every blob
    operation pays a fresh TCP (and TLS) handshake, so a benchmark
    client measures connection-setup rate instead of server rate.
    Thread-safe; connections are returned to the pool only after the
    response body is fully read.  A request on a reused connection that
    dies before yielding a response is retried ONCE on a fresh
    connection (the idle peer may have closed it under us).  Idle
    sockets older than `idle_timeout` are closed on the next pool
    touch — Go's Transport.IdleConnTimeout — so a long-lived daemon
    does not hold fds to every peer it ever contacted."""

    def __init__(self, timeout: float = 30.0, max_idle_per_host: int = 16,
                 idle_timeout: float = 60.0, role: str = "client",
                 region: str = ""):
        self.timeout = timeout
        self.max_idle_per_host = max_idle_per_host
        self.idle_timeout = idle_timeout
        # announced to peers in X-Weedtpu-Role so their byte ledger can
        # label who it was talking to (the master's aggregator and the
        # shell pass their own roles; plain clients stay "client")
        self.role = role
        # fault-plane identities: a region-aware client (the sync pump)
        # declares its home region so region_partition / wan_latency
        # faults can tell its cross-region dials from local ones
        self._fault_ids = (role, "region:" + region) if region \
            else role
        # key -> [(conn, time.monotonic() when parked), ...]
        self._idle: dict[tuple[str, str],
                         list[tuple[_RawConn, float]]] = {}
        self._lock = threading.Lock()
        self._closed = False
        self._last_prune = 0.0

    @staticmethod
    def _split_host(netloc: str) -> tuple[str, int | None]:
        """-> (host, explicit port or None — scheme default applies)."""
        if netloc.startswith("["):  # [v6]:port
            host, _, rest = netloc[1:].partition("]")
            return host, int(rest[1:]) if rest.startswith(":") else None
        host, sep, port_s = netloc.rpartition(":")
        if sep and port_s.isdigit():
            return host, int(port_s)
        return netloc, None

    def _connect(self, scheme: str, netloc: str,
                 timeout: float) -> _RawConn:
        host, port = self._split_host(netloc)
        if scheme == "https":
            from seaweedfs_tpu_torch.security import tls as _tls
            raw = socket.create_connection((host, port or 443),
                                           timeout=timeout)
            raw.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            ctx = _tls.client_ssl()
            sock = ctx.wrap_socket(raw, server_hostname=host)
        else:
            sock = socket.create_connection((host, port or 80),
                                            timeout=timeout)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return _RawConn(sock, timeout)

    def _prune_locked(self, now: float) -> list[_RawConn]:
        """Drop expired idle connections from EVERY key (a host we stopped
        talking to would otherwise keep its sockets forever).  Caller
        holds the lock; the expired conns are returned so the actual
        close() — which may block on TLS shutdown — happens outside it.
        Throttled to ~1Hz: pruning walks every idle list under the global
        lock, and a hot client calls this twice per request — at
        benchmark rates that walk was a measurable share of client CPU
        for a deadline that only needs one-second resolution."""
        expired: list[_RawConn] = []
        if now - self._last_prune < 1.0:
            return expired
        self._last_prune = now
        for key in list(self._idle):
            fresh = [(c, ts) for c, ts in self._idle[key]
                     if now - ts < self.idle_timeout]
            expired += [c for c, ts in self._idle[key]
                        if now - ts >= self.idle_timeout]
            if fresh:
                self._idle[key] = fresh
            else:
                del self._idle[key]
        return expired

    def _get_conn(self, key: tuple[str, str],
                  timeout: float) -> tuple[_RawConn, bool]:
        now = time.monotonic()
        with self._lock:
            expired = self._prune_locked(now)
            idle = self._idle.get(key)
            conn = idle.pop()[0] if idle else None
        for c in expired:
            c.close()
        if conn is not None:
            return conn, True
        return self._connect(key[0], key[1], timeout), False

    def _put_conn(self, key: tuple[str, str], conn: _RawConn) -> None:
        now = time.monotonic()
        parked = False
        with self._lock:
            expired = self._prune_locked(now)
            if not self._closed:
                idle = self._idle.setdefault(key, [])
                if len(idle) < self.max_idle_per_host:
                    idle.append((conn, now))
                    parked = True
        for c in expired:
            c.close()
        if not parked:
            conn.close()

    # methods safe to replay after a mid-flight transport failure (the
    # peer may have processed the first copy)
    IDEMPOTENT = frozenset({"GET", "HEAD", "DELETE"})

    def request(self, url: str, method: str = "GET", body=None,
                headers: dict | None = None,
                timeout: float | None = None) -> tuple[int, dict, bytes]:
        """-> (status, response headers [lowercased keys], body bytes).
        Never raises for HTTP error statuses — only for transport
        failures.

        Stale-keep-alive retry policy: a request on a REUSED connection
        that dies is retried once on a fresh dial — but only when the
        replay is provably safe: idempotent methods always, anything
        else only when the send itself failed at the kernel (the request
        never reached the peer application) AND the process-wide retry
        budget grants a token, so a dead peer can't turn N writers into
        a retry storm."""
        u = urllib.parse.urlsplit(url)
        key = (u.scheme, u.netloc)
        path = u.path or "/"
        if u.query:
            path += "?" + u.query
        tmo = self.timeout if timeout is None else timeout
        # ambient deadline budget: clamp the socket timeout and forward
        # the remainder to the peer
        _res.check_deadline(f"{method} {u.netloc}{u.path}")
        tmo = _res.clamp_timeout(tmo)
        if isinstance(body, (bytearray, memoryview)):
            body = bytes(body)
        elif isinstance(body, str):
            body = body.encode()
        # trace propagation: requests made inside a traced context carry
        # it to the peer (a copy, never mutating the caller's dict);
        # byte-flow class + caller role ride along unconditionally
        headers = dict(headers or {})
        if _trace.current() is not None:
            _trace.inject(headers)
        _netflow.inject(headers, u.path or "/", self.role)
        _res.inject_deadline(headers)
        flow_cls = headers.get(_netflow.CLASS_HEADER)
        # the network faults, a test of one module global while none is
        # armed
        from seaweedfs_tpu_torch.maintenance import faults as _faults
        if _faults.NET_ACTIVE:
            lat = _faults.check_net(self._fault_ids, u.netloc)
            if lat > 0:
                time.sleep(lat)
        # per-peer circuit breaker: a tripped peer fast-fails instead of
        # costing every caller its full connect timeout
        breaker = _res.breaker_for(u.netloc) if _res.breaker_enabled() \
            else None
        if breaker is not None and not breaker.allow():
            raise ConnectionRefusedError(
                f"circuit open to {u.netloc} "
                f"({breaker.failures} consecutive failures)")
        last: Exception | None = None
        for attempt in range(2):
            try:
                if attempt:
                    # the retry must DIAL, not pop another idle
                    # connection — a restarted peer leaves every pooled
                    # socket stale
                    conn, reused = self._connect(key[0], key[1], tmo), \
                        False
                else:
                    conn, reused = self._get_conn(key, tmo)
            except OSError:
                # a failed DIAL is always a real peer signal
                if breaker is not None:
                    breaker.record(False)
                raise
            (_metrics.HTTP_POOL_REUSE if reused
             else _metrics.HTTP_POOL_DIAL).labels().inc()
            try:
                status, hdrs, data, keep = conn.roundtrip(
                    method, path, u.netloc, body, headers, tmo)
            except (http.client.HTTPException, OSError, ValueError) as e:
                conn.close()
                # callers expect http.client/OS errors (the http.client
                # contract this pool replaced); a codec parse failure
                # surfacing as ValueError would slip their handlers
                if isinstance(e, ValueError):
                    e = _BadResponse(str(e))
                last = e
                if reused:
                    # stale idle connection: retry on a fresh dial, but
                    # only when replay is safe — idempotent methods, or a
                    # send the kernel rejected outright (never reached
                    # the peer application), and then only with a retry-
                    # budget token (non-idempotent replays are exactly
                    # where a storm multiplies)
                    if method in self.IDEMPOTENT:
                        continue
                    if getattr(e, "_weedtpu_send_phase", False) and \
                            _res.spend_retry(flow_cls or "data"):
                        continue
                if breaker is not None and \
                        (not reused or breaker.state != "closed"):
                    # a FRESH connection failing is a real peer signal
                    # (a stale keep-alive dying is routine churn) — but
                    # a non-closed breaker must always see the outcome,
                    # or an in-flight half-open probe dying on a stale
                    # conn would leave the probe slot dangling
                    breaker.record(False)
                raise e from None
            if breaker is not None:
                breaker.record(True)
            if keep:
                self._put_conn(key, conn)
            else:
                conn.close()
            peer = hdrs.get(_netflow.ROLE_HEADER.lower(), "server")
            _netflow.account("sent", flow_cls, peer,
                             len(body) if body is not None else 0)
            _netflow.account("recv", flow_cls, peer, len(data))
            return status, hdrs, data
        raise last  # type: ignore[misc]

    def close(self) -> None:
        with self._lock:
            self._closed = True
            conns = [c for idle in self._idle.values() for c, _ in idle]
            self._idle.clear()
        for c in conns:
            c.close()


def aiohttp_trace_config(role: str | None = None):
    """aiohttp client half of trace propagation and byte-flow
    accounting: a TraceConfig whose on_request_start opens a client-send
    span per outgoing request on sampled traces (the peer's server span
    parents to it, so the assembler can difference client-observed and
    server-observed duration into per-hop network time), stamps
    X-Weedtpu-Trace, the deadline, the traffic-class, caller-role and
    tenant headers, and whose chunk hooks book body bytes into the
    netflow ledger.  Every server's ClientSession mounts it."""
    import aiohttp

    def _finish_span(ctx, error: bool) -> None:
        span = getattr(ctx, "send_span", None)
        if span is None:
            return
        ctx.send_span = None
        child, parent_id, start, t0 = span
        _trace.record_span(
            "http.send", child.trace_id, child.span_id, parent_id,
            start, (time.perf_counter() - t0) * 1000.0,
            ctx.send_attrs, error)

    async def _on_request_start(session, ctx, params) -> None:
        # the network faults toward this peer, a test of one module
        # global while none is armed
        from seaweedfs_tpu_torch.maintenance import faults as _faults
        if _faults.NET_ACTIVE:
            import asyncio
            netloc = f"{params.url.host}:{params.url.port}"
            try:
                lat = _faults.check_net(role or "client", netloc)
            except OSError as e:
                raise aiohttp.ClientConnectionError(str(e)) from None
            if lat > 0:
                await asyncio.sleep(lat)
        # deadline budget: each hop forwards only what remains
        _res.inject_deadline(params.headers)
        t = _trace.current()
        ctx.send_span = None
        if t is not None:
            hdr_ctx = t
            if t.sampled:
                child = _trace.Trace(t.trace_id, _trace._new_span_id(),
                                     True)
                ctx.send_span = (child, t.span_id, time.time(),
                                 time.perf_counter())
                ctx.send_attrs = {"method": params.method,
                                  "peer": f"{params.url.host}:"
                                          f"{params.url.port}"}
                hdr_ctx = child
            params.headers[_trace.TRACE_HEADER] = \
                _trace.format_header(hdr_ctx)
        ctx.flow_cls = _netflow.current_class() or \
            _netflow.classify(params.url.path)
        params.headers[_netflow.CLASS_HEADER] = ctx.flow_cls
        if role:
            params.headers[_netflow.ROLE_HEADER] = role
        _heat.inject(params.headers)
        ctx.flow_sent = 0
        ctx.flow_peer = None

    async def _on_request_chunk_sent(session, ctx, params) -> None:
        # buffered until the response arrives: only then is the peer's
        # role known (stamped by its on_response_prepare hook)
        ctx.flow_sent += len(params.chunk)

    async def _on_request_end(session, ctx, params) -> None:
        ctx.flow_peer = params.response.headers.get(
            _netflow.ROLE_HEADER, "server")
        _netflow.account("sent", ctx.flow_cls, ctx.flow_peer,
                         ctx.flow_sent)
        ctx.flow_sent = 0
        _finish_span(ctx, params.response.status >= 500)

    async def _on_request_exception(session, ctx, params) -> None:
        _finish_span(ctx, True)

    async def _on_response_chunk_received(session, ctx, params) -> None:
        _netflow.account("recv", ctx.flow_cls,
                         ctx.flow_peer or "server", len(params.chunk))

    tc = aiohttp.TraceConfig()
    tc.on_request_start.append(_on_request_start)
    tc.on_request_chunk_sent.append(_on_request_chunk_sent)
    tc.on_request_end.append(_on_request_end)
    tc.on_request_exception.append(_on_request_exception)
    tc.on_response_chunk_received.append(_on_response_chunk_received)
    return tc


async def post_json(session, node: str, path: str, body: dict,
                    timeout: float = 600.0) -> dict:
    """POST a JSON body to a peer's admin route over an aiohttp session
    and return the parsed reply; a status other than 200 raises
    RuntimeError carrying the peer's error text."""
    import aiohttp

    from seaweedfs_tpu_torch.security.tls import scheme
    async with session.post(
            f"{scheme()}://{node}{path}", json=body,
            timeout=aiohttp.ClientTimeout(total=timeout)) as r:
        try:
            data = await r.json()
        except Exception:
            data = {}
        if r.status != 200:
            raise RuntimeError(f"{node}{path}: HTTP {r.status} "
                               f"{data.get('error', '')}".strip())
        return data


def parse_range(rng: str, size: int) -> tuple[int, int]:
    """Parse a single-range `bytes=` header against a body of `size` bytes.
    Returns (offset, length); raises ValueError for unsatisfiable ranges
    (callers answer 416)."""
    spec = rng[len("bytes="):].split(",")[0].strip()
    start_s, _, end_s = spec.partition("-")
    if start_s == "":
        n = int(end_s)
        if n <= 0:
            raise ValueError(rng)
        start = max(0, size - n)
        end = size - 1
    else:
        start = int(start_s)
        end = int(end_s) if end_s else size - 1
        end = min(end, size - 1)
    if start > end or start >= size:
        raise ValueError(rng)
    return start, end - start + 1
