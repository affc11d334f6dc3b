"""The PyTorch/CUDA port's resilience layer and pooled client held against
the JAX package: deadlines, the retry budget, hedge delays, circuit
breakers (`utils/resilience.py`), `PooledHTTP`'s stale-connection retry
and breaker gate (`utils/http.py`), their metric families, and the knobs,
which raise in the port on a malformed value where the reference falls
back to its default.  No card is involved.
"""

import random
import socket
import threading
import time

import pytest

from seaweedfs_tpu.stats import metrics as ref_metrics
from seaweedfs_tpu.storage.ec import ec_volume as ref_ecv
from seaweedfs_tpu.utils import http as ref_http
from seaweedfs_tpu.utils import resilience as ref_res

from seaweedfs_tpu_torch.stats import metrics
from seaweedfs_tpu_torch.storage.ec import ec_volume
from seaweedfs_tpu_torch.utils import http, resilience

PACKAGES = {"port": (resilience, http, metrics),
            "ref": (ref_res, ref_http, ref_metrics)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(autouse=True)
def _fresh_state():
    for res in (resilience, ref_res):
        res.reset_breakers()
        res.reset_retry_budget()
        res.reset_latency_trackers()
    yield
    for res in (resilience, ref_res):
        res.reset_breakers()
        res.reset_retry_budget()
        res.reset_latency_trackers()


# ---- deadlines ----------------------------------------------------------

def test_deadline_header_roundtrip():
    tok = resilience.set_deadline(time.monotonic() + 0.5)
    try:
        headers: dict = {}
        resilience.inject_deadline(headers)
        ms = int(headers[resilience.DEADLINE_HEADER])
        assert 0 < ms <= 500
        assert 0.0 < resilience.extract_deadline_s(headers) <= 0.5
        assert 0.0 < resilience.clamp_timeout(30.0) <= 0.5
    finally:
        resilience.reset_deadline(tok)
    assert resilience.remaining() is None
    assert resilience.clamp_timeout(30.0) == 30.0
    assert resilience.extract_deadline_s({}) is None
    assert resilience.extract_deadline_s(
        {resilience.DEADLINE_HEADER: "soon"}) is None


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_deadline_header_crosses_packages(writer, reader):
    """A budget stamped by one package's client is the budget the other
    package's server reads."""
    w, r = PACKAGES[writer][0], PACKAGES[reader][0]
    assert w.DEADLINE_HEADER == r.DEADLINE_HEADER
    tok = w.set_deadline(time.monotonic() + 2.0)
    try:
        headers = w.inject_deadline({})
    finally:
        w.reset_deadline(tok)
    assert 1.5 < r.extract_deadline_s(headers) <= 2.0


def test_deadline_expiry_raises():
    tok = resilience.set_deadline(time.monotonic() - 0.01)
    try:
        with pytest.raises(resilience.DeadlineExceeded):
            resilience.check_deadline("unit test")
        # it walks like the transport errors callers already handle
        assert issubclass(resilience.DeadlineExceeded, OSError)
        assert resilience.clamp_timeout(30.0) == 0.001
    finally:
        resilience.reset_deadline(tok)
    resilience.check_deadline("no budget")  # no deadline: never raises


# ---- circuit breakers ---------------------------------------------------

def test_circuit_breaker_trip_halfopen_close():
    br = resilience.CircuitBreaker(threshold=3, cooldown=0.05)
    assert br.allow()
    for _ in range(3):
        br.record(False)
    assert br.state == "open" and not br.allow()
    time.sleep(0.08)
    assert br.allow()  # half-open probe
    assert not br.allow()  # only one probe at a time
    br.record(False)  # probe failed: re-open
    assert br.state == "open"
    time.sleep(0.08)
    assert br.allow()
    br.record(True)
    assert br.state == "closed" and br.allow()
    assert br.snapshot()["trips"] == 2


def test_breakers_snapshot_equals_reference(monkeypatch):
    """The same outcomes against the same peers leave the same registry:
    only breakers that tripped or failed are listed."""
    monkeypatch.setenv("WEEDTPU_BREAKER_THRESHOLD", "2")
    monkeypatch.setenv("WEEDTPU_BREAKER_COOLDOWN", "30")
    snaps = []
    for res in (resilience, ref_res):
        for peer, outcomes in (("a:1", [False, False]), ("b:2", [False]),
                               ("c:3", [False, True])):
            br = res.breaker_for(peer)
            for ok in outcomes:
                br.record(ok)
        snap = res.breakers_snapshot()
        for s in snap.values():
            s.pop("open_for_s", None)  # jittered
        snaps.append(snap)
    assert snaps[0] == snaps[1]
    assert snaps[0]["a:1"]["state"] == "open" and "c:3" not in snaps[0]


# ---- retry budget -------------------------------------------------------

def test_retry_budget_caps_spend(monkeypatch):
    monkeypatch.setenv("WEEDTPU_RETRY_BUDGET", "1:3")
    resilience.reset_retry_budget()
    b = resilience.retry_budget()
    got = sum(1 for _ in range(50) if b.try_spend("t"))
    assert got <= 4  # burst 3 (+ maybe one refilled token)
    assert not b.try_spend("t")
    # other classes have their own bucket
    assert b.try_spend("other")


def test_spend_retry_books_like_reference(monkeypatch):
    """A dry budget: each package books the same allowed and denied
    spends into its weedtpu_retry_total."""
    monkeypatch.setenv("WEEDTPU_RETRY_BUDGET", "0.001:2")
    grown = []
    for res, met in ((resilience, metrics), (ref_res, ref_metrics)):
        res.reset_retry_budget()
        a0 = met.RETRY_TOTAL.labels("storm", "allowed").value
        d0 = met.RETRY_TOTAL.labels("storm", "denied").value
        outcomes = [res.spend_retry("storm") for _ in range(5)]
        grown.append((outcomes,
                      met.RETRY_TOTAL.labels("storm", "allowed").value - a0,
                      met.RETRY_TOTAL.labels("storm", "denied").value - d0))
    assert grown[0] == grown[1] == ([True, True, False, False, False], 2, 3)


# ---- hedging ------------------------------------------------------------

def test_latency_tracker_and_hedge_delay(monkeypatch):
    tr = resilience.LatencyTracker()
    assert tr.percentile(0.99) is None
    for ms in range(1, 101):
        tr.observe(ms / 1000.0)
    p99 = tr.percentile(0.99)
    assert 0.095 <= p99 <= 0.1
    monkeypatch.setenv("WEEDTPU_HEDGE_PCT", "99")
    assert abs(resilience.hedge_delay_s(tr) - p99) < 0.01
    monkeypatch.setenv("WEEDTPU_HEDGE_PCT", "0")
    assert resilience.hedge_delay_s(tr) is None
    monkeypatch.setenv("WEEDTPU_HEDGE_PCT", "99")
    monkeypatch.setenv("WEEDTPU_HEDGE_MAX_MS", "50")
    assert resilience.hedge_delay_s(tr) == 0.05
    monkeypatch.delenv("WEEDTPU_HEDGE_MAX_MS")
    assert resilience.hedge_delay_s() == 0.05  # no history yet


@pytest.mark.parametrize("env", [
    {}, {"WEEDTPU_HEDGE_PCT": "50"}, {"WEEDTPU_HEDGE_PCT": "0"},
    {"WEEDTPU_HEDGE_PCT": "99", "WEEDTPU_HEDGE_MIN_MS": "40",
     "WEEDTPU_HEDGE_MAX_MS": "60"}])
@pytest.mark.parametrize("history", [0, 7, 300])
def test_hedge_delay_equals_reference(monkeypatch, env, history):
    """The same seeded latencies (more than the window, for 300) and the
    same knobs give the same hedge delay in both packages."""
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    rng = random.Random(history)
    lat = [rng.uniform(0.001, 0.2) for _ in range(history)]
    got = []
    for res in (resilience, ref_res):
        tr = res.LatencyTracker()
        for s in lat:
            tr.observe(s)
        got.append((res.hedge_delay_s(tr), len(tr),
                    tr.percentile(0.5)))
    assert got[0] == got[1]


# ---- knobs --------------------------------------------------------------

def _call(res, name):
    """The call that reads knob `name` in package module `res`."""
    return {
        "WEEDTPU_HEDGE_PCT": lambda: res.hedge_delay_s(),
        "WEEDTPU_HEDGE_MIN_MS": lambda: res.hedge_delay_s(),
        "WEEDTPU_HEDGE_MAX_MS": lambda: res.hedge_delay_s(),
        "WEEDTPU_BREAKER_THRESHOLD": lambda: res.CircuitBreaker().threshold,
        "WEEDTPU_BREAKER_COOLDOWN": lambda: res.CircuitBreaker().cooldown,
        "WEEDTPU_DEADLINE_MS": lambda: res.default_deadline_ms(),
        "WEEDTPU_RETRY_BUDGET": lambda: res.retry_budget().snapshot(),
        "WEEDTPU_BREAKER": lambda: res.breaker_enabled(),
    }[name]()


@pytest.mark.parametrize("name,value", [
    ("WEEDTPU_HEDGE_PCT", "ninety"), ("WEEDTPU_HEDGE_MIN_MS", "1ms"),
    ("WEEDTPU_HEDGE_MAX_MS", ""), ("WEEDTPU_BREAKER_THRESHOLD", "five"),
    ("WEEDTPU_BREAKER_COOLDOWN", "2s"), ("WEEDTPU_DEADLINE_MS", "x"),
    ("WEEDTPU_RETRY_BUDGET", "fast:8"), ("WEEDTPU_BREAKER", "yes")])
def test_malformed_knob_raises_where_reference_falls_back(monkeypatch, name,
                                                          value):
    """A kept difference: the port raises ValueError on a malformed knob;
    the reference returns what its default gives."""
    want = _call(ref_res, name)  # the reference's default
    monkeypatch.setenv(name, value)
    ref_res.reset_retry_budget()
    resilience.reset_retry_budget()
    assert _call(ref_res, name) == want
    with pytest.raises(ValueError, match=name):
        _call(resilience, name)


def test_ec_read_mode_raises_where_reference_falls_back(monkeypatch):
    """WEEDTPU_EC_READ: the reference reads any value but "serial" as the
    batched engine; the port takes "batched" or "serial" and raises on
    anything else, before it reads a byte."""
    assert ec_volume.read_mode() == "batched"
    monkeypatch.setenv("WEEDTPU_EC_READ", "serial")
    assert ec_volume.read_mode() == "serial"
    assert ec_volume.read_mode("batched") == "batched"
    monkeypatch.setenv("WEEDTPU_EC_READ", "bogus")
    with pytest.raises(ValueError, match="bogus"):
        ec_volume.read_mode()
    with pytest.raises(ValueError, match="fast"):
        ec_volume.read_mode("fast")

    class Probe(ref_ecv.EcVolume):
        """The reference's read path up to the engine it picks."""
        def __init__(self):
            self.picked = []
            self.large_block = self.small_block = 100
            self.dat_size = 1000
            self.version = 3
            self.spec = type("S", (), {"k": 10})

        def find_needle(self, nid):
            return 0, 10

        def _read_ranges(self, plan, reader):
            self.picked.append("batched")
            raise StopIteration

        def read_interval(self, *a):
            self.picked.append("serial")
            raise StopIteration

    probe = Probe()
    with pytest.raises(StopIteration):
        probe.read_needle(1)
    assert probe.picked == ["batched"]  # "bogus" fell back


# ---- metric families ----------------------------------------------------

@pytest.mark.parametrize("family", ["RETRY_TOTAL", "HEDGE_TOTAL",
                                    "HTTP_POOL_REUSE", "HTTP_POOL_DIAL",
                                    "EC_DEGRADED_READ"])
def test_metric_family_equals_reference(family):
    mine, ref = getattr(metrics, family), getattr(ref_metrics, family)
    assert (mine.name, mine.help, mine.label_names, mine.kind) == \
        (ref.name, ref.help, ref.label_names, ref.kind)


# ---- PooledHTTP ---------------------------------------------------------

class _FlakyServer:
    """Serves `serve_n` requests per connection, then closes it: the
    client's parked keep-alive socket goes stale under it."""

    def __init__(self):
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.port = self.sock.getsockname()[1]
        self.requests: list[str] = []
        self._stop = False
        self.serve_n = 1
        threading.Thread(target=self._run, daemon=True).start()

    def _run(self):
        while not self._stop:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn):
        served = 0
        buf = b""
        try:
            while served < self.serve_n:
                while b"\r\n\r\n" not in buf:
                    chunk = conn.recv(65536)
                    if not chunk:
                        return
                    buf += chunk
                head, _, buf = buf.partition(b"\r\n\r\n")
                method = head.split(b" ", 1)[0].decode()
                cl = 0
                for line in head.split(b"\r\n"):
                    if line.lower().startswith(b"content-length:"):
                        cl = int(line.split(b":")[1])
                while len(buf) < cl:
                    buf += conn.recv(65536)
                buf = buf[cl:]
                self.requests.append(method)
                conn.sendall(b"HTTP/1.1 200 OK\r\n"
                             b"Content-Length: 2\r\n\r\nok")
                served += 1
        finally:
            conn.close()

    def close(self):
        self._stop = True
        self.sock.close()


def _stale_retry(http_mod, met):
    srv = _FlakyServer()
    pool = http_mod.PooledHTTP(timeout=5.0)
    base = f"http://127.0.0.1:{srv.port}"
    dial0 = met.HTTP_POOL_DIAL.labels().value
    reuse0 = met.HTTP_POOL_REUSE.labels().value
    try:
        # the first GET parks a keep-alive conn the server then closes:
        # the second GET meets a stale socket and is retried on a fresh
        # dial, transparently
        st, _, body = pool.request(f"{base}/a")
        assert st == 200 and body == b"ok"
        time.sleep(0.05)
        st, _, body = pool.request(f"{base}/b")
        assert st == 200 and body == b"ok"
        assert srv.requests == ["GET", "GET"]
        # a POST on a stale conn whose response never comes (its bytes may
        # have reached the peer) is not replayed: the error surfaces
        time.sleep(0.05)
        with pytest.raises(Exception):
            pool.request(f"{base}/c", method="POST", body=b"payload")
        assert srv.requests.count("POST") <= 1
    finally:
        pool.close()
        srv.close()
    return (met.HTTP_POOL_DIAL.labels().value - dial0,
            met.HTTP_POOL_REUSE.labels().value - reuse0)


def test_pooled_http_retry_idempotent_only():
    """Each package's client behaves alike against the same flaky peer,
    and books the same dials and reuses."""
    assert _stale_retry(http, metrics) == _stale_retry(ref_http, ref_metrics)


def test_pooled_http_breaker_fast_fails(monkeypatch):
    monkeypatch.setenv("WEEDTPU_BREAKER_THRESHOLD", "3")
    monkeypatch.setenv("WEEDTPU_BREAKER_COOLDOWN", "30")
    pool = http.PooledHTTP(timeout=0.5)
    port = _free_port()  # nothing listens here
    url = f"http://127.0.0.1:{port}/x"
    try:
        for _ in range(3):
            with pytest.raises(OSError):
                pool.request(url)
        # the breaker is open: the failure is instant, not a dial
        t0 = time.perf_counter()
        with pytest.raises(ConnectionRefusedError, match="circuit open"):
            pool.request(url)
        assert time.perf_counter() - t0 < 0.1
        snap = resilience.breakers_snapshot()
        assert snap[f"127.0.0.1:{port}"]["state"] == "open"
        assert snap[f"127.0.0.1:{port}"]["failures"] == 3
    finally:
        pool.close()


def test_pooled_http_refuses_a_spent_deadline():
    """No dial once the ambient budget is spent."""
    pool = http.PooledHTTP(timeout=5.0)
    tok = resilience.set_deadline(time.monotonic() - 0.001)
    try:
        with pytest.raises(resilience.DeadlineExceeded):
            pool.request(f"http://127.0.0.1:{_free_port()}/x")
    finally:
        resilience.reset_deadline(tok)
        pool.close()
    assert resilience.breakers_snapshot() == {}
