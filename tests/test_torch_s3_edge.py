"""The tenant edge under the port's S3 gateway, held to the reference:

- the tenant and QoS metric families are the reference's (names, help,
  labels), since /cluster/metrics merges them across packages;
- twin of tests/test_heat.py::test_resolve_tenant_access_key_bucket_anonymous,
  and the port's resolver equal to the reference's on the same inputs;
- `trace.aiohttp_middleware(trust_flow="loopback", tenant_resolver=...)`
  driven with a remote and a loopback peer: a remote caller's class,
  role and tenant headers are ignored and a loopback caller's honoured,
  in both packages' middlewares on the same requests;
- twin of tests/test_heat.py::test_tenant_counters_conserve_with_netflow
  on a port cluster and gateway;
- the five `TenantQoS` twins of tests/test_serving_plane.py, and its
  knobs: a malformed `WEEDTPU_S3_QOS_*` raises in the port where the
  reference falls back to the default;
- twin of tests/test_flight_recorder.py::test_byte_conservation_replicated_write
  on a port cluster.
"""

import asyncio
import time
import urllib.request

import numpy as np
import pytest

from seaweedfs_tpu.s3 import qos as ref_qos
from seaweedfs_tpu.stats import heat as ref_heat
from seaweedfs_tpu.stats import metrics as ref_metrics
from seaweedfs_tpu.stats import netflow as ref_netflow
from seaweedfs_tpu.stats import trace as ref_trace

from seaweedfs_tpu_torch.client import WeedClient
from seaweedfs_tpu_torch.s3.qos import TenantQoS, parse_weights
from seaweedfs_tpu_torch.stats import heat, metrics, netflow, trace
from tests.test_torch_master_cluster import Cluster, free_port


@pytest.fixture(autouse=True)
def _quiet_cluster(monkeypatch):
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "0")
    monkeypatch.setenv("WEEDTPU_REPAIR_INTERVAL", "0")


@pytest.mark.parametrize("name", ["TENANT_REQUESTS", "TENANT_BYTES",
                                  "S3_QOS"])
def test_tenant_families_are_the_references(name):
    ref, mine = getattr(ref_metrics, name), getattr(metrics, name)
    assert (mine.name, mine.help, mine.label_names, mine.kind) == \
        (ref.name, ref.help, ref.label_names, ref.kind)
    assert metrics.REGISTRY._metrics[mine.name] is mine


# ---- tenant resolution ------------------------------------------------------

def test_resolve_tenant_access_key_bucket_anonymous():
    v4 = ("AWS4-HMAC-SHA256 Credential=AKIDEXAMPLE/20260803/us-east-1/"
          "s3/aws4_request, SignedHeaders=host, Signature=deadbeef")
    assert heat.resolve_tenant({"Authorization": v4}, {}, "/b/k") == \
        "AKIDEXAMPLE"
    assert heat.resolve_tenant({"Authorization": "AWS AKV2:sig"}, {},
                               "/b/k") == "AKV2"
    assert heat.resolve_tenant(
        {}, {"X-Amz-Credential": "AKPRE/20260803/r/s3/aws4_request"},
        "/b/k") == "AKPRE"
    assert heat.resolve_tenant({}, {}, "/images/cat.png") == "images"
    assert heat.resolve_tenant({}, {}, "/") == "anonymous"


@pytest.mark.parametrize("headers,query,path", [
    ({"Authorization": "AWS4-HMAC-SHA256 Credential=K1/2026/r/s3/"
                       "aws4_request, SignedHeaders=host, Signature=0"},
     {}, "/b/k"),
    ({"Authorization": "AWS4-HMAC-SHA256 Credential="}, {}, "/bk/x"),
    ({"Authorization": "AWS4-HMAC-SHA256 nothing"}, {}, "/"),
    ({"Authorization": "AWS :sig"}, {}, "/bucket"),
    ({"Authorization": "Bearer x"}, {"X-Amz-Credential": "/x"}, "/b2/"),
    ({}, {"X-Amz-Credential": "AKQ"}, "//"),
    ({}, {}, "/" + "b" * 100 + "/k"),
    ({"Authorization": "AWS " + "k" * 90 + ":s"}, {}, "/b"),
])
def test_resolve_tenant_equals_reference(headers, query, path):
    assert heat.resolve_tenant(headers, query, path) == \
        ref_heat.resolve_tenant(headers, query, path)


# ---- the middleware's trust rule --------------------------------------------

def _mock_req(path, peer, headers):
    from unittest import mock

    from aiohttp.test_utils import make_mocked_request
    tr = mock.Mock()
    tr.get_extra_info = lambda key, default=None: \
        (peer, 1234) if key == "peername" else default
    return make_mocked_request("GET", path, headers=headers, transport=tr)


def _through(trace_mod, heat_mod, netflow_mod, metrics_mod, peer, headers):
    """One GET /bkt/key from `peer` through a tenant-edge middleware of
    one package: what the handler saw (ambient class and tenant) and
    what the edge booked (byte-ledger peer role, tenant counter)."""
    from aiohttp import web
    seen = {}

    async def handler(req):
        seen["class"] = netflow_mod.current_class()
        seen["tenant"] = heat_mod.current_tenant()
        return web.Response(body=b"x" * 10)

    mw = trace_mod.aiohttp_middleware(
        "s3", trust_flow="loopback",
        tenant_resolver=lambda req: heat_mod.resolve_tenant(
            req.headers, req.query, req.path))
    # per series: a role's bytes may sit under several classes
    sent0 = {tuple(lab): ch.value
             for lab, ch in metrics_mod.NET_BYTES._pairs()
             if dict(lab).get("direction") == "sent"}
    reqs0 = {tuple(lab): ch.value
             for lab, ch in metrics_mod.TENANT_REQUESTS._pairs()}
    resp = asyncio.run(mw(_mock_req("/bkt/key", peer, headers), handler))
    assert resp.status == 200
    seen["booked_role"] = sorted({
        dict(lab)["peer_role"]
        for lab, ch in metrics_mod.NET_BYTES._pairs()
        if dict(lab).get("direction") == "sent"
        and ch.value != sent0.get(tuple(lab), 0.0)})
    seen["tenant_requests"] = sorted(
        dict(lab)["tenant"] + ":" + dict(lab)["op"]
        for lab, ch in metrics_mod.TENANT_REQUESTS._pairs()
        if ch.value != reqs0.get(tuple(lab), 0.0))
    return seen


@pytest.mark.parametrize("peer", ["203.0.113.9", "10.1.2.3", "127.0.0.1",
                                  "::1"])
def test_loopback_trust_rule_equals_reference(peer):
    """A remote caller's X-Weedtpu-Class, -Role and -Tenant are ignored
    under trust_flow="loopback": its GET books as data from a client and
    bills the bucket's tenant.  A loopback caller's are honoured.  Both
    packages' middlewares give the same verdict on the same request."""
    headers = {netflow.CLASS_HEADER: "repair",
               netflow.ROLE_HEADER: "volume",
               heat.TENANT_HEADER: "victim-tenant"}
    mine = _through(trace, heat, netflow, metrics, peer, headers)
    ref = _through(ref_trace, ref_heat, ref_netflow, ref_metrics, peer,
                   headers)
    assert mine == ref
    if peer in ("127.0.0.1", "::1"):
        assert mine == {"class": "repair", "tenant": "victim-tenant",
                        "booked_role": ["volume"],
                        "tenant_requests": ["victim-tenant:read"]}
    else:
        assert mine == {"class": "data", "tenant": "bkt",
                        "booked_role": ["client"],
                        "tenant_requests": ["bkt:read"]}


def test_default_middleware_keeps_trusting_and_books_no_tenant():
    """The defaults (`trust_flow=True`, no resolver) leave the port's
    other servers as they were: a remote caller's headers are honoured
    and no tenant counter moves."""
    headers = {netflow.CLASS_HEADER: "repair",
               netflow.ROLE_HEADER: "volume",
               heat.TENANT_HEADER: "t-remote"}
    from aiohttp import web
    seen = {}

    async def handler(req):
        seen["class"] = netflow.current_class()
        seen["tenant"] = heat.current_tenant()
        return web.Response(body=b"y")

    reqs0 = {tuple(lab): ch.value
             for lab, ch in metrics.TENANT_REQUESTS._pairs()}
    mw = trace.aiohttp_middleware("volume")
    resp = asyncio.run(mw(_mock_req("/3,01", "203.0.113.9", headers),
                          handler))
    assert resp.status == 200
    assert seen == {"class": "repair", "tenant": "t-remote"}
    assert {tuple(lab): ch.value
            for lab, ch in metrics.TENANT_REQUESTS._pairs()} == reqs0


def test_resolver_failure_is_anonymous():
    from aiohttp import web
    seen = {}

    async def handler(req):
        seen["tenant"] = heat.current_tenant()
        return web.Response()

    def boom(req):
        raise RuntimeError("resolver down")

    mw = trace.aiohttp_middleware("s3", trust_flow="loopback",
                                  tenant_resolver=boom)
    asyncio.run(mw(_mock_req("/b/k", "203.0.113.9", {}), handler))
    assert seen == {"tenant": "anonymous"}
    assert heat.current_tenant() is None  # the contextvar was reset


# ---- tenant counters conserve with the byte ledger --------------------------

def _tenant_bytes_total(direction: str) -> float:
    total = 0.0
    for labels, child in metrics.TENANT_BYTES._pairs():
        if dict(labels).get("direction") == direction:
            total += child.value
    return total


def _tenant_requests() -> dict:
    out: dict = {}
    for labels, child in metrics.TENANT_REQUESTS._pairs():
        ld = dict(labels)
        out[(ld["tenant"], ld["op"])] = child.value
    return out


def _client_data_recv() -> float:
    total = 0.0
    for labels, child in metrics.NET_BYTES._pairs():
        ld = dict(labels)
        if ld.get("direction") == "recv" and ld.get("class") == "data" \
                and ld.get("peer_role") == "client":
            total += child.value
    return total


@pytest.fixture()
def s3_heat_stack(tmp_path, monkeypatch):
    monkeypatch.setenv("WEEDTPU_REPAIR_INTERVAL", "3600")
    old = heat.TRACKER
    heat.TRACKER = heat.HeatTracker(k=64, halflife=100000.0)
    from seaweedfs_tpu_torch.s3.s3api_server import S3ApiServer
    from seaweedfs_tpu_torch.server.filer_server import FilerServer
    c = Cluster(tmp_path, n_volume_servers=1).start()
    c.wait_heartbeats()
    filer = FilerServer(c.master.url, port=free_port(),
                        data_dir=str(tmp_path / "f"))
    c.submit(filer.start())
    s3 = S3ApiServer(filer.url, port=free_port(), master_url=c.master.url)
    c.submit(s3.start())
    yield c, filer, s3
    c.submit(s3.stop())
    c.submit(filer.stop())
    c.stop()
    heat.TRACKER = old


def test_tenant_counters_conserve_with_netflow(s3_heat_stack):
    c, filer, s3 = s3_heat_stack
    base = f"http://{s3.url}"
    # unauthenticated requests resolve tenant = bucket name
    payload_a = bytes(range(256)) * 64   # 16 KiB
    payload_b = b"q" * 5000
    req0 = _tenant_requests()
    b0_recv = _tenant_bytes_total("recv")
    # the edge books its client traffic under peer_role=client (urllib
    # sends no role header); every other in-process hop books under a
    # server's role, so the client-facing slice is what tenant
    # accounting conserves with
    nf0_recv = _client_data_recv()

    for bucket, payload, n in (("tenant-a", payload_a, 3),
                               ("tenant-b", payload_b, 2)):
        req = urllib.request.Request(f"{base}/{bucket}", method="PUT")
        urllib.request.urlopen(req, timeout=30).close()
        for i in range(n):
            req = urllib.request.Request(f"{base}/{bucket}/obj{i}",
                                         data=payload, method="PUT")
            urllib.request.urlopen(req, timeout=30).close()
            with urllib.request.urlopen(f"{base}/{bucket}/obj{i}",
                                        timeout=30) as r:
                assert r.read() == payload

    # the middleware books in its finally, which may still run when the
    # client's read() returns: wait for the ledger to converge
    want = {("tenant-a", "write"): 4, ("tenant-a", "read"): 3,
            ("tenant-b", "write"): 3, ("tenant-b", "read"): 2}
    deadline = time.time() + 5
    while True:
        reqs = _tenant_requests()
        d = {k: reqs.get(k, 0) - req0.get(k, 0) for k in want}
        if d == want or time.time() >= deadline:
            break
        time.sleep(0.05)
    assert d == want, d

    expect = 3 * len(payload_a) + 2 * len(payload_b)
    deadline = time.time() + 5
    while True:
        nf_recv = _client_data_recv()
        tenant_recv = _tenant_bytes_total("recv") - b0_recv
        if (tenant_recv >= expect
                and tenant_recv == pytest.approx(nf_recv - nf0_recv,
                                                 rel=0.01)) \
                or time.time() >= deadline:
            break
        time.sleep(0.05)
    assert tenant_recv >= expect  # PUT bodies at minimum
    assert tenant_recv == pytest.approx(nf_recv - nf0_recv, rel=0.01), \
        (tenant_recv, nf_recv - nf0_recv)

    snap = heat.TRACKER.serialize()["dims"]["tenant"]
    keys = {e[0] for e in snap["entries"]}
    assert {"tenant-a", "tenant-b"} <= keys, keys

    # a loopback caller may declare a tenant (the canary, an inner
    # gateway); the edge honours it instead of resolving one
    req = urllib.request.Request(
        f"{base}/tenant-a/obj0",
        headers={heat.TENANT_HEADER: "declared-tenant"})
    with urllib.request.urlopen(req, timeout=30) as r:
        assert r.status == 200 and r.read() == payload_a
    deadline = time.time() + 5
    while time.time() < deadline and \
            ("declared-tenant", "read") not in _tenant_requests():
        time.sleep(0.05)
    assert ("declared-tenant", "read") in _tenant_requests()


# ---- tenant QoS -------------------------------------------------------------

class TestTenantQoS:
    def test_parse_weights(self):
        assert parse_weights("alice=4,bob=1,default=1") == \
            {"alice": 4.0, "bob": 1.0, "default": 1.0}
        assert parse_weights(" a = 2 , junk, =3, neg=-1, c=0.5 ") == \
            {"a": 2.0, "c": 0.5}
        assert parse_weights("") == {}

    def test_disabled_admits_everything(self):
        q = TenantQoS(rate=0.0)
        assert not q.enabled
        assert all(q.admit("anyone") for _ in range(100))
        assert q.shed == 0

    def test_abusive_tenant_sheds_into_429s(self):
        q = TenantQoS(rate=5.0, burst_s=0.2, refresh_s=60.0)
        outcomes = [q.admit("noisy") for _ in range(50)]
        assert any(outcomes) and not all(outcomes)
        assert q.shed_by_tenant["noisy"] == outcomes.count(False)
        # a different tenant still gets its own bucket's burst
        assert q.admit("quiet")

    def test_weighted_shares_follow_config(self):
        for _ in range(64):  # enough traffic for the sketch to call
            heat.record("tenant", "qos-gold", 4096, "read")
            heat.record("tenant", "qos-lead", 4096, "read")
        q = TenantQoS(rate=100.0, burst_s=1.0, refresh_s=60.0,
                      weights={"qos-gold": 3.0, "default": 1.0})
        q.admit("qos-gold")
        q.admit("qos-lead")
        q.set_rate(100.0)   # force a refresh over both live buckets
        q.admit("qos-gold")
        gold = q._buckets["qos-gold"].rate
        lead = q._buckets["qos-lead"].rate
        assert gold > 0 and lead > 0
        assert abs(gold / lead - 3.0) < 0.01
        assert gold + lead <= 100.0 + 1e-6

    def test_set_rate_and_configure_force_refresh(self):
        q = TenantQoS(rate=10.0, burst_s=1.0, refresh_s=60.0)
        q.admit("t1")
        r0 = q._buckets["t1"].rate
        q.set_rate(20.0)
        q.admit("t1")  # refresh was forced: split recomputed
        assert q._buckets["t1"].rate > r0


@pytest.mark.parametrize("spec", ["", "alice=4,bob=1,default=1",
                                  " a = 2 , junk, =3, neg=-1, c=0.5 ",
                                  "x=1,,y=2", "=", "a=b"])
def test_parse_weights_equals_reference(spec):
    assert parse_weights(spec) == ref_qos.parse_weights(spec)


def test_qos_knobs_read_as_the_references(monkeypatch):
    monkeypatch.setenv("WEEDTPU_S3_QOS_RATE", "40")
    monkeypatch.setenv("WEEDTPU_S3_QOS_BURST", "0.5")
    monkeypatch.setenv("WEEDTPU_S3_QOS_REFRESH", "7")
    monkeypatch.setenv("WEEDTPU_S3_QOS_WEIGHTS", "gold=3, default=1")
    mine, ref = TenantQoS().status(), ref_qos.TenantQoS().status()
    assert mine == ref
    assert (mine["total_rate"], mine["burst_s"], mine["refresh_s"],
            mine["weights"]) == (40.0, 0.5, 7.0,
                                 {"gold": 3.0, "default": 1.0})


@pytest.mark.parametrize("name,value", [
    ("WEEDTPU_S3_QOS_RATE", "fast"), ("WEEDTPU_S3_QOS_BURST", "2s"),
    ("WEEDTPU_S3_QOS_REFRESH", ""), ("WEEDTPU_S3_QOS_WEIGHTS", "gold=3,junk"),
    ("WEEDTPU_S3_QOS_WEIGHTS", "neg=-1")])
def test_malformed_qos_knob_raises_where_reference_falls_back(
        monkeypatch, tmp_path, name, value):
    """A difference kept on purpose (ROADMAP §3): the reference drops a
    malformed knob for its default; the port raises when the gateway is
    constructed, before its socket binds."""
    monkeypatch.setenv(name, value)
    fell_back = ref_qos.TenantQoS().status()
    monkeypatch.delenv(name)
    default = ref_qos.TenantQoS().status()
    if name.endswith("WEIGHTS"):
        # the reference drops the malformed pair and keeps the rest
        default["weights"] = ref_qos.parse_weights(value)
    assert fell_back == default
    monkeypatch.setenv(name, value)
    with pytest.raises(ValueError, match=name):
        TenantQoS()
    from seaweedfs_tpu_torch.s3.s3api_server import S3ApiServer
    with pytest.raises(ValueError, match=name):
        S3ApiServer("127.0.0.1:1", port=free_port())


# ---- byte conservation ------------------------------------------------------

def _flow_snapshot() -> dict:
    return {(d, c): netflow.class_total(d, c)
            for d in ("sent", "recv") for c in sorted(netflow.CLASSES)}


def _flow_delta(before: dict) -> dict:
    after = _flow_snapshot()
    return {k: after[k] - before.get(k, 0.0) for k in after}


def test_byte_conservation_replicated_write(tmp_path):
    """Client-side sent bytes == server-side received bytes per class
    (within framing overhead) across a write with replication on the
    port's cluster: client -> volume A books class=data, A -> B's
    fan-out books class=replication, and each class conserves."""
    c = Cluster(tmp_path, n_volume_servers=2, replication="001").start()
    try:
        c.wait_heartbeats()
        client = WeedClient(c.master.url)
        size = 256 * 1024
        rng = np.random.default_rng(7)
        before = _flow_snapshot()
        payloads = {}
        for i in range(8):
            data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
            payloads[client.upload(data, name=f"cons{i}.bin")] = data
        for fid, data in payloads.items():
            assert client.download(fid) == data
        delta = _flow_delta(before)
        client.close()
        total = 8 * size
        assert delta[("recv", "replication")] >= total
        assert delta[("recv", "data")] >= 2 * total  # uploads + reads
        for cls in ("data", "replication"):
            sent = delta[("sent", cls)]
            recv = delta[("recv", cls)]
            assert recv > 0, cls
            assert abs(sent - recv) <= 0.01 * max(sent, recv), (
                cls, sent, recv)
    finally:
        c.stop()
