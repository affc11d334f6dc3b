"""The port's master (seaweedfs_tpu_torch/server/master.py) in process on
the CPU, held to the reference's.

A port `MasterServer` and a reference `MasterServer` run side by side on
one asyncio loop in a thread, with real sockets; each test sends both
the same requests over HTTP and compares the answers, with the masters'
own addresses normalised.  Where a master must reach a volume server
(growth, vacuum) each gets a port `VolumeServer` on the CPU.
"""

import asyncio
import json
import re
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
from aiohttp import web

from seaweedfs_tpu import pb as ref_pb
from seaweedfs_tpu.security import jwt as ref_jwt
from seaweedfs_tpu.server import master as ref_master
from seaweedfs_tpu.stats import metrics as ref_metrics
from seaweedfs_tpu.stats import trace as ref_trace

from seaweedfs_tpu_torch import pb
from seaweedfs_tpu_torch.security.guard import SecurityConfig
from seaweedfs_tpu_torch.server import master as mastermod
from seaweedfs_tpu_torch.server import volume_server as vsmod
from seaweedfs_tpu_torch.stats import metrics, trace


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Loop:
    """An asyncio loop in a daemon thread."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()

    def run(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(60)

    def close(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(5)


def call(url: str, path: str, body=None, method=None, data=None,
         ctype="application/json"):
    """(status, parsed JSON, else raw bytes) of one request."""
    if body is not None:
        data = json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://{url}{path}", data=data,
        method=method or ("POST" if data is not None else "GET"),
        headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            status, raw, rtype = r.status, r.read(), \
                r.headers.get("Content-Type", "")
    except urllib.error.HTTPError as e:
        status, raw, rtype = e.code, e.read(), \
            e.headers.get("Content-Type", "")
    return status, (json.loads(raw) if "json" in rtype else raw)


@pytest.fixture()
def pair():
    """A started port master and a started reference master; kwargs for
    both through `pair.start(**kw)`."""
    lp = Loop()
    started = []

    class Pair:
        def start(self, **kw):
            self.mine = mastermod.MasterServer("127.0.0.1", free_port(), **kw)
            self.ref = ref_master.MasterServer("127.0.0.1", free_port(), **kw)
            for m in (self.mine, self.ref):
                lp.run(m.start())
                started.append(m)
            return self

        def both(self, path, **kw):
            """The same request to both: (port's, reference's), each
            master's own address replaced by "M"."""
            out = []
            for m in (self.mine, self.ref):
                st, body = call(m.url, path, **kw)
                if isinstance(body, bytes):
                    body = body.decode().replace(m.url, "M")
                else:
                    body = json.loads(json.dumps(body).replace(m.url, "M"))
                out.append((st, body))
            return out

    p = Pair()
    p.loop = lp
    yield p
    for m in started:
        lp.run(m.stop())
    lp.close()


# ---- the route table ------------------------------------------------------

def _table(app) -> list[tuple[str, str]]:
    return sorted({(r.method, r.resource.canonical)
                   for r in app.router.routes()})


def test_route_table_equals_reference_less_the_left_out():
    """Every (method, path) of the reference master's route table is the
    port's, and the port has no other.  Since the replication slice
    nothing is left out (the name is the pin's from when the geo view
    was): `LEFT_OUT` is gone and `/cluster/geo` is served."""
    assert not hasattr(mastermod, "LEFT_OUT")
    mine = mastermod.MasterServer("127.0.0.1", 1)
    ref = ref_master.MasterServer("127.0.0.1", 1)
    assert _table(mine.app) == _table(ref.app)
    assert ("GET", "/cluster/geo") in _table(mine.app)
    assert ("POST", "/raft/install_snapshot") in _table(mine.app)
    assert ("GET", "/debug/pprof") in _table(mine.app)
    assert mine._UNGUARDED == ref._UNGUARDED


def test_left_out_routes_answer_404(pair):
    """The route the pin once held out, `/cluster/geo`, answers 200 on
    both masters, with the same keys and no direction while no sync pump
    reports; a POST to it is refused alike (405)."""
    pair.start()
    got = {}
    for name, m in (("mine", pair.mine), ("ref", pair.ref)):
        st, body = call(m.url, "/cluster/geo")
        assert st == 200, name
        got[name] = body
        assert call(m.url, "/cluster/geo", body={}, method="POST")[0] == 405
    assert sorted(got["mine"]) == sorted(got["ref"])
    assert got["mine"]["directions"] == got["ref"]["directions"] == {}


@pytest.mark.parametrize("name", [
    "MASTER_RECEIVED_HEARTBEATS", "MASTER_ASSIGN_COUNTER", "MASTER_LOOKUPS"])
def test_master_metric_families_are_the_references(name):
    ref, mine = getattr(ref_metrics, name), getattr(metrics, name)
    assert (mine.name, mine.help, mine.label_names, mine.kind) == \
        (ref.name, ref.help, ref.label_names, ref.kind)
    assert metrics.REGISTRY._metrics[mine.name] is mine


# ---- heartbeats in, lookups out --------------------------------------------

NODES = [("127.0.0.1:18080", "dc1", "r1"), ("127.0.0.1:18081", "dc1", "r2"),
         ("127.0.0.1:18082", "dc2", "r1")]


def beats(seed: int) -> list[dict]:
    """A round of full-state beats, one per node, from the seed."""
    rng = np.random.default_rng(seed)
    out = []
    for i, (url, dc, rack) in enumerate(NODES):
        vols = []
        for vid in sorted(rng.choice(range(1, 20), 4, replace=False)):
            vols.append({
                "id": int(vid), "collection": ("", "pics")[int(vid) % 2],
                "size": int(rng.integers(0, 80 << 20)),
                "file_count": int(rng.integers(0, 500)),
                "delete_count": int(rng.integers(0, 50)),
                "deleted_bytes": int(rng.integers(0, 1 << 20)),
                "read_only": bool(rng.random() < 0.2),
                "replica_placement": ("000", "001")[int(vid) % 2],
                "ttl": "", "version": 3,
                "modified_at": int(rng.integers(1, 1 << 30))})
        ecs = [{"id": 30 + j, "collection": "",
                "shard_ids": sorted(rng.choice(14, 5, replace=False)
                                    .tolist()),
                "shard_size": int(rng.integers(1, 1 << 20)),
                "codec": ("rs_10_4", "lrc_10_2_2")[j]}
               for j in range(2)]
        out.append({"id": url, "url": url, "public_url": url,
                    "data_center": dc, "rack": rack,
                    "max_volume_count": 10 + i, "max_file_key": 1000 * i,
                    "volumes": vols, "ec_shards": ecs})
    return out


def _views(pair) -> list:
    views = []
    for path in ("/dir/status", "/cluster/status",
                 *(f"/dir/lookup?volumeId={v}" for v in range(0, 21)),
                 "/dir/lookup?volumeId=3&collection=pics",
                 "/dir/lookup?volumeId=4,0102&collection=pics",
                 *(f"/dir/ec/lookup?volumeId={v}" for v in (29, 30, 31))):
        views.append((path, pair.both(path)))
    return views


def test_beats_json_and_protobuf_give_the_references_views(pair):
    """The same beats, as JSON and as protobuf from either package's
    encoder, posted to both masters: every lookup, the EC shard map,
    /dir/status and /cluster/status equal the reference's."""
    pair.start(volume_size_limit=64 << 20)
    for seed, frame in ((0, "json"), (1, "pb"), (2, "ref_pb"), (3, "json")):
        for beat in beats(seed):
            if frame == "json":
                kw = {"body": beat}
            else:
                enc = pb if frame == "pb" else ref_pb
                kw = {"data": enc.heartbeat_to_bytes(beat),
                      "ctype": pb.CONTENT_TYPE}
            got = pair.both("/heartbeat", **kw)
            assert got[0] == got[1] == (200, {"volume_size_limit": 64 << 20})
        for path, (mine, ref) in _views(pair):
            assert mine == ref, (frame, path)
    st, status = call(pair.mine.url, "/dir/status")
    topo = status["Topology"]
    assert sorted(topo["nodes"]) == sorted(u for u, _, _ in NODES)
    assert topo["max_volume_id"] >= 31
    # the beats' max_file_key raised the sequencer as the reference's
    assert pair.mine.topo.sequencer.peek() == pair.ref.topo.sequencer.peek()


def test_bad_heartbeats(pair, monkeypatch):
    """A corrupt protobuf frame and bad JSON answer 400, not 500; a master
    that cannot decode protobuf answers 415 (the sender's JSON fallback)."""
    pair.start()
    got = pair.both("/heartbeat", data=b"\xff\xff\xff\x07garbage",
                    ctype=pb.CONTENT_TYPE)
    assert got[0][0] == got[1][0] == 400
    assert got[0][1]["error"].startswith("bad protobuf heartbeat")
    got = pair.both("/heartbeat", data=b"{not json")
    assert got[0] == got[1] == (400, {"error": "bad json heartbeat"})
    monkeypatch.setattr(pb, "available", lambda: False)
    monkeypatch.setattr(ref_pb, "available", lambda: False)
    got = pair.both("/heartbeat", data=pb.heartbeat_to_bytes(beats(0)[0]),
                    ctype=pb.CONTENT_TYPE)
    assert got[0][0] == got[1][0] == 415


def test_heartbeats_counted(pair):
    pair.start()
    c = metrics.MASTER_RECEIVED_HEARTBEATS.labels()
    before = c.value
    for beat in beats(4):
        call(pair.mine.url, "/heartbeat", body=beat)
    assert c.value - before == len(NODES)


# ---- assign, growth, JWT ---------------------------------------------------

def _volume_server(lp, tmp_path, name, master_url):
    d = tmp_path / name
    d.mkdir()
    vs = vsmod.VolumeServer([str(d)], master_url, "127.0.0.1", free_port(),
                            heartbeat_interval=0.3, device="cpu")
    lp.run(vs.start())
    return vs


def test_assign_grows_and_signs_as_the_reference(pair, tmp_path,
                                                 monkeypatch):
    """/dir/assign on an empty layout grows a volume on a volume server
    (/admin/assign_volume), answers the reference's keys, and carries a
    per-fid write JWT that the reference's `security/jwt` verifies."""
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "0")
    sec = SecurityConfig({"jwt": {"signing": {"key": "s3cret",
                                              "expires_after_seconds": 60}}})
    pair.start(security=sec)
    servers = [_volume_server(pair.loop, tmp_path, n, m.url)
               for n, m in (("p", pair.mine), ("r", pair.ref))]
    try:
        shapes = []
        for m in (pair.mine, pair.ref):
            st, a = call(m.url, "/dir/assign?count=3")
            assert st == 200, a
            shapes.append(sorted(a))
            vid, key_cookie = a["fid"].split(",")
            assert a["count"] == 3 and int(vid) == 1
            assert re.fullmatch(r"[0-9a-f]+", key_cookie)
            assert a["url"] == a["publicUrl"] == servers[
                0 if m is pair.mine else 1].url
            claims = ref_jwt.decode_jwt(
                ref_jwt.SigningKey("s3cret", 60), a["auth"], a["fid"])
            assert claims["fid"] == a["fid"]
        assert shapes[0] == shapes[1] == ["auth", "count", "fid",
                                          "publicUrl", "url"]
        # the grown volume is writable with that token
        st, a = call(pair.mine.url, "/dir/assign")
        req = urllib.request.Request(
            f"http://{a['url']}/{a['fid']}", data=b"payload", method="PUT",
            headers={"Authorization": f"Bearer {a['auth']}"})
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.status == 201
        # /vol/grow adds a second volume; every master counts its assigns
        st, g = call(pair.mine.url, "/vol/grow?count=1", data=b"")
        assert (st, g) == (200, {"count": 1})
        assert pair.mine.topo.max_volume_id == 2
        st, _ = call(pair.mine.url, "/vol/grow?replication=001", data=b"")
        assert st == 500  # one node cannot hold two copies
    finally:
        for vs in servers:
            pair.loop.run(vs.stop())


def test_assign_without_nodes_fails_as_the_reference(pair):
    pair.start()
    got = pair.both("/dir/assign")
    assert got[0] == got[1] == (500, {"error":
                                      "no free volumes and cannot grow"})


# ---- admin lock, MQ epochs, members ----------------------------------------

def test_admin_lock_as_the_reference(pair):
    pair.start()
    toks = []
    for m in (pair.mine, pair.ref):
        st, a = call(m.url, "/admin/lock", body={"owner": "shell-a"})
        assert st == 200 and len(a["token"]) == 16
        assert call(m.url, "/admin/lock", body={"owner": "shell-b"}) == \
            (409, {"error": "locked by shell-a"})
        assert call(m.url, "/admin/renew_lock", body={"token": "nope"}) == \
            (409, {"error": "not lock owner"})
        assert call(m.url, "/admin/renew_lock",
                    body={"token": a["token"]}) == (200, {})
        # a lock not renewed for 30 s lapses
        tok, owner, ts = m._admin_lock
        m._admin_lock = (tok, owner, ts - 31)
        st, b = call(m.url, "/admin/lock", body={"owner": "shell-b"})
        assert st == 200
        assert call(m.url, "/admin/unlock", body={"token": a["token"]}) == \
            (200, {})  # the stale token unlocks nothing
        assert m._admin_lock[1] == "shell-b"
        assert call(m.url, "/admin/unlock", body={"token": b["token"]}) == \
            (200, {})
        assert m._admin_lock is None
        toks.append(a["token"])
    assert toks[0] != toks[1]


def test_mq_epochs_rise(pair):
    pair.start()
    last = 0
    for _ in range(20):
        st, e = call(pair.mine.url, "/cluster/mq/epoch", body={"key": "t/0"})
        assert st == 200 and e["epoch"] > last and e["epoch"] >= 1 << 60
        last = e["epoch"]
    got = pair.both("/cluster/mq/epoch", body={})
    assert got[0] == got[1] == (400, {"error": "key required"})


def test_cluster_members_leave_after_30s(pair):
    pair.start(node_timeout=0.2)  # an expire tick every 0.1 s
    for m in (pair.mine, pair.ref):
        for addr in ("127.0.0.1:8888", "127.0.0.1:8889"):
            assert call(m.url, "/cluster/register",
                        body={"type": "filer", "address": addr}) == (200, {})
        call(m.url, "/cluster/register", body={"type": "broker",
                                               "address": "b:1"})
    mine, ref = pair.both("/cluster/status")
    assert mine == ref
    assert mine[1]["Members"] == {"broker": ["b:1"], "filer": [
        "127.0.0.1:8888", "127.0.0.1:8889"]}
    for m in (pair.mine, pair.ref):
        m.cluster_members["filer"]["127.0.0.1:8888"] -= 31
    mine, ref = pair.both("/cluster/status")
    assert mine == ref and mine[1]["Members"]["filer"] == ["127.0.0.1:8889"]
    deadline = time.time() + 10
    while time.time() < deadline and \
            "127.0.0.1:8888" in pair.mine.cluster_members["filer"]:
        time.sleep(0.05)
    assert sorted(pair.mine.cluster_members["filer"]) == ["127.0.0.1:8889"]


# ---- status page, stream, vacuum -------------------------------------------

def test_ui_tables_equal_reference(pair):
    pair.start()
    for beat in beats(5):
        pair.both("/heartbeat", body=beat)
    call(pair.mine.url, "/cluster/register", body={"address": "f:1"})
    call(pair.ref.url, "/cluster/register", body={"address": "f:1"})
    mine, ref = pair.both("/")
    assert mine[0] == ref[0] == 200
    assert mine[1] == ref[1]
    for section in ("topology", "volumes", "ec shard map", "members"):
        assert f"<h2>{section}</h2>" in mine[1]
    assert "127.0.0.1:18082" in mine[1]


def test_cluster_stream_pushes_deltas(pair):
    """/cluster/stream: a snapshot of every known vid, its end marker,
    then a delta when a beat moves a volume."""
    pair.start()
    beat = beats(6)[0]
    call(pair.mine.url, "/heartbeat", body=beat)
    resp = urllib.request.urlopen(
        f"http://{pair.mine.url}/cluster/stream", timeout=30)
    try:
        lines = []
        while not lines or "snapshot_end" not in lines[-1]:
            lines.append(json.loads(resp.readline()))
        vids = [ev["vid"] for ev in lines[:-1]]
        assert vids == sorted(v["id"] for v in beat["volumes"]) + [30, 31]
        assert lines[0]["locations"] == [{"url": beat["url"],
                                          "publicUrl": beat["url"]}]
        gone = beat["volumes"].pop(0)["id"]
        call(pair.mine.url, "/heartbeat", body=beat)
        ev = json.loads(resp.readline())
        assert ev == {"vid": gone, "locations": []}
    finally:
        resp.close()


def test_vacuum_scan_and_toggle(pair, tmp_path, monkeypatch):
    """/vol/vacuum posts /admin/volume/vacuum to every volume over the
    garbage threshold; /vol/vacuum_toggle parks the background scan."""
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "0")
    pair.start()
    vs = _volume_server(pair.loop, tmp_path, "v", pair.mine.url)
    try:
        st, a = call(pair.mine.url, "/dir/assign")
        vid = int(a["fid"].split(",")[0])
        fids = [f"{vid},{k:x}{0x1234abcd:08x}" for k in range(1, 21)]
        for f in fids:
            req = urllib.request.Request(f"http://{vs.url}/{f}",
                                         data=b"x" * 2000, method="PUT")
            urllib.request.urlopen(req, timeout=30).close()
        for f in fids[:15]:
            req = urllib.request.Request(f"http://{vs.url}/{f}",
                                         method="DELETE")
            urllib.request.urlopen(req, timeout=30).close()
        pair.loop.run(vs._heartbeat_once())
        assert call(pair.mine.url, "/vol/vacuum?garbageThreshold=0.99",
                    data=b"") == (200, {"vacuumed": 0})
        assert call(pair.mine.url, "/vol/vacuum?garbageThreshold=0.3",
                    data=b"") == (200, {"vacuumed": 1})
        pair.loop.run(vs._heartbeat_once())
        assert call(pair.mine.url, "/vol/vacuum", data=b"") == \
            (200, {"vacuumed": 0})
        for f in fids[15:]:
            assert call(vs.url, "/" + f)[1] == b"x" * 2000
        for on in (False, True):
            assert call(pair.mine.url, "/vol/vacuum_toggle",
                        body={"enabled": on}) == (200, {"enabled": on})
            assert pair.mine.vacuum_enabled is on
    finally:
        pair.loop.run(vs.stop())


def test_raft_routes_without_peers(pair):
    pair.start()
    mine, ref = pair.both("/raft/status")
    assert mine == ref == (200, {"raft": "disabled", "leader": "M"})
    for rpc in ("request_vote", "append_entries", "install_snapshot",
                "peers/add", "peers/remove"):
        mine, ref = pair.both(f"/raft/{rpc}", body={})
        assert mine == ref == (400, {"error": "raft disabled"}), rpc
    assert pair.mine.is_leader and pair.mine.leader_url == pair.mine.url


def test_guard_whitelist(pair):
    """The IP whitelist guards the client routes; heartbeats and /metrics
    pass (`_UNGUARDED`)."""
    sec = SecurityConfig({"access": {"white_list": ["10.9.9.9"]}})
    pair.start(security=sec)
    mine, ref = pair.both("/dir/status")
    assert mine == ref == (403, {"error": "forbidden"})
    mine, ref = pair.both("/heartbeat", body=beats(7)[0])
    assert mine[0] == ref[0] == 200
    assert call(pair.mine.url, "/metrics")[0] == 200


def test_middleware_slow_exempt_and_region(monkeypatch):
    """`aiohttp_middleware(slow_exempt=, region=)`: a long poll on an
    exempt path is not kept as a slow request, another slow request is,
    and every span carries the region, as in the reference."""
    monkeypatch.setenv("WEEDTPU_SLOW_MS", "50")
    monkeypatch.setenv("WEEDTPU_TRACE_SAMPLE", "1000000")
    lp = Loop()

    async def slow(req):
        await asyncio.sleep(0.12)
        return web.json_response({})

    runners, got = [], []
    try:
        for mod in (trace, ref_trace):
            app = web.Application(middlewares=[mod.aiohttp_middleware(
                "master", slow_exempt=("/poll",), region="eu")])
            app.add_routes([web.get("/poll", slow), web.get("/other", slow),
                            web.get("/sampled", slow)])
            r = web.AppRunner(app)
            lp.run(r.setup())
            port = free_port()
            lp.run(web.TCPSite(r, "127.0.0.1", port).start())
            runners.append(r)
            mod.reset_ring()
            for path in ("/poll", "/other"):
                call(f"127.0.0.1:{port}", path)
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/sampled",
                headers={mod.TRACE_HEADER: f"{'ab' * 16}-{'cd' * 8}-1"})
            urllib.request.urlopen(req, timeout=30).close()
            got.append(sorted((s["attrs"]["path"], s["attrs"].get("region"),
                               bool(s["attrs"].get("retro")))
                              for s in mod.ring_snapshot()))
    finally:
        for r in runners:
            lp.run(r.cleanup())
        lp.close()
    assert got[0] == got[1] == [("/other", "eu", True),
                                ("/sampled", "eu", False)]
