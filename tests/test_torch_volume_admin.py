"""The rest of the port's volume server held against the reference: volume
copy, move and incremental copy, unconvert, tiering, needles and query,
and the telemetry routes (/heat, /perf, /debug/*).

Handler tests call both packages' handlers on unstarted servers over
copies of one volume or shard set (the port's with `device="cpu"`, the
reference's with WEEDTPU_EC_CODEC=numpy set only around its calls);
their answers and files must be byte-equal.  In-process tests run port
servers on a loop thread behind the reference master
(tests/test_torch_volume_server.py's `Harness`).  The cluster tests are
twins of the reference's own (tests/test_autopilot.py,
tests/test_backend_tier.py, tests/test_shell_commands.py,
tests/test_aux.py): the reference master and shell in process over port
volume servers started by the port's CLI in subprocesses
(tests/test_torch_cluster.py's `PortCluster`), and mixed clusters whose
volumes and shard sets cross between the packages both ways.  Tolerance
everywhere: byte equality.
"""

import asyncio
import contextlib
import glob
import io
import json
import os
import shutil
import threading
import time
import types
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest

from seaweedfs_tpu.client import WeedClient
from seaweedfs_tpu.server.volume_server import VolumeServer as RefVS
from seaweedfs_tpu.shell.commands import CommandEnv, run_command
from seaweedfs_tpu.storage.store import Store as RefStore

from seaweedfs_tpu_torch.server import volume_server as vsmod
from seaweedfs_tpu_torch.stats import heat, pipeline, profile, trace
from seaweedfs_tpu_torch.storage import needle as ndl
from seaweedfs_tpu_torch.storage.ec import ec_files, layout
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.storage.volume import Volume

from tests.test_torch_cluster import PortCluster, vs_call, wait_for
from tests.test_torch_volume_server import free_port, harness  # noqa: F401
from tests.test_torch_volume_server import fid, put_blobs

COOKIE = 0x1234ABCD


def fake_req(body=None, query=None, remote="127.0.0.1"):
    async def _json():
        return body
    return types.SimpleNamespace(json=_json, query=query or {},
                                 headers={}, remote=remote)


async def _no_beat():
    return None


def call(vs, handler: str, req):
    resp = asyncio.run(getattr(vs, handler)(req))
    return resp.status, resp.body


def make_volume(d, vid=7, n=40, seed=5, docs=False) -> dict:
    """A volume of `n` needles written by the port's Volume (JSON documents
    with `docs`, every fifth of them not an object, and needle 3 written
    twice and needle 5 deleted); returns {nid: payload} of the live
    needles."""
    os.makedirs(d, exist_ok=True)
    v = Volume(str(d), "", vid)
    rng = np.random.default_rng(seed)
    out = {}
    for nid in range(1, n + 1):
        if docs:
            data = json.dumps({"name": f"user{nid}", "age": 20 + nid,
                               "city": "oslo" if nid % 2 else "bergen"}
                              if nid % 5 else [nid]).encode()
        else:
            data = rng.integers(0, 256, int(rng.integers(1000, 20_000)),
                                dtype=np.uint8).tobytes()
        v.append_needle(ndl.Needle(cookie=COOKIE, id=nid, data=data,
                                   append_at_ns=nid))
        out[nid] = data
    if docs:
        again = json.dumps({"name": "user3", "age": 99,
                            "city": "oslo"}).encode()
        v.append_needle(ndl.Needle(cookie=COOKIE, id=3, data=again,
                                   append_at_ns=n + 1))
        out[3] = again
    v.delete_needle(5, COOKIE)
    del out[5]
    v.close()
    return out


class Pair:
    """The port's and the reference's VolumeServer, unstarted, each over
    its own copy of one directory; heartbeats stubbed on the
    instances."""

    def __init__(self, tmp_path, monkeypatch, fill):
        self.mp = monkeypatch
        pdir, rdir = tmp_path / "port", tmp_path / "ref"
        pdir.mkdir()
        fill(pdir)
        shutil.copytree(pdir, rdir)
        self.pdir, self.rdir = pdir, rdir
        self.port = vsmod.VolumeServer([str(pdir)], "127.0.0.1:1",
                                       "127.0.0.1", free_port(),
                                       device="cpu")
        self.port._heartbeat_once = _no_beat
        with self.ref_codec():
            self.ref = RefVS([str(rdir)], "127.0.0.1:1", port=free_port())
        self.ref._heartbeat_once = _no_beat

    @contextlib.contextmanager
    def ref_codec(self):
        with self.mp.context() as m:
            m.setenv("WEEDTPU_EC_CODEC", "numpy")
            yield

    def both(self, handler: str, body=None, query=None):
        got = call(self.port, handler, fake_req(body, query))
        with self.ref_codec():
            want = call(self.ref, handler, fake_req(body, query))
        return got, want

    def close(self):
        self.port.store.close()
        self.ref.store.close()


@pytest.fixture
def docs_pair(tmp_path, monkeypatch):
    p = Pair(tmp_path, monkeypatch, lambda d: make_volume(d, docs=True))
    yield p
    p.close()


# ---- needles and query -----------------------------------------------------

@pytest.mark.parametrize("limit", [None, 7])
def test_needles_equal_reference(docs_pair, limit):
    q = {"volume": "7"} if limit is None else {"volume": "7",
                                               "limit": str(limit)}
    (st, got), (rst, want) = docs_pair.both("handle_volume_needles",
                                            query=q)
    assert st == rst == 200
    got, want = json.loads(got), json.loads(want)
    assert got == want
    live = sorted(nid for nid in range(1, 41) if nid != 5)
    assert sorted(got["needles"]) == (live if limit is None
                                      else sorted(got["needles"]))
    assert got["count"] == (len(live) if limit is None else limit)
    assert call(docs_pair.port, "handle_volume_needles",
                fake_req(query={"volume": "99"}))[0] == 404


@pytest.mark.parametrize("flt,projections", [
    ({"field": "age", "op": ">=", "value": 45}, ["name", "age"]),
    ({"field": "city", "op": "=", "value": "oslo"}, None),
    ({"field": "name", "op": "like", "value": "user1"}, ["name"]),
    ({"field": "age", "op": "<", "value": "x"}, None),
    (None, ["city"])])
def test_query_equals_reference_and_plain_python(docs_pair, flt,
                                                 projections):
    """The NDJSON rows equal the reference's and what the same filter
    selects in plain Python over the live documents: a needle written
    twice answers once, with its later document; a deleted one and the
    documents that are not objects never."""
    body = {"volume": 7, "filter": flt, "projections": projections}
    (st, got), (rst, want) = docs_pair.both("handle_query", body)
    assert st == rst == 200 and got == want
    docs = make_volume(docs_pair.pdir.parent / "plain", docs=True)
    ops = {">=": lambda a, b: a >= b, "=": lambda a, b: a == b,
           "<": lambda a, b: a < b,
           "like": lambda a, b: isinstance(a, str) and b in a}
    rows = []
    for nid in sorted(docs, key=lambda n: (n == 3, n)):  # 3 moved last
        doc = json.loads(docs[nid])
        if not isinstance(doc, dict):
            continue
        if flt is not None:
            try:
                if not ops[flt["op"]](doc.get(flt["field"]), flt["value"]):
                    continue
            except TypeError:
                continue
        if projections:
            doc = {k: doc.get(k) for k in projections}
        rows.append(doc)
    assert [json.loads(r) for r in got.splitlines()] == rows


def test_query_needs_the_read_key(docs_pair):
    from seaweedfs_tpu_torch.security.guard import SecurityConfig
    from seaweedfs_tpu_torch.security.jwt import SigningKey, gen_jwt
    key = SigningKey(b"read-secret")
    docs_pair.port.security = SecurityConfig()
    docs_pair.port.security.volume_read = key
    req = fake_req({"volume": 7})
    assert call(docs_pair.port, "handle_query", req)[0] == 401
    req.headers = {"Authorization": "Bearer " + gen_jwt(key, "")}
    st, raw = call(docs_pair.port, "handle_query", req)
    assert st == 200 and len(raw.splitlines()) == 32


# ---- heartbeat of a staged copy, tier download ---------------------------

def test_staged_copy_stays_out_of_the_beat_as_reference(tmp_path,
                                                        monkeypatch):
    """A staged volume is left out of the beat and its slot counted, in
    both packages alike."""
    make_volume(tmp_path / "d", vid=7)
    make_volume(tmp_path / "d", vid=8, seed=6)
    port = Store([str(tmp_path / "d")], 8, "n:1", device="cpu")
    with monkeypatch.context() as m:
        m.setenv("WEEDTPU_EC_CODEC", "numpy")
        ref = RefStore([str(tmp_path / "d")], 8, "n:1")
    try:
        for s in (port, ref):
            s.get_volume(8).staging = True
        got, want = port.collect_heartbeat(), ref.collect_heartbeat()
        for b in (got, want):
            for v in b["volumes"]:
                v.pop("modified_at")
        assert got == want
        assert [v["id"] for v in got["volumes"]] == [7]
        assert got["max_volume_count"] == 7
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize("delete_remote", [False, True])
def test_tier_download_delete_remote_as_reference(tmp_path, delete_remote):
    from seaweedfs_tpu.storage.volume import Volume as RefVolume
    blobs = make_volume(tmp_path / "src", vid=4)
    out = {}
    for name, cls in (("port", Volume), ("ref", RefVolume)):
        d = tmp_path / name
        shutil.copytree(tmp_path / "src", d)
        v = cls(str(d), "", 4)
        remote = tmp_path / f"{name}_remote"
        v.tier_move("local", {"directory": str(remote)})
        v.tier_download(delete_remote)
        for nid, data in blobs.items():
            assert v.read_needle(nid, COOKIE).data == data
        out[name] = (sorted(p.name for p in remote.rglob("*")
                            if p.is_file()),
                     (d / "4.dat").read_bytes(), v.read_only)
        v.close()
    assert out["port"] == out["ref"]
    assert bool(out["port"][0]) is not delete_remote


# ---- unconvert -----------------------------------------------------------

@pytest.mark.parametrize("lost", [(), (0, 3, 10, 12), (12,)])
def test_unconvert_equals_reference(tmp_path, monkeypatch, lost):
    """The shard set decodes back to the same .dat and .idx in both
    packages (the missing data shards rebuilt first, on the port's
    device), the volume mounts writable, and the shard set, .ecx, .ecj
    and .vif are gone."""
    blobs = {}

    def fill(d):
        blobs.update(make_volume(d))
        base = os.path.join(str(d), "7")
        ec_files.write_ec_files(base, device="cpu")
        ec_files.write_sorted_ecx(base + ".idx")
        for ext in (".dat", ".idx"):
            os.remove(base + ext)
        for i in lost:
            os.remove(base + layout.to_ext(i))

    p = Pair(tmp_path, monkeypatch, fill)
    try:
        (st, got), (rst, want) = p.both("handle_volume_unconvert",
                                        {"volume": 7})
        assert st == rst == 200, (got, want)
        got = json.loads(got)
        assert got == json.loads(want)
        assert got["decoded"] is True and got["thawed"] is True
        # a missing data shard rebuilds every missing shard first
        assert got["shards_retired"] == (
            list(range(14)) if any(i < 10 for i in lost)
            else [i for i in range(14) if i not in lost])
        for ext in (".dat", ".idx"):
            assert (p.pdir / f"7{ext}").read_bytes() == \
                (p.rdir / f"7{ext}").read_bytes()
        assert sorted(os.listdir(p.pdir)) == ["7.dat", "7.idx"]
        v = p.port.store.get_volume(7)
        assert v is not None and not v.read_only
        assert p.port.store.get_ec_volume(7) is None
        for nid, data in blobs.items():
            assert v.read_needle(nid, COOKIE).data == data
        job = p.port._ec_jobs[7]
        assert job["state"] == "done" and job["kind"] == "unconvert"
        assert call(p.port, "handle_volume_unconvert",
                    fake_req({"volume": 7}))[0] == 404
    finally:
        p.close()


def test_unconvert_thaws_a_frozen_volume_without_decoding(harness):
    """After /admin/ec/fleet_convert the frozen .dat is still mounted:
    unconvert thaws it and retires the shard set, with no decode."""
    h = harness(master=False)
    h.json(0, "/admin/assign_volume", {"volume": 21})
    blobs = put_blobs(h, 0, 21, 6, seed=3)
    dat = (h.dir(0) / "21.dat").read_bytes()
    assert h.json(0, "/admin/ec/fleet_convert",
                  {"volumes": [21]})[1]["converted"] == [21]
    assert h.vs[0].store.get_volume(21).read_only
    st, out = h.json(0, "/admin/volume/unconvert", {"volume": 21})
    assert st == 200 and out["decoded"] is False
    assert out["shards_retired"] == list(range(14))
    assert (h.dir(0) / "21.dat").read_bytes() == dat
    assert not glob.glob(str(h.dir(0) / "21.ec*"))
    assert not h.vs[0].store.get_volume(21).read_only
    for f, data in blobs.items():
        assert h.call(0, "/" + f)[2] == data
    assert h.call(0, "/" + fid(21, 99), data=b"new", method="PUT")[0] == 201


# ---- copy, move and incremental copy through two port servers ----------

def leftovers(d) -> list[str]:
    return [p for pat in ("*.cpd", "*.cpx", "*.staging", "*.cptail")
            for p in glob.glob(os.path.join(str(d), pat))]


def test_staged_copy_crc_and_finalize(harness):
    """A staged copy streams both files with their CRC32, stays read-only
    and out of the beat (so out of the reference master's /dir/lookup)
    behind its .staging marker; the finalizing call catches up 0 bytes
    and flips it live, and the master then lists it."""
    h = harness(n=2)
    a, b = h.vs
    h.json(0, "/admin/assign_volume", {"volume": 11})
    blobs = put_blobs(h, 0, 11, 12, seed=8)
    st, out = h.json(1, "/admin/volume/copy",
                     {"volume": 11, "source": a.url, "staging": True})
    assert st == 200 and out["file_count"] == 12
    for ext in ("dat", "idx"):
        assert out["crc"][ext] == zlib.crc32(
            (h.dir(0) / f"11.{ext}").read_bytes())
    assert (h.dir(1) / "11.staging").exists()
    v = b.store.get_volume(11)
    assert v.staging and v.read_only
    assert 11 not in [x["id"] for x in
                      b.store.collect_heartbeat()["volumes"]]

    def located() -> list[str]:
        st, r = vs_call(h.master_url, "/dir/lookup?volumeId=11")
        return sorted(x["url"] for x in r.get("locations", []))
    time.sleep(0.5)  # B's beats reach the reference master meanwhile
    assert located() == [a.url]
    st, out = h.json(1, "/admin/volume/copy",
                     {"volume": 11, "source": a.url, "staging": True,
                      "finalize": True})
    assert st == 200 and out == {"incremental": True, "appended_bytes": 0}
    assert not v.staging and not v.read_only
    assert located() == sorted([a.url, b.url])
    assert leftovers(h.dir(1)) == []
    for f, data in blobs.items():
        assert h.call(1, "/" + f)[2] == data


def test_move_aborts_then_moves(harness):
    """A move at a dead target answers 500 and leaves the source serving
    and writable; a second move of a volume mid-move is refused (409);
    the real move lands the volume byte-equal on the target, retires the
    source, and counts `weedtpu_volume_moves_total`."""
    from seaweedfs_tpu_torch.stats import metrics
    h = harness(n=2)
    a, b = h.vs
    h.json(0, "/admin/assign_volume", {"volume": 12})
    blobs = put_blobs(h, 0, 12, 10, seed=9)
    ok0 = metrics.VOLUME_MOVES.labels("ok").value
    ab0 = metrics.VOLUME_MOVES.labels("aborted").value
    st, out = h.json(0, "/admin/volume/move",
                     {"volume": 12, "target": f"127.0.0.1:{free_port()}"})
    assert st == 500
    assert not a.store.get_volume(12).read_only
    assert h.json(0, "/admin/volume/move",
                  {"volume": 12, "target": a.url})[0] == 400
    a._moves_active.add(12)
    assert h.json(0, "/admin/volume/move",
                  {"volume": 12, "target": b.url})[0] == 409
    a._moves_active.discard(12)
    dat = (h.dir(0) / "12.dat").read_bytes()
    st, out = h.json(0, "/admin/volume/move", {"volume": 12,
                                               "target": b.url})
    assert st == 200 and out["moved"] == 12 and out["target"] == b.url
    assert out["crc"] == zlib.crc32(dat)
    assert a.store.get_volume(12) is None
    assert not (h.dir(0) / "12.dat").exists()
    assert (h.dir(1) / "12.dat").read_bytes() == dat
    assert not b.store.get_volume(12).read_only
    assert leftovers(h.dir(0)) == leftovers(h.dir(1)) == []
    for f, data in blobs.items():
        assert h.call(1, "/" + f)[2] == data
    assert metrics.VOLUME_MOVES.labels("ok").value == ok0 + 1
    assert metrics.VOLUME_MOVES.labels("aborted").value == ab0 + 1
    # a target already holding the volume refuses it as a move
    h.json(0, "/admin/assign_volume", {"volume": 13})
    h.json(1, "/admin/volume/copy", {"volume": 13, "source": a.url})
    assert h.json(0, "/admin/volume/move",
                  {"volume": 13, "target": b.url})[0] == 409


def test_move_killed_mid_transfer_leaves_the_source_serving(harness):
    """The source's file pulls stall (`delay_file_pull`), the target is
    stopped mid-transfer: the move answers 500, the source still serves
    every needle byte-equal and writable, and a second move to a live
    target completes."""
    h = harness(n=3)
    a, b, c = h.vs
    h.json(0, "/admin/assign_volume", {"volume": 14})
    blobs = put_blobs(h, 0, 14, 8, seed=10)
    h.json(0, "/admin/faults",
           {"faults": [{"action": "delay_file_pull", "ms": 1500}]})
    result = {}
    t = threading.Thread(target=lambda: result.update(
        move=h.json(0, "/admin/volume/move", {"volume": 14,
                                              "target": b.url})))
    t.start()
    time.sleep(0.5)
    h.submit(b.stop())
    t.join(60)
    assert result["move"][0] == 500, result
    h.json(0, "/admin/faults",
           {"faults": [{"action": "delay_file_pull", "ms": 0}]})
    assert not a.store.get_volume(14).read_only
    for f, data in blobs.items():
        assert h.call(0, "/" + f)[2] == data
    st, out = h.json(0, "/admin/volume/move", {"volume": 14,
                                               "target": c.url})
    assert st == 200, out
    for f, data in blobs.items():
        assert h.call(2, "/" + f)[2] == data
    h.vs.remove(b)  # stopped already


def test_incremental_copy_pulls_the_tail(harness):
    h = harness(n=2)
    a, b = h.vs
    h.json(0, "/admin/assign_volume", {"volume": 15})
    put_blobs(h, 0, 15, 5, seed=11)
    assert h.json(1, "/admin/volume/copy",
                  {"volume": 15, "source": a.url})[0] == 200
    size0 = (h.dir(0) / "15.dat").stat().st_size
    tail = {}
    for k in range(6, 9):
        data = os.urandom(3000 + k)
        assert h.call(0, "/" + fid(15, k), data=data, method="PUT")[0] \
            == 201
        tail[fid(15, k)] = data
    size1 = (h.dir(0) / "15.dat").stat().st_size
    st, out = h.json(1, "/admin/volume/copy", {"volume": 15,
                                               "source": a.url})
    assert st == 200 and out == {"incremental": True,
                                 "appended_bytes": size1 - size0}
    for ext in (".dat", ".idx"):
        assert (h.dir(1) / f"15{ext}").read_bytes() == \
            (h.dir(0) / f"15{ext}").read_bytes()
    for f, data in tail.items():
        assert h.call(1, "/" + f)[2] == data
    assert h.json(1, "/admin/volume/copy", {"volume": 15,
                                            "source": a.url})[1] == \
        {"incremental": True, "appended_bytes": 0}
    # a vacuumed source has another compaction revision: refused
    h.call(0, "/" + fid(15, 6), method="DELETE")
    h.json(0, "/admin/volume/vacuum", {"volume": 15})
    assert h.json(1, "/admin/volume/copy", {"volume": 15,
                                            "source": a.url})[0] == 409


def test_tier_move_and_download_through_the_server(harness, tmp_path):
    h = harness(master=False)
    h.json(0, "/admin/assign_volume", {"volume": 16})
    blobs = put_blobs(h, 0, 16, 6, seed=12)
    dat = (h.dir(0) / "16.dat").read_bytes()
    remote = tmp_path / "tier"
    st, out = h.json(0, "/admin/volume/tier_move",
                     {"volume": 16, "kind": "local",
                      "options": {"directory": str(remote)}})
    assert (st, out) == (200, {"backend": "remote"})
    assert not (h.dir(0) / "16.dat").exists()
    for f, data in blobs.items():
        assert h.call(0, "/" + f)[2] == data
    # ROADMAP fault 3.6 holds after a tier move through the server: a
    # boot over the directory mounts the volume from its .tier marker
    rebooted = Store([str(h.dir(0))], device="cpu")
    try:
        v = rebooted.get_volume(16)
        assert v is not None and v.read_only and v.backend_kind == "remote"
        for f, data in blobs.items():
            nid = int(f.split(",")[1][:-8], 16)
            assert v.read_needle(nid, COOKIE).data == data
    finally:
        rebooted.close()
    st, out = h.json(0, "/admin/volume/tier_download",
                     {"volume": 16, "delete_remote": True})
    assert (st, out) == (200, {"backend": "disk"})
    assert (h.dir(0) / "16.dat").read_bytes() == dat
    assert not [p for p in remote.rglob("*") if p.is_file()]
    for f, data in blobs.items():
        assert h.call(0, "/" + f)[2] == data
    assert h.json(0, "/admin/volume/tier_move", {"volume": 99})[0] == 404


# ---- telemetry routes ----------------------------------------------------

def _mock_req(path, peer):
    from unittest import mock

    from aiohttp.test_utils import make_mocked_request
    tr = mock.Mock()
    tr.get_extra_info = lambda key, default=None: \
        (peer, 1234) if key == "peername" else default
    return make_mocked_request("GET", path, transport=tr)


def test_debug_routes_share_one_loopback_guard():
    """Twin of tests/test_observability.py::
    test_debug_routes_share_one_loopback_guard: every /debug route 403s
    a remote peer through `trace.debug_guard`, and answers loopback."""
    routes = {r.path: r.handler for r in trace.debug_routes()}
    assert sorted(routes) == ["/debug/pipeline", "/debug/pprof",
                              "/debug/requests", "/debug/traces"]
    for path, handler in routes.items():
        resp = asyncio.run(handler(_mock_req(path, "203.0.113.9")))
        assert resp.status == 403, path
    for path in ("/debug/requests", "/debug/traces", "/debug/pipeline"):
        resp = asyncio.run(routes[path](_mock_req(path, "127.0.0.1")))
        assert resp.status == 200, path


def test_debug_traces_pin_keeps_a_trace_past_the_ring():
    trace.reset_ring()
    try:
        root = trace.new_root()
        tok = trace._current.set(root)
        with trace.span("volume.move", vid=1):
            pass
        trace._current.reset(tok)
        resp = asyncio.run(trace.handle_debug_traces(_mock_req(
            f"/debug/traces?tid={root.trace_id}&pin=1", "127.0.0.1")))
        body = json.loads(resp.text)
        assert [s["name"] for s in body["traces"][0]["spans"]] == \
            ["volume.move"]
        assert trace.pinned_ids() == [root.trace_id]
        for _ in range(trace.TRACE_BUF):
            trace.record_span("filler", "f" * 32, "0" * 16, None,
                              time.time(), 0.1)
        kept = trace.traces(tid=root.trace_id)
        assert [s["name"] for s in kept[0]["spans"]] == ["volume.move"]
    finally:
        trace.reset_ring()


def test_profiler_start_stop_leaves_zero_threads(monkeypatch):
    """Twin of tests/test_observability.py::
    test_profiler_start_stop_leaves_zero_threads; a malformed rate
    raises."""
    def profiler_threads():
        return [t for t in threading.enumerate()
                if t.name == "weedtpu-profiler"]

    monkeypatch.setenv("WEEDTPU_PROFILE_HZ", "250")
    p1 = profile.ensure_started()
    p2 = profile.ensure_started()
    assert p1 is p2 and p1.running and profile.global_profiler() is p1
    profile.shutdown()
    assert not profiler_threads()
    monkeypatch.setenv("WEEDTPU_PROFILE_HZ", "0")
    assert profile.ensure_started() is None
    assert not profiler_threads()
    for bad in ("fast", "-3"):
        monkeypatch.setenv("WEEDTPU_PROFILE_HZ", bad)
        with pytest.raises(ValueError, match="WEEDTPU_PROFILE_HZ"):
            profile.ensure_started()


def _spin(stop):
    while not stop.is_set():
        sum(range(500))


def test_debug_pprof_on_demand_window_and_formats():
    """Twin of tests/test_observability.py::
    test_debug_pprof_on_demand_window_and_formats."""
    profile.shutdown()
    resp = asyncio.run(profile.handle_debug_pprof(
        _mock_req("/debug/pprof", "127.0.0.1")))
    assert resp.status == 400
    stop = threading.Event()
    worker = threading.Thread(target=_spin, args=(stop,), daemon=True)
    worker.start()
    try:
        resp = asyncio.run(profile.handle_debug_pprof(_mock_req(
            "/debug/pprof?seconds=0.25&hz=400", "127.0.0.1")))
        assert resp.status == 200 and "_spin" in resp.text
        resp = asyncio.run(profile.handle_debug_pprof(_mock_req(
            "/debug/pprof?seconds=0.2&hz=400&format=table", "127.0.0.1")))
        assert "kernel profile" in resp.text
        resp = asyncio.run(profile.handle_debug_pprof(_mock_req(
            "/debug/pprof?seconds=0.2&hz=400&format=json", "127.0.0.1")))
        body = json.loads(resp.text)
        assert body["samples"] > 0 and isinstance(body["stacks"], list)
        assert "kernels" in body
    finally:
        stop.set()
        worker.join(2)
    assert not [t for t in threading.enumerate()
                if t.name == "weedtpu-profiler"]


def test_heat_and_perf_routes_serve_the_process_state(harness):
    """/heat serves the process's tracker, the volume read most ranked
    first; /perf the pipeline snapshot, a rebuild's job in it; and
    /debug/pprof a window of the server's stacks."""
    h = harness(master=False)
    h.json(0, "/admin/assign_volume", {"volume": 17})
    blobs = put_blobs(h, 0, 17, 4, seed=13)
    heat.reset()
    for _ in range(3):
        for f in blobs:
            h.call(0, "/" + f)
    st, snap = h.json(0, "/heat")
    assert st == 200 and snap["id"] == heat.TRACKER.tracker_id
    top = snap["dims"]["volume"]["entries"]
    assert top[0][0] == "17", top
    h.json(0, "/admin/volume/readonly", {"volume": 17})
    h.json(0, "/admin/ec/generate", {"volume": 17})
    os.remove(h.dir(0) / "17.ec02")
    h.json(0, "/admin/ec/rebuild", {"volume": 17})
    st, perf = h.json(0, "/perf")
    assert st == 200 and perf["id"] == pipeline.TRACKER_ID
    assert any(j["kind"] == "ec_rebuild" for j in perf["jobs"]), \
        perf["jobs"]
    st, _, raw = h.call(0, "/debug/pprof?seconds=0.3&hz=300")
    assert st == 200 and raw.strip()


# ---- cluster twins: the reference master and shell over port nodes -----

@pytest.fixture
def port2(tmp_path):
    c = PortCluster(tmp_path, n_port=2).start()
    yield c
    c.stop()


def _post_json(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.load(r)


def test_volume_move_end_to_end_and_dead_target_abort(port2):
    """Twin of tests/test_autopilot.py::
    test_volume_move_end_to_end_and_dead_target_abort."""
    c = port2
    client = WeedClient(c.master.url)
    rng = np.random.default_rng(0xB0B)
    blobs = {}
    for i in range(8):
        data = rng.integers(0, 256, 20_000, dtype=np.uint8).tobytes()
        blobs[client.upload(data, name=f"m{i}.bin")] = data
    vid = int(next(iter(blobs)).partition(",")[0])
    env = CommandEnv(c.master.url)
    src = env.volume_locations(vid)[0]
    dst = next(u for u in c.port_urls if u != src)
    sdir = c.port_dirs[c.port_urls.index(src)]
    ddir = c.port_dirs[c.port_urls.index(dst)]
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post_json(f"http://{src}/admin/volume/move",
                   {"volume": vid, "target": f"127.0.0.1:{free_port()}"})
    assert ei.value.code == 500
    vols = {v["id"]: v for v in vs_call(src, "/status")[1]["volumes"]}
    assert not vols[vid]["read_only"]
    for f, data in blobs.items():
        assert client.download(f) == data
    dat = (sdir / f"{vid}.dat").read_bytes()
    out = _post_json(f"http://{src}/admin/volume/move",
                     {"volume": vid, "target": dst})
    assert out["moved"] == vid and out["target"] == dst
    assert out["crc"] == zlib.crc32(dat)
    assert vid not in {v["id"] for v in vs_call(src, "/status")[1]
                       ["volumes"]}
    moved = {v["id"]: v for v in vs_call(dst, "/status")[1]["volumes"]}
    assert not moved[vid]["read_only"]
    assert (ddir / f"{vid}.dat").read_bytes() == dat
    assert leftovers(sdir) == leftovers(ddir) == []
    wait_for(lambda: env.volume_locations(vid) == [dst], what="the move")
    client._vid_cache.clear()
    for f, data in blobs.items():
        assert client.download(f) == data
    client.close()


def test_autopilot_tiering_round_trip_end_to_end(tmp_path, monkeypatch):
    """Twin of tests/test_autopilot.py::
    test_autopilot_tiering_round_trip_end_to_end: the reference master
    demotes a port node's cold volumes through its /admin/ec/fleet_convert
    and the seal, serves them from the shard sets, and promotes them back
    through its /admin/volume/unconvert once its /heat shows them hot."""
    monkeypatch.setenv("WEEDTPU_AUTOPILOT", "execute")
    c = PortCluster(tmp_path, n_port=1).start()
    try:
        master = c.master
        ap = master.autopilot
        ap.cold_rps = 1e9
        ap.cold_s = 0.0
        ap.hot_rps = 0.01
        ap.hot_s = 0.0
        ap.cooldown_s = 0.0
        client = WeedClient(master.url)
        rng = np.random.default_rng(0xA171)
        blobs = {}
        for i in range(10):
            data = rng.integers(0, 256, int(rng.integers(8_000, 30_000)),
                                dtype=np.uint8).tobytes()
            blobs[client.upload(data, name=f"t{i}.bin")] = data
        node, d = c.port_urls[0], c.port_dirs[0]
        vids = sorted(v["id"] for v in vs_call(node, "/status")[1]
                      ["volumes"])
        wait_for(lambda: sorted(master.topo.nodes[node].volumes) == vids,
                 what="the beat")
        master.collect_heat()
        out = _post_json(f"http://{master.url}/cluster/autopilot",
                         {"tick": True, "wait": True})
        demotes = [p for p in out["plans"]
                   if p["policy"] == "tiering_demote"]
        assert {p["vid"] for p in demotes} == set(vids)
        c.submit(master.convert.tick())
        st = master.convert.status()
        assert st["converted"] == len(vids), st
        beat = vs_call(node, "/status")[1]
        assert beat["volumes"] == []
        assert sorted(e["id"] for e in beat["ec_shards"]) == vids
        for vid in vids:
            assert not (d / f"{vid}.dat").exists()
        wait_for(lambda: all(master.topo.nodes[node].ec_shards.get(v)
                             for v in vids), what="the shard beats")
        client._vid_cache.clear()
        for f, data in blobs.items():
            assert client.download(f) == data
        for _ in range(3):
            for f, data in blobs.items():
                assert client.download(f) == data
        master.collect_heat()
        out = _post_json(f"http://{master.url}/cluster/autopilot",
                         {"tick": True, "wait": True})
        promotes = [p for p in out["plans"]
                    if p["policy"] == "tiering_promote"]
        assert {p["vid"] for p in promotes} == set(vids), out["plans"]
        beat = vs_call(node, "/status")[1]
        assert beat["ec_shards"] == []
        assert sorted(v["id"] for v in beat["volumes"]) == vids
        assert not any(v["read_only"] for v in beat["volumes"])
        for vid in vids:
            assert (d / f"{vid}.dat").exists()
            assert not glob.glob(str(d / f"{vid}.ec*"))
        wait_for(lambda: all(master.topo.nodes[node].volumes.get(v)
                             for v in vids), what="the volume beats")
        client._vid_cache.clear()
        for f, data in blobs.items():
            assert client.download(f) == data
        client.close()
    finally:
        c.stop()


def test_tier_move_via_server_and_shell(tmp_path):
    """Twin of tests/test_backend_tier.py::
    test_tier_move_via_server_and_shell."""
    c = PortCluster(tmp_path, n_port=1).start()
    try:
        client = WeedClient(c.master.url)
        f = client.upload(b"cold data", name="c.bin")
        vid = int(f.split(",")[0])
        env = CommandEnv(c.master.url)
        env.acquire_lock()
        buf = io.StringIO()
        run_command(env, f"volume.tier.move -volumeId {vid} "
                         f"-dest local:{tmp_path / 'tier'}", buf)
        assert "tier local" in buf.getvalue()
        assert client.download(f) == b"cold data"
        assert any(name.endswith(".dat")
                   for _, _, files in os.walk(tmp_path / "tier")
                   for name in files)
        env.release_lock()
    finally:
        c.stop()


def test_fix_replication_restores_copy(port2):
    """Twin of tests/test_shell_commands.py::
    test_fix_replication_restores_copy."""
    c = port2
    client = WeedClient(c.master.url)
    f = client.upload(b"replicate me", name="r.txt")
    vid = int(f.split(",")[0])
    env = CommandEnv(c.master.url)
    env.acquire_lock()
    locs = env.volume_locations(vid)
    other = [u for u in c.port_urls if u not in locs]
    env.vs_post(other[0], "/admin/volume/copy",
                {"volume": vid, "source": locs[0]})
    wait_for(lambda: len(env.volume_locations(vid)) == 2, what="2 copies")
    buf = io.StringIO()
    run_command(env, "volume.fix.replication -apply", buf)
    assert "over-replicated" in buf.getvalue()
    wait_for(lambda: len(env.volume_locations(vid)) == 1, what="1 copy")
    client._vid_cache.clear()
    assert client.download(f) == b"replicate me"
    env.release_lock()


def test_incremental_volume_copy(port2):
    """Twin of tests/test_shell_commands.py::test_incremental_volume_copy."""
    c = port2
    client = WeedClient(c.master.url)
    f1 = client.upload(b"first " * 100, name="a.bin")
    vid = int(f1.split(",")[0])
    env = CommandEnv(c.master.url)
    env.acquire_lock()
    locs = env.volume_locations(vid)
    dst = next(u for u in c.port_urls if u not in locs)
    env.vs_post(dst, "/admin/volume/copy", {"volume": vid,
                                            "source": locs[0]})
    wait_for(lambda: len(env.volume_locations(vid)) == 2, what="2 copies")
    client.upload_to(locs[0], f"{vid},000000aadeadbeef?type=replicate",
                     b"tail-data")
    r = env.vs_post(dst, "/admin/volume/copy", {"volume": vid,
                                                "source": locs[0]})
    assert r.get("incremental") and r.get("appended_bytes", 0) > 0
    got = urllib.request.urlopen(
        f"http://{dst}/{vid},000000aadeadbeef", timeout=15).read()
    assert got == b"tail-data"
    r2 = env.vs_post(dst, "/admin/volume/copy", {"volume": vid,
                                                 "source": locs[0]})
    assert r2.get("appended_bytes") == 0
    env.release_lock()


def test_json_query_pushdown(tmp_path):
    """Twin of tests/test_aux.py::test_json_query_pushdown."""
    c = PortCluster(tmp_path, n_port=1).start()
    try:
        client = WeedClient(c.master.url)
        docs = [{"name": f"user{i}", "age": 20 + i,
                 "city": "oslo" if i % 2 else "bergen"} for i in range(10)]
        fids = [client.upload(json.dumps(d).encode(), name=f"d{i}.json")
                for i, d in enumerate(docs)]
        vid = int(fids[0].split(",")[0])
        url = c.port_urls[0]

        def query(body):
            req = urllib.request.Request(f"http://{url}/admin/query",
                                         data=json.dumps(body).encode(),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=30) as r:
                return [json.loads(line) for line in r.read().splitlines()]

        rows = query({"volume": vid,
                      "filter": {"field": "age", "op": ">=", "value": 25},
                      "projections": ["name", "age"]})
        assert len(rows) == 5
        assert all(set(r) == {"name", "age"} and r["age"] >= 25
                   for r in rows)
        rows = query({"volume": vid,
                      "filter": {"field": "city", "op": "=",
                                 "value": "oslo"}})
        assert len(rows) == 5 and all(r["city"] == "oslo" for r in rows)
    finally:
        c.stop()


# ---- mixed clusters: volumes and shard sets cross the packages ---------

def test_mixed_move_crosses_packages(tmp_path):
    """A volume written on a reference node moves to a port node and back:
    each move's CRC equals the .dat's, the .dat and .idx stay byte-equal
    through both, and every blob reads back from wherever it lives."""
    c = PortCluster(tmp_path, n_port=1, n_ref=1).start()
    try:
        ref, port = c.ref_servers[0], c.port_urls[0]
        client = WeedClient(c.master.url)
        vid = 31
        ref.store.allocate_volume(vid, "", "000", "")
        rng = np.random.default_rng(31)
        blobs = {}
        for k in range(1, 13):
            data = rng.integers(0, 256, int(rng.integers(500, 40_000)),
                                dtype=np.uint8).tobytes()
            f = fid(vid, k)
            client.upload_to(ref.url, f, data)
            blobs[f] = data
        rbase = os.path.join(str(tmp_path / "ref0"), str(vid))
        files = {ext: open(rbase + ext, "rb").read()
                 for ext in (".dat", ".idx")}
        out = _post_json(f"http://{ref.url}/admin/volume/move",
                         {"volume": vid, "target": port})
        assert out["crc"] == zlib.crc32(files[".dat"])
        pbase = os.path.join(str(c.port_dirs[0]), str(vid))
        for ext, data in files.items():
            assert open(pbase + ext, "rb").read() == data
        assert ref.store.get_volume(vid) is None
        for f, data in blobs.items():
            assert vs_call(port, "/" + f) == (200, data)
        out = _post_json(f"http://{port}/admin/volume/move",
                         {"volume": vid, "target": ref.url})
        assert out["crc"] == zlib.crc32(files[".dat"])
        for ext, data in files.items():
            assert open(rbase + ext, "rb").read() == data
        assert not os.path.exists(pbase + ".dat")
        for f, data in blobs.items():
            assert vs_call(ref.url, "/" + f) == (200, data)
        assert leftovers(c.port_dirs[0]) == leftovers(tmp_path / "ref0") \
            == []
    finally:
        c.stop()


def test_mixed_unconvert_after_reference_encode(tmp_path, monkeypatch):
    """The reference encodes a volume; its shard set, less two data
    shards, is copied to a port node, which unconverts it (rebuilding the
    two first): the .dat and .idx equal the reference's own, and every
    blob reads back from the port node, which can write again."""
    c = PortCluster(tmp_path, n_port=1, n_ref=1).start()
    try:
        ref, port = c.ref_servers[0], c.port_urls[0]
        client = WeedClient(c.master.url)
        vid = 32
        ref.store.allocate_volume(vid, "", "000", "")
        rng = np.random.default_rng(32)
        blobs = {}
        for k in range(1, 15):
            data = rng.integers(0, 256, int(rng.integers(500, 40_000)),
                                dtype=np.uint8).tobytes()
            f = fid(vid, k)
            client.upload_to(ref.url, f, data)
            blobs[f] = data
        rbase = os.path.join(str(tmp_path / "ref0"), str(vid))
        with monkeypatch.context() as m:
            m.setenv("WEEDTPU_EC_CODEC", "numpy")
            assert vs_call(ref.url, "/admin/volume/readonly",
                           {"volume": vid})[0] == 200
            assert vs_call(ref.url, "/admin/ec/generate",
                           {"volume": vid})[0] == 200
        files = {ext: open(rbase + ext, "rb").read()
                 for ext in (".dat", ".idx")}
        shards = [i for i in range(14) if i not in (1, 6)]
        assert vs_call(port, "/admin/ec/copy",
                       {"volume": vid, "source": ref.url,
                        "shards": shards, "copy_ecx": True})[0] == 200
        assert vs_call(port, "/admin/ec/mount", {"volume": vid})[0] == 200
        st, out = vs_call(port, "/admin/volume/unconvert", {"volume": vid})
        assert st == 200 and out["decoded"] is True, out
        assert out["shards_retired"] == list(range(14))
        pbase = os.path.join(str(c.port_dirs[0]), str(vid))
        for ext, data in files.items():
            assert open(pbase + ext, "rb").read() == data
        for f, data in blobs.items():
            assert vs_call(port, "/" + f) == (200, data)
        req = urllib.request.Request(f"http://{port}/{fid(vid, 99)}",
                                     data=b"again", method="PUT")
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.status == 201
    finally:
        c.stop()
