"""The port's maintenance routes held against the reference: scrub and its
rate, faults, the repair helper's partial, the reduced rebuild's 500,
the canary's probe and the recode.

Handler tests build both packages' `VolumeServer`s over copies of one
shard set (the port's with `device="cpu"`) and call the handlers with the
same request, the reference's with WEEDTPU_EC_CODEC=numpy set only around
its calls (the port raises on that value); their answers and files must
be byte-equal.  The cluster tests are twins of tests/test_maintenance.py's
heal tests: the reference master or the port's, in process, over one port
volume server started by the port's CLI in a subprocess
(tests/test_torch_cluster.py's `PortCluster`), driven through
`/admin/faults`, `/admin/scrub` and the master's `/maintenance/tick`.
"""

import asyncio
import contextlib
import io
import json
import os
import shutil
import time
import types

import numpy as np
import pytest

from seaweedfs_tpu.maintenance import faults as ref_faults
from seaweedfs_tpu.maintenance import scrub as ref_scrub
from seaweedfs_tpu.ops import gf as ref_gf
from seaweedfs_tpu.server.volume_server import VolumeServer as RefVS
from seaweedfs_tpu.storage.store import Store as RefStore

from seaweedfs_tpu_torch.maintenance import faults, scrub
from seaweedfs_tpu_torch.ops import regen
from seaweedfs_tpu_torch.server import volume_server as vsmod
from seaweedfs_tpu_torch.storage import needle as ndl
from seaweedfs_tpu_torch.storage.ec import ec_files, layout
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.storage.volume import Volume

from tests.test_torch_cluster import PortCluster, vs_call, wait_for
from tests.test_torch_volume_server import free_port


def fake_req(body=None, query=None, remote="127.0.0.1"):
    async def _json():
        return body
    return types.SimpleNamespace(json=_json, query=query or {},
                                 remote=remote)


async def _no_beat():
    return None


def call(vs, handler: str, req):
    """(status, body bytes) of one handler call outside a server."""
    resp = asyncio.run(getattr(vs, handler)(req))
    return resp.status, resp.body


def make_volume(d, vid=7, n=40, seed=5) -> tuple[str, dict]:
    """A volume of `n` needles of 1-20 KB written by the port's Volume and
    encoded by the port on the CPU at the default layout; the `.dat` and
    `.idx` removed, so a node over `d` holds the shard set only."""
    v = Volume(str(d), "", vid)
    rng = np.random.default_rng(seed)
    blobs = {}
    for nid in range(1, n + 1):
        data = rng.integers(0, 256, int(rng.integers(1000, 20_000)),
                            dtype=np.uint8).tobytes()
        v.append_needle(ndl.Needle(cookie=0x1234ABCD, id=nid, data=data))
        blobs[nid] = data
    v.close()
    base = os.path.join(str(d), str(vid))
    ec_files.write_ec_files(base, device="cpu")
    ec_files.write_sorted_ecx(base + ".idx")
    for ext in (".dat", ".idx"):
        os.remove(base + ext)
    return base, blobs


def files_of(base) -> dict:
    out = {}
    for ext in [layout.to_ext(i) for i in range(layout.MAX_TOTAL_SHARDS)] \
            + [".ecx", ".vif"]:
        if os.path.exists(base + ext):
            with open(base + ext, "rb") as f:
                out[ext] = f.read()
    return out


class Pair:
    """The port's and the reference's VolumeServer, unstarted, each over
    its own copy of one shard set (volume 7); heartbeats stubbed on the
    instances."""

    def __init__(self, tmp_path, monkeypatch):
        self.mp = monkeypatch
        pdir, rdir = tmp_path / "port", tmp_path / "ref"
        pdir.mkdir()
        self.base, self.blobs = make_volume(pdir)
        shutil.copytree(pdir, rdir)
        self.rbase = str(rdir / "7")
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
def pair(tmp_path, monkeypatch):
    p = Pair(tmp_path, monkeypatch)
    yield p
    p.close()


# ---- faults --------------------------------------------------------------

def test_faults_env_parse_equals_reference():
    spec = "delete_shard:1:3;flip_bit:2:7:4096:5;delay_shard_read:50;" \
        "delay_file_pull:20;shard_write_error:EIO;partition:volume:x;" \
        "wan_latency:dc1:dc2:40;peer_error:node1:25"
    assert faults.parse_env(spec) == ref_faults.parse_env(spec) == [
        {"action": "delete_shard", "volume": 1, "shard": 3},
        {"action": "flip_bit", "volume": 2, "shard": 7, "offset": 4096,
         "bit": 5},
        {"action": "delay_shard_read", "ms": 50.0},
        {"action": "delay_file_pull", "ms": 20.0},
        {"action": "shard_write_error", "kind": "EIO"},
        {"action": "partition", "a": "volume", "b": "x"},
        {"action": "wan_latency", "a": "dc1", "b": "dc2", "ms": 40.0,
         "jitter": 0.0},
        {"action": "peer_error", "dst": "node1", "pct": 25.0}]


@pytest.mark.parametrize("directive", [
    "bogus:1", "flip_bit:x", "delete_shard:1", "delay_shard_read:soon",
    "partition:volume", "peer_latency:n:fast"])
def test_fault_plan_raises_where_reference_drops(tmp_path, monkeypatch,
                                                 directive):
    """An unknown or malformed WEEDTPU_FAULTS directive raises, and the
    server refuses to start before its socket binds; the reference logs
    the directive and drops it."""
    spec = "delete_shard:1:3;" + directive
    assert ref_faults.parse_env(spec) == [
        {"action": "delete_shard", "volume": 1, "shard": 3}]
    with pytest.raises(ValueError, match="WEEDTPU_FAULTS"):
        faults.parse_env(spec)
    monkeypatch.setenv("WEEDTPU_FAULTS", spec)
    vs = vsmod.VolumeServer([str(tmp_path / "vs")], "127.0.0.1:1",
                            "127.0.0.1", free_port(), device="cpu")
    try:
        with pytest.raises(ValueError, match="WEEDTPU_FAULTS"):
            asyncio.run(vs.start())
        assert vs._runner is None  # it failed before binding
    finally:
        vs.store.close()


def test_storage_faults_equal_reference(pair):
    """flip_bit and delete_shard change the same bytes and answer the
    same; the deleted shard leaves the mounted volume."""
    body = {"faults": [
        {"action": "flip_bit", "volume": 7, "shard": 2, "offset": 1234,
         "bit": 3},
        {"action": "delete_shard", "volume": 7, "shard": 12},
        {"action": "flip_bit", "volume": 99, "shard": 0, "offset": 0}]}
    (st, got), (rst, want) = pair.both("handle_faults", body)
    assert st == rst == 200
    assert json.loads(got) == json.loads(want)
    assert [a["ok"] for a in json.loads(got)["applied"]] == \
        [True, True, False]
    assert files_of(pair.base) == files_of(pair.rbase)
    assert 12 not in pair.port.store.get_ec_volume(7).shards


def test_net_faults_apply_through_admin_faults(pair):
    """Twin of tests/test_chaos.py::test_parse_env_net_directives, applied
    through /admin/faults: the parsed network directives go to both
    packages' handlers, which answer alike and arm the same process-wide
    registry (each package's own); the storage fault beside them still
    applies, and `clear_net` disarms everything."""
    spec = ("partition:filer:volume;peer_latency:vs1:50:10;"
            "peer_error:vs1:25;shard_write_error:EIO;clear_net")
    parsed = faults.parse_env(spec)
    assert parsed == ref_faults.parse_env(spec)
    assert [p["action"] for p in parsed] == [
        "partition", "peer_latency", "peer_error", "shard_write_error",
        "clear_net"]
    keys = ("partitions", "latency_ms", "error_rate", "shard_write_error")
    try:
        body = {"faults": parsed[:-1] + [
            {"action": "delete_shard", "volume": 7, "shard": 1}]}
        (st, got), (rst, want) = pair.both("handle_faults", body)
        assert st == rst == 200
        assert json.loads(got) == json.loads(want)
        assert all(a["ok"] for a in json.loads(got)["applied"])
        snap = faults.net_snapshot()
        assert {k: snap[k] for k in keys} == \
            {k: ref_faults.net_snapshot()[k] for k in keys} == {
                "partitions": [["filer", "volume"]],
                "latency_ms": {"vs1": [50.0, 10.0]},
                "error_rate": {"vs1": 25.0}, "shard_write_error": "EIO"}
        assert faults.NET_ACTIVE
        (st, got), (rst, want) = pair.both(
            "handle_faults", {"faults": parsed[-1:]})
        assert json.loads(got) == json.loads(want)
        assert not faults.NET_ACTIVE and faults.net_snapshot()["partitions"] \
            == []
    finally:
        faults.clear_net()
        ref_faults.clear_net()


def test_faults_and_scrub_are_loopback_only(pair):
    for handler in ("handle_faults", "handle_scrub"):
        st, raw = call(pair.port, handler, fake_req({}, remote="10.1.2.3"))
        assert (st, json.loads(raw)) == (403, {"error": "forbidden"})


def test_delays_stall_shard_reads_and_file_pulls(pair):
    body = {"faults": [{"action": "delay_shard_read", "ms": 120},
                       {"action": "delay_file_pull", "ms": 80}]}
    st, _ = call(pair.port, "handle_faults", fake_req(body))
    assert st == 200
    t0 = time.perf_counter()
    st, data = call(pair.port, "handle_ec_shard_read", fake_req(query={
        "volume": "7", "shard": "0", "offset": "0", "size": "100"}))
    assert st == 200 and time.perf_counter() - t0 >= 0.12
    assert data == open(pair.base + ".ec00", "rb").read()[:100]
    t0 = time.perf_counter()
    st, _ = call(pair.port, "handle_file_pull",
                 fake_req(query={"name": "bad"}))
    assert st == 400 and time.perf_counter() - t0 >= 0.08


# ---- scrub ----------------------------------------------------------------

@pytest.mark.parametrize("name,value", [
    ("WEEDTPU_SCRUB_MBPS", "fast"), ("WEEDTPU_SCRUB_MBPS", "-1"),
    ("WEEDTPU_SCRUB_INTERVAL", "0"), ("WEEDTPU_SCRUB_INTERVAL", "soon"),
    ("WEEDTPU_SCRUB_WINDOW", "1.5"), ("WEEDTPU_SCRUB_WINDOW", "0"),
    ("WEEDTPU_SCRUB_REMOTE", "yes")])
def test_scrub_knob_raises_where_reference_falls_back(tmp_path, monkeypatch,
                                                      name, value):
    store = Store([str(tmp_path)], device="cpu")
    monkeypatch.setenv(name, value)
    try:
        with pytest.raises(ValueError, match=name):
            scrub.Scrubber(store)
        # the reference takes the same value (or its default) and goes on
        ref_scrub.Scrubber(store)
        vs = vsmod.VolumeServer([str(tmp_path / "vs")], "127.0.0.1:1",
                                "127.0.0.1", free_port(), device="cpu")
        with pytest.raises(ValueError, match=name):
            asyncio.run(vs.start())
        assert vs._runner is None  # it failed before binding
        vs.store.close()
    finally:
        store.close()


def test_scrub_knobs_take_the_reference_defaults(tmp_path, monkeypatch):
    for name in ("WEEDTPU_SCRUB_MBPS", "WEEDTPU_SCRUB_INTERVAL",
                 "WEEDTPU_SCRUB_WINDOW", "WEEDTPU_SCRUB_REMOTE"):
        monkeypatch.delenv(name, raising=False)
    store = Store([str(tmp_path)], device="cpu")
    try:
        s, r = scrub.Scrubber(store), ref_scrub.Scrubber(store)
        assert (s.mbps, s.interval) == (r.mbps, r.interval) == (8.0, 300.0)
        assert s.window is None and r.window == scrub.DEFAULT_WINDOW
        monkeypatch.setenv("WEEDTPU_SCRUB_WINDOW", "4096")
        monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "2.5")
        s, r = scrub.Scrubber(store), ref_scrub.Scrubber(store)
        assert (s.window, s.mbps) == (r.window, r.mbps) == (4096, 2.5)
    finally:
        store.close()


def test_scrub_rate_semantics_equal_reference(tmp_path):
    """Operator pushes latch a pause on 0 and release it above; the
    governor's pushes and scales respect the latch and scale this node's
    configured rate, in both packages alike."""
    store = Store([str(tmp_path)], device="cpu")
    try:
        s = scrub.Scrubber(store, mbps=4.0)
        r = ref_scrub.Scrubber(store, mbps=4.0)
        steps = [("scale", 0.5), ("set", 3.0, True), ("set", 0.0, False),
                 ("set", 6.0, True), ("scale", 1.0), ("set", 5.0, False),
                 ("scale", 2.0), ("scale", -1.0), ("set", -3.0, False)]
        for step in steps:
            outs = []
            for x in (s, r):
                if step[0] == "scale":
                    outs.append(x.apply_governed_scale(step[1]))
                else:
                    outs.append(x.set_mbps(step[1], governed=step[2]))
                outs.append((x.mbps, x.configured_mbps, x.operator_paused))
            assert outs[:2] == outs[2:], step
        s.set_mbps(0)
        r.set_mbps(0)
        assert _strip_times(s.scrub_once()) == \
            _strip_times(r.scrub_once()) == \
            {"bytes": 0, "volumes": {}, "paused": True}
    finally:
        store.close()


def _strip_times(summary: dict) -> dict:
    out = {k: v for k, v in summary.items() if k != "ts"}
    out["volumes"] = {vid: {k: v for k, v in res.items()
                            if k != "last_scrub"}
                      for vid, res in summary["volumes"].items()}
    return out


def test_scrub_verdicts_equal_reference(pair, tmp_path):
    """One pass over a store volume with a corrupt needle and an EC volume
    with a flipped bit: the port's verdicts (needle CRC through
    csrc/crc32c.cc, the syndrome scan, the quarantine) equal the
    reference's, and the windows ran on the store's device."""
    d = tmp_path / "port"
    v = Volume(str(d), "", 3)
    for nid in range(1, 21):
        v.append_needle(ndl.Needle(cookie=7, id=nid, data=os.urandom(3000)))
    off, _ = v.nm.get(9)
    v.close()
    with open(str(d / "3.dat"), "r+b") as f:  # a data byte of needle 9
        f.seek(off * 8 + 16 + 4 + 100)
        b = f.read(1)
        f.seek(off * 8 + 16 + 4 + 100)
        f.write(bytes([b[0] ^ 0x40]))
    shutil.copy(d / "3.dat", tmp_path / "ref" / "3.dat")
    shutil.copy(d / "3.idx", tmp_path / "ref" / "3.idx")
    for base in (pair.base, pair.rbase):
        with open(base + ".ec04", "r+b") as f:
            f.seek(5000)
            b = f.read(1)
            f.seek(5000)
            f.write(bytes([b[0] ^ 1]))
    store = Store([str(d)], device="cpu")
    with pair.ref_codec():
        rstore = RefStore([str(tmp_path / "ref")])
    try:
        got = scrub.Scrubber(store, mbps=1e6).scrub_once()
        with pair.ref_codec():
            want = ref_scrub.Scrubber(rstore, mbps=1e6).scrub_once()
    finally:
        store.close()
        rstore.close()
    assert _strip_times(got) == _strip_times(want)
    assert got["volumes"]["3"]["corrupt"] == [{"needle": "9"}]
    assert got["volumes"]["7"]["corrupt"][0]["shard"] == 4
    assert got["volumes"]["7"]["quarantined"] == {"4": [[0, 1048576]]}


def test_scrubber_respects_rate_limit(tmp_path):
    """Twin of tests/test_maintenance.py::test_scrubber_respects_rate_limit:
    a pass over ~2 MB at 2 MB/s takes about a second; unthrottled it is
    far faster, and both passes verify the same needles."""
    vol = Volume(str(tmp_path), "", 9)
    blob = os.urandom(32 * 1024)
    for i in range(1, 65):  # ~2 MB of needle data
        vol.append_needle(ndl.Needle(cookie=1, id=i, data=blob))
    vol.close()
    store = Store([str(tmp_path)], device="cpu")
    try:
        fast = scrub.Scrubber(store, mbps=10_000)
        t0 = time.perf_counter()
        s1 = fast.scrub_once()
        fast_s = time.perf_counter() - t0
        assert s1["bytes"] > 1_900_000
        slow = scrub.Scrubber(store, mbps=2.0)
        t0 = time.perf_counter()
        s2 = slow.scrub_once()
        slow_s = time.perf_counter() - t0
        # 2 MB at 2 MB/s less the 0.25 s burst allowance
        assert slow_s >= 0.6, slow_s
        assert slow_s > fast_s * 2
        assert _strip_times(s1) == _strip_times(s2)
        assert s1["volumes"]["9"]["needles"] == 64
    finally:
        store.close()


def test_background_scrubber_reports_to_the_master(tmp_path, monkeypatch):
    """The server starts a scrubber at the knobs' rate; its passes post
    to the master's /maintenance/scrub_report; /admin/scrub_rate retunes
    it, 400 on a body that is not a dict; WEEDTPU_SCRUB_MBPS=0 leaves
    none, and /admin/scrub_rate answers mbps null."""
    from aiohttp import web
    from tests.test_torch_volume_server import Harness
    reports = []

    async def heartbeat(req):
        await req.read()
        return web.json_response({"volume_size_limit": 1 << 30})

    async def scrub_report(req):
        reports.append(await req.json())
        return web.json_response({})

    def master():
        app = web.Application()
        app.add_routes([web.post("/heartbeat", heartbeat),
                        web.post("/maintenance/scrub_report",
                                 scrub_report)])
        return app

    monkeypatch.setenv("WEEDTPU_SCRUB_INTERVAL", "0.3")
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "50")
    (tmp_path / "a").mkdir()
    h = Harness(tmp_path / "a", master_app=master())
    try:
        vs = h.vs[0]
        assert vs.scrubber is not None and vs.scrubber.mbps == 50.0
        h.json(0, "/admin/assign_volume", {"volume": 4})
        h.call(0, "/4,01637037d6", data=b"x" * 5000, method="PUT")
        wait_for(lambda: any("4" in r["volumes"] for r in reports),
                 timeout=10, what="a background scrub report")
        rep = next(r for r in reports if "4" in r["volumes"])
        assert rep["node"] == vs.url
        assert rep["volumes"]["4"]["needles"] == 1
        assert h.json(0, "/admin/scrub_rate", {"mbps": 0}) == \
            (200, {"mbps": 0.0, "operator_paused": True})
        assert h.json(0, "/admin/scrub", {})[1]["paused"] is True
        assert h.json(0, "/admin/scrub_rate",
                      {"mbps": 20, "governed": True})[1] == \
            {"mbps": 0.0, "operator_paused": True}
        assert h.json(0, "/admin/scrub_rate", {"mbps": 20})[1] == \
            {"mbps": 20.0, "operator_paused": False}
        assert h.json(0, "/admin/scrub_rate", {"scale": 0.5})[1] == \
            {"mbps": 10.0, "operator_paused": False}
        st, _, _ = h.call(0, "/admin/scrub_rate", data=b"[2.5]",
                          headers={"Content-Type": "application/json"})
        assert st == 400
        n = len(reports)
        summary = h.json(0, "/admin/scrub", {})[1]
        assert summary["volumes"]["4"]["crc_mismatches"] == 0
        assert len(reports) > n  # /admin/scrub reports too
    finally:
        h.stop()
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "0")
    (tmp_path / "b").mkdir()
    h = Harness(tmp_path / "b", master_app=master())
    try:
        assert h.vs[0].scrubber is None
        assert h.json(0, "/admin/scrub_rate", {"mbps": 3}) == \
            (200, {"mbps": None})
    finally:
        h.stop()


# ---- /admin/ec/partial -----------------------------------------------------

def test_ec_partial_equals_reference(pair):
    rng = np.random.default_rng(3)
    for sids, alpha in (([0, 4, 11], 1), ([2], 1), (list(range(10)), 1)):
        coeff = rng.integers(0, 256, (2, len(sids)), dtype=np.uint8)
        body = {"volume": 7, "shards": sids, "offset": 4096, "size": 8192,
                "coeff": coeff.tolist()}
        (st, got), (rst, want) = pair.both("handle_ec_partial", body)
        assert st == rst == 200 and got == want
        rows = np.stack([np.fromfile(pair.base + layout.to_ext(s),
                                     np.uint8)[4096:4096 + 8192]
                         for s in sids])
        assert got == ref_gf.gf_matmul(coeff, rows).tobytes()


def test_ec_partial_quarantined_range_is_409(pair):
    ev = pair.port.store.get_ec_volume(7)
    ev.quarantine_range(5, 0, 65536)
    body = {"volume": 7, "shards": [4, 5], "offset": 0, "size": 4096,
            "coeff": [[1, 1]]}
    st, raw = call(pair.port, "handle_ec_partial", fake_req(body))
    assert st == 409 and b"shard 5" in raw
    body["shards"] = [4, 6]
    assert call(pair.port, "handle_ec_partial", fake_req(body))[0] == 200
    body["volume"] = 8
    assert call(pair.port, "handle_ec_partial", fake_req(body))[0] == 404


def test_ec_partial_rejects_oversized_shard_list(tmp_path):
    """Twin of tests/test_regen.py::test_ec_partial_rejects_oversized_
    shard_list: an over-long or duplicated shard list is a 400."""
    vs = vsmod.VolumeServer([str(tmp_path)], "127.0.0.1:0", "127.0.0.1",
                            free_port(), device="cpu")
    try:
        too_many = list(range(layout.TOTAL_SHARDS)) + [0]
        for body in ({"volume": 7, "shards": too_many, "offset": 0,
                      "size": 4096, "coeff": [[1] * len(too_many)]},
                     {"volume": 7, "shards": [0, 0], "offset": 0,
                      "size": 4096, "coeff": [[1, 1]]},
                     {"volume": 7, "shards": [0], "offset": 0,
                      "size": ec_files.DEFAULT_BATCH + 1, "coeff": [[1]]},
                     {"volume": 7, "shards": [0], "offset": 0, "size": 8,
                      "coeff": [[1]], "alpha": 65},
                     {"volume": 7, "shards": "x"}):
            assert call(vs, "handle_ec_partial", fake_req(body))[0] == 400
        # a well-formed request passes the shape checks (404: no volume 7)
        assert call(vs, "handle_ec_partial", fake_req(
            {"volume": 7, "shards": [0, 1], "offset": 0, "size": 4096,
             "coeff": [[1, 1]]}))[0] == 404
    finally:
        vs.store.close()


def test_ec_partial_alpha_sub_rows(tmp_path, monkeypatch):
    """Twin of tests/test_codecs.py::test_ec_partial_alpha_sub_rows: an
    MSR helper ships combined sub-rows (virtual sid f*alpha+row is
    column `row` of file f's [size, alpha] view), equal to the
    reference's; a whole-shard request still works on the same files."""
    a = 8
    rng = np.random.default_rng(21)
    dirs = {}
    for name in ("port", "ref"):
        d = tmp_path / name
        d.mkdir()
        dirs[name] = os.path.join(str(d), "9")
    size = 512
    files = {}
    for f_ in (3, 5):
        files[f_] = rng.integers(0, 256, size * a, dtype=np.uint8)
        for base in dirs.values():
            files[f_].tofile(base + layout.to_ext(f_))
    for base in dirs.values():
        open(base + ".ecx", "wb").close()
        ec_files.write_vif(base, size * a * 9, codec="msr_9_16")
    vs = vsmod.VolumeServer([str(tmp_path / "port")], "127.0.0.1:0",
                            "127.0.0.1", free_port(), device="cpu")
    with monkeypatch.context() as m:
        m.setenv("WEEDTPU_EC_CODEC", "numpy")
        ref = RefVS([str(tmp_path / "ref")], "127.0.0.1:0",
                    port=free_port())
    try:
        assert vs.store.get_ec_volume(9) is not None
        sids = [3 * a + 0, 3 * a + 2, 5 * a + 7]
        coeff = rng.integers(1, 256, (1, len(sids)), dtype=np.uint8)
        body = {"volume": 9, "shards": sids, "offset": 0, "size": size,
                "alpha": a, "coeff": coeff.tolist()}
        st, got = call(vs, "handle_ec_partial", fake_req(body))
        with monkeypatch.context() as m:
            m.setenv("WEEDTPU_EC_CODEC", "numpy")
            rst, want = call(ref, "handle_ec_partial", fake_req(body))
        assert st == rst == 200 and got == want
        rows = np.stack([files[s // a].reshape(size, a)[:, s % a]
                         for s in sids])
        assert got == ref_gf.gf_matmul(coeff, rows)[0].tobytes()
        st, got = call(vs, "handle_ec_partial", fake_req(
            {"volume": 9, "shards": [3], "offset": 0, "size": size * a,
             "coeff": [[1]]}))
        assert st == 200 and got == files[3].tobytes()
    finally:
        vs.store.close()
        ref.store.close()


# ---- the reduced rebuild's 500 -------------------------------------------

def test_ec_rebuild_500_surfaces_replan_story(tmp_path, monkeypatch):
    """Twin of tests/test_codecs.py::test_ec_rebuild_500_surfaces_replan_
    story: when replanning runs out of substitutes, the 500 body names
    the helper that died, its shards and the replans spent."""
    vs = vsmod.VolumeServer([str(tmp_path)], "127.0.0.1:0", "127.0.0.1",
                            free_port(), device="cpu")
    try:
        with open(os.path.join(str(tmp_path), "4.ec00"), "wb") as f:
            f.write(b"\0" * 64)

        def boom(*a, **kw):
            stats = kw.get("stats")
            if stats is not None:
                stats["replans"] = 3
                stats["dead_helpers"] = ["a:1", "b:2", "a:1"]
            raise regen.HelperDied("a:1", (7, 8))

        monkeypatch.setattr(ec_files, "rebuild_ec_reduced", boom)
        body = {"volume": 4, "reduced":
                {"lost": [7], "groups": [{"node": "a:1", "shards": [7]}]}}
        st, raw = call(vs, "handle_ec_rebuild", fake_req(body))
        assert st == 500
        assert json.loads(raw) == {
            "error": str(regen.HelperDied("a:1", (7, 8))),
            "helper": "a:1", "helper_shards": [7, 8], "replans": 3,
            "dead_helpers": ["a:1", "b:2", "a:1"]}
        assert vs._ec_jobs[4]["state"] == "failed"
    finally:
        vs.store.close()


# ---- /admin/ec/probe_read ---------------------------------------------------

def test_probe_read_equals_reference(pair):
    """The probe reads the first live needle with a planned shard
    withheld, through the decode: the same answer as the reference's and
    the needle's bytes.  Every probe decodes (one reconstruct batch): its
    read goes through a view with an LRU of its own, in both packages,
    so a repeat is never served from the volume's LRU."""
    ev = pair.port.store.get_ec_volume(7)
    (st, got), (rst, want) = pair.both("handle_ec_probe_read",
                                       query={"volume": "7"})
    assert st == rst == 200 and json.loads(got) == json.loads(want)
    probe = json.loads(got)
    assert probe["bytes"] == len(pair.blobs[1])
    assert probe["needle"] == "1" and probe["skipped_shard"] == 0
    for n in (1, 2, 3):
        snap = ev.read_stats_snapshot()
        assert snap["reconstruct_batches"] == n
        assert snap["reconstruct_cache_hits"] == 0
        st, again = call(pair.port, "handle_ec_probe_read",
                         fake_req(query={"volume": "7"}))
        assert json.loads(again) == probe
    for q, code in (({"volume": "8"}, 404), ({"volume": "x"}, 400)):
        assert call(pair.port, "handle_ec_probe_read",
                    fake_req(query=q))[0] == code


# ---- /admin/ec/recode ------------------------------------------------------

@pytest.mark.parametrize("to", ["lrc_10_2_2", "msr_9_16"])
def test_recode_equals_reference(pair, to):
    """RS -> `to` in place, with a data shard missing (regenerated first):
    the shard files and `.vif` equal the reference recode's, the shards
    past the new geometry are gone, the volume is remounted under the
    new code on the server's device and every needle reads back; a
    second recode to the same code is a no-op."""
    for base in (pair.base, pair.rbase):
        os.remove(base + ".ec06")
    body = {"volume": 7, "codec": to}
    (st, got), (rst, want) = pair.both("handle_ec_recode", body)
    assert st == rst == 200, (got, want)
    assert json.loads(got) == json.loads(want)
    assert files_of(pair.base) == files_of(pair.rbase)
    assert ec_files.read_vif(pair.base)["codec"] == to
    ev = pair.port.store.get_ec_volume(7)
    assert ev.codec_tag == to and ev.codec.device.type == "cpu"
    assert json.loads(got)["shards"] == list(range(ev.spec.n))
    for nid, data in pair.blobs.items():
        assert pair.port.store.read_needle(7, nid).data == data
    assert not os.path.exists(pair.base + ".dat.recode")
    assert pair.port._ec_jobs[7]["state"] == "done"
    st, raw = call(pair.port, "handle_ec_recode", fake_req(body))
    assert (st, json.loads(raw)) == (200, {"codec": to, "unchanged": True})


def test_recode_back_and_refusals(pair):
    """LRC and back to RS gives the original shard set; too few shards
    is a 409; an unknown volume a 404."""
    orig = files_of(pair.base)
    for to in ("lrc_10_2_2", "rs_10_4"):
        st, raw = call(pair.port, "handle_ec_recode",
                       fake_req({"volume": 7, "codec": to}))
        assert st == 200, raw
    assert files_of(pair.base) == orig
    for sid in range(5):
        os.remove(pair.base + layout.to_ext(sid))
    st, raw = call(pair.port, "handle_ec_recode",
                   fake_req({"volume": 7, "codec": "lrc_10_2_2"}))
    assert st == 409 and b"recode needs 10 local shards" in raw
    assert call(pair.port, "handle_ec_recode",
                fake_req({"volume": 8, "codec": "lrc_10_2_2"}))[0] == 404


# ---- the heal flow: the reference master over a port node ----------------

@pytest.fixture(scope="module", params=["reference", "port"])
def heal_cluster(request, tmp_path_factory):
    """One port volume server (all 14 shards on it, so the syndrome scan
    assembles full stripes locally) under the reference master or the
    port's, the background scrub and repair loops parked: tests drive
    /admin/scrub and /maintenance/tick."""
    mp = pytest.MonkeyPatch()
    mp.setenv("WEEDTPU_REPAIR_INTERVAL", "3600")
    c = PortCluster(tmp_path_factory.mktemp("heal"), n_port=1,
                    env={"WEEDTPU_SCRUB_INTERVAL": "3600"},
                    master=request.param).start()
    yield c
    c.stop()
    mp.undo()


def _upload_and_encode(c, n=20, size=15000, seed=3, collection=""):
    from seaweedfs_tpu.client import WeedClient
    from seaweedfs_tpu.shell.commands import CommandEnv, run_command
    client = WeedClient(c.master.url)
    rng = np.random.default_rng(seed)
    payloads = {}
    for i in range(n):
        data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        payloads[client.upload(data, name=f"m{i}.bin",
                               collection=collection)] = data
    vid = int(next(iter(payloads)).partition(",")[0])
    time.sleep(0.5)
    env = CommandEnv(c.master.url)
    out = io.StringIO()
    run_command(env, "lock", out)
    run_command(env, f"ec.encode -volumeId {vid} -collection {collection}"
                if collection else f"ec.encode -volumeId {vid}", out)
    run_command(env, "unlock", out)
    time.sleep(0.5)
    return client, payloads, vid


def _status(c, vid):
    return vs_call(c.master.url, "/maintenance/status")[1]["volumes"][
        str(vid)]


def test_shard_loss_detected_by_heartbeat_diff_and_auto_rebuilt(
        heal_cluster):
    """Twin of tests/test_maintenance.py's: shard loss injected through
    the port node's /admin/faults surfaces in the master's ledger through
    the heartbeat diff and is rebuilt within one planner tick."""
    c = heal_cluster
    client, payloads, vid = _upload_and_encode(c, collection="loss")
    url = c.port_urls[0]
    st, r = vs_call(url, "/admin/faults", {"faults": [
        {"action": "delete_shard", "volume": vid, "shard": 4},
        {"action": "delete_shard", "volume": vid, "shard": 12}]})
    assert st == 200 and all(a["ok"] for a in r["applied"]), r
    wait_for(lambda: _status(c, vid)["shards_missing"] == [4, 12],
             timeout=10, what="the loss in the ledger")
    assert _status(c, vid)["state"] == "degraded"
    r = vs_call(c.master.url, "/maintenance/tick", {"wait": True})[1]
    assert any(a["vid"] == vid for a in r["actions"]), r
    wait_for(lambda: _status(c, vid)["state"] == "healthy", timeout=10,
             what="a healthy volume")
    assert len(_status(c, vid)["shards_present"]) == 14
    client._vid_cache.clear()
    for fid, data in payloads.items():
        assert client.download(fid) == data, fid


def test_end_to_end_heal_delete_two_flip_one(heal_cluster):
    """Twin of tests/test_maintenance.py's acceptance scenario: a bit
    flipped in shard 0 is found by the port's /admin/scrub, localised and
    quarantined (reads reconstruct around it), two more shards deleted;
    the master purges and rebuilds to a clean, fully protected set."""
    c = heal_cluster
    client, payloads, vid = _upload_and_encode(c, seed=4, collection="heal")
    url = c.port_urls[0]
    vs_call(url, "/admin/faults", {"faults": [
        {"action": "flip_bit", "volume": vid, "shard": 0,
         "offset": 1234}]})
    sc = vs_call(url, "/admin/scrub", {})[1]
    cor = sc["volumes"][str(vid)]["corrupt"]
    assert cor and cor[0]["shard"] == 0, cor
    assert sc["volumes"][str(vid)]["quarantined"].get("0"), sc
    client._vid_cache.clear()
    for fid, data in payloads.items():
        assert client.download(fid) == data, f"quarantined {fid}"
    vs_call(url, "/admin/faults", {"faults": [
        {"action": "delete_shard", "volume": vid, "shard": 3},
        {"action": "delete_shard", "volume": vid, "shard": 11}]})
    wait_for(lambda: _status(c, vid)["shards_missing"] == [3, 11],
             timeout=10, what="the loss in the ledger")
    assert _status(c, vid)["state"] == "corrupt"
    vs_call(c.master.url, "/maintenance/tick", {"wait": True})
    wait_for(lambda: _status(c, vid)["state"] == "healthy"
             and len(_status(c, vid)["shards_present"]) == 14,
             timeout=15, what="a healthy volume")
    sc = vs_call(url, "/admin/scrub", {})[1]
    assert sc["volumes"][str(vid)]["corrupt"] == [], sc
    client._vid_cache.clear()
    for fid, data in payloads.items():
        assert client.download(fid) == data, fid
