"""Fleet conversion through the port's volume server, held against the
reference: `/admin/ec/fleet_convert` and `convert_volumes`' progress and
cancel.

Twins of tests/test_fleet_convert.py's cancel, cluster and partial-failure
tests, with the reference master (and, for the cluster and
partial-failure twins, the port's) in process over a port volume server
on the same loop (`device="cpu"`), and the fleet handler's files and answer
against the reference handler's on copies of the same volumes (the
reference's codec WEEDTPU_CONVERT_CODEC=numpy, set only around its call).
"""

import asyncio
import json
import os
import shutil
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from seaweedfs_tpu.server.volume_server import VolumeServer as RefVS
from seaweedfs_tpu.stats import netflow as ref_netflow

from seaweedfs_tpu_torch.ops import fleet_convert
from seaweedfs_tpu_torch.server import volume_server as vsmod
from seaweedfs_tpu_torch.stats import netflow
from seaweedfs_tpu_torch.storage import needle as ndl
from seaweedfs_tpu_torch.storage.ec import ec_files, layout
from seaweedfs_tpu_torch.storage.volume import Volume

from tests.test_torch_volume_server import Harness, free_port

GEOM = dict(large_block=10_000, small_block=100, batch_size=1000)


def _make_volumes(tmp_path, sizes, seed=7):
    rng = np.random.default_rng(seed)
    bases = []
    for i, sz in enumerate(sizes):
        base = str(tmp_path / f"{i + 1}")
        with open(base + ".dat", "wb") as f:
            f.write(rng.integers(0, 256, sz, dtype=np.uint8).tobytes())
        bases.append(base)
    return bases


def _shard_bytes(base):
    out = {}
    for i in range(layout.TOTAL_SHARDS):
        p = base + layout.to_ext(i)
        if os.path.exists(p):
            with open(p, "rb") as f:
                out[i] = f.read()
    return out


# ---- convert_volumes' progress and cancel --------------------------------

def test_convert_cancel_clean_abort(tmp_path):
    """Twin of tests/test_fleet_convert.py::test_convert_cancel_clean_
    abort: cancel mid-stream raises EncodeCancelled, no partial shard
    set is visible, no .tmp is left, and an earlier shard set stays
    untouched."""
    bases = _make_volumes(tmp_path, [300_000, 280_000], seed=9)
    ec_files.write_ec_files(bases[0], large_block=10_000, small_block=100,
                            device="cpu")
    before = _shard_bytes(bases[0])
    calls = []

    def cancel():
        calls.append(1)
        return len(calls) > 2  # abort a couple of batches in

    with pytest.raises(ec_files.EncodeCancelled):
        fleet_convert.convert_volumes(bases, cancel=cancel, device="cpu",
                                      **GEOM)
    assert _shard_bytes(bases[0]) == before
    assert _shard_bytes(bases[1]) == {}
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]


def test_convert_progress_counts_the_volume_bytes(tmp_path):
    """`progress` sees the fleet's staged volume bytes rise to the total,
    under the convert traffic class, as the reference's does."""
    sizes = [150_000, 5_000, 61_001]
    bases = _make_volumes(tmp_path, sizes)
    seen, classes = [], []

    def progress(n):
        seen.append(n)
        classes.append(netflow.current_class())

    fleet_convert.convert_volumes(bases, progress=progress, device="cpu",
                                  **GEOM)
    assert seen == sorted(seen) and seen[-1] == sum(sizes)
    assert set(classes) == {"convert"}


# ---- /admin/ec/fleet_convert against the reference handler ---------------

async def _no_beat():
    return None


def _needle_volumes(d, vids, seed):
    rng = np.random.default_rng(seed)
    for vid in vids:
        v = Volume(str(d), "", vid)
        for nid in range(1, int(rng.integers(3, 30))):
            v.append_needle(ndl.Needle(
                cookie=0x1234ABCD, id=nid,
                data=rng.integers(0, 256, int(rng.integers(100, 40_000)),
                                  dtype=np.uint8).tobytes()))
        v.close()


def test_fleet_handler_equals_reference(tmp_path, monkeypatch):
    """The port's handler over three volumes writes the reference
    handler's shard sets, .ecx and .vif on copies of the same volumes,
    answers the same, and leaves the volumes read-only; an unknown
    volume is skipped, a list of none a 404."""
    pdir, rdir = tmp_path / "port", tmp_path / "ref"
    pdir.mkdir()
    _needle_volumes(pdir, (3, 4, 5), seed=11)
    shutil.copytree(pdir, rdir)
    port = vsmod.VolumeServer([str(pdir)], "127.0.0.1:1", "127.0.0.1",
                              free_port(), device="cpu")
    port._heartbeat_once = _no_beat
    ref = RefVS([str(rdir)], "127.0.0.1:1", port=free_port())
    ref._heartbeat_once = _no_beat

    def call(vs, body):
        async def _json():
            return body
        resp = asyncio.run(vs.handle_ec_fleet_convert(
            types.SimpleNamespace(json=_json)))
        return resp.status, json.loads(resp.body)

    try:
        body = {"volumes": [3, 4, 5, 77, "x", 3]}
        st, got = call(port, body)
        with monkeypatch.context() as m:
            m.setenv("WEEDTPU_CONVERT_CODEC", "numpy")
            rst, want = call(ref, body)
        assert st == rst == 200
        got.pop("wall_s")
        want.pop("wall_s")
        assert got == want
        assert got["converted"] == [3, 4, 5] and \
            got["skipped"] == {"77": "not found"}
        for vid in (3, 4, 5):
            for ext in [layout.to_ext(i) for i in range(14)] + \
                    [".ecx", ".vif"]:
                assert (pdir / f"{vid}{ext}").read_bytes() == \
                    (rdir / f"{vid}{ext}").read_bytes(), (vid, ext)
            assert port.store.get_volume(vid).read_only
        assert port._ec_jobs[3] is port._ec_jobs[5]
        assert port._ec_jobs[3]["state"] == "done"
        assert port._ec_jobs[3]["bytes_done"] == port._ec_jobs[3]["total"]
        assert call(port, {"volumes": [77]})[0] == 404
    finally:
        port.store.close()
        ref.store.close()


def test_fleet_handler_books_its_own_seconds(tmp_path):
    """A committed run books the handler's seconds outside the stream
    under its stages' `server`: the parts are in order and add up to no
    more than the handler's whole, and the stream's `wall_s` lies inside
    `convert_s`."""
    _needle_volumes(tmp_path, (3, 4), seed=13)
    vs = vsmod.VolumeServer([str(tmp_path)], "127.0.0.1:1", "127.0.0.1",
                            free_port(), device="cpu")
    vs._heartbeat_once = _no_beat

    async def _json():
        return {"volumes": [3, 4]}

    try:
        resp = asyncio.run(vs.handle_ec_fleet_convert(
            types.SimpleNamespace(json=_json)))
        assert resp.status == 200
        stages = vs._ec_jobs[3]["stages"]
        server = stages["server"]
        assert sorted(server) == ["beat_s", "convert_s", "ecx_s",
                                  "flush_s", "handler_s"]
        assert all(v >= 0 for v in server.values())
        assert server["convert_s"] >= stages["wall_s"]
        assert server["handler_s"] >= sum(
            server[k] for k in ("flush_s", "convert_s", "ecx_s", "beat_s"))
    finally:
        vs.store.close()


# ---- through the reference master ---------------------------------------

@pytest.fixture(scope="module")
def node(tmp_path_factory):
    """The reference master and one port volume server in process."""
    h = Harness(tmp_path_factory.mktemp("fleet_node"), n=1)
    yield h
    h.stop()


@pytest.fixture(scope="module")
def port_node(tmp_path_factory):
    """The port's master (its repair loop off) and one port volume server
    in process."""
    mp = pytest.MonkeyPatch()
    mp.setenv("WEEDTPU_REPAIR_INTERVAL", "0")
    h = Harness(tmp_path_factory.mktemp("fleet_port_node"), n=1,
                master="port")
    mp.undo()
    yield h
    h.stop()


def _node(request, master):
    return request.getfixturevalue("node" if master == "reference"
                                   else "port_node")


def _upload(h, n, seed, collection):
    from seaweedfs_tpu.client import WeedClient
    client = WeedClient(h.master.url)
    rng = np.random.default_rng(seed)
    blobs = {}
    for i in range(n):
        data = rng.integers(0, 256, int(rng.integers(5_000, 40_000)),
                            dtype=np.uint8).tobytes()
        blobs[client.upload(data, name=f"f{i}.bin",
                            collection=collection)] = data
    return client, blobs


async def _enqueue_and_tick(master, vids):
    accepted = master.convert.enqueue(vids)
    actions = await master.convert.tick()
    return {"accepted": accepted, "actions": actions}


@pytest.mark.parametrize("master", ["reference", "port"])
def test_cluster_fleet_convert_end_to_end(request, master):
    """Twin of tests/test_fleet_convert.py::test_cluster_fleet_convert_
    end_to_end: the master's conversion scheduler (the reference's or
    the port's) paces a /admin/ec/fleet_convert batch to the port node;
    whole shard sets commit with .ecx and .vif, the orchestration hop
    books as class convert, and every blob reads back."""
    node = _node(request, master)
    flow = ref_netflow if master == "reference" else netflow
    client, blobs = _upload(node, 12, seed=0xFEE7, collection="fleet")
    vs = node.vs[0]
    vids = sorted({int(f.partition(",")[0]) for f in blobs})
    for v in vids:
        vs.store.get_volume(v).nm.flush()
    recv0 = flow.class_total("recv", "convert")
    res = node.submit(asyncio.wait_for(_enqueue_and_tick(node.master, vids),
                                       60))
    assert res["accepted"] == vids
    assert all(a["outcome"] == "ok" for a in res["actions"]), res
    for v in vids:
        base = vs.store.get_volume(v)._base
        assert sorted(_shard_bytes(base)) == list(range(14)), v
        assert os.path.exists(base + ".ecx")
        assert ec_files.read_vif(base) is not None
        assert vs.store.get_volume(v).read_only
    assert flow.class_total("recv", "convert") > recv0
    for fid, data in blobs.items():
        assert client.download(fid) == data


@pytest.mark.parametrize("master", ["reference", "port"])
def test_fleet_convert_partial_failure_settles_freeze(request, master,
                                                      monkeypatch):
    """Twin of tests/test_fleet_convert.py::test_fleet_convert_partial_
    failure_settles_freeze, under either master: a run that dies after
    its first volume committed keeps that volume frozen with its .ecx
    and thaws the rolled-back one."""
    node = _node(request, master)
    _, first = _upload(node, 6, seed=11, collection="freeze1")
    _, second = _upload(node, 3, seed=12, collection="freeze2")
    vs = node.vs[0]
    vids = sorted({int(f.partition(",")[0]) for f in (*first, *second)})
    assert len(vids) >= 2
    for v in vids:
        vs.store.get_volume(v).nm.flush()
    real = fleet_convert.convert_volumes

    def first_commits_then_dies(bases, **kw):
        real(bases[:1], **kw)
        raise RuntimeError("disk died after the first commit")

    monkeypatch.setattr(fleet_convert, "convert_volumes",
                        first_commits_then_dies)
    req = urllib.request.Request(
        f"http://{vs.url}/admin/ec/fleet_convert",
        data=json.dumps({"volumes": vids}).encode(),
        headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=60)
    assert ei.value.code == 500
    committed, rest = vids[0], vids[1:]
    v0 = vs.store.get_volume(committed)
    assert v0.read_only
    assert sorted(_shard_bytes(v0._base)) == list(range(14))
    assert os.path.exists(v0._base + ".ecx")
    for vid in rest:
        v = vs.store.get_volume(vid)
        assert not v.read_only
        assert _shard_bytes(v._base) == {}
    assert vs._ec_jobs[committed]["state"] == "failed"


def test_fleet_cancel_through_any_volume(node, monkeypatch):
    """/admin/ec/cancel on any volume of a running conversion aborts it:
    409, nothing committed, every volume thawed."""
    _, blobs = _upload(node, 8, seed=13, collection="cancel")
    vs = node.vs[0]
    vids = sorted({int(f.partition(",")[0]) for f in blobs})
    for v in vids:
        vs.store.get_volume(v).nm.flush()
    real = fleet_convert.convert_volumes

    def slow_start(bases, **kw):
        cancel = kw["cancel"]
        for _ in range(500):  # until /admin/ec/cancel lands
            if cancel():
                break
            time.sleep(0.01)
        return real(bases, **kw)

    monkeypatch.setattr(fleet_convert, "convert_volumes", slow_start)
    out = {}

    def convert():
        out["r"] = node.call(0, "/admin/ec/fleet_convert",
                             {"volumes": vids})

    th = threading.Thread(target=convert)
    th.start()
    for _ in range(500):
        st, prog = node.json(0, f"/admin/ec/progress?volumeId={vids[-1]}")
        if st == 200 and prog["state"] == "running":
            break
        time.sleep(0.01)
    assert prog["kind"] == "fleet_convert" and prog["volumes"] == vids
    assert node.json(0, "/admin/ec/cancel", {"volume": vids[-1]}) == \
        (200, {"ok": True})
    th.join(60)
    assert out["r"][0] == 409
    for vid in vids:
        v = vs.store.get_volume(vid)
        assert not v.read_only and _shard_bytes(v._base) == {}
