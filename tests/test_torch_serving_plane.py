"""The serving plane of the port's filer server: the shared vid cache on
the read path and the cluster hot tier, on a port cluster (the port's
master, two port volume servers with `device="cpu"`, two port
`FilerServer`s over one shared SQLite store), twins of
tests/test_serving_plane.py's filer tests:

- steady-state reads issue no master /dir/lookup;
- under concurrent reads through both filers, each chunk is fetched from
  the volume tier once, cluster-wide (`direct` summed);
- /__hot__/status and the master's `hot_tier` rollup (`collect_hot_tier`
  and /cluster/perf);
- membership churn: a third filer joins and leaves without a stale-home
  404;
- the autopilot's chunk policy plans a promote and seeds the chunk's
  home filer through its /__hot__/seed.
"""

import json
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import pytest

from seaweedfs_tpu_torch.client import WeedClient
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.stats import metrics
from seaweedfs_tpu_torch.utils.hashring import RendezvousRing
from tests.test_torch_master_cluster import Cluster, free_port


def req(url, method="GET", data=None, headers=None):
    r = urllib.request.Request(url, data=data, method=method,
                               headers=headers or {})
    try:
        with urllib.request.urlopen(r, timeout=30) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


@pytest.fixture(scope="module")
def plane(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("plane")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WEEDTPU_SCRUB_MBPS", "0")
        mp.setenv("WEEDTPU_REPAIR_INTERVAL", "0")
        c = Cluster(tmp, n_volume_servers=2).start()
        c.wait_heartbeats()
        filers = []
        for _ in range(2):
            # both gateways share one metadata store (one SQLite file):
            # one namespace, two chunk caches
            f = FilerServer(c.master.url, port=free_port(),
                            data_dir=str(tmp / "fshared"), chunk_size=8192)
            f._test_data_dir = str(tmp / "fshared")
            c.submit(f.start())
            filers.append(f)
        _sync_rings(c, filers)
        yield c, filers
        for f in filers:
            c.submit(f.stop())
        c.stop()


def _sync_rings(c, filers, expect=None):
    """The ring refresh that rides the register beat, now, once `expect`
    (default: all of `filers`) registrations have landed."""
    want = len(filers) if expect is None else expect
    deadline = time.time() + 10.0
    while time.time() < deadline:
        fresh = time.time() - 30.0
        live = [a for a, ts in
                c.master.cluster_members.get("filer", {}).items()
                if ts > fresh]
        if len(live) >= want:
            break
        time.sleep(0.05)
    for f in filers:
        c.submit(f._refresh_hot_ring())


def _hot_delta(before, after):
    return {k: after[k] - before[k] for k in after}


class _PinnedRing(RendezvousRing):
    """The ring of the same members with every key homed on `pinned`: a
    layout that the address-keyed ring gives only now and then (the
    filers' addresses come from free_port())."""

    def __init__(self, members, pinned: str):
        super().__init__(members)
        self.pinned = pinned

    def home(self, key: str) -> str:
        return self.pinned


@pytest.mark.parametrize("layout", ["ring", "f1", "f2"])
def test_filer_steady_state_reads_skip_master(plane, layout):
    """Ten steady reads through f1 touch neither the master nor the
    volume tier, wherever the chunks' homes fall: "ring" as the
    rendezvous ring places them, "f1"/"f2" with every home pinned on
    that filer.  The reads are served from a cache in the cluster: f1's
    own (hit_local) for chunks homed on f1, the home's through a route
    (f1's route_out, the home's hit_local) for the others."""
    c, (f1, f2) = plane
    rings = (f1.hot_ring, f2.hot_ring)
    if layout != "ring":
        home = {"f1": f1, "f2": f2}[layout].url
        f1.hot_ring = _PinnedRing(rings[0].members, home)
        f2.hot_ring = _PinnedRing(rings[1].members, home)
    try:
        base = f"http://{f1.url}"
        body = bytes(range(256)) * 128  # 32 KiB: 4 chunks of 8 KiB
        n_chunks = 4
        path = f"{base}/steady/{layout}.bin"
        st, _, _ = req(path, method="PUT", data=body)
        assert st == 201
        st, got, _ = req(path)
        assert st == 200 and got == body
        master_before = metrics.MASTER_LOOKUPS.labels().value
        resolver_before = [f._vid_resolver.upstream_lookups
                           for f in (f1, f2)]
        hits_before = [f.vid_cache.hits for f in (f1, f2)]
        before = [dict(f1.hot_stats), dict(f2.hot_stats)]
        for _ in range(10):
            st, got, _ = req(path)
            assert st == 200 and got == body
        d1 = _hot_delta(before[0], f1.hot_stats)
        d2 = _hot_delta(before[1], f2.hot_stats)
        assert metrics.MASTER_LOOKUPS.labels().value == master_before
        assert [f._vid_resolver.upstream_lookups
                for f in (f1, f2)] == resolver_before
        assert d1["direct"] == 0 and d2["direct"] == 0, (d1, d2)
        assert d1["hit_local"] + d1["route_out"] == 10 * n_chunks, d1
        assert d1["route_fail"] == 0, d1
        assert d2["route_in"] == d1["route_out"], (d1, d2)
        cache_hits = sum(f.vid_cache.hits - h
                         for f, h in zip((f1, f2), hits_before))
        assert cache_hits + d1["hit_local"] + d2["hit_local"] > 0
        if layout == "f1":
            assert d1["hit_local"] == 10 * n_chunks and d1["route_out"] == 0
        elif layout == "f2":
            assert d1["route_out"] == 10 * n_chunks, d1
            assert d2["hit_local"] == 10 * n_chunks, d2
    finally:
        f1.hot_ring, f2.hot_ring = rings


def test_concurrent_multi_filer_load(plane):
    c, (f1, f2) = plane
    assert len(f1.hot_ring) >= 2 and len(f2.hot_ring) >= 2
    body = bytes((i * 7) & 0xFF for i in range(128 * 1024))  # 16 chunks
    st, _, _ = req(f"http://{f1.url}/hot/one.bin", method="PUT", data=body)
    assert st == 201
    before = [dict(f1.hot_stats), dict(f2.hot_stats)]
    urls = [f"http://{f1.url}/hot/one.bin", f"http://{f2.url}/hot/one.bin"]
    with ThreadPoolExecutor(16) as ex:
        futs = [ex.submit(req, urls[i % 2]) for i in range(16)]
        results = [f.result(60) for f in futs]
    for st, got, _ in results:
        assert st == 200 and got == body
    d1 = _hot_delta(before[0], f1.hot_stats)
    d2 = _hot_delta(before[1], f2.hot_stats)
    # 16 concurrent reads of 16 distinct chunks through two filers: 16
    # volume-tier fetches cluster-wide
    assert d1["direct"] + d2["direct"] == 16, (d1, d2)
    assert d1["route_in"] + d2["route_in"] > 0
    assert d1["route_out"] + d2["route_out"] > 0
    assert d1["route_fail"] == 0 and d2["route_fail"] == 0


def test_hot_status_and_master_rollup(plane):
    c, (f1, f2) = plane
    st, raw, _ = req(f"http://{f1.url}/__hot__/status")
    assert st == 200
    s = json.loads(raw)
    assert s["enabled"] and s["ring"] and s["ring_version"] >= 1
    assert "vid_cache" in s and "events" in s
    hot = c.master.collect_hot_tier()
    assert len(hot.get("nodes") or []) == 2
    assert hot["events"]["direct"] > 0
    assert hot.get("hit_ratio") is not None
    # /cluster/perf carries the same block, its ratio from its events
    st, raw, _ = req(f"http://{c.master.url}/cluster/perf")
    assert st == 200
    block = json.loads(raw)["hot_tier"]
    ev = block["events"]
    assert ev == {k: f1.hot_stats[k] + f2.hot_stats[k] for k in ev}
    hits = ev["hit_local"] + ev["route_out"]
    assert block["hit_ratio"] == round(hits / (hits + ev["direct"]), 4)


def test_join_and_leave_rebuild_ring_without_stale_404s(plane):
    c, (f1, f2) = plane
    body = bytes((i * 13) & 0xFF for i in range(96 * 1024))
    st, _, _ = req(f"http://{f1.url}/churn/mid.bin", method="PUT", data=body)
    assert st == 201
    v_before = f1.hot_ring.version

    # join: a third filer re-homes about a third of the key space
    f3 = FilerServer(c.master.url, port=free_port(),
                     data_dir=f1._test_data_dir, chunk_size=8192)
    c.submit(f3.start())
    _sync_rings(c, [f1, f2, f3])
    assert f1.hot_ring.version > v_before
    assert len(f1.hot_ring) == 3 == len(f3.hot_ring)
    for f in (f1, f2, f3):
        st, got, _ = req(f"http://{f.url}/churn/mid.bin")
        assert st == 200 and got == body

    # leave: f3 stops but lingers in the membership; routes to the dead
    # home degrade to direct fetches, never 404s
    c.submit(f3.stop())
    for f in (f1, f2):
        st, got, _ = req(f"http://{f.url}/churn/mid.bin")
        assert st == 200 and got == body

    # expiry: the rings shrink and every read is ring-internal again
    c.master.cluster_members.get("filer", {}).pop(f3.url, None)
    _sync_rings(c, [f1, f2])
    assert len(f1.hot_ring) == 2 == len(f2.hot_ring)
    assert f3.url not in f1.hot_ring._members
    fails_before = f1.hot_stats["route_fail"] + f2.hot_stats["route_fail"]
    for f in (f1, f2):
        st, got, _ = req(f"http://{f.url}/churn/mid.bin")
        assert st == 200 and got == body
    assert f1.hot_stats["route_fail"] + f2.hot_stats["route_fail"] \
        == fails_before


def test_plan_and_execute_seeds_home_filer(plane, monkeypatch):
    """The autopilot's chunk policy, through the port's master, plans a
    promote of a sustained-hot chunk to its home filer and executes it
    there with /__hot__/seed; an immediate second tick plans nothing
    (per-fid cooldown)."""
    c, (f1, f2) = plane
    client = WeedClient(c.master.url)
    fid = client.upload(b"promote me " * 512)
    client.close()
    ring = RendezvousRing([f1.url, f2.url])
    home = f1 if ring.home(fid) == f1.url else f2
    assert home.chunk_cache.get(fid) is None

    view = {"chunks": {"total_rps": 9.0, "top": [
        {"key": fid, "rps": 9.0, "sustained_s": 120.0,
         "bytes_rate": 1e6, "reads": 900, "writes": 0}]}}
    monkeypatch.setattr(c.master, "cached_heat", lambda: view)
    monkeypatch.setenv("WEEDTPU_AUTOPILOT", "execute")
    ap = c.master.autopilot
    made = c.submit(ap.tick())
    plans = [p for p in made if p["policy"] == "chunk_promote"]
    assert len(plans) == 1
    assert plans[0]["node"] == home.url
    assert fid in plans[0]["fids"]
    c.submit(ap.wait_idle())
    done = ap.plans[plans[0]["id"]]
    assert done["state"] == "done", done
    assert done["outcome"]["seeded"] == 1
    assert home.chunk_cache.get(fid) is not None
    assert home.hot_stats["seeded"] >= 1

    made2 = c.submit(ap.tick())
    assert not [p for p in made2 if p["policy"] == "chunk_promote"]
