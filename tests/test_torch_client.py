"""The port's blob client and its vid cache (`seaweedfs_tpu_torch/client.py`,
`utils/vid_cache.py`) held against the reference's.

The cache and resolver tests are twins of tests/test_serving_plane.py's
`TestVidCache` and `TestSyncResolver`, run on the port's classes.  The
streamed-map twin of tests/test_cluster.py is
tests/test_torch_master_cluster.py's `test_streamed_vid_map_invalidation`
with `driver="port"`.  Then the clients of the two packages read what the
other wrote on one port cluster, and the stream thread ends with the
client and its master.

The knobs are a kept difference (ROADMAP §3): a malformed
WEEDTPU_VID_CACHE_TTL or WEEDTPU_VID_NEG_TTL raises in the port, where
the reference falls back to the default.
"""

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from seaweedfs_tpu.client import WeedClient as RefClient
from seaweedfs_tpu.utils import vid_cache as ref_vid_cache

from seaweedfs_tpu_torch.client import WeedClient
from seaweedfs_tpu_torch.utils.vid_cache import SyncVidResolver, VidCache
from tests.test_torch_master_cluster import Cluster


@pytest.fixture(autouse=True)
def _quiet_cluster(monkeypatch):
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "0")
    monkeypatch.setenv("WEEDTPU_REPAIR_INTERVAL", "0")


# ---- twins of TestVidCache ---------------------------------------------------

class TestVidCache:
    def test_ttl_and_expiry(self):
        c = VidCache(ttl=0.05)
        c.put(7, ["127.0.0.1:1"])
        assert c.fresh(7) == ["127.0.0.1:1"]
        time.sleep(0.08)
        assert c.fresh(7) is None  # expired, not invalidated
        assert c.misses >= 1

    def test_negative_window(self):
        c = VidCache(ttl=10.0, negative_ttl=0.05)
        c.put_negative(9)
        assert c.negative(9)
        time.sleep(0.08)
        assert not c.negative(9)
        # a positive sighting clears the negative mark immediately
        c.put_negative(9)
        c.put(9, ["a:1"])
        assert not c.negative(9) and c.fresh(9) == ["a:1"]

    def test_invalidate_once_semantics(self):
        c = VidCache(ttl=10.0)
        c.put(3, ["a:1"])
        assert c.invalidate(3) is True   # dropped a live route: retry
        assert c.invalidate(3) is False  # nothing left: do NOT retry
        assert c.invalidations == 1

    def test_dict_facade(self):
        c = VidCache(ttl=10.0)
        c[5] = (["a:1", "b:2"], time.time())
        assert 5 in c and len(c) == 1
        urls, ts = c[5]
        assert urls == ["a:1", "b:2"] and ts > 0
        c.pop(5)
        assert 5 not in c
        c[6] = (["x:1"], time.time())
        c.clear()
        assert len(c) == 0


def test_stats_equal_the_reference_after_one_sequence():
    """The same puts, lookups, negatives and invalidations leave both
    caches with the same counters and the same map."""
    caches = [VidCache(ttl=10.0, negative_ttl=5.0),
              ref_vid_cache.VidCache(ttl=10.0, negative_ttl=5.0)]
    for c in caches:
        c.put(1, ["a:1"])
        c.put(2, ["b:2", "c:3"])
        c.fresh(1)
        c.fresh(3)
        c.put_negative(4)
        c.negative(4)
        c.negative(5)
        c.invalidate(2)
        c.invalidate(2)
    port, ref = (c.stats() for c in caches)
    assert port == ref
    assert dict(caches[0].items()).keys() == dict(caches[1].items()).keys()


@pytest.mark.parametrize("name", ["WEEDTPU_VID_CACHE_TTL",
                                  "WEEDTPU_VID_NEG_TTL"])
def test_malformed_knob_raises_where_the_reference_falls_back(monkeypatch,
                                                              name):
    monkeypatch.setenv(name, "ten")
    with pytest.raises(ValueError, match=name):
        VidCache()
    ref = ref_vid_cache.VidCache()
    assert (ref.ttl, ref.negative_ttl) == (ref_vid_cache.DEFAULT_TTL,
                                           ref_vid_cache.DEFAULT_NEG_TTL)
    monkeypatch.setenv(name, "2.5")
    c = VidCache()
    assert (c.ttl if name.endswith("CACHE_TTL") else c.negative_ttl) == 2.5


# ---- twins of TestSyncResolver -----------------------------------------------

class TestSyncResolver:
    def test_collapses_concurrent_lookups(self):
        gate = threading.Event()
        calls = []

        def fetch(vid):
            calls.append(vid)
            gate.wait(5.0)
            return ["127.0.0.1:9"]

        r = SyncVidResolver(VidCache(ttl=10.0), fetch)
        with ThreadPoolExecutor(8) as ex:
            futs = [ex.submit(r.lookup, 4) for _ in range(8)]
            time.sleep(0.2)
            gate.set()
            results = [f.result(10) for f in futs]
        assert all(res == ["127.0.0.1:9"] for res in results)
        assert len(calls) == 1 and r.upstream_lookups == 1
        assert r.joined == 7

    def test_negative_caching_absorbs_repeats(self):
        calls = []

        def fetch(vid):
            calls.append(vid)
            return []

        r = SyncVidResolver(VidCache(ttl=10.0, negative_ttl=5.0), fetch)
        assert r.lookup(404) == []
        assert r.lookup(404) == []
        assert len(calls) == 1  # second miss served from the neg cache

    def test_errors_propagate_and_are_not_cached(self):
        calls = []

        def fetch(vid):
            calls.append(vid)
            raise RuntimeError("master down")

        r = SyncVidResolver(VidCache(ttl=10.0), fetch)
        with pytest.raises(RuntimeError):
            r.lookup(1)
        with pytest.raises(RuntimeError):
            r.lookup(1)
        assert len(calls) == 2  # a failure never poisons the cache


# ---- the client on a port cluster --------------------------------------------

def test_each_client_reads_what_the_other_wrote(tmp_path):
    """On one port cluster the port's `WeedClient` reads back, byte for
    byte, what the reference's wrote, and the other way round; each
    deletes what the other wrote."""
    c = Cluster(tmp_path, n_volume_servers=2).start()
    try:
        c.wait_heartbeats()
        port, ref = WeedClient(c.master.url), RefClient(c.master.url)
        rng = np.random.default_rng(20)
        written = {}
        for i in range(24):
            writer = (port, ref)[i % 2]
            data = rng.integers(0, 256, int(rng.integers(1, 60_000)),
                                dtype=np.uint8).tobytes()
            fid = writer.upload(data, name=f"x{i}.bin", collection="xc")
            written[fid] = (writer, data)
        for fid, (writer, data) in written.items():
            reader = ref if writer is port else port
            assert reader.download(fid) == data, fid
            assert reader.lookup(int(fid.split(",")[0])) == \
                writer.lookup(int(fid.split(",")[0]))
        for fid, (writer, _) in list(written.items())[:6]:
            (ref if writer is port else port).delete(fid)
            with pytest.raises(RuntimeError):
                writer.download(fid)
        assert port.assign(count=3)["count"] == 3
        with pytest.raises(RuntimeError):
            port.download("9999,01deadbeef")
        assert port._resolver.upstream_lookups >= 1
        port.close()
        ref.close()
    finally:
        c.stop()


def test_stream_thread_ends_with_the_client_and_its_master(tmp_path):
    """`close()` and the master's stop end the `/cluster/stream` thread:
    the master ends the response when it stops, so the thread, blocked
    reading it, returns at once instead of at its 60 s timeout."""
    c = Cluster(tmp_path, n_volume_servers=1).start()
    stopped = False
    try:
        c.wait_heartbeats()
        before = set(threading.enumerate())
        client = WeedClient(c.master.url, stream_updates=True)
        ours = [t for t in threading.enumerate()
                if t not in before and t.name == "weed-vidmap-stream"]
        assert len(ours) == 1
        fid = client.upload(b"streamed")
        vid = int(fid.split(",")[0])
        deadline = time.time() + 8
        while time.time() < deadline and vid not in client._vid_cache:
            time.sleep(0.05)
        assert client._stream_live and vid in client._vid_cache
        client.close()
        c.stop()
        stopped = True
        ours[0].join(5)
        assert not ours[0].is_alive()
        assert not client._stream_live
    finally:
        if not stopped:
            c.stop()
