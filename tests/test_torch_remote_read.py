"""The PyTorch/CUDA port's EC read engine with remote shards, held against
the JAX package: remote shard fetches through a `shard_reader`, survivors
gathered from peers (the codec's basis first: an LRC local group on a
peer), hedging against a slow peer and the rescue of its abandoned
fetches, the reconstruction LRU, quarantine, `skip_shards`, the serial
baseline, concurrent reads of one volume, and the trace, class and
deadline headers the pooled client carries to a peer (plain and TLS).

Both packages read the same shard files with the same reader: the port
on the CPU (`device="cpu"`, the plain version of the kernel), the
reference with its numpy codec.  Peers are in-process readers over a
second directory, or a standard-library loopback server.  Comparisons
are exact: bytes, `read_stats_snapshot()` and the hedge counters.
"""

import os
import re
import shutil
import ssl
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from seaweedfs_tpu.stats import metrics as ref_metrics
from seaweedfs_tpu.stats import netflow as ref_netflow
from seaweedfs_tpu.stats import trace as ref_trace
from seaweedfs_tpu.storage.ec import ec_volume as ref_ecv
from seaweedfs_tpu.utils import http as ref_http
from seaweedfs_tpu.utils import resilience as ref_res

from seaweedfs_tpu_torch.maintenance import scrub
from seaweedfs_tpu_torch.ops import codecs
from seaweedfs_tpu_torch.security import tls
from seaweedfs_tpu_torch.stats import metrics, netflow, trace
from seaweedfs_tpu_torch.storage import needle, types
from seaweedfs_tpu_torch.storage.ec import ec_files, ec_volume, layout
from seaweedfs_tpu_torch.storage.volume import Volume
from seaweedfs_tpu_torch.utils import http, resilience

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKS = {"rs_10_4": (10000, 100), "lrc_10_2_2": (10000, 100),
          "msr_9_16": (8000, 400)}


@pytest.fixture(scope="module")
def volumes(tmp_path_factory):
    """volumes(tag) -> (base, {needle_id: data}): one volume of 40
    needles (1..7000 B), encoded by the port under `tag` with every shard
    present; made once per tag."""
    made: dict = {}

    def make(tag):
        if tag not in made:
            root = tmp_path_factory.mktemp(tag)
            v = Volume(str(root), "", 3)
            rng = np.random.default_rng(5)
            blobs = {}
            for i in range(1, 41):
                data = rng.bytes(int(rng.integers(1, 7000)))
                v.append_needle(needle.Needle(cookie=9, id=i, data=data))
                blobs[i] = data
            v.close()
            base = str(root / "3")
            large, small = BLOCKS[tag]
            ec_files.write_ec_files(base, large_block=large,
                                    small_block=small, batch_size=small * 10,
                                    codec_tag=tag, device="cpu")
            ec_files.write_sorted_ecx(base + ".idx")
            made[tag] = (base, blobs)
        return made[tag]
    return make


@pytest.fixture(autouse=True)
def _fresh_state():
    for res in (resilience, ref_res):
        res.reset_breakers()
        res.reset_latency_trackers()
    yield
    for res in (resilience, ref_res):
        res.reset_breakers()
        res.reset_latency_trackers()


@pytest.fixture
def ref_codec(monkeypatch):
    """Run `fn` with the reference's numpy codec selected, only around
    the reference's calls (the port raises on the reference's kinds)."""
    def run(fn, *a, **kw):
        with monkeypatch.context() as mp:
            mp.setenv("WEEDTPU_EC_CODEC", "numpy")
            return fn(*a, **kw)
    return run


def _node(base, dst, keep) -> str:
    """A node's directory: copies of the shards in `keep`, the .ecx and
    the .vif.  Returns its base path."""
    os.makedirs(dst, exist_ok=True)
    out = os.path.join(dst, os.path.basename(base))
    n = codecs.parse_tag(ec_files.read_vif(base).get("codec")).n
    for ext in [layout.to_ext(i) for i in range(n) if i in keep] + \
            [".ecx", ".vif"]:
        shutil.copy(base + ext, out + ext)
    return out


class PeerReader:
    """An in-process peer: preads shard ranges from the source volume for
    the shards it holds (None for any other), `delay` seconds late on the
    shards in `slow`."""

    def __init__(self, base, holds, slow=(), delay=0.0):
        self.base = base
        self.holds = set(holds)
        self.slow = set(slow)
        self.delay = delay
        self.asked: list[int] = []

    def __call__(self, sid, off, size):
        self.asked.append(sid)
        if sid not in self.holds:
            return None
        if sid in self.slow:
            time.sleep(self.delay)
        with open(self.base + layout.to_ext(sid), "rb") as f:
            return os.pread(f.fileno(), size, off)


def _plan(ev, nid) -> list[int]:
    """The shard of each interval of a needle's read plan."""
    off, size = ev.find_needle(nid)
    return [iv.to_shard_id_and_offset(ev.large_block, ev.small_block)[0]
            for iv in layout.locate_data(ev.large_block, ev.small_block,
                                         ev.dat_size, off,
                                         types.actual_size(size, ev.version),
                                         data_shards=ev.spec.k)]


def _touches(ev, nid) -> set[int]:
    return set(_plan(ev, nid))


def _open_both(base, ref_codec):
    large, small = BLOCKS[codecs.parse_tag(
        ec_files.read_vif(base).get("codec")).tag]
    return (ec_volume.EcVolume(base, large, small, device="cpu"),
            ref_codec(ref_ecv.EcVolume, base, large, small))


def _hedges(met) -> dict:
    return {o: met.HEDGE_TOTAL.labels(o).value
            for o in ("fired", "hedge_won", "primary_rescued")}


# ---- twins of tests/test_read_engine.py's EC tests ----------------------

@pytest.mark.parametrize("codec", ["cpu", "native"])
def test_degraded_read_byte_identity(volumes, tmp_path, monkeypatch,
                                     ref_codec, codec):
    """Degraded reads through the batched engine return the healthy bytes
    on the port's plain codec and on its native host codec, with the
    reference's counters."""
    base, blobs = volumes("rs_10_4")
    node = _node(base, str(tmp_path / "n"), set(range(14)) - {2, 5, 11})
    with monkeypatch.context() as mp:
        if codec == "native":
            mp.setenv("WEEDTPU_EC_CODEC", "native")
        ev = ec_volume.EcVolume(node, *BLOCKS["rs_10_4"], device="cpu")
    ref = ref_codec(ref_ecv.EcVolume, node, *BLOCKS["rs_10_4"])
    try:
        for nid, data in blobs.items():
            assert ev.read_needle(nid).data == data, nid
            assert ref_codec(ref.read_needle, nid).data == data, nid
        stats = ev.read_stats_snapshot()
        assert stats["reconstruct_batches"] >= 1
        assert stats["reconstruct_intervals"] >= stats["reconstruct_batches"]
        assert stats == ref.read_stats_snapshot()
    finally:
        ev.close()
        ref.close()


def test_degraded_serial_and_batched_agree(volumes, tmp_path, monkeypatch):
    """The serial per-interval baseline and the batched engine are two
    paths over the same shards: byte-identical results; the knob picks
    the serial one too."""
    base, blobs = volumes("rs_10_4")
    node = _node(base, str(tmp_path / "n"), set(range(14)) - {0, 7})
    ev = ec_volume.EcVolume(node, *BLOCKS["rs_10_4"], device="cpu")
    try:
        for nid, data in blobs.items():
            assert ev.read_needle(nid, mode="serial").data == data
            assert ev.read_needle(nid, mode="batched").data == data
        batches = ev.read_stats_snapshot()["reconstruct_batches"]
        monkeypatch.setenv("WEEDTPU_EC_READ", "serial")
        nid = max(blobs, key=lambda i: len(blobs[i]))
        assert ev.read_needle(nid).data == blobs[nid]
        # serial: one batch per interval on a lost shard, never cached
        assert ev.read_stats_snapshot()["reconstruct_batches"] - batches \
            == sum(1 for s in _plan(ev, nid) if s in (0, 7))
    finally:
        ev.close()


@pytest.mark.parametrize("remote", [False, True])
def test_concurrent_degraded_reads_one_volume(volumes, tmp_path,
                                              monkeypatch, remote):
    """Eight threads hammer one EcVolume under a short switch interval,
    with shard 1 on a peer or lost: every read is right, and with the LRU
    off the counters are exactly eight times one thread's (a lost update
    under the lock would show)."""
    monkeypatch.setattr(ec_volume, "RECONSTRUCT_CACHE_BYTES", 0)
    monkeypatch.setenv("WEEDTPU_HEDGE_PCT", "0")
    base, blobs = volumes("rs_10_4")
    node = _node(base, str(tmp_path / "n"), set(range(14)) - {1, 8})
    reader = PeerReader(base, {1}) if remote else None
    ev = ec_volume.EcVolume(node, *BLOCKS["rs_10_4"], device="cpu")
    errors: list = []

    def worker(seed: int) -> None:
        ids = list(blobs)
        np.random.default_rng(seed).shuffle(ids)
        try:
            for nid in ids:
                if ev.read_needle(nid, reader).data != blobs[nid]:
                    raise AssertionError(f"bytes mismatch for {nid}")
        except Exception as e:  # surfaced after join
            errors.append(e)

    try:
        worker(99)
        one = ev.read_stats_snapshot()
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            threads = [threading.Thread(target=worker, args=(s,))
                       for s in range(8)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
        finally:
            sys.setswitchinterval(old)
        assert not any(th.is_alive() for th in threads)
        assert not errors, errors
        got = ev.read_stats_snapshot()
        assert got == {k: 9 * v for k, v in one.items()}
        assert (got["remote_shard_reads"] > 0) == remote
    finally:
        ev.close()


def test_coalesced_intervals_one_dispatch(tmp_path, monkeypatch):
    """A needle spanning many blocks of a lost shard reconstructs in ONE
    codec dispatch, with adjacent same-shard ranges coalesced; reading it
    again is served from the reconstruction LRU."""
    vol = Volume(str(tmp_path), "", 4)
    big = np.random.default_rng(9).integers(
        0, 256, 6000, dtype=np.uint8).tobytes()
    vol.append_needle(needle.Needle(cookie=0x9, id=1, data=big))
    vol.close()
    base = str(tmp_path / "4")
    ec_files.write_ec_files(base, large_block=10000, small_block=100,
                            batch_size=1000, device="cpu")
    ec_files.write_sorted_ecx(base + ".idx")
    os.remove(base + layout.to_ext(3))
    calls = []
    real = ec_files._reconstruct_batch

    def counting(codec, shards, wanted):
        calls.append(list(wanted))
        return real(codec, shards, wanted)

    monkeypatch.setattr(ec_files, "_reconstruct_batch", counting)
    ev = ec_volume.EcVolume(base, 10000, 100, device="cpu")
    try:
        assert ev.read_needle(1).data == big
        assert calls == [[3]]  # one dispatch for the whole needle
        assert ev.read_stats_snapshot()["intervals_coalesced"] > 0
        assert ev.read_needle(1).data == big
        assert calls == [[3]]
        assert ev.read_stats_snapshot()["reconstruct_cache_hits"] > 0
        ev._recon_cache.clear()  # emptied: the next read reconstructs
        ev._recon_cache_bytes = 0
        assert ev.read_needle(1).data == big
        assert len(calls) == 2
    finally:
        ev.close()


def test_reconstruct_cache_is_bounded(volumes, tmp_path, monkeypatch):
    """The LRU keeps at most RECONSTRUCT_CACHE_BYTES, dropping the least
    recently used ranges first; 0 keeps nothing."""
    base, blobs = volumes("rs_10_4")
    node = _node(base, str(tmp_path / "n"), set(range(14)) - {4})
    monkeypatch.setattr(ec_volume, "RECONSTRUCT_CACHE_BYTES", 300)
    ev = ec_volume.EcVolume(node, *BLOCKS["rs_10_4"], device="cpu")
    try:
        for nid, data in blobs.items():
            assert ev.read_needle(nid).data == data
        assert 0 < ev._recon_cache_bytes <= 300
        assert ev._recon_cache_bytes == sum(
            len(v) for v in ev._recon_cache.values())
        monkeypatch.setattr(ec_volume, "RECONSTRUCT_CACHE_BYTES", 0)
        ev._recon_cache.clear()
        ev._recon_cache_bytes = 0
        for nid in list(blobs)[:5]:
            ev.read_needle(nid)
        assert not ev._recon_cache
    finally:
        ev.close()


def test_ec_read_stats_reach_metrics_registry(volumes, tmp_path):
    """An EcVolume's counters mirror into weedtpu_ec_degraded_read, as the
    volume server mirrors them into /metrics."""
    base, blobs = volumes("rs_10_4")
    node = _node(base, str(tmp_path / "n"), set(range(1, 14)))
    ev = ec_volume.EcVolume(node, *BLOCKS["rs_10_4"], device="cpu")
    try:
        for nid in blobs:
            ev.read_needle(nid)
        snap = ev.read_stats_snapshot()
        assert sorted(snap) == [
            "intervals_coalesced", "local_shard_reads",
            "reconstruct_batches", "reconstruct_cache_hits",
            "reconstruct_intervals", "remote_shard_reads"]
        lines = []
        for met in (metrics, ref_metrics):
            for stat, v in snap.items():
                met.EC_DEGRADED_READ.labels(stat).set(v)
            lines.append(sorted(
                line for line in met.REGISTRY.render().splitlines()
                if line.startswith("weedtpu_ec_degraded_read{")))
        assert lines[0] == lines[1]
        assert 'weedtpu_ec_degraded_read{stat="reconstruct_batches"} ' \
            f'{snap["reconstruct_batches"]}' in lines[0]
    finally:
        ev.close()


def test_quarantined_range_served_via_reconstruction(tmp_path, monkeypatch,
                                                     ref_codec):
    """Twin of tests/test_maintenance.py's: corrupt bytes under a
    quarantined range are never served; reads reconstruct the range from
    the other shards and return the original payload, as the
    reference's do, and clearing the shard's quarantine serves the disk
    again."""
    vol = Volume(str(tmp_path), "", 7)
    rng = np.random.default_rng(0)
    payloads = {}
    for i in range(1, 25):
        data = rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
        vol.append_needle(needle.Needle(cookie=0x11, id=i, data=data))
        payloads[i] = data
    vol.close()
    base = str(tmp_path / "7")
    ec_files.write_ec_files(base, large_block=1 << 40, small_block=100,
                            batch_size=1000, device="cpu")
    ec_files.write_sorted_ecx(base + ".idx")
    with open(base + layout.to_ext(2), "r+b") as f:
        f.seek(64)
        f.write(b"\xff" * 128)
    monkeypatch.setattr(scrub, "DEFAULT_WINDOW", 100)
    ev = ec_volume.EcVolume(base, 1 << 40, 100, device="cpu")
    ref = ref_codec(ref_ecv.EcVolume, base, 1 << 40, 100)
    try:
        found = scrub.syndrome_scan(ev)
        assert found and {c["shard"] for c in found} == {2}
        for c in found:
            ev.quarantine_range(c["shard"], c["offset"], c["size"])
            ref.quarantine_range(c["shard"], c["offset"], c["size"])
        assert ev.quarantine_snapshot() == ref.quarantine_snapshot()
        assert ev.quarantine_snapshot()["2"] == [[0, 200]]
        for nid, data in payloads.items():
            assert ev.read_needle(nid).data == data, nid
            assert ref_codec(ref.read_needle, nid).data == data, nid
        stats = ev.read_stats_snapshot()
        assert stats["reconstruct_batches"] > 0
        assert stats == ref.read_stats_snapshot()
        ev.clear_quarantine(2)
        assert ev.quarantine_snapshot() == {}
        assert ev._read_local(2, 64, 128) == b"\xff" * 128
    finally:
        ev.close()
        ref.close()


def test_quarantine_ranges_merge():
    ev = ec_volume.EcVolume.__new__(ec_volume.EcVolume)
    ev._quarantine, ev._quarantine_lock = {}, threading.Lock()
    ref = ref_ecv.EcVolume.__new__(ref_ecv.EcVolume)
    ref._quarantine, ref._quarantine_lock = {}, threading.Lock()
    for v in (ev, ref):
        for sid, off, size in ((3, 100, 50), (3, 0, 10), (3, 140, 60),
                               (3, 10, 5), (4, 7, 1), (3, 400, 1)):
            v.quarantine_range(sid, off, size)
    assert ev.quarantine_snapshot() == ref.quarantine_snapshot() == \
        {"3": [[0, 15], [100, 100], [400, 1]], "4": [[7, 1]]}
    assert ev._is_quarantined(3, 199, 5) and not ev._is_quarantined(3, 200, 5)


# ---- remote reads, both packages ----------------------------------------

# (tag, shards the node holds, shards the peer holds, shards the reader
# must be asked for, or None to leave that unchecked)
TOPOLOGIES = {
    # every needle byte on shards 0-3 comes from the peer
    "rs_remote": ("rs_10_4", set(range(4, 14)), {0, 1, 2, 3}, None),
    # shards 4 and 5 lost: their reconstruction gathers 8 local
    # survivors and 2 from the peer
    "rs_survivors": ("rs_10_4", set(range(6, 14)), {0, 1, 2, 3}, None),
    # shard 2 lost, the rest of its local group (0, 1, 3, 4, 10) on the
    # peer: the basis is read through the reader, never k survivors
    "lrc_group_on_peer": ("lrc_10_2_2", {5, 6, 7, 8, 9, 11, 12, 13},
                          {0, 1, 3, 4, 10}, {0, 1, 2, 3, 4, 10}),
    # file 0 on the peer, file 1 lost: 0 is fetched for the reads on it
    # and as a survivor of 1's alpha-widened decode
    "msr_lost_remote": ("msr_9_16", set(range(2, 18)), {0}, None),
}


@pytest.mark.parametrize("mode", ["batched", "serial"])
@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
def test_remote_reads_equal_reference(volumes, tmp_path, monkeypatch,
                                      ref_codec, topo, mode):
    """The same node, peer and reader under both packages: equal bytes
    and equal counters, with the peer really read (and, where a shard is
    lost everywhere, a reconstruction)."""
    monkeypatch.setenv("WEEDTPU_HEDGE_PCT", "0")  # no timing in the counts
    tag, keep, holds, asked = TOPOLOGIES[topo]
    base, blobs = volumes(tag)
    node = _node(base, str(tmp_path / "n"), keep)
    readers = {"port": PeerReader(base, holds),
               "ref": PeerReader(base, holds)}
    ev, ref = _open_both(node, ref_codec)
    try:
        for nid, data in blobs.items():
            assert ev.read_needle(nid, readers["port"],
                                  mode=mode).data == data, nid
            assert ref_codec(ref.read_needle, nid, readers["ref"],
                             mode).data == data, nid
        stats = ev.read_stats_snapshot()
        assert stats == ref.read_stats_snapshot()
        assert stats["remote_shard_reads"] > 0
        lost = set(range(ev.spec.n)) - keep - holds
        assert (stats["reconstruct_batches"] > 0) == bool(lost)
        if asked is not None:
            assert set(readers["port"].asked) == \
                set(readers["ref"].asked) == asked
    finally:
        ev.close()
        ref.close()


def test_remote_fanout_follows_locality_rank(volumes, tmp_path):
    """A reader exposing `locality_rank` is asked for survivors nearest
    first (one worker at a time here, so the order is the submission
    order)."""
    base, blobs = volumes("rs_10_4")
    node = _node(base, str(tmp_path / "n"), set(range(6, 14)))
    reader = PeerReader(base, {0, 1, 2, 3})
    reader.locality_rank = lambda sid: {3: 0, 2: 1}.get(sid, 5)
    ev = ec_volume.EcVolume(node, *BLOCKS["rs_10_4"], device="cpu")
    seen = []
    orig = ec_volume.ThreadPoolExecutor

    class OneWorker(orig):
        def __init__(self, max_workers=None, **kw):
            super().__init__(max_workers=1, **kw)

    try:
        ec_volume.ThreadPoolExecutor = OneWorker
        ev._gather_survivors({4, 5}, [(0, 100)], reader)
        seen = list(reader.asked)
    finally:
        ec_volume.ThreadPoolExecutor = orig
        ev.close()
    assert seen[:2] == [3, 2], seen


# ---- hedging, both packages ---------------------------------------------

@pytest.mark.parametrize("arm", ["on", "off", "rescue"])
def test_hedging_equals_reference(volumes, tmp_path, monkeypatch, ref_codec,
                                  arm):
    """A peer 0.2 s late on shards 0 and 1.  Hedging on (p99, at most 50
    ms): every read fires the hedge and the reconstruction wins.  Off:
    every read waits for the peer, nothing fires.  Rescue (nobody holds
    11-13, so the hedge's reconstruction finds 9 survivors of 10): the
    abandoned fetches serve the read.  Both packages count alike."""
    base, blobs = volumes("rs_10_4")
    keep = set(range(2, 11)) if arm == "rescue" else set(range(2, 14))
    node = _node(base, str(tmp_path / "n"), keep)
    monkeypatch.setenv("WEEDTPU_HEDGE_PCT", "0" if arm == "off" else "99")
    monkeypatch.setenv("WEEDTPU_HEDGE_MAX_MS", "50")
    ev, ref = _open_both(node, ref_codec)
    nids = [nid for nid in sorted(blobs) if {0, 1} <= _touches(ev, nid)][:4]
    assert len(nids) == 4
    grown, walls = [], []
    try:
        for vol, met, read in (
                (ev, metrics, lambda v, n, r: v.read_needle(n, r)),
                (ref, ref_metrics,
                 lambda v, n, r: ref_codec(v.read_needle, n, r))):
            reader = PeerReader(base, {0, 1}, slow={0, 1}, delay=0.2)
            before = _hedges(met)
            batches = vol.read_stats_snapshot()["reconstruct_batches"]
            t0 = time.perf_counter()
            for nid in nids:
                assert read(vol, nid, reader).data == blobs[nid], nid
            walls.append(time.perf_counter() - t0)
            after = _hedges(met)
            grown.append(({o: after[o] - before[o] for o in after},
                          vol.read_stats_snapshot()["reconstruct_batches"]
                          - batches))
            time.sleep(0.25)  # the abandoned fetches finish
        assert grown[0] == grown[1]
        want = {"on": ({"fired": 4, "hedge_won": 4, "primary_rescued": 0},
                       4),
                "off": ({"fired": 0, "hedge_won": 0, "primary_rescued": 0},
                        0),
                "rescue": ({"fired": 4, "hedge_won": 0,
                            "primary_rescued": 4}, 0)}[arm]
        assert grown[0] == want
        if arm == "off":
            assert min(walls) >= 4 * 0.2
    finally:
        ev.close()
        ref.close()


def test_fetches_past_the_cutoff_do_not_teach_the_tracker(volumes, tmp_path,
                                                          monkeypatch):
    """Only fetches that beat the hedge cutoff feed SHARD_FETCH: a slow
    peer stays slow to it; with hedging off nothing feeds it."""
    base, blobs = volumes("rs_10_4")
    node = _node(base, str(tmp_path / "n"), set(range(2, 14)))
    ev = ec_volume.EcVolume(node, *BLOCKS["rs_10_4"], device="cpu")
    nid = next(n for n in sorted(blobs) if 0 in _touches(ev, n))
    try:
        monkeypatch.setenv("WEEDTPU_HEDGE_PCT", "0")
        ev.read_needle(nid, PeerReader(base, {0, 1}))
        assert len(resilience.SHARD_FETCH) == 0
        monkeypatch.setenv("WEEDTPU_HEDGE_PCT", "99")
        monkeypatch.setenv("WEEDTPU_HEDGE_MAX_MS", "50")
        ev.read_needle(nid, PeerReader(base, {0, 1}, slow={0, 1},
                                       delay=0.2))
        assert len(resilience.SHARD_FETCH) == 0
        ev._recon_cache.clear()
        ev._recon_cache_bytes = 0
        monkeypatch.setenv("WEEDTPU_HEDGE_MIN_MS", "2000")
        monkeypatch.setenv("WEEDTPU_HEDGE_MAX_MS", "2000")
        ev.read_needle(nid, PeerReader(base, {0, 1}))
        assert len(resilience.SHARD_FETCH) > 0
        time.sleep(0.25)
    finally:
        ev.close()


# ---- skip_shards, both packages -----------------------------------------

@pytest.mark.parametrize("tag", sorted(BLOCKS))
def test_skip_shards_equals_reference(volumes, tmp_path, ref_codec, tag):
    """`skip_shards={0}` on a node with every shard: each read touching
    shard 0 reconstructs it, the reader is never asked for it, the bytes
    and counters equal the reference's, and neither volume's own LRU
    grows."""
    base, blobs = volumes(tag)
    n = codecs.parse_tag(tag).n
    node = _node(base, str(tmp_path / "n"), set(range(n)))
    ev, ref = _open_both(node, ref_codec)
    readers = [PeerReader(base, range(n)), PeerReader(base, range(n))]
    try:
        for nid, data in blobs.items():
            assert ev.read_needle(nid, readers[0],
                                  skip_shards={0}).data == data, nid
            assert ref_codec(ref.read_needle, nid, readers[1],
                             skip_shards=frozenset({0})).data == data, nid
        stats = ev.read_stats_snapshot()
        assert stats["reconstruct_batches"] > 0
        assert stats == ref.read_stats_snapshot()
        for vol in (ev, ref):
            assert not vol._recon_cache and vol._recon_cache_bytes == 0
            assert set(vol.shards) == set(range(n))
        assert 0 not in readers[0].asked and 0 not in readers[1].asked
    finally:
        ev.close()
        ref.close()


# ---- headers across packages --------------------------------------------

@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_trace_header_crosses_packages(writer, reader):
    w = trace if writer == "port" else ref_trace
    r = ref_trace if writer == "port" else trace
    assert w.TRACE_HEADER == r.TRACE_HEADER == "X-Weedtpu-Trace"
    for sampled in (True, False):
        t = w.new_root(sampled)
        got = r.parse_header(w.format_header(t))
        assert (got.trace_id, got.span_id, got.sampled) == \
            (t.trace_id, t.span_id, sampled)
    for bad in ("", "x-y-1", "0" * 32 + "-" + "g" * 16 + "-1",
                "0" * 31 + "-" + "0" * 16 + "-1"):
        assert r.parse_header(bad) is None and w.parse_header(bad) is None


@pytest.mark.parametrize("cls,path,role", [
    (None, "/3,0123", None), (None, "/admin/ec/shard_read", "volume"),
    ("repair", "/3,0123", "volume"), ("bogus", "/heat", "client")])
def test_class_header_equals_reference(cls, path, role):
    got = []
    for nf in (netflow, ref_netflow):
        tok = nf.set_class(cls) if cls else None
        try:
            h = nf.inject({}, path, role)
        finally:
            if tok is not None:
                nf.reset(tok)
        got.append((h, nf.extract_class(h, path),
                    nf.extract_class({}, path)))
    assert got[0] == got[1]


class _HeaderServer:
    """A loopback HTTP/1.1 server that answers 200 "ok" and keeps the
    headers of each request."""

    def __init__(self, context=None):
        seen = self.seen = []

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            disable_nagle_algorithm = True  # the body is a write of its own

            def do_GET(self):
                seen.append(dict(self.headers))
                self.send_response(200)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"ok")

            def log_message(self, *a):
                pass

        self.srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        if context is not None:
            self.srv.socket = context.wrap_socket(self.srv.socket,
                                                  server_side=True)
        self.port = self.srv.server_address[1]
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(timeout=10)


def test_pooled_http_headers_equal_reference():
    """Inside a sampled trace, a repair flow and a 2 s budget, each
    package's client sends the same headers: a well-formed trace header
    naming the ambient trace, the class, the caller's role and the
    remaining budget."""
    srv = _HeaderServer()
    got = {}
    try:
        for name, tr, nf, res, hmod in (
                ("port", trace, netflow, resilience, http),
                ("ref", ref_trace, ref_netflow, ref_res, ref_http)):
            pool = hmod.PooledHTTP(timeout=5.0, role="volume")
            root = tr.new_root()
            tok = res.set_deadline(time.monotonic() + 2.0)
            try:
                with tr.span("t.read", parent=root), nf.flow("repair"):
                    st, _, body = pool.request(
                        f"http://127.0.0.1:{srv.port}/admin/ec/shard_read")
                assert (st, body) == (200, b"ok")
                pool.request(f"http://127.0.0.1:{srv.port}/3,01")
            finally:
                res.reset_deadline(tok)
                pool.close()
            got[name] = (root, srv.seen[-2:])
    finally:
        srv.close()
    shapes = []
    for name, (root, (traced, plain)) in got.items():
        hdr = traced["X-Weedtpu-Trace"]
        assert re.fullmatch(r"[0-9a-f]{32}-[0-9a-f]{16}-1", hdr), hdr
        assert hdr.startswith(root.trace_id + "-")
        assert 1500 < int(traced["X-Weedtpu-Deadline"]) <= 2000
        assert "X-Weedtpu-Trace" not in plain
        shapes.append((sorted(k for k in traced if k.startswith("X-")),
                       traced["X-Weedtpu-Class"], traced["X-Weedtpu-Role"],
                       sorted(k for k in plain if k.startswith("X-")),
                       plain["X-Weedtpu-Class"]))
    assert shapes[0] == shapes[1]
    assert shapes[0][1:3] == ("repair", "volume")
    assert shapes[0][4] == "data"


def test_remote_read_through_pooled_http(volumes, tmp_path, monkeypatch):
    """The read engine's reader over a real loopback peer: a
    standard-library server answering /admin/ec/shard_read from its own
    EcVolume's `_read_local` (404 where the shard is not local), fetched
    through the port's PooledHTTP; one slow request is hedged."""
    monkeypatch.setenv("WEEDTPU_HEDGE_PCT", "0")  # no timing in the counts
    base, blobs = volumes("rs_10_4")
    peer = ec_volume.EcVolume(_node(base, str(tmp_path / "p"), {0, 1}),
                              *BLOCKS["rs_10_4"], device="cpu")
    delay = {"s": 0.0}

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        disable_nagle_algorithm = True  # the body is a write of its own

        def do_GET(self):
            q = dict(p.split("=") for p in self.path.split("?")[1].split("&"))
            time.sleep(delay["s"])
            data = peer._read_local(int(q["shard"]), int(q["offset"]),
                                    int(q["size"]))
            self.send_response(200 if data is not None else 404)
            body = data if data is not None else b"not local"
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    pool = http.PooledHTTP(timeout=5.0, role="volume")

    def reader(sid, off, size):
        try:
            st, _, body = pool.request(
                f"http://127.0.0.1:{srv.server_address[1]}/admin/ec/"
                f"shard_read?volume=3&shard={sid}&offset={off}&size={size}")
        except OSError:
            return None
        return body if st == 200 else None

    ev = ec_volume.EcVolume(_node(base, str(tmp_path / "n"),
                                  set(range(2, 14))),
                            *BLOCKS["rs_10_4"], device="cpu")
    try:
        for nid, data in blobs.items():
            assert ev.read_needle(nid, reader).data == data
        assert ev.read_stats_snapshot()["remote_shard_reads"] > 0
        assert ev.read_stats_snapshot()["reconstruct_batches"] == 0
        nid = next(n for n in blobs if 0 in _touches(ev, n))
        monkeypatch.setenv("WEEDTPU_HEDGE_PCT", "99")
        monkeypatch.setenv("WEEDTPU_HEDGE_MAX_MS", "50")
        delay["s"] = 0.2
        fired = metrics.HEDGE_TOTAL.labels("hedge_won").value
        assert ev.read_needle(nid, reader).data == blobs[nid]
        assert metrics.HEDGE_TOTAL.labels("hedge_won").value == fired + 1
        time.sleep(0.25)
    finally:
        pool.close()
        srv.shutdown()
        srv.server_close()
        th.join(timeout=10)
        ev.close()
        peer.close()


# ---- TLS ----------------------------------------------------------------

def test_pooled_http_over_tls(tmp_path):
    """The port's PooledHTTP fetches over https from a standard-library
    server whose context is the port's `server_ssl`, with certificates
    from the port's `generate_certs` (mutual TLS: the client presents
    the node certificate)."""
    pytest.importorskip("cryptography",
                        reason="generate_certs needs the cryptography "
                               "package, which this host lacks")
    conf = tls.generate_certs(str(tmp_path / "certs"))
    assert sorted(conf) == ["ca", "cert", "key", "verify_client"]
    tls.configure(conf)
    srv = None
    try:
        assert tls.enabled() and tls.scheme() == "https"
        assert tls.server_ssl() is tls.server_ssl()  # cached per role
        srv = _HeaderServer(context=tls.server_ssl())
        pool = http.PooledHTTP(timeout=5.0)
        try:
            st, _, body = pool.request(f"https://127.0.0.1:{srv.port}/x")
            assert (st, body) == (200, b"ok")
            st, _, body = pool.request(f"https://localhost:{srv.port}/y")
            assert (st, body) == (200, b"ok")
        finally:
            pool.close()
        # a client without the node certificate is refused (mTLS)
        bare = ssl.create_default_context(cafile=conf["ca"])
        with pytest.raises((ssl.SSLError, ConnectionError)):
            import socket
            with socket.create_connection(("127.0.0.1", srv.port)) as s:
                with bare.wrap_socket(s, server_hostname="127.0.0.1") as c:
                    c.sendall(b"GET / HTTP/1.1\r\nHost: x\r\n\r\n")
                    if not c.recv(1):
                        raise ConnectionError("closed")
    finally:
        if srv is not None:
            srv.close()
        tls.configure(None)
    assert not tls.enabled() and tls.scheme() == "http"
    assert tls.server_ssl() is None and tls.client_ssl() is None


def test_tls_configure_refuses_mtls_without_ca():
    with pytest.raises(ValueError, match="verify_client"):
        tls.configure({"cert": "a.crt", "key": "a.key",
                       "verify_client": True})
    assert not tls.enabled()


def test_tls_imports_without_cryptography():
    """Nothing on the card's path needs `cryptography`: the module
    imports and configures plain HTTP with the package hidden."""
    code = ("import sys\n"
            "sys.modules['cryptography'] = None\n"
            "from seaweedfs_tpu_torch.security import tls\n"
            "from seaweedfs_tpu_torch.utils import http\n"
            "tls.configure(None)\n"
            "assert tls.scheme() == 'http'\n"
            "try:\n"
            "    tls.generate_certs(sys.argv[1])\n"
            "except ImportError:\n"
            "    pass\n"
            "else:\n"
            "    raise SystemExit('generate_certs ran without cryptography')\n")
    subprocess.run([sys.executable, "-c", code, "/nonexistent/certs"],
                   cwd=REPO, check=True, timeout=60)
