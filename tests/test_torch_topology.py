"""The port's topology and sequencers (seaweedfs_tpu_torch/topology/
topology.py, sequence.py) held against the reference's on the same
inputs.

A seeded stream of full-state heartbeats over six nodes in two data
centres of two racks each goes into both `Topology` classes: volumes
appear (some replicated), fill past the size limit and turn read-only,
and vanish; EC shards appear and move between nodes; nodes fall silent
and expire, and come back.  After every beat the two topologies must
answer alike: `to_dict()` (what the shell plans from), every lookup, the
EC shard map, `find_empty_slots` for five placements, a write pick under
one seed, and the vid-change events.
"""

import random
import time

import numpy as np
import pytest

from seaweedfs_tpu.storage import types as ref_types
from seaweedfs_tpu.topology import sequence as ref_sequence
from seaweedfs_tpu.topology import topology as ref_topology

from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.topology import sequence, topology

LIMIT = 64 * 1024 * 1024
NODES = [(f"10.0.{i}.1:8080", ("dc1", "dc2")[i % 2],
          ("r1", "r2")[(i // 2) % 2]) for i in range(6)]
PLACEMENTS = ("000", "001", "010", "100", "200")
TIMEOUT = 25.0


class Clock:
    """time.time for both modules: the stream's own seconds."""

    def __init__(self):
        self.now = 1_700_000_000.0

    def __call__(self):
        return self.now


def beat_stream(seed: int, n: int = 200):
    """(node index, beat, clock advance) tuples: each node's full state
    as the stream mutates it; `None` for a tick without a beat (an
    expiry check)."""
    rng = np.random.default_rng(seed)
    state = {i: {"volumes": {}, "ec": {}} for i in range(len(NODES))}
    silent: set[int] = set()
    next_vid = 1
    out = []
    for step in range(n):
        op = rng.integers(0, 10)
        i = int(rng.integers(len(NODES)))
        st = state[i]
        if op <= 2:  # a new volume, replicated to a second node sometimes
            vid, next_vid = next_vid, next_vid + 1
            rp = PLACEMENTS[int(rng.integers(3))]
            col = ("", "pics", "logs")[int(rng.integers(3))]
            ttl = ("", "3d")[int(rng.integers(2))]
            v = {"id": vid, "collection": col, "size": 0,
                 "file_count": 0, "delete_count": 0, "deleted_bytes": 0,
                 "read_only": False, "replica_placement": rp, "ttl": ttl,
                 "version": 3, "modified_at": float(step)}
            st["volumes"][vid] = v
            if rp != "000":
                j = (i + 1 + int(rng.integers(len(NODES) - 1))) % len(NODES)
                state[j]["volumes"][vid] = dict(v)
        elif op <= 4 and st["volumes"]:  # writes, past the limit at times
            vid = int(rng.choice(sorted(st["volumes"])))
            v = st["volumes"][vid]
            v["size"] += int(rng.integers(1, LIMIT // 3))
            v["file_count"] += int(rng.integers(1, 100))
            v["deleted_bytes"] += int(rng.integers(0, 1000))
            v["modified_at"] = float(step)
            if rng.random() < 0.1:
                v["read_only"] = True
        elif op == 5 and st["volumes"]:  # a volume leaves this node
            vid = int(rng.choice(sorted(st["volumes"])))
            del st["volumes"][vid]
        elif op == 6:  # an EC volume's shards land here
            vid, next_vid = next_vid, next_vid + 1
            sids = sorted(rng.choice(14, int(rng.integers(1, 8)),
                                     replace=False).tolist())
            st["ec"][vid] = {"id": vid, "collection": "ecc" if vid % 2
                             else "", "shard_ids": sids,
                             "shard_size": int(rng.integers(1, 1 << 20)),
                             "codec": ("", "rs_10_4", "lrc_10_2_2")[
                                 int(rng.integers(3))]}
        elif op == 7:  # a shard moves to another node
            holders = [k for k in state if state[k]["ec"]]
            if holders:
                k = holders[int(rng.integers(len(holders)))]
                vid = int(rng.choice(sorted(state[k]["ec"])))
                e = state[k]["ec"][vid]
                sid = e["shard_ids"].pop(0)
                if not e["shard_ids"]:
                    del state[k]["ec"][vid]
                dst = state[i]["ec"].setdefault(
                    vid, {**e, "shard_ids": []})
                dst["shard_ids"] = sorted(set(dst["shard_ids"]) | {sid})
                out.append((k, _beat(state[k], k), 0.1))
        elif op == 8:  # a node falls silent, or comes back
            if i in silent:
                silent.discard(i)
            elif len(silent) < 2:
                silent.add(i)
        else:  # time passes with no beat: expiry
            out.append((None, None, float(rng.integers(5, 20))))
            continue
        for k in sorted(state):
            if k not in silent:
                out.append((k, _beat(state[k], k), 0.2))
    return out


def _beat(st: dict, i: int) -> dict:
    return {"max_volume_count": 8 + i,
            "volumes": [dict(v) for _, v in sorted(st["volumes"].items())],
            "ec_shards": [dict(e, shard_ids=list(e["shard_ids"]))
                          for _, e in sorted(st["ec"].items())]}


def _urls(nodes) -> list[str]:
    return [n.url for n in nodes]


def _slots(sets) -> list[list[str]] | None:
    return None if sets is None else [[n.id for n in s] for s in sets]


def _answers(topo, rp_mod, vids: range) -> dict:
    return {
        "dict": topo.to_dict(),
        "lookup": {v: _urls(topo.lookup(v)) for v in vids},
        "lookup_col": {v: _urls(topo.lookup(v, "pics")) for v in vids},
        "ec": {v: (None if (e := topo.lookup_ec_shards(v)) is None else
                   {s: _urls(ns) for s, ns in e.items()}) for v in vids},
        "slots": {rp: _slots(topo.find_empty_slots(
            rp_mod.ReplicaPlacement.parse(rp), 2)) for rp in PLACEMENTS},
        "sizes": dict(topo.ec_shard_sizes),
        "codecs": dict(topo.ec_codecs),
        "collections": dict(topo.ec_collections),
    }


@pytest.mark.parametrize("seed", [0, 1])
def test_topology_twin_over_a_beat_stream(seed, monkeypatch):
    clock = Clock()
    monkeypatch.setattr(time, "time", clock)
    ref = ref_topology.Topology(volume_size_limit=LIMIT)
    mine = topology.Topology(volume_size_limit=LIMIT)
    events = {"ref": [], "mine": []}
    ref.on_vid_change = events["ref"].append
    mine.on_vid_change = events["mine"].append
    stream = beat_stream(seed)
    assert len(stream) >= 200
    expired = 0
    for step, (i, beat, dt) in enumerate(stream):
        clock.now += dt
        if i is None:
            dead = ref.expire_dead_nodes(TIMEOUT)
            assert mine.expire_dead_nodes(TIMEOUT) == dead
            expired += len(dead)
        else:
            url, dc, rack = NODES[i]
            for topo in (ref, mine):
                topo.register_heartbeat(url, url, "", dc, rack, beat)
        assert events["mine"] == events["ref"], step
        vids = range(1, ref.max_volume_id + 2)
        assert _answers(mine, t, vids) == _answers(ref, ref_types, vids), \
            step
        for col, rp, ttl in sorted(ref.layouts):
            s = (seed + 1) * 7919 + step
            random.seed(s)
            want = ref.pick_for_write(col, rp, ttl)
            mine.rng.seed(s)
            got = mine.pick_for_write(col, rp, ttl)
            assert (got and (got[0], _urls(got[1]))) == \
                (want and (want[0], _urls(want[1]))), (step, col, rp, ttl)
    # the stream reached every kind of state it is meant to
    d = ref.to_dict()
    assert expired > 0 and events["ref"]
    assert any(lo.readonly for lo in ref.layouts.values())
    assert any(lo.writables for lo in ref.layouts.values())
    assert ref.ec_shard_locations and d["ec_collections"]


def test_growth_and_unregister_equal_reference():
    """The master's growth bookkeeping: `find_empty_slots` placements,
    `next_volume_id`, layout registers and `unregister_node`."""
    ref = ref_topology.Topology(volume_size_limit=LIMIT)
    mine = topology.Topology(volume_size_limit=LIMIT)
    for topo in (ref, mine):
        for url, dc, rack in NODES:
            topo.register_heartbeat(url, url, "", dc, rack,
                                    {"max_volume_count": 3})
    for rp in PLACEMENTS:
        for topo, mod, state in ((ref, ref_types, ref_topology.VolumeState),
                                 (mine, t, topology.VolumeState)):
            sets = topo.find_empty_slots(mod.ReplicaPlacement.parse(rp), 1)
            vid = topo.next_volume_id()
            for node in sets[0]:
                v = state(id=vid, collection="", replica_placement=rp)
                node.volumes[vid] = v
                topo.layout("", rp, "").register(v, node)
        assert mine.to_dict() == ref.to_dict(), rp
    # placements that fit nowhere answer None in both
    for rp in ("220", "030", "005"):
        got = _slots(mine.find_empty_slots(t.ReplicaPlacement.parse(rp), 3))
        assert got == _slots(ref.find_empty_slots(
            ref_types.ReplicaPlacement.parse(rp), 3)), rp
    assert got is None
    for topo in (ref, mine):
        topo.unregister_node(NODES[0][0])
        topo.unregister_node("nobody:1")
    assert mine.to_dict() == ref.to_dict()


def test_layout_pick_uses_the_topologys_generator():
    """Write picks draw from `Topology.rng` alone: reseeding the module
    changes nothing, reseeding the generator repeats the pick."""
    topo = topology.Topology(volume_size_limit=LIMIT)
    url, dc, rack = NODES[0]
    topo.register_heartbeat(url, url, "", dc, rack, {"volumes": [
        {"id": v, "size": 1} for v in range(1, 30)]})
    topo.rng.seed(5)
    first = [topo.pick_for_write("", "000", "")[0] for _ in range(20)]
    topo.rng.seed(5)
    random.seed(99)
    assert [topo.pick_for_write("", "000", "")[0]
            for _ in range(20)] == first
    assert len(set(first)) > 5


# ---- sequencers ------------------------------------------------------------

def test_memory_sequencer_equals_reference():
    rng = np.random.default_rng(3)
    ref, mine = ref_sequence.MemorySequencer(), sequence.MemorySequencer()
    for _ in range(300):
        if rng.random() < 0.3:
            seen = int(rng.integers(0, 5000))
            ref.set_max(seen)
            mine.set_max(seen)
        else:
            c = int(rng.integers(1, 50))
            assert mine.next_ids(c) == ref.next_ids(c)
        assert mine.peek() == ref.peek()
    assert sequence.MemorySequencer(start=77).next_ids() == 77


def test_snowflake_layout_equals_reference(monkeypatch):
    """Under one clock both packages issue the same ids: 41-bit ms since
    2020-01-01, the 10-bit node id, a 12-bit sequence that rolls into
    the next millisecond."""
    clock = Clock()
    monkeypatch.setattr(time, "time", clock)
    node = 0x5A5 | 0x400  # masked to 10 bits
    ref = ref_sequence.SnowflakeSequencer(node)
    mine = sequence.SnowflakeSequencer(node)
    assert mine.node_id == ref.node_id == 0x1A5
    assert mine.EPOCH_MS == ref.EPOCH_MS
    ids = []
    for step in range(40):
        clock.now += 0.0004 * (step % 4)
        got, want = mine.next_ids(3), ref.next_ids(3)
        assert got == want
        ids.append(got)
        mine.set_max(1 << 62)  # timestamps dominate: a no-op
        ref.set_max(1 << 62)
    first = ids[0]
    ms = int(clock.now * 1000) - sequence.SnowflakeSequencer.EPOCH_MS
    assert (first >> 22) <= ms and (first >> 12) & 0x3FF == 0x1A5
    assert ids == sorted(ids) and len(set(ids)) == len(ids)


def test_snowflake_sequence_rolls_over_within_a_millisecond(monkeypatch):
    """4096 ids in one millisecond exhaust the sequence: the next id
    waits for the clock, in both packages, and stays monotonic."""
    ticks = iter(range(10**6))
    base = 1_700_000_000.0

    def clock():
        # the first 4100 reads see one millisecond, then it advances
        n = next(ticks)
        return base + (0.0 if n < 4100 else 0.001 * (n - 4099))
    for mod in (ref_sequence, sequence):
        ticks = iter(range(10**6))
        monkeypatch.setattr(time, "time", clock)
        s = mod.SnowflakeSequencer(7)
        got = [s.next_ids() for _ in range(4097)]
        assert got == sorted(got) and len(set(got)) == 4097
        assert got[-1] >> 22 > got[0] >> 22
