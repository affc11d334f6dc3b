"""Cluster topology: DC -> Rack -> DataNode tree, volume layouts, growth,
EC shard registry.

Counterpart of `seaweedfs_tpu/topology/topology.py` (reference:
weed/topology/topology.go, volume_layout.go, volume_growth.go,
topology_ec.go): the locality classes the repair planner, the
degraded-read fan-out and the repair-byte ledgers share, and the
master's soft state, rebuilt from heartbeats: nodes, the writable-volume
layouts, the EC shard map, replica placement.  `to_dict()` is what the
shell plans from (`/dir/status`), so it equals the reference's for the
same beats, ordering of lists included.

Differences from the reference, kept on purpose:
- `Topology.rng` (a `random.Random`) is the one source of the layouts'
  write picks, where the reference draws from the `random` module: a
  `Random` and the module under one seed draw alike;
- no `ec_codec()`: nothing calls it.  The `ec_codecs` and
  `ec_shard_sizes` maps that the beats fill stay, for the repair planner.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field

from seaweedfs_tpu_torch.storage import types as t

# locality classes relative to a reference node, the shared ranking the
# repair planner, degraded-read fan-out, and repair-byte accounting all
# use: 0 same node, 1 same rack, 2 same DC / other rack, 3 other DC
LOCALITY_NAMES = ("node", "rack", "dc", "remote")


def locality_name(cls: int) -> str:
    """Clamped class -> label, the one spelling every repair-byte
    ledger (planner decisions, rebuilder metrics, shell summaries)
    attributes by."""
    return LOCALITY_NAMES[min(max(int(cls), 0), 3)]


def locality_class(dc_a: str, rack_a: str, dc_b: str, rack_b: str,
                   same_node: bool = False) -> int:
    """Network distance class between two placements.  Empty labels
    normalize to the heartbeat defaults so a label-less deployment
    compares as one rack."""
    if same_node:
        return 0
    if (dc_a or "DefaultDataCenter") != (dc_b or "DefaultDataCenter"):
        return 3
    return 1 if (rack_a or "DefaultRack") == (rack_b or "DefaultRack") \
        else 2


@dataclass
class VolumeState:
    id: int
    collection: str
    size: int = 0
    file_count: int = 0
    delete_count: int = 0
    deleted_bytes: int = 0
    read_only: bool = False
    replica_placement: str = "000"
    ttl: str = ""
    version: int = t.CURRENT_VERSION
    modified_at: float = 0.0  # last write, for ec.encode quiet selection


@dataclass
class DataNode:
    id: str  # "host:port"
    url: str
    public_url: str
    dc: str = "DefaultDataCenter"
    rack: str = "DefaultRack"
    max_volume_count: int = 8
    volumes: dict[int, VolumeState] = field(default_factory=dict)
    ec_shards: dict[int, set[int]] = field(default_factory=dict)  # vid -> shard ids
    last_seen: float = field(default_factory=time.time)

    @property
    def free_slots(self) -> int:
        return max(0, self.max_volume_count - len(self.volumes))


class VolumeLayout:
    """Writable-volume bookkeeping per (collection, rp, ttl)
    (reference: weed/topology/volume_layout.go)."""

    def __init__(self, rp: str, ttl: str, volume_size_limit: int,
                 rng: random.Random):
        self.rp = t.ReplicaPlacement.parse(rp)
        self.rng = rng
        self.ttl = ttl
        self.volume_size_limit = volume_size_limit
        self.locations: dict[int, list[DataNode]] = {}
        self.writables: set[int] = set()
        self.readonly: set[int] = set()

    def register(self, v: VolumeState, node: DataNode) -> None:
        nodes = self.locations.setdefault(v.id, [])
        if node not in nodes:
            nodes.append(node)
        if v.read_only or v.size >= self.volume_size_limit:
            self.set_readonly(v.id)
        elif len(nodes) >= self.rp.copy_count:
            self.writables.add(v.id)

    def unregister(self, vid: int, node: DataNode) -> None:
        nodes = self.locations.get(vid, [])
        if node in nodes:
            nodes.remove(node)
        if not nodes:
            self.locations.pop(vid, None)
            self.writables.discard(vid)
        elif len(nodes) < self.rp.copy_count:
            self.writables.discard(vid)

    def set_readonly(self, vid: int) -> None:
        self.writables.discard(vid)
        self.readonly.add(vid)

    def pick_for_write(self) -> tuple[int, list[DataNode]] | None:
        if not self.writables:
            return None
        vid = self.rng.choice(tuple(self.writables))
        return vid, self.locations[vid]


class Topology:
    def __init__(self, volume_size_limit: int = 30 * 1024 * 1024 * 1024,
                 sequencer=None, replication: str = "000"):
        from seaweedfs_tpu_torch.topology.sequence import MemorySequencer
        self.volume_size_limit = volume_size_limit
        self.sequencer = sequencer or MemorySequencer()
        self.default_replication = replication
        self.nodes: dict[str, DataNode] = {}
        self.layouts: dict[tuple[str, str, str], VolumeLayout] = {}
        self.ec_shard_locations: dict[int, dict[int, list[DataNode]]] = {}
        self.ec_collections: dict[int, str] = {}
        # heartbeat-reported shard file size per EC volume: the repair
        # planner's repair-byte estimates (cross-rack budget) need it
        self.ec_shard_sizes: dict[int, int] = {}
        # heartbeat-reported codec tag per EC volume; absent (old node,
        # pre-codec-family beat) means rs
        self.ec_codecs: dict[int, str] = {}
        self.max_volume_id = 0
        # the layouts' write picks draw from here (tests seed it)
        self.rng = random.Random()
        # volume-location delta hook (streamed vid-map updates, reference:
        # master_grpc_server.go broadcastToClients): called with each vid
        # whose location set changed; the master turns it into client
        # push events
        self.on_vid_change = None
        self._lock = threading.RLock()

    def _vids_changed(self, vids) -> None:
        cb = self.on_vid_change
        if cb is None:
            return
        for vid in vids:
            try:
                cb(vid)
            except Exception:  # a broken subscriber must not stall beats
                pass

    # -- membership ----------------------------------------------------

    def layout(self, collection: str, rp: str, ttl: str) -> VolumeLayout:
        key = (collection, rp, ttl)
        lo = self.layouts.get(key)
        if lo is None:
            lo = VolumeLayout(rp, ttl, self.volume_size_limit, self.rng)
            self.layouts[key] = lo
        return lo

    def register_heartbeat(self, node_id: str, url: str, public_url: str,
                           dc: str, rack: str, beat: dict) -> None:
        """Full-state heartbeat: replaces the node's volume/EC shard view
        (reference: master_grpc_server.go recv loop + topology_ec.go:16-36)."""
        with self._lock:
            node = self.nodes.get(node_id)
            if node is None:
                node = DataNode(id=node_id, url=url, public_url=public_url or url,
                                dc=dc or "DefaultDataCenter",
                                rack=rack or "DefaultRack")
                self.nodes[node_id] = node
            node.url, node.public_url = url, public_url or url
            node.last_seen = time.time()
            node.max_volume_count = beat.get("max_volume_count", node.max_volume_count)
            prev_vids = set(node.volumes)
            prev_ec = {vid for vid, s in node.ec_shards.items() if s}

            # unregister vanished volumes
            new_vids = {v["id"] for v in beat.get("volumes", [])}
            for vid in list(node.volumes):
                if vid not in new_vids:
                    v = node.volumes.pop(vid)
                    self.layout(v.collection, v.replica_placement, v.ttl) \
                        .unregister(vid, node)

            for vd in beat.get("volumes", []):
                v = VolumeState(
                    id=vd["id"], collection=vd.get("collection", ""),
                    size=vd.get("size", 0), file_count=vd.get("file_count", 0),
                    delete_count=vd.get("delete_count", 0),
                    deleted_bytes=vd.get("deleted_bytes", 0),
                    read_only=vd.get("read_only", False),
                    replica_placement=vd.get("replica_placement", "000"),
                    ttl=vd.get("ttl", ""), version=vd.get("version", t.CURRENT_VERSION),
                    modified_at=vd.get("modified_at", 0.0))
                node.volumes[v.id] = v
                self.layout(v.collection, v.replica_placement, v.ttl).register(v, node)
                self.max_volume_id = max(self.max_volume_id, v.id)

            # EC shards: replace this node's contribution
            node.ec_shards = {e["id"]: set(e["shard_ids"])
                              for e in beat.get("ec_shards", [])}
            for vid in list(self.ec_shard_locations):
                ec = self.ec_shard_locations[vid]
                for sid in list(ec):
                    nodes = ec[sid]
                    if node in nodes and sid not in node.ec_shards.get(vid, ()):
                        nodes.remove(node)
                    if not nodes:
                        del ec[sid]
                if not ec:
                    del self.ec_shard_locations[vid]
            for e in beat.get("ec_shards", []):
                vid = e["id"]
                self.ec_collections[vid] = e.get("collection", "")
                if e.get("shard_size"):
                    self.ec_shard_sizes[vid] = int(e["shard_size"])
                if e.get("codec"):
                    self.ec_codecs[vid] = str(e["codec"])
                per_vid = self.ec_shard_locations.setdefault(vid, {})
                for sid in e["shard_ids"]:
                    nodes = per_vid.setdefault(sid, [])
                    if node not in nodes:
                        nodes.append(node)
                self.max_volume_id = max(self.max_volume_id, vid)
            new_ec = {vid for vid, s in node.ec_shards.items() if s}
            self._vids_changed((prev_vids ^ new_vids)
                               | (prev_ec ^ new_ec))

    def unregister_node(self, node_id: str) -> None:
        with self._lock:
            node = self.nodes.pop(node_id, None)
            if node is None:
                return
            for vid, v in node.volumes.items():
                self.layout(v.collection, v.replica_placement, v.ttl) \
                    .unregister(vid, node)
            for ec in self.ec_shard_locations.values():
                for nodes in ec.values():
                    if node in nodes:
                        nodes.remove(node)
            self._vids_changed(set(node.volumes)
                               | {vid for vid, s in node.ec_shards.items()
                                  if s})

    def expire_dead_nodes(self, timeout: float = 25.0) -> list[str]:
        now = time.time()
        dead = [nid for nid, n in self.nodes.items()
                if now - n.last_seen > timeout]
        for nid in dead:
            self.unregister_node(nid)
        return dead

    # -- lookup --------------------------------------------------------

    def lookup(self, vid: int, collection: str = "") -> list[DataNode]:
        with self._lock:
            for (col, _, _), lo in self.layouts.items():
                if collection and col != collection:
                    continue
                nodes = lo.locations.get(vid)
                if nodes:
                    return list(nodes)
            ec = self.ec_shard_locations.get(vid)
            if ec:
                seen: list[DataNode] = []
                for nodes in ec.values():
                    for n in nodes:
                        if n not in seen:
                            seen.append(n)
                return seen
            return []

    def lookup_ec_shards(self, vid: int) -> dict[int, list[DataNode]] | None:
        with self._lock:
            ec = self.ec_shard_locations.get(vid)
            return {k: list(v) for k, v in ec.items()} if ec else None

    # -- assignment / growth ------------------------------------------

    def pick_for_write(self, collection: str, rp: str, ttl: str
                       ) -> tuple[int, list[DataNode]] | None:
        with self._lock:
            return self.layout(collection, rp or self.default_replication,
                               ttl).pick_for_write()

    def find_empty_slots(self, rp: t.ReplicaPlacement,
                         count: int) -> list[list[DataNode]] | None:
        """Pick `count` replica sets honouring the placement code
        (reference: volume_growth.go:133 findEmptySlotsForOneVolume).
        Greedy: main node, then same-rack, other-rack, other-DC copies."""
        with self._lock:
            results = []
            for _ in range(count):
                candidates = sorted(
                    (n for n in self.nodes.values() if n.free_slots > 0),
                    key=lambda n: -n.free_slots)
                if not candidates:
                    return None
                main = candidates[0]
                chosen = [main]

                def pick(pred, k):
                    picked = []
                    if k <= 0:
                        return picked
                    for n in candidates:
                        if n in chosen or n in picked:
                            continue
                        if pred(n):
                            picked.append(n)
                            if len(picked) == k:
                                break
                    return picked

                same_rack = pick(lambda n: n.dc == main.dc and n.rack == main.rack,
                                 rp.same_rack)
                diff_rack = pick(lambda n: n.dc == main.dc and n.rack != main.rack,
                                 rp.diff_rack)
                diff_dc = pick(lambda n: n.dc != main.dc, rp.diff_dc)
                if (len(same_rack) < rp.same_rack or len(diff_rack) < rp.diff_rack
                        or len(diff_dc) < rp.diff_dc):
                    return None
                chosen += same_rack + diff_rack + diff_dc
                results.append(chosen)
            return results

    def next_volume_id(self) -> int:
        with self._lock:
            self.max_volume_id += 1
            return self.max_volume_id

    # -- status ---------------------------------------------------------

    def to_dict(self) -> dict:
        with self._lock:
            return {
                "max_volume_id": self.max_volume_id,
                "volume_size_limit": self.volume_size_limit,
                "ec_collections": {str(v): c for v, c
                                   in self.ec_collections.items() if c},
                "nodes": {
                    nid: {
                        "url": n.url, "public_url": n.public_url,
                        "dc": n.dc, "rack": n.rack,
                        "free_slots": n.free_slots,
                        "volumes": sorted(n.volumes),
                        "volume_infos": [
                            {"id": v.id, "collection": v.collection,
                             "size": v.size, "file_count": v.file_count,
                             "read_only": v.read_only,
                             "replica_placement": v.replica_placement,
                             "ttl": v.ttl, "modified_at": v.modified_at}
                            for _, v in sorted(n.volumes.items())],
                        "ec_shards": {str(v): sorted(s)
                                      for v, s in n.ec_shards.items()},
                    } for nid, n in self.nodes.items()
                },
                "writables": {
                    f"{col or '_'}/{rp}/{ttl or '_'}": sorted(lo.writables)
                    for (col, rp, ttl), lo in self.layouts.items()
                },
            }
