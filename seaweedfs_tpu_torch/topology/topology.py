"""Cluster topology: the locality classes.

Counterpart of `seaweedfs_tpu/topology/topology.py`, cut to the network
distance classes that the repair planner, the degraded-read fan-out and
the repair-byte ledgers share (:22-42).  The DC -> rack -> node tree, the
volume layouts and the EC shard registry come with the master (ROADMAP
1.18a).
"""

from __future__ import annotations

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
