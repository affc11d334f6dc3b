"""Fan-out pool sizing for the master's parallel HTTP calls to its fleet.

Counterpart of `seaweedfs_tpu/utils/fanout.py`, whole.  Every place the
master fans a request out to the whole fleet (the aggregator's scrape,
the fan-out GETs of /cluster/heat, /cluster/perf and the trace views,
the governor's scrub-rate pushes) sizes its thread pool here.  A fixed
cap of 8 serialises a 500-node scrape into 500/8 round trips, so the
pool grows with the fleet up to WEEDTPU_FANOUT_POOL (default 64): the
threads spend their lives blocked in socket reads, and the cap bounds
file descriptors and memory, not CPU.  A malformed value raises
ValueError, where the reference falls back to the default.
"""

from __future__ import annotations

import os

_DEFAULT_CAP = 64


def pool_cap() -> int:
    """Upper bound on a fan-out pool's size (WEEDTPU_FANOUT_POOL, an
    integer, default 64; values below 1 count as 1)."""
    raw = os.environ.get("WEEDTPU_FANOUT_POOL", "").strip()
    if not raw:
        return _DEFAULT_CAP
    try:
        cap = int(raw)
    except ValueError:
        raise ValueError(f"WEEDTPU_FANOUT_POOL={raw!r}: want an integer") \
            from None
    return max(1, cap)


def workers(n: int) -> int:
    """Pool size for a fan-out over ``n`` targets: min(n, cap), at least 1."""
    return max(1, min(int(n), pool_cap()))
