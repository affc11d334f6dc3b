"""Rendezvous (highest-random-weight) hashing for the cluster hot tier.

Counterpart of `seaweedfs_tpu/utils/hashring.py`, whole.  Every node
independently computes the same owner for a key from nothing but the
live membership list: no coordination, no token ring state to
replicate.  When a node joins or leaves, only the keys whose argmax
moved re-home (1/N of the space), which is the churn profile a cache
tier wants: a membership change invalidates the fewest warm entries.

blake2b keyed per (node, key) pair gives a stable, well-mixed 64-bit
score; rendezvous beats jump-hash here because membership is an
arbitrary mutable set of addresses, not a dense integer range.  The
autopilot's chunk promotion picks each hot chunk's home filer with it.
"""

from __future__ import annotations

import hashlib
import threading


def _score(node: str, key: str) -> int:
    h = hashlib.blake2b(f"{node}\x00{key}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big")


class RendezvousRing:
    """Thread-safe membership set with `home(key)` owner selection."""

    def __init__(self, members: list[str] | None = None):
        self._members: tuple[str, ...] = tuple(sorted(set(members or ())))
        self._lock = threading.Lock()
        self.version = 0

    @property
    def members(self) -> tuple[str, ...]:
        return self._members

    def update(self, members) -> bool:
        """Replace membership; returns True when it actually changed."""
        new = tuple(sorted(set(members)))
        with self._lock:
            if new == self._members:
                return False
            self._members = new
            self.version += 1
            return True

    def home(self, key: str) -> str | None:
        """The owning member for `key`, or None on an empty ring."""
        members = self._members
        if not members:
            return None
        return max(members, key=lambda m: _score(m, key))

    def ranked(self, key: str) -> list[str]:
        """All members by descending score: element 0 is `home(key)`,
        element 1 the failover owner, and so on."""
        return sorted(self._members, key=lambda m: _score(m, key),
                      reverse=True)

    def __len__(self) -> int:
        return len(self._members)
