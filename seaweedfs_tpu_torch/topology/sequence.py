"""File-id sequencers (reference: weed/sequence/).

Counterpart of `seaweedfs_tpu/topology/sequence.py`, whole: the same
counter and the same snowflake bit layout, so file keys issued by a
master of either package never collide with the other's.
"""

from __future__ import annotations

import threading
import time


class MemorySequencer:
    """Monotonic counter; master persists/advances it via set_max."""

    def __init__(self, start: int = 1):
        self._next = start
        self._lock = threading.Lock()

    def next_ids(self, count: int = 1) -> int:
        with self._lock:
            first = self._next
            self._next += count
            return first

    def set_max(self, seen: int) -> None:
        with self._lock:
            if seen >= self._next:
                self._next = seen + 1

    def peek(self) -> int:
        return self._next


class SnowflakeSequencer:
    """41-bit ms timestamp | 10-bit node | 12-bit sequence
    (reference: weed/sequence/snowflake_sequencer.go)."""

    EPOCH_MS = 1_577_836_800_000  # 2020-01-01

    def __init__(self, node_id: int):
        self.node_id = node_id & 0x3FF
        self._lock = threading.Lock()
        self._last_ms = 0
        self._seq = 0

    def next_ids(self, count: int = 1) -> int:
        with self._lock:
            first = None
            for _ in range(count):
                now = int(time.time() * 1000) - self.EPOCH_MS
                if now == self._last_ms:
                    self._seq = (self._seq + 1) & 0xFFF
                    if self._seq == 0:
                        while now <= self._last_ms:
                            now = int(time.time() * 1000) - self.EPOCH_MS
                else:
                    self._seq = 0
                self._last_ms = now
                nid = (now << 22) | (self.node_id << 12) | self._seq
                if first is None:
                    first = nid
            return first

    def set_max(self, seen: int) -> None:
        pass  # timestamps already dominate
