"""Topic + partition model.

Counterpart of `seaweedfs_tpu/mq/topic.py` (reference:
weed/mq/topic/{topic.go,partition.go,local_partition.go}), whole.  A
topic's key space is a ring of 4096 slots; each partition owns a
contiguous [range_start, range_stop) slice of the ring, and a message is
routed by hashing its key onto the ring.  `ring_slot` and `split_ring`
are the reference's to the slot: a client of either package routes a key
to the same partition, and brokers of both packages agree on a ring.

`LocalPartition` adds one thing to the reference's: `add_waker`, a hook
called after every append or snapshot load, so a server waits for new
messages without holding a thread (the broker's long-poll).
"""

from __future__ import annotations

import threading
import time
import zlib
from dataclasses import dataclass

PARTITION_COUNT_RING = 4096  # reference: mq/topic/partition.go PartitionCount


@dataclass(frozen=True)
class Topic:
    namespace: str
    name: str

    def __str__(self) -> str:
        return f"{self.namespace}.{self.name}"

    @classmethod
    def parse(cls, s: str) -> "Topic":
        ns, _, name = s.rpartition(".")
        return cls(ns or "default", name)


@dataclass(frozen=True)
class Partition:
    range_start: int
    range_stop: int
    ring_size: int = PARTITION_COUNT_RING

    def holds_key(self, key: bytes) -> bool:
        return self.range_start <= ring_slot(key) < self.range_stop


def ring_slot(key: bytes, ring_size: int = PARTITION_COUNT_RING) -> int:
    return zlib.crc32(key) % ring_size


def split_ring(partition_count: int,
               ring_size: int = PARTITION_COUNT_RING) -> list[Partition]:
    """Divide the ring into `partition_count` contiguous ranges
    (reference: pub_balancer/allocate.go allocateTopicPartitions)."""
    assert partition_count > 0
    step = ring_size // partition_count
    parts = []
    for i in range(partition_count):
        start = i * step
        stop = ring_size if i == partition_count - 1 else (i + 1) * step
        parts.append(Partition(start, stop, ring_size))
    return parts


@dataclass
class Message:
    offset: int
    ts_ns: int
    key: bytes
    value: bytes

    def to_dict(self) -> dict:
        return {"offset": self.offset, "ts_ns": self.ts_ns,
                "key": self.key.decode("utf-8", "replace"),
                "value": self.value.decode("utf-8", "replace")}


class LocalPartition:
    """In-memory append log for one partition with blocking follow reads
    (reference: mq/topic/local_partition.go + log_buffer)."""

    def __init__(self, partition: Partition, max_messages: int = 1 << 20):
        self.partition = partition
        self.max_messages = max_messages
        self.messages: list[Message] = []
        self.base_offset = 0  # offset of messages[0] after trimming
        self._lock = threading.Condition()
        self._wakers: set = set()

    def add_waker(self, fn) -> None:
        """Call `fn()` after each change of the log until `remove_waker`;
        it runs on the appending thread, under the partition's lock."""
        with self._lock:
            self._wakers.add(fn)

    def remove_waker(self, fn) -> None:
        with self._lock:
            self._wakers.discard(fn)

    def _changed(self) -> None:
        self._lock.notify_all()
        for fn in list(self._wakers):
            fn()

    def publish(self, key: bytes, value: bytes) -> int:
        with self._lock:
            offset = self.base_offset + len(self.messages)
            self.messages.append(Message(offset, time.time_ns(), key, value))
            if len(self.messages) > self.max_messages:
                drop = len(self.messages) - self.max_messages
                self.messages = self.messages[drop:]
                self.base_offset += drop
            self._changed()
            return offset

    def read(self, offset: int, limit: int = 1024,
             wait: float = 0.0) -> list[Message]:
        """Messages from `offset` (clamped to retained range); blocks up to
        `wait` seconds when nothing new."""
        deadline = time.monotonic() + wait
        with self._lock:
            while True:
                start = max(offset, self.base_offset) - self.base_offset
                batch = self.messages[start:start + limit]
                if batch or wait <= 0:
                    return batch
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return []
                self._lock.wait(remaining)

    @property
    def next_offset(self) -> int:
        with self._lock:
            return self.base_offset + len(self.messages)

    # -- replication (reference: partition followers, mq/broker) ---------

    def append_replica(self, offset: int, ts_ns: int, key: bytes,
                       value: bytes) -> bool:
        """Follower-side append at an explicit offset. Returns False on a
        gap (the leader then pushes a full snapshot); stale offsets are
        acknowledged as already-held."""
        with self._lock:
            nxt = self.base_offset + len(self.messages)
            if offset < nxt:
                return True
            if offset > nxt:
                return False
            self.messages.append(Message(offset, ts_ns, key, value))
            if len(self.messages) > self.max_messages:
                drop = len(self.messages) - self.max_messages
                self.messages = self.messages[drop:]
                self.base_offset += drop
            self._changed()
            return True

    def snapshot(self) -> tuple[int, list[Message]]:
        with self._lock:
            return self.base_offset, list(self.messages)

    def load_snapshot(self, base_offset: int,
                      messages: list[Message]) -> None:
        """Replace local state when the incoming log extends further."""
        with self._lock:
            if base_offset + len(messages) <= \
                    self.base_offset + len(self.messages):
                return
            self.base_offset = base_offset
            self.messages = list(messages)
            self._changed()
