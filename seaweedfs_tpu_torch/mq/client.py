"""MQ client library: publisher with partition-ring routing + consumer
groups.

Counterpart of `seaweedfs_tpu/mq/client.py`, whole: the same requests to
the same routes, so a client of either package works against brokers of
either.  Reference: weed/mq/client/pub_client (publishes straight to each
partition's assigned broker, refreshing assignments from the balancer) and
weed/mq/client/sub_client (joins a consumer group, gets partitions from
the coordinator, streams each and commits progress).  Same roles over the
broker HTTP surface, synchronous (usable from tests, shell, and plain
scripts):

    client = MQClient(["127.0.0.1:17777"])
    client.configure("chat.room1", partition_count=4)
    client.publish("chat.room1", b"hello", key=b"alice")

    consumer = client.consumer("chat.room1", group="readers")
    for msg in consumer.poll(max_messages=100):
        ...
    consumer.commit()
"""

from __future__ import annotations

import base64
import json
import time
import urllib.error
import urllib.parse
import urllib.request

from seaweedfs_tpu_torch.mq.topic import Topic, ring_slot, split_ring
from seaweedfs_tpu_torch.security.tls import scheme as _tls_scheme


class MQError(RuntimeError):
    pass


class MQClient:
    """Seed-broker client: keeps a live ring view (the same sorted broker
    list every broker derives), routes each publish to the partition's
    owner, and falls back through the ring on failures."""

    def __init__(self, brokers: list[str], timeout: float = 30.0):
        if not brokers:
            raise ValueError("need at least one seed broker")
        self.seeds = list(brokers)
        self.timeout = timeout
        self.ring: list[str] = sorted(brokers)
        self._topic_parts: dict[str, int] = {}

    # -- http ----------------------------------------------------------

    def _req(self, broker: str, path: str, data: bytes | None = None,
             method: str | None = None) -> tuple[int, bytes, dict]:
        req = urllib.request.Request(
            f"{_tls_scheme()}://{broker}{path}", data=data,
            method=method or ("POST" if data is not None else "GET"))
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return r.status, r.read(), dict(r.headers)
        except urllib.error.HTTPError as e:
            # a 4xx/5xx is an ANSWER (fenced, repartition conflict, ...),
            # not a dead broker — hand the status to the caller
            return e.code, e.read(), dict(e.headers)

    def _any_broker(self, path: str, data: bytes | None = None):
        """Try the ring then the seeds; first broker that answers wins."""
        last: Exception | None = None
        for broker in list(self.ring) + [s for s in self.seeds
                                         if s not in self.ring]:
            try:
                return broker, self._req(broker, path, data)
            except (urllib.error.URLError, OSError) as e:
                last = e
        raise MQError(f"no broker reachable: {last}")

    def refresh(self) -> None:
        """Update the ring + topic partition counts from any live broker."""
        _, (st, body, _) = self._any_broker("/topics/list")
        if st != 200:
            return
        listing = json.loads(body)
        if listing.get("brokers"):
            self.ring = sorted(listing["brokers"])
        for t in listing.get("topics", []):
            self._topic_parts[t["name"]] = t["partition_count"]

    # -- admin ----------------------------------------------------------

    def configure(self, topic: str, partition_count: int = 4) -> None:
        body = json.dumps({"topic": topic,
                           "partition_count": partition_count}).encode()
        _, (st, resp, _) = self._any_broker("/topics/configure", body)
        if st != 200:
            raise MQError(f"configure failed: {resp!r}")
        self._topic_parts[str(Topic.parse(topic))] = partition_count

    # -- publish ---------------------------------------------------------

    def _partition_of(self, topic: str, key: bytes) -> int:
        t = str(Topic.parse(topic))
        n = self._topic_parts.get(t)
        if n is None:
            self.refresh()
            n = self._topic_parts.get(t, 4)
        slot = ring_slot(key)
        for i, p in enumerate(split_ring(n)):
            if p.range_start <= slot < p.range_stop:
                return i
        return slot % n

    def publish(self, topic: str, value: bytes,
                key: bytes = b"") -> tuple[int, int]:
        """-> (partition, offset).  Routed to the owner directly (the
        reference's pub_client does the same; any broker forwards anyway)."""
        pi = self._partition_of(topic, key)
        owner = self.ring[pi % len(self.ring)] if self.ring else self.seeds[0]
        path = "/pub?" + urllib.parse.urlencode(
            {"topic": topic,
             "key_b64": base64.b64encode(key).decode()})
        order = [owner] + [b for b in self.ring if b != owner]
        last: Exception | str = "no brokers"
        for attempt, broker in enumerate(order):
            try:
                st, body, _ = self._req(broker, path, value)
            except (urllib.error.URLError, OSError) as e:
                last = e
                continue
            if st == 200:
                out = json.loads(body)
                return out["partition"], out["offset"]
            last = body.decode("utf-8", "replace")
            if st == 503:  # fenced / owner moved: refresh and retry
                self.refresh()
        raise MQError(f"publish failed: {last}")

    # -- subscribe -------------------------------------------------------

    def fetch(self, topic: str, partition: int, offset: int,
              limit: int = 1024, wait: float = 0.0) -> tuple[list[dict], int]:
        """One batch from one partition -> (messages, next_offset)."""
        path = "/sub?" + urllib.parse.urlencode(
            {"topic": topic, "partition": str(partition),
             "offset": str(offset), "limit": str(limit),
             "wait": str(wait)})
        _, (st, body, headers) = self._any_broker(path)
        if st != 200:
            raise MQError(f"fetch failed: {body!r}")
        msgs = [json.loads(line) for line in body.splitlines() if line]
        nxt = int(headers.get("X-Next-Offset", offset))
        return msgs, nxt

    def consumer(self, topic: str, group: str,
                 member: str | None = None) -> "GroupConsumer":
        return GroupConsumer(self, topic, group,
                             member or f"member-{time.time_ns()}")


class GroupConsumer:
    """Consumer-group member: join assigns partitions (round-robin over
    live members at the group's coordinator broker), poll() walks them
    from the committed offsets, commit() persists progress."""

    def __init__(self, client: MQClient, topic: str, group: str,
                 member: str):
        self.client = client
        self.topic = topic
        self.group = group
        self.member = member
        self.partitions: list[int] = []
        self.positions: dict[int, int] = {}  # partition -> next offset

    def join(self) -> list[int]:
        body = json.dumps({"group": self.group, "topic": self.topic,
                           "member": self.member}).encode()
        _, (st, resp, _) = self.client._any_broker("/coordinator/join", body)
        if st != 200:
            raise MQError(f"join failed: {resp!r}")
        self.partitions = json.loads(resp)["partitions"]
        for pi in self.partitions:
            if pi not in self.positions:
                self.positions[pi] = self._committed(pi)
        return self.partitions

    def _committed(self, pi: int) -> int:
        path = "/offsets/get?" + urllib.parse.urlencode(
            {"group": self.group, "topic": self.topic, "partition": str(pi)})
        _, (st, body, _) = self.client._any_broker(path)
        return int(json.loads(body).get("offset", 0)) if st == 200 else 0

    def poll(self, max_messages: int = 1024,
             wait: float = 0.0) -> list[dict]:
        """Next batch across this member's partitions, advancing local
        positions (commit() makes them durable)."""
        if not self.partitions:
            self.join()
        out: list[dict] = []
        for pi in self.partitions:
            if len(out) >= max_messages:
                break
            msgs, nxt = self.client.fetch(
                self.topic, pi, self.positions.get(pi, 0),
                limit=max_messages - len(out), wait=wait)
            for m in msgs:
                m["partition"] = pi
            out.extend(msgs)
            self.positions[pi] = nxt
        return out

    def commit(self) -> None:
        for pi, offset in self.positions.items():
            body = json.dumps({"group": self.group, "topic": self.topic,
                               "partition": pi, "offset": offset}).encode()
            _, (st, resp, _) = self.client._any_broker("/offsets/commit",
                                                       body)
            if st != 200:
                raise MQError(f"commit failed: {resp!r}")
