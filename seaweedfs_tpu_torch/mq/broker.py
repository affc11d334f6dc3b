"""MQ broker: HTTP pub/sub with partition balancing, follower replication,
broker failover, and subscriber-group coordination.

Counterpart of `seaweedfs_tpu/mq/broker.py`, with every route of its
table and the same bytes on the wire (the NDJSON lines, `X-Next-Offset`,
the `/topics/list` JSON, the `/replicate` and `/partition/state`
payloads, the register body and the epoch request), so a ring may hold
brokers of both packages.  What two brokers must compute alike is the
reference's, faults and all: the ring and its owner and follower rule,
the group coordinator, the newest-segment-wins dedup.  Kept apart on
purpose, each local to one broker (ROADMAP fault 3.18, each pinned by a
test):
- a long-poll `/sub` waits for a publish on the loop (a waker on the
  partition) and holds no thread, and `/pub` appends on the loop; the
  reference runs both in the loop's default thread pool, where as many
  long-polls as the pool has threads hold back every publish until a
  poll expires;
- `stop` ends its live long-polls at once, awaits its cancelled tasks,
  and closes its client session after its server; the reference's stop
  waits in `runner.cleanup()` for each live long-poll to run out;
- an owner whose replication meets a gap (the follower's 409) waits
  for the offsets below it that concurrent publishes are still
  replicating and sends it once more, and pushes the whole partition
  only when the gap remains; the reference's concurrent publishes reach
  the follower out of order and each gap pushes the whole partition;
- concurrent first publishes to a partition share one catch-up and one
  fencing epoch; the reference's each fetch an epoch of their own, and
  the follower fences (403) the append whose lower epoch reaches it
  after a higher one, which the owner has already appended: the client
  sees 503, publishes again, and the log keeps both copies;
- a reconcile round pulls a peer's partition only when this broker is
  still short of the next offset the peer had the round before (a
  divergence); the reference pulls the whole partition whenever the
  peer is ahead, a replica still on its way included.

Reference: weed/mq/broker/{broker_grpc_pub.go:37 Publish,
broker_grpc_sub.go:13 Subscribe, broker_grpc_configure.go} plus the
coordination plane in weed/mq/pub_balancer/ (partition->broker assignment)
and weed/mq/sub_coordinator/ (consumer-group partition assignment +
progress). The reference streams over gRPC with an elected balancer
broker; here the same roles ride HTTP with a DETERMINISTIC balance rule —
partition i of a topic is owned by sorted(live_brokers)[i % n], its
follower is the next broker in that ring — so every broker (and client)
computes identical assignments from the shared live-broker view instead of
holding leader state:

  POST /topics/configure   {"topic": "ns.name", "partition_count": N}
  GET  /topics/list
  POST /pub?topic=ns.name  body=value, ?key= routes by ring slot;
                           forwarded to the owning broker, synchronously
                           replicated to the follower
  GET  /sub?topic=ns.name&partition=i&offset=K[&wait=seconds]
                           -> NDJSON batch (long-polls when caught up)
  POST /replicate          follower append (leader pushes a snapshot on gap)
  GET/POST /partition/state  full-partition snapshot pull / push
  POST /coordinator/join   {"group","topic","member"} -> partitions for
                           this member (round-robin over live members)
  POST /offsets/commit     {"group","topic","partition","offset"}
  GET  /offsets/get?group=&topic=&partition=
  GET  /status

Brokers register in the master's cluster registry (type=broker); each
broker's peer view = master's member list filtered by a direct liveness
probe, refreshed continuously. Killing a broker re-routes its partitions
to survivors, which already hold the data via follower replication —
publishes keep succeeding and subscribers lose nothing. Group offsets are
broadcast to every live broker on commit so they also survive failover.

Durability (with `filer_url`): partition logs flush into the filer as
binary segments under /topics/<ns>/<topic>/<partition>/ (mq/segments.py;
reference persists topic data into the filer the same way), topic confs as
topic.json, and committed group offsets write through to
/topics/.offsets/ — kill and restart EVERY broker and topics, messages,
and consumer progress all recover.  Reads below the RAM window fall back
to the segment files.

Fencing: partition ownership carries an epoch issued by the master
(/cluster/mq/epoch, monotonic per partition).  Replicas reject appends
with an older epoch, so two brokers with divergent ring views fail loudly
instead of silently interleaving/merging logs.  The unflushed RAM tail is
still lost if owner AND follower die inside one flush interval — the same
window the reference's in-memory log buffer has.
"""

from __future__ import annotations

import asyncio
import base64
import json
import logging
import time

import aiohttp
from aiohttp import web

from seaweedfs_tpu_torch.mq.topic import (LocalPartition, Message, Topic,
                                          ring_slot, split_ring)
from seaweedfs_tpu_torch.security import tls as _tls
from seaweedfs_tpu_torch.security.tls import scheme as _tls_scheme

log = logging.getLogger("mq.broker")


class BrokerServer:
    def __init__(self, master_url: str, host: str = "127.0.0.1",
                 port: int = 17777, peer_refresh: float = 2.0,
                 member_ttl: float = 15.0, filer_url: str | None = None,
                 flush_interval: float = 2.0):
        self.master_url = master_url
        self.host, self.port = host, port
        self.peer_refresh = peer_refresh
        self.member_ttl = member_ttl
        self.filer_url = filer_url
        self.flush_interval = flush_interval
        # str(topic) -> list[LocalPartition]
        self.topics: dict[str, list[LocalPartition]] = {}
        self.peer_brokers: list[str] = [self.url]  # sorted, self included
        # (group, topic) -> {member: last_seen}
        self.group_members: dict[tuple[str, str], dict[str, float]] = {}
        # (group, topic, partition) -> committed offset
        self.group_offsets: dict[tuple[str, str, int], int] = {}
        # fencing (advisor finding: divergent ring views must not silently
        # merge): (topic, pi) -> epoch I publish under / highest seen
        self.own_epoch: dict[tuple[str, int], int] = {}
        self.seen_epoch: dict[tuple[str, int], int] = {}
        # (topic, pi) -> next offset already durable in filer segments
        self.flushed_upto: dict[tuple[str, int], int] = {}
        self._conf_persisted: set[str] = set()
        self._seg_cache: dict[tuple, list] = {}  # LRU of decoded segments
        self.store = None  # FilerSegmentStore when filer_url is set
        self.app = web.Application(client_max_size=64 * 1024 * 1024)
        self.app.add_routes([
            web.post("/topics/configure", self.handle_configure),
            web.get("/topics/list", self.handle_list),
            web.post("/pub", self.handle_pub),
            web.get("/sub", self.handle_sub),
            web.post("/replicate", self.handle_replicate),
            web.get("/partition/state", self.handle_partition_state_get),
            web.post("/partition/state", self.handle_partition_state_put),
            web.post("/coordinator/join", self.handle_coordinator_join),
            web.post("/offsets/commit", self.handle_offsets_commit),
            web.post("/offsets/sync", self.handle_offsets_sync),
            web.get("/offsets/get", self.handle_offsets_get),
            web.post("/flush", self.handle_flush),
            web.get("/status", self.handle_status),
        ])
        self._runner: web.AppRunner | None = None
        self._session: aiohttp.ClientSession | None = None
        self._register_task: asyncio.Task | None = None
        self._flush_task: asyncio.Task | None = None
        self._polls: set[asyncio.Event] = set()  # live long-polls' wakes
        self._stopping = False
        # (topic, pi) -> offsets appended here whose replication to the
        # follower is under way, and the condition their ends notify
        self._replicating: dict[tuple[str, int], set[int]] = {}
        self._replicated = asyncio.Condition()
        # (topic, pi) -> the lock its takeover (catch-up, epoch) holds
        self._takeover: dict[tuple[str, int], asyncio.Lock] = {}
        # (peer, topic, pi) -> the peer's next offset when the last
        # reconcile round found it ahead of this broker's
        self._ahead: dict[tuple[str, str, int], int] = {}

    @property
    def url(self) -> str:
        return f"{self.host}:{self.port}"

    async def start(self) -> None:
        self._session = aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(ssl=_tls.client_ssl()),
            timeout=aiohttp.ClientTimeout(total=30))
        if self.filer_url:
            from seaweedfs_tpu_torch.mq.segments import FilerSegmentStore
            self.store = FilerSegmentStore(self._session, self.filer_url)
            await self._recover()
        self._runner = web.AppRunner(self.app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.host, self.port,
                           ssl_context=_tls.server_ssl("broker"))
        await site.start()
        self._register_task = asyncio.create_task(self._register_loop())
        if self.store is not None:
            self._flush_task = asyncio.create_task(self._flush_loop())
        log.info("mq broker on %s", self.url)

    async def stop(self) -> None:
        """End the live long-polls (each answers what it has, nothing),
        stop the loops and await them, drain the tails to the filer, stop
        serving, then close the client session the handlers used."""
        self._stopping = True
        for changed in list(self._polls):
            changed.set()
        tasks = [t for t in (self._register_task, self._flush_task) if t]
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        if self.store is not None:
            try:
                await self._flush_all()  # graceful stop drains the tail
            except Exception:
                log.exception("final flush failed")
        if self._runner:
            await self._runner.cleanup()
        if self._session:
            await self._session.close()

    # -- durability (reference: topic data persisted into the filer under
    #    /topics; segment serde weed/mq/segment/message_serde.go) ---------

    async def _recover(self) -> None:
        """Rebuild topics + partition tails + flush cursors from the filer:
        a full-cluster restart loses nothing that was flushed."""
        for topic in await self.store.list_topics():
            n = await self.store.read_conf(topic)
            if not n:
                continue
            parts = self._get_topic(topic, auto_create=True, n=n)
            for pi, part in enumerate(parts):
                segs = await self.store.list_segments(topic, pi)
                if not segs:
                    continue
                # load the tail segments into the RAM window, newest
                # first; dedup by offset with the newest segment winning
                # (overlapping segments can exist after a ring-change
                # flush race) and corrupt files skipped
                by_off: dict[int, object] = {}
                for base, end, name in reversed(segs):
                    for m in await self.store.read_segment(topic, pi,
                                                           name):
                        by_off.setdefault(m.offset, m)
                    if len(by_off) >= part.max_messages:
                        break
                msgs = [by_off[o] for o in sorted(by_off)]
                msgs = msgs[-part.max_messages:]
                if msgs:
                    part.load_snapshot(msgs[0].offset, msgs)
                # cursor from the last GOOD message, not the segment file
                # names: a corrupt tail segment must not suppress
                # re-flushing (and thus silently lose) its offset range
                self.flushed_upto[(topic, pi)] = \
                    (msgs[-1].offset + 1) if msgs else 0
        if self.topics:
            log.info("recovered %d topics from filer", len(self.topics))

    async def _flush_loop(self) -> None:
        while True:
            await asyncio.sleep(self.flush_interval)
            try:
                await self._flush_all()
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("segment flush failed")

    async def _flush_all(self) -> None:
        """Write every owned partition's unflushed tail as one new segment.
        Only the owner flushes; after a failover the new owner derives its
        cursor from the filer listing.  During a ring-change window two
        brokers may briefly both believe they own a partition and write
        overlapping segments — readers (_recover, _read_segments) dedup by
        offset, newest segment first, so the race degrades to redundant
        bytes, not replayed duplicates."""
        if self.store is None:
            return
        for topic, parts in list(self.topics.items()):
            for pi, part in enumerate(parts):
                if self._owner_of(pi) != self.url:
                    continue
                key = (topic, pi)
                if key not in self.flushed_upto:
                    self.flushed_upto[key] = \
                        await self.store.flushed_upto(topic, pi)
                upto = self.flushed_upto[key]
                if part.next_offset <= upto:
                    continue
                # off-loop: read takes the partition lock and copies up to
                # the whole RAM window (read clamps to >= upto already)
                tail = await asyncio.to_thread(part.read, upto,
                                               1 << 20)
                if not tail:
                    continue
                if topic not in self._conf_persisted:
                    # auto-created topics (first pub) persist their conf
                    # with their first segment so recovery finds them
                    await self.store.write_conf(topic, len(parts))
                    self._conf_persisted.add(topic)
                await self.store.write_segment(topic, pi, tail)
                self.flushed_upto[key] = tail[-1].offset + 1

    async def handle_flush(self, req: web.Request) -> web.Response:
        """Force-drain the unflushed tails (deterministic tests; ops)."""
        if self.store is None:
            return web.json_response({"error": "no filer configured"},
                                     status=400)
        await self._flush_all()
        return web.json_response({"ok": True})

    # -- fencing epochs --------------------------------------------------

    async def _ensure_epoch(self, topic: str, pi: int) -> int:
        """Owner-side: fetch a fresh fencing epoch from the master the
        first time this broker publishes to a partition (and again after
        being fenced).  Monotonic per partition across the cluster."""
        key = (topic, pi)
        epoch = self.own_epoch.get(key)
        if epoch is not None:
            return epoch
        try:
            async with self._session.post(
                    f"{_tls_scheme()}://{self.master_url}/cluster/mq/epoch",
                    json={"key": f"{topic}/{pi}"},
                    timeout=aiohttp.ClientTimeout(total=5)) as r:
                epoch = int((await r.json())["epoch"])
        except (aiohttp.ClientError, asyncio.TimeoutError,
                ValueError, KeyError):
            # master unreachable: publish under the highest epoch this
            # broker has itself replicated for (passes the follower's
            # >= check in the common case) and do NOT cache, so the next
            # publish retries the master — a master outage must degrade
            # fencing, not turn into a publish outage
            return self.seen_epoch.get(key, 0)
        self.own_epoch[key] = epoch
        return epoch

    # -- membership / balance --------------------------------------------

    async def _register_loop(self) -> None:
        while True:
            try:
                async with self._session.post(
                        f"{_tls_scheme()}://{self.master_url}/cluster/register",
                        json={"type": "broker", "address": self.url},
                        timeout=aiohttp.ClientTimeout(total=10)):
                    pass
            except asyncio.CancelledError:
                raise
            except Exception:
                pass  # the loop must outlive any transient failure
            try:
                await self._refresh_peers()
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("peer refresh failed")
            await asyncio.sleep(self.peer_refresh)

    async def _refresh_peers(self) -> None:
        """Live-broker view = master registry ∩ direct probe. The balance
        rule is pure arithmetic over this sorted list, so agreement on the
        list IS agreement on every partition assignment."""
        candidates = {self.url}
        try:
            async with self._session.get(
                    f"{_tls_scheme()}://{self.master_url}/cluster/status",
                    timeout=aiohttp.ClientTimeout(total=5)) as r:
                members = (await r.json()).get("Members", {})
                candidates.update(members.get("broker", []))
        except (aiohttp.ClientError, asyncio.TimeoutError, ValueError):
            # ONE slow/failed registry fetch must not collapse the ring
            # to {self}: that splits the brain — this broker briefly
            # owns every partition, accepts appends under its solo
            # ring, and the divergence reconciles by DROPPING whichever
            # side's log is shorter.  Keep probing the known ring
            # instead; genuinely dead peers still drop via the direct
            # probe below, and the registry re-adds newcomers next
            # cycle.
            candidates.update(self.peer_brokers)

        async def probe(addr: str) -> str | None:
            if addr == self.url:
                return addr
            try:
                async with self._session.get(
                        f"{_tls_scheme()}://{addr}/status",
                        timeout=aiohttp.ClientTimeout(total=2)) as r:
                    return addr if r.status == 200 else None
            except (aiohttp.ClientError, asyncio.TimeoutError):
                return None

        alive = sorted(a for a in await asyncio.gather(
            *(probe(a) for a in sorted(candidates))) if a)
        if alive != self.peer_brokers:
            log.info("broker ring: %s -> %s", self.peer_brokers, alive)
            self.peer_brokers = alive
            # ownership may have moved: publish under fresh fencing epochs
            # so a peer still on the old ring cannot silently interleave
            self.own_epoch.clear()
            self._ahead.clear()
        # anti-entropy every cycle (and the takeover path after a ring
        # change): a broker that accepted publishes under a stale ring view
        # holds data its settled owner lacks; comparing next_offsets and
        # pulling the longer log converges every such divergence
        await self._reconcile()

    async def _reconcile(self) -> None:
        for peer in self.peer_brokers:
            if peer == self.url:
                continue
            try:
                async with self._session.get(
                        f"{_tls_scheme()}://{peer}/topics/list",
                        timeout=aiohttp.ClientTimeout(total=5)) as r:
                    listing = await r.json()
            except (aiohttp.ClientError, asyncio.TimeoutError, ValueError):
                continue
            for t in listing.get("topics", []):
                name = t["name"]
                parts = self._get_topic(name, auto_create=True,
                                        n=t["partition_count"])
                if len(parts) != t["partition_count"]:
                    continue  # partition-count conflict; leave it alone
                for pi, peer_next in enumerate(t["next_offsets"]):
                    mine = self._owner_of(pi) == self.url or \
                        self._follower_of(pi) == self.url
                    seen = self._ahead.pop((peer, name, pi), None)
                    if not mine or peer_next <= parts[pi].next_offset:
                        continue
                    if seen is not None and parts[pi].next_offset < seen:
                        # still short of what the peer had a round ago:
                        # a divergence, not a replica on its way
                        await self._pull_state(peer, name, pi, parts[pi])
                    else:
                        self._ahead[(peer, name, pi)] = peer_next

    async def _catch_up(self, topic: str, pi: int,
                        part: LocalPartition) -> None:
        """Pull this partition's state from every live peer before the
        first append under fresh ownership; load_snapshot keeps only a
        log longer than ours, so this is an idempotent fast-forward to
        the fleet's high-water mark."""
        for peer in self.peer_brokers:
            if peer == self.url:
                continue
            await self._pull_state(peer, topic, pi, part)

    async def _pull_state(self, peer: str, topic: str, pi: int,
                          part: LocalPartition) -> None:
        try:
            async with self._session.get(
                    f"{_tls_scheme()}://{peer}/partition/state",
                    params={"topic": topic, "partition": str(pi)},
                    timeout=aiohttp.ClientTimeout(total=30)) as r:
                if r.status != 200:
                    return
                st = await r.json()
        except (aiohttp.ClientError, asyncio.TimeoutError, ValueError):
            return
        part.load_snapshot(st["base_offset"],
                           _decode_messages(st["messages"]))

    def _owner_of(self, pi: int) -> str:
        b = self.peer_brokers
        return b[pi % len(b)] if b else self.url

    def _follower_of(self, pi: int) -> str | None:
        b = self.peer_brokers
        if len(b) < 2:
            return None
        return b[(pi + 1) % len(b)]

    # -- topic admin -----------------------------------------------------

    def _get_topic(self, name: str,
                   auto_create: bool = False,
                   n: int = 4) -> list[LocalPartition] | None:
        key = str(Topic.parse(name))
        parts = self.topics.get(key)
        if parts is None and auto_create:
            parts = [LocalPartition(p) for p in split_ring(n)]
            self.topics[key] = parts
        return parts

    async def handle_configure(self, req: web.Request) -> web.Response:
        body = await req.json()
        topic = str(Topic.parse(body["topic"]))
        n = int(body.get("partition_count", 4))
        if n <= 0 or n > 4096:
            return web.json_response({"error": "bad partition_count"},
                                     status=400)
        existing = self.topics.get(topic)
        if existing is not None and len(existing) != n:
            return web.json_response(
                {"error": "cannot repartition a live topic"}, status=409)
        if existing is None:
            self.topics[topic] = [LocalPartition(p) for p in split_ring(n)]
        if self.store is not None:
            try:
                await self.store.write_conf(topic, n)
            except OSError:
                log.exception("topic conf persist failed")
        if not req.query.get("propagated"):
            # every broker holds every partition object (leader for some,
            # follower for others) so configuration fans out
            for peer in self.peer_brokers:
                if peer == self.url:
                    continue
                try:
                    async with self._session.post(
                            f"{_tls_scheme()}://{peer}/topics/configure"
                            "?propagated=1", json=body,
                            timeout=aiohttp.ClientTimeout(total=5)):
                        pass
                except (aiohttp.ClientError, asyncio.TimeoutError):
                    pass
        return web.json_response({"topic": topic, "partition_count": n})

    async def handle_list(self, req: web.Request) -> web.Response:
        return web.json_response({
            "topics": [
                {"name": name, "partition_count": len(parts),
                 "next_offsets": [p.next_offset for p in parts]}
                for name, parts in sorted(self.topics.items())],
            "brokers": self.peer_brokers,
        })

    # -- publish ---------------------------------------------------------

    async def handle_pub(self, req: web.Request) -> web.Response:
        topic = req.query.get("topic", "")
        if not topic:
            return web.json_response({"error": "topic required"}, status=400)
        parts = self._get_topic(topic, auto_create=True)
        if "key_b64" in req.query:  # arbitrary-bytes keys (mq/client.py)
            try:
                key = base64.b64decode(req.query["key_b64"])
            except ValueError:
                return web.json_response({"error": "bad key_b64"},
                                         status=400)
        else:
            key = req.query.get("key", "").encode()
        value = await req.read()
        slot = ring_slot(key)
        part = next((p for p in parts if p.partition.holds_key(key)),
                    parts[slot % len(parts)])
        pi = parts.index(part)

        owner = self._owner_of(pi)
        if owner != self.url and not req.query.get("forwarded"):
            resp = await self._forward_pub(owner, req.query, value)
            if resp is not None:
                return resp
            # owner unreachable: refresh the ring and serve it ourselves if
            # ownership moved here, else fail loudly
            await self._refresh_peers()
            if self._owner_of(pi) != self.url:
                return web.json_response(
                    {"error": f"partition {pi} owner unreachable"},
                    status=503)

        tkey = str(Topic.parse(topic))
        # one takeover per partition at a time: concurrent first
        # publishes share its catch-up and its epoch (each fetching an
        # epoch of its own, the one whose lower epoch reached the
        # follower last would be fenced after its append)
        async with self._takeover.setdefault((tkey, pi), asyncio.Lock()):
            if (tkey, pi) not in self.own_epoch:
                # fresh ownership of this partition (the ring changed, or
                # first publish ever): catch up from peers BEFORE the
                # first append.  A takeover owner whose local log is
                # short (it was neither owner nor follower before) would
                # otherwise assign offsets from ITS next_offset, colliding
                # with the log the previous owner's follower still holds
                # — and anti-entropy resolves collisions by keeping the
                # longer (old) log, silently DROPPING the fresh appends
                # (observed as failover message loss under ring flap).
                await self._catch_up(tkey, pi, part)
            epoch = await self._ensure_epoch(tkey, pi)
        # the append runs on the loop: the partition's own lock is only
        # ever held briefly (a long-poll waits on the loop, not on it)
        offset = part.publish(key, value)
        replicating = self._replicating.setdefault((tkey, pi), set())
        replicating.add(offset)
        try:
            fenced = await self._replicate_out(topic, pi, part, offset, key,
                                               value, epoch)
        finally:
            replicating.discard(offset)
            async with self._replicated:
                self._replicated.notify_all()
        if fenced:
            # the follower has seen a newer owner: this broker's ring view
            # is stale — refresh and route the NEXT publish correctly; the
            # message is already appended locally and anti-entropy will
            # reconcile, but tell the client the truth
            self.own_epoch.pop((str(Topic.parse(topic)), pi), None)
            await self._refresh_peers()
            return web.json_response(
                {"error": f"fenced: partition {pi} has a newer owner"},
                status=503)
        return web.json_response({"partition": pi, "offset": offset})

    async def _forward_pub(self, owner: str, query, value: bytes):
        try:
            params = dict(query)
            params["forwarded"] = "1"
            async with self._session.post(
                    f"{_tls_scheme()}://{owner}/pub", params=params,
                    data=value,
                    timeout=aiohttp.ClientTimeout(total=15)) as r:
                return web.json_response(await r.json(), status=r.status)
        except (aiohttp.ClientError, asyncio.TimeoutError, ValueError):
            return None

    async def _replicate_out(self, topic: str, pi: int,
                             part: LocalPartition, offset: int,
                             key: bytes, value: bytes,
                             epoch: int = 0) -> bool:
        """Synchronous replication to the partition's follower (reference:
        partition followers).  A gap answer first waits for the offsets
        below this one that concurrent publishes are still replicating,
        then tries once more; a gap that remains triggers a snapshot
        push so a rejoining follower converges.  Returns True when the
        follower FENCED this append (it has seen a newer ownership
        epoch)."""
        follower = self._follower_of(pi)
        if follower is None:
            return False
        msg = {
            "topic": topic, "partition": pi, "offset": offset,
            "partition_count": len(self.topics[str(Topic.parse(topic))]),
            "ts_ns": time.time_ns(), "epoch": epoch,
            "key": base64.b64encode(key).decode(),
            "value": base64.b64encode(value).decode(),
        }
        for again in (False, True):
            try:
                async with self._session.post(
                        f"{_tls_scheme()}://{follower}/replicate", json=msg,
                        timeout=aiohttp.ClientTimeout(total=10)) as r:
                    if r.status == 403:
                        return True
                    if r.status != 409:
                        return False
            except (aiohttp.ClientError, asyncio.TimeoutError):
                return False  # follower down; the ring refresh re-routes it
            if not again:
                await self._below_replicated(str(Topic.parse(topic)), pi,
                                             offset)
        # the follower has a gap of its own: push everything
        await self._push_state(follower, topic, pi, part)
        return False

    async def _below_replicated(self, tkey: str, pi: int,
                                offset: int) -> None:
        """Until no offset below `offset` of the partition is still being
        replicated by this broker (10 s at most)."""
        replicating = self._replicating.get((tkey, pi), set())
        async with self._replicated:
            try:
                await asyncio.wait_for(self._replicated.wait_for(
                    lambda: not any(o < offset for o in replicating)), 10)
            except asyncio.TimeoutError:
                pass

    async def _push_state(self, peer: str, topic: str, pi: int,
                          part: LocalPartition) -> None:
        base, msgs = part.snapshot()
        try:
            async with self._session.post(
                    f"{_tls_scheme()}://{peer}/partition/state",
                    params={"topic": topic, "partition": str(pi)},
                    json={"base_offset": base,
                          "partition_count": len(
                              self.topics[str(Topic.parse(topic))]),
                          "messages": _encode_messages(msgs)},
                    timeout=aiohttp.ClientTimeout(total=30)):
                pass
        except (aiohttp.ClientError, asyncio.TimeoutError):
            pass

    async def handle_replicate(self, req: web.Request) -> web.Response:
        body = await req.json()
        topic = body["topic"]
        pi = int(body["partition"])
        parts = self._get_topic(topic, auto_create=True,
                                n=int(body.get("partition_count", 4)))
        if not 0 <= pi < len(parts):
            return web.json_response({"error": "bad partition"}, status=400)
        # fencing: appends from an owner whose epoch is older than the
        # newest we've replicated for are rejected, not merged (a stale
        # ring view must fail loudly instead of silently discarding the
        # settled owner's interleaved messages)
        ekey = (str(Topic.parse(topic)), pi)
        epoch = int(body.get("epoch", 0))
        seen = self.seen_epoch.get(ekey, 0)
        if epoch < seen:
            return web.json_response(
                {"error": f"fenced: epoch {epoch} < {seen}"}, status=403)
        self.seen_epoch[ekey] = epoch
        ok = parts[pi].append_replica(
            int(body["offset"]), int(body["ts_ns"]),
            base64.b64decode(body["key"]), base64.b64decode(body["value"]))
        if not ok:
            return web.json_response({"error": "gap"}, status=409)
        return web.json_response({"ok": True})

    async def handle_partition_state_get(self,
                                         req: web.Request) -> web.Response:
        parts = self._get_topic(req.query.get("topic", ""))
        if parts is None:
            return web.json_response({"error": "no such topic"}, status=404)
        pi = int(req.query.get("partition", "0"))
        if not 0 <= pi < len(parts):
            return web.json_response({"error": "bad partition"}, status=400)
        base, msgs = parts[pi].snapshot()
        return web.json_response({"base_offset": base,
                                  "partition_count": len(parts),
                                  "messages": _encode_messages(msgs)})

    async def handle_partition_state_put(self,
                                         req: web.Request) -> web.Response:
        body = await req.json()
        parts = self._get_topic(req.query.get("topic", ""),
                                auto_create=True,
                                n=int(body.get("partition_count", 4)))
        pi = int(req.query.get("partition", "0"))
        if not 0 <= pi < len(parts):
            return web.json_response({"error": "bad partition"}, status=400)
        parts[pi].load_snapshot(body["base_offset"],
                                _decode_messages(body["messages"]))
        return web.json_response({"ok": True})

    # -- subscribe -------------------------------------------------------

    async def handle_sub(self, req: web.Request) -> web.Response:
        topic = req.query.get("topic", "")
        parts = self._get_topic(topic)
        if parts is None:
            return web.json_response({"error": "no such topic"}, status=404)
        try:
            pi = int(req.query.get("partition", "0"))
            offset = int(req.query.get("offset", "0"))
            wait = min(float(req.query.get("wait", "0")), 60.0)
            limit = min(int(req.query.get("limit", "1024")), 16384)
        except ValueError:
            return web.json_response({"error": "bad params"}, status=400)
        if not 0 <= pi < len(parts):
            return web.json_response({"error": "bad partition"}, status=400)
        owner = self._owner_of(pi)
        if owner != self.url and self._follower_of(pi) != self.url:
            # this broker holds no replica of pi: an empty 200 here would
            # read as "caught up" forever — send the subscriber to the owner
            raise web.HTTPTemporaryRedirect(
                f"{_tls_scheme()}://{owner}/sub?{req.query_string}")
        part = parts[pi]
        if offset < part.base_offset and self.store is not None:
            # below the RAM window: serve from the durable filer segments
            batch = await self._read_segments(topic, pi, offset, limit)
            if batch:
                lines = b"".join(
                    json.dumps(m.to_dict(),
                               separators=(",", ":")).encode() + b"\n"
                    for m in batch)
                return web.Response(
                    body=lines, content_type="application/x-ndjson",
                    headers={"X-Next-Offset":
                             str(batch[-1].offset + 1)})
        batch = await self._follow(part, offset, limit, wait)
        lines = b"".join(
            json.dumps(m.to_dict(), separators=(",", ":")).encode() + b"\n"
            for m in batch)
        return web.Response(body=lines, content_type="application/x-ndjson",
                            headers={"X-Next-Offset": str(
                                batch[-1].offset + 1 if batch else offset)})

    async def _follow(self, part: LocalPartition, offset: int, limit: int,
                      wait: float) -> list[Message]:
        """`part.read(offset, limit, wait)` without a thread: read at
        once, and while nothing is new wait on the loop for the
        partition's waker, up to `wait` seconds or the broker's stop."""
        batch = part.read(offset, limit)
        if batch or wait <= 0 or self._stopping:
            return batch
        loop = asyncio.get_running_loop()
        deadline = loop.time() + wait
        changed = asyncio.Event()

        def waker() -> None:  # on the appending thread
            try:
                loop.call_soon_threadsafe(changed.set)
            except RuntimeError:  # the loop has closed
                pass
        part.add_waker(waker)
        self._polls.add(changed)
        try:
            while True:
                changed.clear()
                batch = part.read(offset, limit)
                remaining = deadline - loop.time()
                if batch or remaining <= 0 or self._stopping:
                    return batch
                try:
                    await asyncio.wait_for(changed.wait(), remaining)
                except asyncio.TimeoutError:
                    pass
        finally:
            part.remove_waker(waker)
            self._polls.discard(changed)

    async def _read_segments(self, topic: str, pi: int, offset: int,
                             limit: int):
        """Messages from `offset` out of the filer segment files (the
        reference reads aged topic data back out of /topics the same way).
        Only segments covering [offset, ...) are downloaded, the most
        recently decoded ones are kept in a small LRU (a replaying
        consumer advances through a segment across several fetches —
        re-downloading it each time would make replay O(segments^2)), and
        duplicate offsets from flush-race overlaps are dropped."""
        # A LATER segment's copy of an offset wins — the same newest-wins
        # rule _recover applies, so live subscribers and a restarted
        # cluster resolve flush-race overlaps identically.  Early exit only
        # once `limit` offsets are collected AND the next segment starts
        # beyond the limit-th one (no density assumption: torn-tail drops
        # and corrupt-segment skips can leave gaps a fixed offset+limit
        # window would silently jump over).
        by_off: dict[int, Message] = {}
        if limit <= 0:
            return []
        for base, end, name in await self.store.list_segments(topic, pi):
            if end <= offset:
                continue
            if len(by_off) >= limit and \
                    base > sorted(by_off)[limit - 1]:
                break
            ckey = (topic, pi, name)
            msgs = self._seg_cache.get(ckey)
            if msgs is None:
                msgs = await self.store.read_segment(topic, pi, name)
                self._seg_cache[ckey] = msgs
                while len(self._seg_cache) > 8:
                    self._seg_cache.pop(next(iter(self._seg_cache)))
            for m in msgs:
                if m.offset >= offset:
                    by_off[m.offset] = m
        return [by_off[o] for o in sorted(by_off)][:limit]

    # -- consumer-group coordination (reference: sub_coordinator/) -------

    def _coordinator_of(self, group: str) -> str:
        """One broker coordinates each group (reference: sub_coordinator is
        the balancer-leader's job); deterministic over the ring so every
        member lands on the same one."""
        b = self.peer_brokers
        return b[ring_slot(group.encode()) % len(b)] if b else self.url

    async def handle_coordinator_join(self, req: web.Request) -> web.Response:
        """Register/renew a group member and return its partitions: the
        round-robin split of the topic's partitions over the live members
        (ConsumerGroup.BalanceConsumerGroupInstances in the reference).
        Joins are forwarded to the group's coordinator broker — membership
        lives in one place, so members joining via different brokers can
        never get overlapping assignments."""
        body = await req.json()
        group = body["group"]
        topic = str(Topic.parse(body["topic"]))
        member = body["member"]
        coord = self._coordinator_of(group)
        if coord != self.url and not req.query.get("forwarded"):
            try:
                async with self._session.post(
                        f"{_tls_scheme()}://{coord}/coordinator/join"
                        "?forwarded=1", json=body,
                        timeout=aiohttp.ClientTimeout(total=10)) as r:
                    return web.json_response(await r.json(),
                                             status=r.status)
            except (aiohttp.ClientError, asyncio.TimeoutError, ValueError):
                await self._refresh_peers()
                if self._coordinator_of(group) != self.url:
                    return web.json_response(
                        {"error": "group coordinator unreachable"},
                        status=503)
        parts = self._get_topic(topic)
        if parts is None:
            return web.json_response({"error": "no such topic"}, status=404)
        gm = self.group_members.setdefault((group, topic), {})
        now = time.monotonic()
        gm[member] = now
        for m, seen in list(gm.items()):
            if now - seen > self.member_ttl:
                del gm[m]
        members = sorted(gm)
        mine = [i for i in range(len(parts))
                if members[i % len(members)] == member]
        return web.json_response({"partitions": mine, "members": members,
                                  "generation": len(members)})

    async def handle_offsets_commit(self, req: web.Request) -> web.Response:
        body = await req.json()
        key = (body["group"], str(Topic.parse(body["topic"])),
               int(body["partition"]))
        self.group_offsets[key] = int(body["offset"])
        if self.store is not None:
            # write-through so progress survives a full-cluster restart
            try:
                await self.store.write_offset(key[0], key[1], key[2],
                                              self.group_offsets[key])
            except OSError:
                log.exception("offset persist failed")

        # fan the commit out (concurrently — a dead peer must not stall the
        # consumer) so any surviving broker can answer offsets/get later
        async def push(peer: str) -> None:
            try:
                async with self._session.post(
                        f"{_tls_scheme()}://{peer}/offsets/sync",
                        json={"entries": [[key[0], key[1], key[2],
                                           self.group_offsets[key]]]},
                        timeout=aiohttp.ClientTimeout(total=5)):
                    pass
            except (aiohttp.ClientError, asyncio.TimeoutError):
                pass
        await asyncio.gather(*(push(p) for p in self.peer_brokers
                               if p != self.url))
        return web.json_response({"ok": True})

    async def handle_offsets_sync(self, req: web.Request) -> web.Response:
        body = await req.json()
        for g, t, p, off in body.get("entries", []):
            # exact value, not max: a deliberate rewind commit must
            # propagate, or brokers diverge and a failover skips the replay
            self.group_offsets[(g, t, int(p))] = int(off)
        return web.json_response({"ok": True})

    async def handle_offsets_get(self, req: web.Request) -> web.Response:
        key = (req.query.get("group", ""),
               str(Topic.parse(req.query.get("topic", ""))),
               int(req.query.get("partition", "0")))
        offset = self.group_offsets.get(key)
        if offset is None and self.store is not None:
            offset = await self.store.read_offset(*key)
            if offset is not None:
                self.group_offsets[key] = offset
        return web.json_response({"offset": offset or 0})

    async def handle_status(self, req: web.Request) -> web.Response:
        return web.json_response({
            "topics": len(self.topics),
            "partitions": sum(len(p) for p in self.topics.values()),
            "brokers": self.peer_brokers,
            "groups": len(self.group_members),
        })


def _encode_messages(msgs: list[Message]) -> list[list]:
    return [[m.offset, m.ts_ns,
             base64.b64encode(m.key).decode(),
             base64.b64encode(m.value).decode()] for m in msgs]


def _decode_messages(rows: list[list]) -> list[Message]:
    return [Message(int(o), int(ts),
                    base64.b64decode(k), base64.b64decode(v))
            for o, ts, k, v in rows]
