"""Durable MQ storage: partition log segments + group offsets in the filer.

Counterpart of `seaweedfs_tpu/mq/segments.py`, whole.  Reference: the
broker persists topic data into the filer under /topics
(weed/mq/broker/broker_topic_conf_read_write.go writes topic.conf there,
weed/filer/filer_notify_append.go appends the log segments) and the
segment byte format lives in weed/mq/segment/message_serde.go
(flatbuffers).  Here a segment is a self-contained binary file of
consecutive messages:

    "WMQ1" then repeated [offset u64][ts_ns u64][klen u32][vlen u32][key][value]
    (big-endian), named <base>-<end>.seg (end exclusive) under
    /topics/<namespace>/<topic>/<partition>/

plus a per-topic topic.json ({"partition_count": N}) and group offsets as
tiny files under /topics/.offsets/<group>/<topic>.<partition> — so a
full-cluster broker restart recovers topics, data, and consumer progress
from the filer alone.  Every byte written into the filer is the
reference's, so brokers of either package recover the other's topics.
aiohttp is imported where the filer is called: the segment codec needs
none of it.
"""

from __future__ import annotations

import asyncio
import json
import struct

from seaweedfs_tpu_torch.mq.topic import Message, Topic
from seaweedfs_tpu_torch.security.tls import scheme as _tls_scheme

SEG_MAGIC = b"WMQ1"
SEG_HEADER = struct.Struct(">QQII")  # offset, ts_ns, klen, vlen


def encode_segment(msgs: list[Message]) -> bytes:
    out = [SEG_MAGIC]
    for m in msgs:
        out.append(SEG_HEADER.pack(m.offset, m.ts_ns, len(m.key),
                                   len(m.value)))
        out.append(m.key)
        out.append(m.value)
    return b"".join(out)


def decode_segment(data: bytes) -> list[Message]:
    if data[:4] != SEG_MAGIC:
        raise ValueError("bad segment magic")
    msgs: list[Message] = []
    pos = 4
    n = len(data)
    while pos < n:
        if pos + SEG_HEADER.size > n:
            break  # segment cut inside a record header: same torn-tail drop
        off, ts, klen, vlen = SEG_HEADER.unpack_from(data, pos)
        pos += SEG_HEADER.size
        key = data[pos:pos + klen]
        pos += klen
        value = data[pos:pos + vlen]
        pos += vlen
        if len(key) != klen or len(value) != vlen:
            # segment cut mid-record (torn write): a silently shortened
            # message must not replay — drop the partial trailing record
            break
        msgs.append(Message(off, ts, key, value))
    return msgs


def seg_name(base: int, end: int) -> str:
    return f"{base:020d}-{end:020d}.seg"


def parse_seg_name(name: str) -> tuple[int, int] | None:
    if not name.endswith(".seg"):
        return None
    try:
        base, end = name[:-4].split("-")
        return int(base), int(end)
    except ValueError:
        return None


class FilerSegmentStore:
    """Async filer-backed storage for the broker (one per BrokerServer)."""

    def __init__(self, session, filer_url: str, root: str = "/topics"):
        self.session = session  # an aiohttp.ClientSession
        self.filer_url = filer_url
        self.root = root.rstrip("/")

    def _u(self, path: str) -> str:
        return f"{_tls_scheme()}://{self.filer_url}{path}"

    def topic_dir(self, topic: str) -> str:
        t = Topic.parse(topic)
        return f"{self.root}/{t.namespace}/{t.name}"

    # -- topic conf ----------------------------------------------------

    async def write_conf(self, topic: str, partition_count: int) -> None:
        await self._put(f"{self.topic_dir(topic)}/topic.json",
                        json.dumps({"partition_count":
                                    partition_count}).encode())

    async def read_conf(self, topic: str) -> int | None:
        data = await self._get(f"{self.topic_dir(topic)}/topic.json")
        if data is None:
            return None
        try:
            return int(json.loads(data)["partition_count"])
        except (ValueError, KeyError):
            return None

    async def list_topics(self) -> list[str]:
        """Walk /topics/<ns>/<topic> two levels deep."""
        out: list[str] = []
        for ns in await self._list(self.root):
            if ns.startswith("."):
                continue
            for name in await self._list(f"{self.root}/{ns}"):
                if await self._get(
                        f"{self.root}/{ns}/{name}/topic.json") is not None:
                    out.append(f"{ns}.{name}")
        return out

    # -- segments ------------------------------------------------------

    async def write_segment(self, topic: str, pi: int,
                            msgs: list[Message]) -> None:
        if not msgs:
            return
        base, end = msgs[0].offset, msgs[-1].offset + 1
        path = f"{self.topic_dir(topic)}/{pi}/{seg_name(base, end)}"
        await self._put(path, encode_segment(msgs))

    async def list_segments(self, topic: str,
                            pi: int) -> list[tuple[int, int, str]]:
        """-> sorted [(base, end, name)]."""
        out = []
        for name in await self._list(f"{self.topic_dir(topic)}/{pi}"):
            parsed = parse_seg_name(name)
            if parsed:
                out.append((parsed[0], parsed[1], name))
        out.sort()
        return out

    async def read_segment(self, topic: str, pi: int,
                           name: str) -> list[Message]:
        data = await self._get(f"{self.topic_dir(topic)}/{pi}/{name}")
        if data is None:
            return []
        try:
            return decode_segment(data)
        except (ValueError, struct.error):
            # truncated/corrupt segment (e.g. broker killed mid-PUT) must
            # not wedge recovery or reads — skip it
            return []

    async def flushed_upto(self, topic: str, pi: int) -> int:
        segs = await self.list_segments(topic, pi)
        return segs[-1][1] if segs else 0

    # -- group offsets -------------------------------------------------

    def _offset_path(self, group: str, topic: str, pi: int) -> str:
        return f"{self.root}/.offsets/{group}/{topic}.{pi}"

    async def write_offset(self, group: str, topic: str, pi: int,
                           offset: int) -> None:
        await self._put(self._offset_path(group, topic, pi),
                        str(offset).encode())

    async def read_offset(self, group: str, topic: str,
                          pi: int) -> int | None:
        data = await self._get(self._offset_path(group, topic, pi))
        if data is None:
            return None
        try:
            return int(data)
        except ValueError:
            return None

    # -- filer http ----------------------------------------------------

    async def _put(self, path: str, data: bytes) -> None:
        import aiohttp
        async with self.session.put(
                self._u(path), data=data,
                timeout=aiohttp.ClientTimeout(total=30)) as r:
            if r.status >= 400:
                raise OSError(f"filer put {path}: {r.status}")

    async def _get(self, path: str) -> bytes | None:
        import aiohttp
        try:
            async with self.session.get(
                    self._u(path),
                    timeout=aiohttp.ClientTimeout(total=30)) as r:
                if r.status == 404:
                    return None
                if r.status >= 400:
                    raise OSError(f"filer get {path}: {r.status}")
                return await r.read()
        except (aiohttp.ClientError, asyncio.TimeoutError):
            return None

    async def _list(self, dir_path: str) -> list[str]:
        import aiohttp
        try:
            async with self.session.get(
                    self._u(dir_path.rstrip("/") + "/"),
                    params={"limit": "100000"},
                    timeout=aiohttp.ClientTimeout(total=30)) as r:
                if r.status != 200:
                    return []
                listing = await r.json()
        except (aiohttp.ClientError, asyncio.TimeoutError, ValueError):
            return []
        return [e["FullPath"].rsplit("/", 1)[-1]
                for e in listing.get("Entries") or []]
