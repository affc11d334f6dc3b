"""The port's message queue (`seaweedfs_tpu_torch/mq/`): its broker,
client, segment store and topic model, on port clusters (the port's
master, a port volume server with `device="cpu"` and, where the brokers
keep their logs, a port `FilerServer`, in process on one loop thread).

- Twins of tests/test_gateways.py's `TestMqBroker`,
  `TestMqBrokerCluster` and `TestMQDurable`, and of
  tests/test_race.py's `test_mq_partition_publish_read_concurrent`,
  each keeping its name and checks.  Where the reference's tests sleep
  for a ring to settle, the twins wait for the condition itself: every
  broker's ring, survivors included, before a read that routes by it
  (the reference's failover test once read through a survivor whose ring
  still named the stopped broker, and was refused).
- Across the packages: `ring_slot`, `split_ring` and the segment bytes
  equal the reference's; each package's `MQClient` on the other's
  brokers; a ring of one broker of each package that loses nothing when
  either stops; segments and group offsets one package's brokers wrote
  into a filer, recovered by the other's.
- The faults of ROADMAP 3.18, each beside the reference's behaviour: a
  long-poll holds no thread of the loop's pool; a stop ends the live
  long-polls at once; an owner whose replication meets a gap waits for
  the replication of the offsets below it and tries again before it
  pushes the whole partition; concurrent first publishes share one
  fencing epoch; a reconcile round pulls a partition only on a
  divergence, not for a replica on its way.
"""

import asyncio
import concurrent.futures
import json
import threading
import time
import urllib.error
import urllib.request

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from seaweedfs_tpu.mq import client as ref_client
from seaweedfs_tpu.mq import segments as ref_segments
from seaweedfs_tpu.mq import topic as ref_topic
from seaweedfs_tpu_torch.mq import client as mq_client
from seaweedfs_tpu_torch.mq import segments, topic
from tests.test_race import gang
from tests.test_torch_master_cluster import Cluster, free_port


@pytest.fixture(autouse=True)
def _quiet_cluster(monkeypatch):
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "0")
    monkeypatch.setenv("WEEDTPU_REPAIR_INTERVAL", "0")
    monkeypatch.setenv("WEEDTPU_AGG_INTERVAL", "0")


def req(url, method="GET", data=None, headers=None):
    r = urllib.request.Request(url, data=data, method=method,
                               headers=headers or {})
    try:
        with urllib.request.urlopen(r, timeout=30) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def until(pred, what, timeout=40.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"{what} within {timeout} s")


def broker_cls(pkg):
    if pkg == "ref":
        from seaweedfs_tpu.mq.broker import BrokerServer
    else:
        from seaweedfs_tpu_torch.mq.broker import BrokerServer
    return BrokerServer


def settled(brokers):
    """Every broker's ring is the sorted list of `brokers`."""
    ring = sorted(b.url for b in brokers)
    return all(b.peer_brokers == ring for b in brokers)


class Brokers:
    """A port cluster (master and one volume server) with brokers the
    test starts, optionally a port filer they keep their logs in; every
    broker still up is stopped on the way out."""

    def __init__(self, tmp_path, filer=False):
        self.tmp = tmp_path
        self.c = Cluster(tmp_path, n_volume_servers=1).start()
        self.up: list = []
        self.filer = None
        try:
            self.c.wait_heartbeats()
            if filer:
                from seaweedfs_tpu_torch.server.filer_server import \
                    FilerServer
                self.filer = FilerServer(self.c.master.url, port=free_port(),
                                         data_dir=str(tmp_path / "f"))
                self.c.submit(self.filer.start())
        except BaseException:
            self.c.stop()
            raise

    def start(self, pkg="port", **kw):
        if self.filer is not None:
            kw.setdefault("filer_url", self.filer.url)
        b = broker_cls(pkg)(self.c.master.url, port=free_port(), **kw)
        self.c.submit(b.start())
        self.up.append(b)
        return b

    def stop(self, b):
        self.up.remove(b)
        self.c.submit(b.stop())

    def close(self):
        try:
            for b in list(self.up):
                self.stop(b)
            if self.filer is not None:
                self.c.submit(self.filer.stop())
        finally:
            self.c.stop()


@pytest.fixture()
def stack(tmp_path):
    """The reference's stack, cut to the broker: the port's master, one
    port volume server and one port broker at its default refresh."""
    s = Brokers(tmp_path)
    broker = s.start()
    yield s, broker
    s.close()


@pytest.fixture()
def durable_stack(tmp_path):
    s = Brokers(tmp_path, filer=True)
    brokers = [s.start(peer_refresh=0.5) for _ in range(2)]
    until(lambda: settled(brokers), "both brokers in one ring")
    yield s
    s.close()


# ---- twins of tests/test_gateways.py::TestMqBroker -------------------------

def test_configure_pub_sub(stack):
    _, broker = stack
    base = f"http://{broker.url}"
    st_, body, _ = req(f"{base}/topics/configure", method="POST",
                       data=json.dumps({"topic": "chat.room1",
                                        "partition_count": 2}).encode())
    assert st_ == 200
    offs = {}
    for i in range(10):
        st_, body, _ = req(f"{base}/pub?topic=chat.room1&key=k{i}",
                           method="POST", data=f"msg-{i}".encode())
        assert st_ == 200
        d = json.loads(body)
        offs.setdefault(d["partition"], []).append(d["offset"])
    assert set(offs) <= {0, 1} and len(offs) >= 1
    for plist in offs.values():
        assert plist == list(range(len(plist)))
    got = []
    for pi in range(2):
        st_, body, hdrs = req(
            f"{base}/sub?topic=chat.room1&partition={pi}&offset=0")
        assert st_ == 200
        for line in body.splitlines():
            got.append(json.loads(line)["value"])
    assert sorted(got) == sorted(f"msg-{i}" for i in range(10))


def test_sub_longpoll_and_missing(stack):
    _, broker = stack
    base = f"http://{broker.url}"
    assert req(f"{base}/sub?topic=nope.missing&partition=0")[0] == 404
    req(f"{base}/topics/configure", method="POST",
        data=json.dumps({"topic": "t.empty", "partition_count": 1}).encode())
    st_, body, hdrs = req(f"{base}/sub?topic=t.empty&partition=0&offset=0")
    assert st_ == 200 and body == b"" and hdrs["X-Next-Offset"] == "0"


def test_ring_math():
    parts = topic.split_ring(3)
    assert parts[0].range_start == 0 and parts[-1].range_stop == 4096
    assert sum(p.range_stop - p.range_start for p in parts) == 4096
    slot = topic.ring_slot(b"some-key")
    assert sum(1 for p in parts
               if p.range_start <= slot < p.range_stop) == 1


# ---- twins of tests/test_gateways.py::TestMqBrokerCluster ------------------

def _pub(broker_url, name, key, value):
    st_, body, _ = req(f"http://{broker_url}/pub?topic={name}&key={key}",
                       method="POST", data=value)
    assert st_ == 200, body
    return json.loads(body)


def _read_all(ring, name, n_parts):
    got = []
    for pi in range(n_parts):
        owner = ring[pi % len(ring)]
        st_, body, _ = req(f"http://{owner}/sub?topic={name}"
                           f"&partition={pi}&offset=0&limit=16384")
        assert st_ == 200
        got += [json.loads(ln) for ln in body.splitlines() if ln]
    return got


def test_two_brokers_failover_no_loss(stack):
    s, b1 = stack
    fast1 = s.start(peer_refresh=0.3)
    fast2 = s.start(peer_refresh=0.3)
    # all three rings, the stack broker's too: it serves partitions the
    # pair routes to it
    until(lambda: settled([b1, fast1, fast2]), "three brokers in one ring")
    assert fast1.peer_brokers == fast2.peer_brokers
    assert len(fast1.peer_brokers) >= 3

    name = "t.failover"
    st_, _, _ = req(f"http://{fast1.url}/topics/configure", method="POST",
                    data=json.dumps({"topic": name,
                                     "partition_count": 4}).encode())
    assert st_ == 200
    sent = {}
    for i in range(60):
        via = fast1.url if i % 2 == 0 else fast2.url
        r = _pub(via, name, f"k{i}", f"v{i}".encode())
        sent[f"k{i}"] = r["partition"]
    got = _read_all(fast1.peer_brokers, name, 4)
    assert len(got) == 60

    req(f"http://{fast2.url}/offsets/commit", method="POST",
        data=json.dumps({"group": "g1", "topic": name,
                         "partition": 0, "offset": 7}).encode())
    st_, body, _ = req(f"http://{fast1.url}/offsets/get?group=g1"
                       f"&topic={name}&partition=0")
    assert json.loads(body)["offset"] == 7

    s.stop(fast2)
    # both survivors drop it before a read routes by their rings
    until(lambda: settled([b1, fast1]), "the survivors' ring")
    assert fast2.url not in fast1.peer_brokers

    def count(n):
        got[:] = _read_all(fast1.peer_brokers, name, 4)
        return len(got) == n
    until(lambda: count(60), "messages lost in failover")
    values = {g["key"]: g["value"] for g in got}
    assert values["k3"] == "v3" and values["k59"] == "v59"

    for i in range(60, 80):
        _pub(fast1.url, name, f"k{i}", f"v{i}".encode())
    until(lambda: count(80), "the survivors' 80 messages")
    st_, body, _ = req(f"http://{fast1.url}/offsets/get?group=g1"
                       f"&topic={name}&partition=0")
    assert json.loads(body)["offset"] == 7


def test_consumer_group_assignment(stack):
    _, broker = stack
    base = f"http://{broker.url}"
    name = "t.groups"
    req(f"{base}/topics/configure", method="POST",
        data=json.dumps({"topic": name, "partition_count": 4}).encode())

    def join(member):
        st_, body, _ = req(f"{base}/coordinator/join", method="POST",
                           data=json.dumps({"group": "g", "topic": name,
                                            "member": member}).encode())
        assert st_ == 200
        return json.loads(body)
    a = join("alpha")
    assert a["partitions"] == [0, 1, 2, 3]
    b = join("beta")
    a = join("alpha")
    assert sorted(a["partitions"] + b["partitions"]) == [0, 1, 2, 3]
    assert not set(a["partitions"]) & set(b["partitions"])
    broker.member_ttl = 0.2
    time.sleep(0.4)
    a = join("alpha")
    assert a["partitions"] == [0, 1, 2, 3]


# ---- twins of tests/test_gateways.py::TestMQDurable ------------------------

def test_full_cluster_restart_preserves_messages_and_offsets(durable_stack):
    s = durable_stack
    brokers = list(s.up)
    client = mq_client.MQClient([b.url for b in brokers])
    client.configure("orders.incoming", partition_count=2)
    sent = []
    for i in range(20):
        pi, off = client.publish("orders.incoming", f"payload-{i}".encode(),
                                 key=f"k{i}".encode())
        sent.append((pi, off, f"payload-{i}"))
    consumer = client.consumer("orders.incoming", group="billing",
                               member="m1")
    consumer.join()
    first = consumer.poll(max_messages=7)
    assert len(first) == 7
    consumer.commit()
    committed = dict(consumer.positions)
    for b in brokers:
        assert req(f"http://{b.url}/flush", method="POST",
                   data=b"{}")[0] == 200
    for b in brokers:
        s.stop(b)
    revived = [s.start(peer_refresh=0.5) for _ in range(2)]
    until(lambda: settled(revived), "the revived brokers' ring")
    client2 = mq_client.MQClient([b.url for b in revived])
    client2.refresh()
    got = []
    for pi in range(2):
        offset = 0
        while True:
            msgs, nxt = client2.fetch("orders.incoming", pi, offset)
            if not msgs:
                break
            got.extend(m["value"] for m in msgs)
            offset = nxt
    assert sorted(got) == sorted(v for _, _, v in sent)
    consumer2 = client2.consumer("orders.incoming", group="billing",
                                 member="m1")
    consumer2.join()
    for pi in consumer2.partitions:
        assert consumer2.positions[pi] == committed.get(pi, 0)
    rest = consumer2.poll(max_messages=100)
    assert len(rest) == 20 - 7
    pi, off = client2.publish("orders.incoming", b"after-restart")
    assert off >= 0


def test_epoch_fencing_rejects_stale_owner(durable_stack):
    brokers = list(durable_stack.up)
    client = mq_client.MQClient([b.url for b in brokers])
    client.configure("fence.t", partition_count=1)
    client.publish("fence.t", b"one")
    follower = max(brokers, key=lambda b: b.url)
    seen = follower.seen_epoch.get(("fence.t", 0), 0)
    assert seen > 0
    body = json.dumps({
        "topic": "fence.t", "partition": 0, "partition_count": 1,
        "offset": 99, "ts_ns": 1, "epoch": seen - 1,
        "key": "", "value": "c3RhbGU=",
    }).encode()
    st_, resp, _ = req(f"http://{follower.url}/replicate", method="POST",
                       data=body)
    assert st_ == 403 and b"fenced" in resp
    nxt = follower._get_topic("fence.t")[0].next_offset
    body = json.dumps({
        "topic": "fence.t", "partition": 0, "partition_count": 1,
        "offset": nxt, "ts_ns": 1, "epoch": seen,
        "key": "", "value": "b2s=",
    }).encode()
    assert req(f"http://{follower.url}/replicate", method="POST",
               data=body)[0] == 200


# ---- twin of tests/test_race.py ---------------------------------------------

def test_mq_partition_publish_read_concurrent():
    lp = topic.LocalPartition(topic.Partition(range_start=0,
                                              range_stop=4096))

    def pub(i):
        for j in range(250):
            lp.publish(f"k{i}".encode(), f"{i}:{j}".encode())

    readers_ok = []

    def read_loop(i):
        off = 0
        rounds = 0
        while rounds < 2000 and off < 1000:
            msgs = lp.read(off, limit=64, wait=0.0)
            for m in msgs:
                assert m.offset >= off
                off = m.offset + 1
            rounds += 1
        readers_ok.append(off)

    gang(6, lambda i: pub(i) if i < 4 else read_loop(i))
    assert lp.next_offset == 4 * 250
    msgs = lp.read(0, limit=2000, wait=0.0)
    assert [m.offset for m in msgs] == list(range(1000))


# ---- what crosses between the packages --------------------------------------

@pytest.mark.parametrize("lo", range(1, 4097, 512))
def test_ring_equals_reference_for_every_partition_count(lo):
    for n in range(lo, lo + 512):
        assert [(p.range_start, p.range_stop, p.ring_size)
                for p in topic.split_ring(n)] == \
            [(p.range_start, p.range_stop, p.ring_size)
             for p in ref_topic.split_ring(n)], n


@settings(max_examples=200, deadline=None)
@given(st.binary(max_size=64), st.integers(1, 4096))
def test_ring_slot_and_routing_equal_reference(key, n):
    assert topic.ring_slot(key) == ref_topic.ring_slot(key)
    ours = [p.holds_key(key) for p in topic.split_ring(n)]
    assert ours.count(True) == 1
    assert ours == [p.holds_key(key) for p in ref_topic.split_ring(n)]
    assert str(topic.Topic.parse(key.decode("latin-1"))) == \
        str(ref_topic.Topic.parse(key.decode("latin-1")))


_messages = st.lists(st.tuples(st.integers(0, 2**64 - 1),
                               st.integers(0, 2**64 - 1),
                               st.binary(max_size=40),
                               st.binary(max_size=200)), max_size=8)


@settings(max_examples=150, deadline=None)
@given(_messages, st.integers(0, 10**9))
def test_segment_bytes_equal_reference(rows, cut_seed):
    ours = [topic.Message(*r) for r in rows]
    theirs = [ref_topic.Message(*r) for r in rows]
    data = segments.encode_segment(ours)
    assert data == ref_segments.encode_segment(theirs)

    def rows_of(msgs):
        return [(m.offset, m.ts_ns, m.key, m.value) for m in msgs]
    assert rows_of(segments.decode_segment(data)) == rows
    # a torn tail at any cut drops the partial record, as the reference
    cut = 4 + cut_seed % (len(data) - 3) if len(data) > 4 else 4
    assert rows_of(segments.decode_segment(data[:cut])) == \
        rows_of(ref_segments.decode_segment(data[:cut]))
    for bad in (b"", b"WMQ0" + data[4:]):
        with pytest.raises(ValueError):
            segments.decode_segment(bad)
    base, end = (rows[0][0], rows[-1][0] + 1) if rows else (0, 1)
    name = segments.seg_name(base, end)
    assert name == ref_segments.seg_name(base, end)
    assert segments.parse_seg_name(name) == \
        ref_segments.parse_seg_name(name) == (base, end)
    for other in ("x.seg", "1-2-3.seg", "topic.json"):
        assert segments.parse_seg_name(other) == \
            ref_segments.parse_seg_name(other)


@pytest.mark.parametrize("client_pkg,broker_pkg",
                         [("port", "ref"), ("ref", "port")])
def test_each_client_on_the_other_packages_brokers(tmp_path, client_pkg,
                                                   broker_pkg):
    """One package's `MQClient` configures, publishes and fetches through
    two of the other's brokers, every key on the partition `ring_slot`
    gives it, and a group of two joins, polls everything once, commits
    and reads its offsets back."""
    cmod = mq_client if client_pkg == "port" else ref_client
    s = Brokers(tmp_path)
    try:
        brokers = [s.start(broker_pkg, peer_refresh=0.3) for _ in range(2)]
        until(lambda: settled(brokers), "both brokers in one ring")
        client = cmod.MQClient([b.url for b in brokers])
        client.configure("x.pkg", partition_count=3)
        ranges = topic.split_ring(3)
        sent = {}
        for i in range(30):
            key = f"key-{i}".encode()
            pi, off = client.publish("x.pkg", b"v%d" % i, key=key)
            assert ranges[pi].holds_key(key)
            sent[(pi, off)] = f"v{i}"
        got = {}
        for pi in range(3):
            msgs, nxt = client.fetch("x.pkg", pi, 0)
            got.update({(pi, m["offset"]): m["value"] for m in msgs})
            assert nxt == (max(o for p, o in sent if p == pi) + 1
                           if any(p == pi for p, _ in sent) else 0)
        assert got == sent
        members = [client.consumer("x.pkg", group="gx", member=m)
                   for m in ("m1", "m2")]
        for m in members:
            m.join()
        members[0].join()  # the first learns of the second
        assert sorted(members[0].partitions + members[1].partitions) == \
            [0, 1, 2]
        polled = []
        for m in members:
            polled += [(r["partition"], r["offset"]) for r in m.poll()]
            m.commit()
        assert sorted(polled) == sorted(sent)
        for m in members:
            for pi in m.partitions:
                assert m._committed(pi) == m.positions[pi]
    finally:
        s.close()


@pytest.mark.parametrize("stopped", ["port", "ref"])
def test_mixed_ring_loses_nothing_when_either_broker_stops(tmp_path,
                                                          stopped):
    """A ring of one broker of each package: publishes through either
    reach the partition's owner, the other holds the replica, and after
    either stops the survivor serves every message and takes more."""
    s = Brokers(tmp_path)
    try:
        pair = {pkg: s.start(pkg, peer_refresh=0.3) for pkg in
                ("port", "ref")}
        until(lambda: settled(list(pair.values())), "the mixed ring")
        ring = pair["port"].peer_brokers
        name = "mix.t"
        st_, _, _ = req(f"http://{pair['ref'].url}/topics/configure",
                        method="POST", data=json.dumps(
                            {"topic": name, "partition_count": 4}).encode())
        assert st_ == 200
        until(lambda: all(b._get_topic(name) for b in pair.values()),
              "the topic on both brokers")
        per_part = [0] * 4
        for i in range(40):
            via = pair["port" if i % 2 else "ref"].url
            r = _pub(via, name, f"k{i}", f"v{i}".encode())
            per_part[r["partition"]] += 1
        for pi in range(4):
            for b in pair.values():  # the owner and its follower
                assert b._get_topic(name)[pi].next_offset == per_part[pi], \
                    (b.url, pi, ring)
        survivor = pair["ref" if stopped == "port" else "port"]
        s.stop(pair[stopped])
        until(lambda: survivor.peer_brokers == [survivor.url],
              "the survivor's ring")
        got = _read_all([survivor.url], name, 4)
        assert sorted((g["key"], g["value"]) for g in got) == \
            sorted((f"k{i}", f"v{i}") for i in range(40))
        for i in range(40, 50):
            r = _pub(survivor.url, name, f"k{i}", f"v{i}".encode())
            assert r["offset"] == per_part[r["partition"]]
            per_part[r["partition"]] += 1
        assert len(_read_all([survivor.url], name, 4)) == 50
    finally:
        s.close()


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_segments_and_offsets_cross_between_packages(tmp_path, writer,
                                                     reader):
    """One package's brokers keep a topic's log and a group's offsets in
    a port filer; after every broker stops, two of the other package's
    recover all of it from the filer alone."""
    s = Brokers(tmp_path, filer=True)
    try:
        first = [s.start(writer, peer_refresh=0.3) for _ in range(2)]
        until(lambda: settled(first), "the writers' ring")
        client = mq_client.MQClient([b.url for b in first])
        client.configure("cross.seg", partition_count=3)
        sent = {}
        for i in range(30):
            pi, off = client.publish("cross.seg", bytes([65 + i % 26]) * i,
                                     key=b"%d" % i)
            sent[(pi, off)] = "".join(chr(65 + i % 26) * i)
        g = client.consumer("cross.seg", group="cg", member="only")
        g.join()
        assert len(g.poll(max_messages=11)) == 11
        g.commit()
        committed = dict(g.positions)
        for b in first:
            assert req(f"http://{b.url}/flush", "POST", b"{}")[0] == 200
        for b in first:
            s.stop(b)
        st_, conf, _ = req(f"http://{s.filer.url}/topics/cross/seg/"
                           "topic.json")
        assert st_ == 200 and conf == b'{"partition_count": 3}'
        second = [s.start(reader, peer_refresh=0.3) for _ in range(2)]
        until(lambda: settled(second), "the readers' ring")
        client2 = mq_client.MQClient([b.url for b in second])
        client2.refresh()
        got = {}
        for pi in range(3):
            msgs, _ = client2.fetch("cross.seg", pi, 0)
            got.update({(pi, m["offset"]): m["value"] for m in msgs})
        assert got == sent
        g2 = client2.consumer("cross.seg", group="cg", member="only")
        g2.join()
        assert {pi: g2.positions[pi] for pi in committed} == committed
        assert len(g2.poll(max_messages=100)) == 30 - 11
        pi, off = client2.publish("cross.seg", b"after", key=b"0")
        assert off == 1 + max(o for p, o in sent if p == pi)
    finally:
        s.close()


# ---- ROADMAP 3.18: faults local to one broker --------------------------------

class LoopOf:
    """A master and a broker of `pkg` on a loop whose default thread pool
    has `threads` threads."""

    def __init__(self, pkg, threads=2):
        if pkg == "ref":
            from seaweedfs_tpu.server.master import MasterServer
        else:
            from seaweedfs_tpu_torch.server.master import MasterServer
        self.loop = asyncio.new_event_loop()
        self.pool = concurrent.futures.ThreadPoolExecutor(threads)
        self.loop.set_default_executor(self.pool)
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        self.master = MasterServer("127.0.0.1", free_port())
        self.run(self.master.start())
        self.broker = broker_cls(pkg)(self.master.url, port=free_port())
        self.run(self.broker.start())
        self.url = f"http://{self.broker.url}"
        assert req(f"{self.url}/topics/configure", "POST", json.dumps(
            {"topic": "s.t", "partition_count": 1}).encode())[0] == 200

    def run(self, coro, timeout=60):
        return asyncio.run_coroutine_threadsafe(coro, self.loop) \
            .result(timeout)

    def subscribe(self, offset, wait, into):
        def sub():
            t0 = time.perf_counter()
            st_, body, _ = req(f"{self.url}/sub?topic=s.t&partition=0"
                               f"&offset={offset}&wait={wait}")
            into.append((time.perf_counter() - t0, st_, body))
        th = threading.Thread(target=sub)
        th.start()
        return th

    def close(self):
        try:
            if self.broker is not None:
                self.run(self.broker.stop())
            self.run(self.master.stop())
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(10)
            self.pool.shutdown(wait=False)


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_long_polls_hold_back_a_publish_unlike_the_reference(pkg):
    """Two long-polling subscribers (wait=3) on a loop whose default pool
    has 2 threads, then one publish.  The reference runs each poll and
    the publish in that pool: the publish waits until a poll expires
    (about 3 s), and the polls see nothing.  The port's polls hold no
    thread: the publish is acknowledged at once and wakes both."""
    wait = 3.0
    lo = LoopOf(pkg)
    try:
        subs: list = []
        ths = [lo.subscribe(0, wait, subs) for _ in range(2)]
        time.sleep(0.5)  # both polls waiting
        t0 = time.perf_counter()
        st_, body, _ = req(f"{lo.url}/pub?topic=s.t&key=k", "POST",
                           b"hello")
        acked = time.perf_counter() - t0
        assert st_ == 200 and json.loads(body)["offset"] == 0
        for th in ths:
            th.join(30)
        values = [[json.loads(ln)["value"] for ln in b.splitlines()]
                  for _, _, b in subs]
        if pkg == "ref":
            assert acked > wait - 1.0, acked
            assert [] in values
        else:
            assert acked < 1.0, acked
            assert values == [["hello"], ["hello"]]
            assert max(dt for dt, _, _ in subs) < wait - 1.0, subs
    finally:
        lo.close()


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_stop_ends_long_polls_at_once_unlike_the_reference(pkg):
    """A stop with a long-poll (wait=4) live.  The reference's stop waits
    in `runner.cleanup()` until the poll runs out; the port's answers the
    poll (200, nothing) and returns at once, its loops awaited."""
    lo = LoopOf(pkg)
    try:
        subs: list = []
        th = lo.subscribe(0, 4.0, subs)
        time.sleep(0.5)
        broker, lo.broker = lo.broker, None
        t0 = time.perf_counter()
        lo.run(broker.stop())
        took = time.perf_counter() - t0
        th.join(30)
        if pkg == "ref":
            assert took > 2.0, took
        else:
            assert took < 1.0, took
            assert [(s_, b) for _, s_, b in subs] == [(200, b"")]
            assert subs[0][0] < 2.0, subs
            assert broker._register_task.done() and not broker._polls
    finally:
        lo.close()


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_concurrent_publishes_reach_the_follower_in_order_unlike_the_reference(
        tmp_path, pkg):
    """Two publishes to one partition, the first one's replication held
    back 2 s.  The reference appends the second at once and replicates
    it ahead of the first: the follower answers a gap (409) and the owner
    pushes it the whole partition.  The port's second publish waits for
    the first's replication, so the follower gets offset 0, then 1, and
    nothing is pushed."""
    s = Brokers(tmp_path)
    try:
        brokers = [s.start(pkg, peer_refresh=0.3) for _ in range(2)]
        until(lambda: settled(brokers), "both brokers in one ring")
        for b in brokers:  # no reconcile round from here on
            b.peer_refresh = 3600
        time.sleep(1.0)
        owner, follower = sorted(brokers, key=lambda b: b.url)
        st_, _, _ = req(f"http://{owner.url}/topics/configure", "POST",
                        json.dumps({"topic": "o.one",
                                    "partition_count": 1}).encode())
        assert st_ == 200
        pushed, calls = [], []
        replicate_out, push_state = owner._replicate_out, owner._push_state

        async def slow_first(*a, **kw):
            calls.append(a[3])  # the offset
            if len(calls) == 1:
                await asyncio.sleep(2.0)
            return await replicate_out(*a, **kw)

        async def counted(*a):
            pushed.append(a[1:3])
            return await push_state(*a)
        owner._replicate_out, owner._push_state = slow_first, counted
        acks: dict = {}

        def pub(i):
            acks[i] = _pub(owner.url, "o.one", f"k{i}", b"m%d" % i)
        first = threading.Thread(target=pub, args=(0,))
        first.start()
        time.sleep(0.3)
        pub(1)
        first.join(30)
        assert [acks[i]["offset"] for i in (0, 1)] == [0, 1]
        got = follower._get_topic("o.one")[0].read(0, 10)
        assert [(m.offset, m.value) for m in got] == [(0, b"m0"), (1, b"m1")]
        if pkg == "ref":
            assert pushed == [("o.one", 0)]
        else:
            assert pushed == []
    finally:
        s.close()


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_reconcile_pulls_a_partition_only_on_divergence_unlike_the_reference(
        tmp_path, pkg):
    """The follower one message short of its owner, as while a replica is
    on its way: the reference's reconcile round pulls the whole partition
    at once; the port's records the owner's offset and pulls only if a
    later round still finds it short of that.  Four rounds: short by one
    (the replica then lands), even, short by one again (nothing lands),
    and once more."""
    s = Brokers(tmp_path)
    try:
        brokers = [s.start(pkg, peer_refresh=0.3) for _ in range(2)]
        until(lambda: settled(brokers), "both brokers in one ring")
        for b in brokers:  # the test runs the rounds
            b.peer_refresh = 3600
        time.sleep(1.0)
        owner, follower = sorted(brokers, key=lambda b: b.url)
        assert req(f"http://{owner.url}/topics/configure", "POST",
                   json.dumps({"topic": "r.one",
                               "partition_count": 1}).encode())[0] == 200
        pulls = []
        pull_state = follower._pull_state

        async def counted(*a):
            pulls.append(a[1:3])
            return await pull_state(*a)
        follower._pull_state = counted
        mine, theirs = (b._get_topic("r.one")[0] for b in (follower, owner))
        got = []
        for rnd in range(4):
            if rnd in (0, 2):
                theirs.publish(b"k", b"v%d" % rnd)  # its replica not sent
            s.c.submit(follower._reconcile())
            if rnd == 0 and mine.next_offset == 0:
                mine.append_replica(0, 1, b"k", b"v0")  # it lands
            got.append((len(pulls), mine.next_offset))
        if pkg == "ref":
            assert got == [(1, 1), (1, 1), (2, 2), (2, 2)]
        else:
            assert got == [(0, 1), (0, 1), (0, 1), (1, 2)]
        assert [m.value for m in mine.read(0, 10)] == [b"v0", b"v2"]
    finally:
        s.close()


class EpochMaster:
    """A stand-in master on the test's loop: the cluster registry the
    brokers register with, and `/cluster/mq/epoch` issuing 1, 2, ... in
    the order requests arrive, the first answer held back `hold` s."""

    def __init__(self, loop_run, hold=0.5):
        from aiohttp import web
        self.members: set = set()
        self.issued = 0
        self.hold = hold
        app = web.Application()

        async def register(req):
            self.members.add((await req.json())["address"])
            return web.json_response({})

        async def status(req):
            return web.json_response(
                {"Members": {"broker": sorted(self.members)}})

        async def epoch(req):
            self.issued += 1
            mine = self.issued
            if mine == 1:
                await asyncio.sleep(self.hold)
            return web.json_response({"epoch": mine})
        app.add_routes([web.post("/cluster/register", register),
                        web.get("/cluster/status", status),
                        web.post("/cluster/mq/epoch", epoch)])
        self.runner = web.AppRunner(app)
        self.port = free_port()
        self.url = f"127.0.0.1:{self.port}"
        loop_run(self.runner.setup())
        loop_run(web.TCPSite(self.runner, "127.0.0.1", self.port).start())


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_first_publishes_share_one_epoch_unlike_the_reference(tmp_path,
                                                             pkg):
    """Two publishes to a fresh partition at once, behind a master whose
    first epoch answer (1) comes after its second (2).  The reference's
    publishes each fetch an epoch: the second appends and replicates
    under 2, the first then appends under 1 and the follower fences it
    (403), so the client gets 503 for a message already in the owner's
    log.  The port's publishes share the first fetch: both go through
    under 1."""
    c = Cluster(tmp_path, n_volume_servers=1).start()
    brokers, em = [], None
    try:
        em = EpochMaster(c.submit)
        brokers = [broker_cls(pkg)(em.url, port=free_port(),
                                   peer_refresh=0.3) for _ in range(2)]
        for b in brokers:
            c.submit(b.start())
        until(lambda: settled(brokers), "both brokers in one ring")
        owner, follower = sorted(brokers, key=lambda b: b.url)
        assert req(f"http://{owner.url}/topics/configure", "POST",
                   json.dumps({"topic": "e.one",
                               "partition_count": 1}).encode())[0] == 200
        answers: dict = {}

        def pub(i):
            answers[i] = req(f"http://{owner.url}/pub?topic=e.one&key=k",
                             "POST", b"m%d" % i)[:2]
        first = threading.Thread(target=pub, args=(0,))
        first.start()
        time.sleep(0.2)  # the first waits for its epoch
        pub(1)
        first.join(30)
        log = owner._get_topic("e.one")[0].read(0, 10)
        if pkg == "ref":
            assert em.issued == 2
            assert answers[1][0] == 200 and answers[0][0] == 503
            assert b"fenced" in answers[0][1]
            assert [m.value for m in log] == [b"m1", b"m0"]
        else:
            assert em.issued == 1
            assert [a[0] for a in answers.values()] == [200, 200]
            assert sorted(m.value for m in log) == [b"m0", b"m1"]
            assert [m.value for m in follower._get_topic("e.one")[0]
                    .read(0, 10)] == [m.value for m in log]
    finally:
        for b in brokers:
            c.submit(b.stop())
        if em is not None:
            c.submit(em.runner.cleanup())
        c.stop()
