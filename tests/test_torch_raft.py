"""The port's raft (seaweedfs_tpu_torch/topology/raft.py) and its HA
masters, held to the reference's.

Twins of tests/test_raft.py's seven tests on the port's `RaftNode` and
`MasterServer`, then mixed groups: a reference node with two port nodes
over an in-memory transport, and a reference master with two port
masters over HTTP.  Each must elect one leader, replicate `set_max_vid`
and, for the masters, answer a follower's 409 with that leader.  A state
file written by either package loads in the other.

Deadlines are the reference tests' (15-20 s for a leader), and every
read of "who leads" sits in a settle loop: the tier-1 run shares the
host's cores among six workers.
"""

import asyncio
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest

from seaweedfs_tpu.server import master as ref_master
from seaweedfs_tpu.topology import raft as ref_raft

from seaweedfs_tpu_torch.server import master as mastermod
from seaweedfs_tpu_torch.server import volume_server as vsmod
from seaweedfs_tpu_torch.topology import raft
from seaweedfs_tpu_torch.topology.raft import RaftConfig, RaftNode


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Net:
    """In-memory transport connecting raft nodes of either package by id,
    with partitions."""

    def __init__(self):
        self.nodes: dict = {}
        self.down: set[str] = set()

    def transport_for(self, caller: str):
        def transport(peer: str, rpc: str, payload: dict):
            # symmetric partition: a downed node can neither be reached
            # nor reach anyone
            if peer in self.down or caller in self.down:
                return None
            node = self.nodes.get(peer)
            if node is None:
                return None
            # a JSON round trip, as over HTTP: the packages share only
            # the wire
            payload = json.loads(json.dumps(payload))
            handler = {"request_vote": node.handle_request_vote,
                       "append_entries": node.handle_append_entries,
                       "install_snapshot": node.handle_install_snapshot
                       }.get(rpc)
            return None if handler is None else \
                json.loads(json.dumps(handler(payload)))
        return transport


def make_cluster(n=3, tmp_path=None, mods=None):
    """n nodes, node i of package `mods[i]` (the port's by default)."""
    mods = mods or [raft] * n
    net = Net()
    ids = [f"n{i}" for i in range(n)]
    applied = {i: [] for i in ids}
    nodes = []
    for nid, mod in zip(ids, mods):
        cfg = mod.RaftConfig(
            node_id=nid, peers=[p for p in ids if p != nid],
            election_timeout_ms=(80, 160), heartbeat_ms=25,
            state_path=str(tmp_path / f"{nid}.json") if tmp_path else None)
        node = mod.RaftNode(cfg, net.transport_for(nid),
                            apply_command=applied[nid].append)
        net.nodes[nid] = node
        nodes.append(node)
    return net, nodes, applied


def wait_leader(nodes, timeout=20.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        leaders = [n for n in nodes if n.is_leader]
        if len(leaders) == 1:
            return leaders[0]
        time.sleep(0.02)
    raise TimeoutError("no single leader elected")


def wait_applied(applied, ids, want, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if all(applied[i] == want for i in ids):
            return
        time.sleep(0.02)
    assert {i: applied[i] for i in ids} == {i: want for i in ids}


# ---- twins of tests/test_raft.py -------------------------------------------

def test_election_and_replication(tmp_path):
    net, nodes, applied = make_cluster(3, tmp_path)
    for n in nodes:
        n.start()
    try:
        leader = wait_leader(nodes)
        assert leader.propose({"op": "set_max_vid", "vid": 1})
        assert leader.propose({"op": "set_max_vid", "vid": 2})
        wait_applied(applied, list(applied), [
            {"op": "set_max_vid", "vid": 1},
            {"op": "set_max_vid", "vid": 2}])
    finally:
        for n in nodes:
            n.stop()


def test_leader_failover_and_log_convergence(tmp_path):
    net, nodes, applied = make_cluster(3, tmp_path)
    for n in nodes:
        n.start()
    try:
        leader = wait_leader(nodes)
        assert leader.propose({"op": "set_max_vid", "vid": 10})
        # partition the leader away
        net.down.add(leader.cfg.node_id)
        survivors = [n for n in nodes if n is not leader]
        new_leader = wait_leader(survivors)
        assert new_leader is not leader
        assert new_leader.propose({"op": "set_max_vid", "vid": 11})
        # heal: the old leader steps down and catches up
        net.down.clear()
        deadline = time.time() + 10
        while time.time() < deadline:
            cmds = applied[leader.cfg.node_id]
            if {"op": "set_max_vid", "vid": 11} in cmds and \
                    sum(1 for n in nodes if n.is_leader) == 1:
                break
            time.sleep(0.02)
        assert {"op": "set_max_vid", "vid": 11} in applied[leader.cfg.node_id]
        assert sum(1 for n in nodes if n.is_leader) == 1
    finally:
        for n in nodes:
            n.stop()


def test_minority_cannot_commit(tmp_path):
    net, nodes, applied = make_cluster(3, tmp_path)
    for n in nodes:
        n.start()
    try:
        leader = wait_leader(nodes)
        others = [n.cfg.node_id for n in nodes if n is not leader]
        net.down.update(others)  # the leader is now isolated, no quorum
        assert not leader.propose({"op": "set_max_vid", "vid": 99},
                                  timeout=1.0)
        assert all({"op": "set_max_vid", "vid": 99} not in cmds
                   for cmds in applied.values())
    finally:
        for n in nodes:
            n.stop()


def test_state_persistence(tmp_path):
    net, nodes, applied = make_cluster(1, tmp_path)
    n = nodes[0]
    n.start()
    try:
        wait_leader([n])
        assert n.propose({"op": "set_max_vid", "vid": 5})
    finally:
        n.stop()
    cfg = RaftConfig(node_id="n0", peers=[],
                     state_path=str(tmp_path / "n0.json"))
    replayed = []
    n2 = RaftNode(cfg, lambda *a: None, apply_command=replayed.append)
    assert [e.command for e in n2.log] == [{"op": "set_max_vid", "vid": 5}]
    assert n2.current_term >= 1


def _toy(net, ids, state, nid, mod=raft, threshold=20, path=None):
    """A node whose state machine is a running sum (snapshots are it)."""
    cfg = mod.RaftConfig(
        node_id=nid, peers=[p for p in ids if p != nid],
        election_timeout_ms=(80, 160), heartbeat_ms=25,
        state_path=str(path / f"{nid}.json") if path else None,
        snapshot_threshold=threshold)

    def apply(cmd):
        state[nid]["sum"] += cmd["add"]

    node = mod.RaftNode(cfg, net.transport_for(nid), apply_command=apply,
                        take_snapshot=lambda: dict(state[nid]),
                        restore_snapshot=lambda d: state[nid].update(d))
    net.nodes[nid] = node
    return node


def test_snapshot_compaction_and_restart(tmp_path):
    net = Net()
    ids = ["n0", "n1", "n2"]
    state = {i: {"sum": 0} for i in ids}
    nodes = [_toy(net, ids, state, i, path=tmp_path) for i in ids]
    for n in nodes:
        n.start()
    try:
        leader = wait_leader(nodes)
        total = 0
        for i in range(60):
            assert leader.propose({"add": i}, timeout=10.0)
            total += i
        deadline = time.time() + 10
        while time.time() < deadline and any(
                state[i]["sum"] != total for i in ids):
            time.sleep(0.02)
        assert all(state[i]["sum"] == total for i in ids)
        deadline = time.time() + 5
        while time.time() < deadline and leader.snap_index < 0:
            time.sleep(0.02)
        assert leader.snap_index >= 0
        assert len(leader.log) < 60
        # restart one follower from disk: snapshot + tail replay
        victim = next(n for n in nodes if not n.is_leader)
        vid = victim.cfg.node_id
        victim.stop()
        net.down.add(vid)
        time.sleep(0.2)
        state[vid] = {"sum": 0}
        net.down.discard(vid)
        revived = _toy(net, ids, state, vid, path=tmp_path)
        nodes.append(revived)
        revived.start()
        deadline = time.time() + 10
        while time.time() < deadline and state[vid]["sum"] != total:
            time.sleep(0.02)
        assert state[vid]["sum"] == total
    finally:
        for n in nodes:
            n.stop()


def test_fresh_follower_catches_up_via_install_snapshot(tmp_path):
    net = Net()
    ids = ["n0", "n1", "n2"]
    state = {i: {"sum": 0} for i in ids}
    net.down.add("n2")  # n2 stays dark while the others commit + compact
    nodes = [_toy(net, ids, state, i, threshold=10) for i in ids]
    for n in nodes[:2]:
        n.start()
    try:
        leader = wait_leader(nodes[:2])
        total = 0
        for i in range(40):
            assert leader.propose({"add": i}, timeout=10.0)
            total += i
        deadline = time.time() + 5
        while time.time() < deadline and leader.snap_index < 0:
            time.sleep(0.02)
        assert leader.snap_index >= 0, "leader never compacted"
        net.down.discard("n2")
        nodes[2].start()
        deadline = time.time() + 10
        while time.time() < deadline and state["n2"]["sum"] != total:
            time.sleep(0.02)
        assert state["n2"]["sum"] == total
        assert nodes[2].snap_index >= 0  # arrived via snapshot, not replay
    finally:
        for n in nodes:
            n.stop()


# ---- masters over HTTP -----------------------------------------------------

class MasterGroup:
    """Three masters with raft on one loop thread; `mods[i]` picks the
    package of master i."""

    def __init__(self, tmp_path, mods):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        ports = [free_port() for _ in mods]
        self.peers = [f"127.0.0.1:{p}" for p in ports]
        self.masters = [mod.MasterServer("127.0.0.1", p, peers=self.peers,
                                         raft_state_dir=str(tmp_path /
                                                            "raft"))
                        for mod, p in zip(mods, ports)]
        for m in self.masters:
            self.run(m.start())

    def run(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(60)

    def settled(self, timeout=15.0):
        """(leader, a follower) once one master leads and the follower's
        /cluster/status names it: a re-election can still move the crown
        right after convergence, so both are read again until they agree."""
        deadline = time.time() + timeout
        st: dict = {}
        while time.time() < deadline:
            leaders = [m for m in self.masters if m.is_leader]
            if len(leaders) == 1:
                leader = leaders[0]
                follower = next(m for m in self.masters if m is not leader)
                st = json.load(urllib.request.urlopen(
                    f"http://{follower.url}/cluster/status", timeout=5))
                if st["IsLeader"] is False and st["Leader"] == leader.url:
                    return leader, follower
            time.sleep(0.05)
        raise AssertionError(f"no settled leader: {st}")

    def stop(self):
        for m in self.masters:
            self.run(m.stop())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(5)


def _follower_refuses(follower, leader):
    for path in ("/dir/assign?count=1", "/dir/lookup?volumeId=999",
                 "/dir/ec/lookup?volumeId=999"):
        try:
            urllib.request.urlopen(f"http://{follower.url}{path}",
                                   timeout=5)
            raise AssertionError(f"follower answered {path}")
        except urllib.error.HTTPError as e:
            body = json.loads(e.read())
            assert e.code == 409 and body == {
                "error": "not the leader", "leader": leader.url}, path


def _ha_flow(group, tmp_path):
    """The reference's test_master_ha_cluster steps on `group`: a port
    volume server pointed at a follower finds the leader, an assign
    allocates a vid every master learns, a follower answers 409."""
    leader, follower = group.settled()
    (tmp_path / "v").mkdir(exist_ok=True)
    vs = vsmod.VolumeServer([str(tmp_path / "v")],
                            ",".join(group.peers[::-1]), port=free_port(),
                            heartbeat_interval=0.2, device="cpu")
    group.run(vs.start())
    try:
        deadline = time.time() + 15
        while time.time() < deadline:
            leader, follower = group.settled()
            if leader.topo.nodes:
                break
            time.sleep(0.1)
        assert leader.topo.nodes, "volume server never reached the leader"
        assert vs._wire_pb is True
        a = json.load(urllib.request.urlopen(
            f"http://{leader.url}/dir/assign?count=1", timeout=10))
        assert "fid" in a, a
        vid = int(a["fid"].split(",")[0])
        deadline = time.time() + 10
        while time.time() < deadline:
            if all(m.topo.max_volume_id >= vid for m in group.masters):
                break
            time.sleep(0.05)
        assert all(m.topo.max_volume_id >= vid for m in group.masters)
        leader, follower = group.settled()
        _follower_refuses(follower, leader)
        st = json.load(urllib.request.urlopen(
            f"http://{leader.url}/raft/status", timeout=5))
        assert st["state"] == "leader" and st["node_id"] == leader.url
        assert sorted(st["peers"]) == sorted(
            p for p in group.peers if p != leader.url)
        return vid
    finally:
        group.run(vs.stop())


def test_master_ha_cluster(tmp_path, monkeypatch):
    """Three port masters with raft; assigns go to the leader; a follower
    names the leader; vid allocations replicate."""
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "0")
    group = MasterGroup(tmp_path, [mastermod] * 3)
    try:
        _ha_flow(group, tmp_path)
    finally:
        group.stop()


# ---- mixed groups ----------------------------------------------------------

@pytest.mark.parametrize("ref_at", [0, 2])
def test_mixed_group_elects_and_replicates(tmp_path, ref_at):
    """One reference node and two port nodes: one leader, every command
    applied on every node in order, then a failover among the rest."""
    mods = [raft, raft, raft]
    mods[ref_at] = ref_raft
    net, nodes, applied = make_cluster(3, tmp_path, mods)
    for n in nodes:
        n.start()
    try:
        leader = wait_leader(nodes)
        want = []
        for v in (1, 2, 3):
            assert leader.propose({"op": "set_max_vid", "vid": v})
            want.append({"op": "set_max_vid", "vid": v})
        wait_applied(applied, list(applied), want)
        net.down.add(leader.cfg.node_id)
        survivors = [n for n in nodes if n is not leader]
        new_leader = wait_leader(survivors)
        assert new_leader.propose({"op": "set_max_vid", "vid": 4})
        want.append({"op": "set_max_vid", "vid": 4})
        net.down.clear()
        wait_applied(applied, list(applied), want)
        assert sum(1 for n in nodes if n.is_leader) == 1
    finally:
        for n in nodes:
            n.stop()


def test_mixed_master_group_over_http(tmp_path, monkeypatch):
    """One reference master and two port masters share one raft group
    over /raft/*: one leader, a grown vid on every master, and each
    follower's 409 names that leader."""
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "0")
    group = MasterGroup(tmp_path, [mastermod, ref_master, mastermod])
    try:
        vid = _ha_flow(group, tmp_path)
        leader, _ = group.settled()
        for m in group.masters:
            if m is not leader:
                _follower_refuses(m, leader)
        # the leader's raft log holds the vid in the reference's form
        assert {"op": "set_max_vid", "vid": vid} in \
            [e.command for e in leader.raft.log] or \
            leader.raft.snap_index >= 0
    finally:
        group.stop()


@pytest.mark.parametrize("writer,reader", [(ref_raft, raft),
                                           (raft, ref_raft)])
def test_state_file_crosses_packages(tmp_path, writer, reader):
    """A state file written by one package, compacted or not, loads in
    the other: term, vote, log, snapshot and runtime peers."""
    state = {"n0": {"sum": 0}}
    net = Net()
    node = _toy(net, ["n0"], state, "n0", mod=writer, threshold=5,
                path=tmp_path)
    node.start()
    try:
        wait_leader([node])
        for i in range(8):
            assert node.propose({"add": i})
        deadline = time.time() + 5
        while time.time() < deadline and node.snap_index < 0:
            time.sleep(0.02)
        node.add_peer("127.0.0.1:1")
    finally:
        node.stop()
    raw = json.loads((tmp_path / "n0.json").read_text())
    assert sorted(raw) == ["log", "peers", "snap_index", "snap_term",
                           "snapshot", "term", "voted_for"]
    restored = {}
    cfg = reader.RaftConfig(node_id="n0", peers=[],
                            state_path=str(tmp_path / "n0.json"))
    again = reader.RaftNode(cfg, lambda *a: None, apply_command=None,
                            restore_snapshot=restored.update)
    assert (again.current_term, again.voted_for, again.snap_index,
            again.snap_term) == (node.current_term, node.voted_for,
                                 node.snap_index, node.snap_term)
    assert [e.to_dict() for e in again.log] == \
        [e.to_dict() for e in node.log]
    assert again.cfg.peers == ["127.0.0.1:1"]
    assert restored == node._snapshot_data and restored["sum"] >= 0
    assert again.commit_index == again.last_applied == node.snap_index


def test_election_timeouts_draw_from_the_nodes_generator():
    a = RaftNode(RaftConfig("a"), lambda *x: None, apply_command=None)
    b = RaftNode(RaftConfig("b"), lambda *x: None, apply_command=None)
    a.rng.seed(11)
    b.rng.seed(11)
    draws = [a._election_timeout() for _ in range(5)]
    assert draws == [b._election_timeout() for _ in range(5)]
    assert all(0.15 <= d <= 0.3 for d in draws)
    assert len(set(draws)) == 5
