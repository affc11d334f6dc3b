"""Raft consensus for master HA.

Counterpart of `seaweedfs_tpu/topology/raft.py`, whole.  Every RPC body
and reply is the reference's dict key for key, and the state file
(`raft_{port}.json`) has the reference's format, so port and reference
masters share one group and either package restarts from the other's
file.  The one difference: each node draws its election timeouts from
its own `random.Random` (`RaftNode.rng`), where the reference draws from
the `random` module.

Reference: weed/server/raft_server.go + raft_hashicorp.go — the reference
runs Raft among masters to elect a leader and replicate the topology's
max volume id; followers redirect clients to the leader.  This is a
compact but real Raft: randomized election timeouts, RequestVote /
AppendEntries over the transport callable, log replication with
commit-on-majority, and durable (term, voted_for, log) state.

The state machine here replicates the only hard state the reference
master persists: volume-id allocations (MaxVolumeId) and admin-lock
transitions.  Heartbeat-derived topology is soft state and rebuilt by
volume servers re-reporting, exactly as in the reference.

Robustness under CPU contention (this was a measured flake source):
 - one long-lived replicator thread per peer batches appends and doubles
   as the heartbeat, instead of spawning a thread per peer per 50ms tick
 - pre-vote (raft §9.6 / hashicorp raft PreVote): a node that missed
   heartbeats polls peers WITHOUT bumping its term first; peers that have
   heard from a live leader recently refuse, so a starved node cannot
   depose a healthy leader with a higher term
 - propose() blocks on a condition, not a poll loop
 - runtime membership changes persist with the raft state, so a restart
   keeps the operated-in peer set rather than reverting to CLI flags
"""

from __future__ import annotations

import json
import logging
import os
import random
import threading
import time
from dataclasses import dataclass, field

log = logging.getLogger("raft")

FOLLOWER, CANDIDATE, LEADER = "follower", "candidate", "leader"


@dataclass
class LogEntry:
    term: int
    command: dict

    def to_dict(self) -> dict:
        return {"term": self.term, "command": self.command}


@dataclass
class RaftConfig:
    node_id: str
    peers: list[str] = field(default_factory=list)  # excludes self
    election_timeout_ms: tuple[int, int] = (150, 300)
    heartbeat_ms: int = 50
    state_path: str | None = None
    # compact the log into a state-machine snapshot once this many applied
    # entries accumulate (reference: raft_hashicorp.go snapshots; without
    # this an admin-lock-churning master replays an unbounded log at boot)
    snapshot_threshold: int = 1000


class RaftNode:
    """`transport(peer, rpc_name, payload) -> response dict | None` is
    injected (the master wires it to HTTP POST /raft/<rpc>)."""

    def __init__(self, config: RaftConfig, transport,
                 apply_command, on_leadership_change=None,
                 take_snapshot=None, restore_snapshot=None):
        self.cfg = config
        self.transport = transport
        self.apply_command = apply_command
        self.on_leadership_change = on_leadership_change or (lambda l: None)
        # state-machine hooks for log compaction: take_snapshot() -> dict
        # captures applied state; restore_snapshot(dict) reinstates it
        self.take_snapshot = take_snapshot
        self.restore_snapshot = restore_snapshot

        self.state = FOLLOWER
        self.current_term = 0
        self.voted_for: str | None = None
        # self.log holds entries AFTER the snapshot; absolute index i lives
        # at position i - snap_index - 1
        self.log: list[LogEntry] = []
        self.snap_index = -1   # last absolute index covered by the snapshot
        self.snap_term = 0
        self._snapshot_data: dict | None = None
        self.commit_index = -1
        self.last_applied = -1
        self.leader_id: str | None = None

        self.next_index: dict[str, int] = {}
        self.match_index: dict[str, int] = {}

        self._lock = threading.RLock()
        self._apply_cv = threading.Condition(self._lock)
        self._repl_cv = threading.Condition(self._lock)
        self._replicators: dict[str, threading.Thread] = {}
        self._last_sent: dict[str, float] = {}
        # log slots awaited by in-flight propose() calls: compaction skips
        # them so the committed-in-our-term check can always run (without
        # this a fast compaction makes commitment unverifiable and the
        # proposer would re-propose a possibly-applied command)
        self._pending_proposals: set[int] = set()
        # serializes apply_command batches against snapshot restores so a
        # restored snapshot can never be followed by re-application of
        # entries it already covers (double-apply)
        self._apply_mu = threading.Lock()
        self._restored_through = -1
        self._stop = threading.Event()
        self._last_heartbeat = time.monotonic()
        self._threads: list[threading.Thread] = []
        self.rng = random.Random()  # election timeouts
        self._load_state()

    # -- persistence ----------------------------------------------------

    def _load_state(self) -> None:
        p = self.cfg.state_path
        if not p or not os.path.exists(p):
            return
        try:
            with open(p) as f:
                d = json.load(f)
            self.current_term = d.get("term", 0)
            self.voted_for = d.get("voted_for")
            self.log = [LogEntry(e["term"], e["command"])
                        for e in d.get("log", [])]
            self.snap_index = d.get("snap_index", -1)
            self.snap_term = d.get("snap_term", 0)
            self._snapshot_data = d.get("snapshot")
            if "peers" in d:
                # runtime membership changes survive a restart (the
                # reference persists configuration through the raft log)
                self.cfg.peers = list(d["peers"])
        except (OSError, ValueError):
            log.warning("raft state load failed; starting fresh")
            return
        if self.snap_index >= 0:
            # snapshot state is committed by definition: reinstate it and
            # resume applying from the log tail
            if self.restore_snapshot and self._snapshot_data is not None:
                self.restore_snapshot(self._snapshot_data)
            self.commit_index = self.snap_index
            self.last_applied = self.snap_index
            self._restored_through = self.snap_index

    def _save_state(self) -> None:
        p = self.cfg.state_path
        if not p:
            return
        tmp = p + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"term": self.current_term, "voted_for": self.voted_for,
                       "log": [e.to_dict() for e in self.log],
                       "snap_index": self.snap_index,
                       "snap_term": self.snap_term,
                       "snapshot": self._snapshot_data,
                       "peers": self.cfg.peers}, f)
        os.replace(tmp, p)

    # -- index math (absolute <-> log position) --------------------------

    def _last_index_locked(self) -> int:
        return self.snap_index + len(self.log)

    def _term_at_locked(self, abs_idx: int) -> int:
        if abs_idx == self.snap_index:
            return self.snap_term
        if abs_idx < self.snap_index:
            return 0  # inside the snapshot: term unknown, never needed
        return self.log[abs_idx - self.snap_index - 1].term

    def _entry_at_locked(self, abs_idx: int) -> LogEntry:
        return self.log[abs_idx - self.snap_index - 1]

    # -- lifecycle ------------------------------------------------------

    def start(self) -> None:
        for target in (self._election_loop, self._apply_loop):
            th = threading.Thread(target=target, daemon=True,
                                  name=f"raft-{target.__name__}")
            th.start()
            self._threads.append(th)
        with self._lock:
            self._ensure_replicators_locked()

    def stop(self) -> None:
        self._stop.set()
        with self._apply_cv:
            self._apply_cv.notify_all()
            self._repl_cv.notify_all()

    @property
    def is_leader(self) -> bool:
        with self._lock:
            return self.state == LEADER

    @staticmethod
    def quorum_of(n_peers: int) -> int:
        """Majority of (n_peers + self)."""
        return (n_peers + 1) // 2 + 1

    def quorum(self) -> int:
        return self.quorum_of(len(self.cfg.peers))

    # -- election -------------------------------------------------------

    def _election_timeout(self) -> float:
        lo, hi = self.cfg.election_timeout_ms
        return self.rng.uniform(lo, hi) / 1000.0

    def _election_loop(self) -> None:
        timeout = self._election_timeout()
        while not self._stop.is_set():
            time.sleep(0.01)
            with self._lock:
                if self.state == LEADER:
                    continue  # replicator threads carry the heartbeats
                elapsed = time.monotonic() - self._last_heartbeat
            if elapsed >= timeout:
                self._run_election()
                timeout = self._election_timeout()

    def _collect_votes(self, term: int, last_idx: int, last_term: int,
                       pre: bool, peers: list[str]) -> int | None:
        """One voting round over a membership SNAPSHOT taken under the lock
        by the caller (add_peer/remove_peer mutate cfg.peers in place — an
        unlocked iteration could skip a peer or tally against a different
        quorum denominator than it polled); -> granted count, or None if a
        higher term was observed (we stepped down)."""
        votes = 1
        for peer in peers:
            payload = {"term": term, "candidate_id": self.cfg.node_id,
                       "last_log_index": last_idx,
                       "last_log_term": last_term}
            if pre:
                payload["pre"] = True
            resp = self.transport(peer, "request_vote", payload)
            if resp is None:
                continue
            with self._lock:
                if resp.get("term", 0) > self.current_term:
                    self._become_follower(resp["term"], None)
                    return None
            if resp.get("vote_granted"):
                votes += 1
        return votes

    def _run_election(self) -> None:
        with self._lock:
            term = self.current_term + 1
            last_idx = self._last_index_locked()
            last_term = self._term_at_locked(last_idx) if last_idx >= 0 else 0
            # snapshot membership + quorum size for the whole election: the
            # fan-out and the majority check must see the same peer set
            peers = list(self.cfg.peers)
            quorum = self.quorum_of(len(peers))
        if peers:
            # pre-vote round: probe electability WITHOUT bumping the term.
            # Peers in contact with a live leader refuse, so a CPU-starved
            # or partitioned node rejoining cannot disrupt a stable quorum.
            votes = self._collect_votes(term, last_idx, last_term, pre=True,
                                        peers=peers)
            if votes is None or votes < quorum:
                with self._lock:
                    # back off a full election timeout before re-probing,
                    # or a partitioned node pre-vote-storms every peer
                    self._last_heartbeat = time.monotonic()
                return
        with self._lock:
            if self.current_term >= term or self.state == LEADER:
                # a concurrent RPC moved the term (or elected us) while
                # the lock was released for the pre-vote round; bumping
                # current_term DOWN here would reset voted_for and allow
                # a double vote in the newer term
                return
            self.state = CANDIDATE
            self.current_term = term
            self.voted_for = self.cfg.node_id
            self._save_state()
            self._last_heartbeat = time.monotonic()
        votes = self._collect_votes(term, last_idx, last_term, pre=False,
                                    peers=peers)
        if votes is None:
            return
        with self._lock:
            if self.state != CANDIDATE or self.current_term != term:
                return
            if votes >= quorum:
                self.state = LEADER
                self.leader_id = self.cfg.node_id
                n = self._last_index_locked() + 1
                self.next_index = {p: n for p in self.cfg.peers}
                self.match_index = {p: -1 for p in self.cfg.peers}
                log.info("%s elected leader for term %d (%d votes)",
                         self.cfg.node_id, term, votes)
                self._ensure_replicators_locked()
                self._repl_cv.notify_all()
                self.on_leadership_change(True)

    def _become_follower(self, term: int, leader: str | None) -> None:
        was_leader = self.state == LEADER
        self.state = FOLLOWER
        self.current_term = term
        self.voted_for = None
        if leader:
            self.leader_id = leader
        self._save_state()
        self._last_heartbeat = time.monotonic()
        self._apply_cv.notify_all()  # wake proposers blocked on commit
        if was_leader:
            self.on_leadership_change(False)

    # -- runtime membership (persisted with the raft state) --------------

    def add_peer(self, peer: str) -> None:
        with self._lock:
            if peer == self.cfg.node_id or peer in self.cfg.peers:
                return
            self.cfg.peers.append(peer)
            self.next_index[peer] = self._last_index_locked() + 1
            self.match_index[peer] = -1
            self._ensure_replicators_locked()
            self._save_state()

    def remove_peer(self, peer: str) -> None:
        with self._lock:
            if peer not in self.cfg.peers:
                return
            self.cfg.peers.remove(peer)
            self.next_index.pop(peer, None)
            self.match_index.pop(peer, None)
            self._save_state()
            self._repl_cv.notify_all()  # its replicator thread exits

    # -- replication ----------------------------------------------------

    def _ensure_replicators_locked(self) -> None:
        """One long-lived batching replicator thread per peer: it IS the
        heartbeat (empty batch when idle), and proposals just wake it —
        no thread churn per tick, which matters under CPU contention."""
        for peer in self.cfg.peers:
            th = self._replicators.get(peer)
            if th is not None and th.is_alive():
                continue
            th = threading.Thread(target=self._replicator, args=(peer,),
                                  daemon=True, name=f"raft-repl-{peer}")
            self._replicators[peer] = th
            th.start()

    def _replicator(self, peer: str) -> None:
        hb = self.cfg.heartbeat_ms / 1000.0
        while not self._stop.is_set():
            with self._lock:
                if peer not in self.cfg.peers:
                    self._replicators.pop(peer, None)
                    return
                if self.state != LEADER:
                    self._repl_cv.wait(0.2)
                    continue
                term = self.current_term
                due = self._last_sent.get(peer, 0.0) + hb - time.monotonic()
                pending = self._last_index_locked() >= \
                    self.next_index.get(peer, 0)
                if due > 0 and not pending:
                    self._repl_cv.wait(due)
                    if self.state != LEADER or \
                            (time.monotonic() <
                             self._last_sent.get(peer, 0.0) + hb and
                             self._last_index_locked() <
                             self.next_index.get(peer, 0)):
                        continue
                    term = self.current_term
                self._last_sent[peer] = time.monotonic()
            try:
                self._replicate_to(peer, term)
            except Exception:
                # the thread is this peer's ONLY replication channel — an
                # exception (e.g. an index race during truncation) must
                # never kill it
                log.exception("replication to %s failed", peer)

    def _replicate_to(self, peer: str, term: int) -> None:
        with self._lock:
            if self.state != LEADER or self.current_term != term:
                return
            ni = self.next_index.get(peer, self._last_index_locked() + 1)
            if ni <= self.snap_index:
                # peer lags behind the compacted log: ship the snapshot
                # (InstallSnapshot, raft §7) and retry entries after it
                payload = {
                    "term": term, "leader_id": self.cfg.node_id,
                    "last_included_index": self.snap_index,
                    "last_included_term": self.snap_term,
                    "data": self._snapshot_data}
                rpc = "install_snapshot"
            else:
                prev_idx = ni - 1
                prev_term = self._term_at_locked(prev_idx) \
                    if prev_idx >= 0 else 0
                entries = [e.to_dict()
                           for e in self.log[ni - self.snap_index - 1:]]
                payload = {
                    "term": term, "leader_id": self.cfg.node_id,
                    "prev_log_index": prev_idx, "prev_log_term": prev_term,
                    "entries": entries, "leader_commit": self.commit_index}
                rpc = "append_entries"
        resp = self.transport(peer, rpc, payload)
        if resp is None:
            return
        with self._lock:
            if resp.get("term", 0) > self.current_term:
                self._become_follower(resp["term"], None)
                return
            if self.state != LEADER or self.current_term != term:
                return
            # monotonic guard: overlapping in-flight RPCs mean a stale
            # response can arrive late — match_index must never regress
            # below already-acknowledged entries
            if rpc == "install_snapshot":
                if resp.get("success"):
                    self.match_index[peer] = max(
                        self.match_index.get(peer, -1),
                        payload["last_included_index"])
                    self.next_index[peer] = self.match_index[peer] + 1
                return
            if resp.get("success"):
                self.match_index[peer] = max(
                    self.match_index.get(peer, -1),
                    payload["prev_log_index"] + len(payload["entries"]))
                self.next_index[peer] = self.match_index[peer] + 1
                self._advance_commit_locked()
            else:
                self.next_index[peer] = max(self.snap_index + 1,
                                            self.match_index.get(peer, -1)
                                            + 1, ni - 1)

    def _advance_commit_locked(self) -> None:
        for n in range(self._last_index_locked(), self.commit_index, -1):
            if self._term_at_locked(n) != self.current_term:
                continue
            count = 1 + sum(1 for p in self.cfg.peers
                            if self.match_index.get(p, -1) >= n)
            if count >= self.quorum():
                self.commit_index = n
                self._apply_cv.notify_all()
                break

    def _apply_loop(self) -> None:
        while not self._stop.is_set():
            with self._apply_cv:
                while self.last_applied >= self.commit_index and \
                        not self._stop.is_set():
                    self._apply_cv.wait(0.2)
                if self._stop.is_set():
                    return
                start = self.last_applied + 1
                end = self.commit_index
                to_apply = [(i, self._entry_at_locked(i))
                            for i in range(start, end + 1)]
                self.last_applied = end
            with self._apply_mu:
                for i, entry in to_apply:
                    if i <= self._restored_through:
                        continue  # a restored snapshot already covers it
                    try:
                        self.apply_command(entry.command)
                    except Exception:
                        log.exception("apply failed at index %d", i)
            with self._lock:
                self._maybe_compact_locked()

    def _maybe_compact_locked(self) -> None:
        """Fold applied entries into a state-machine snapshot and truncate
        the log (reference analogue: raft_hashicorp.go snapshot config)."""
        if self.take_snapshot is None:
            return
        if len(self.log) < self.cfg.snapshot_threshold:
            return
        upto = self.last_applied
        if self._pending_proposals and min(self._pending_proposals) <= upto:
            # a snapshot can only be cut exactly at last_applied (that is
            # what take_snapshot() captures) — so while a proposer still
            # needs its slot's term for the commit check, DEFER compaction
            # entirely rather than mislabel the snapshot's coverage
            return
        if upto <= self.snap_index:
            return
        data = self.take_snapshot()
        term = self._term_at_locked(upto)
        self.log = self.log[upto - self.snap_index:]
        self.snap_index = upto
        self.snap_term = term
        self._snapshot_data = data
        self._save_state()
        log.info("%s compacted log through index %d (%d entries remain)",
                 self.cfg.node_id, upto, len(self.log))

    # -- client API -----------------------------------------------------

    def propose(self, command: dict, timeout: float = 5.0) -> bool:
        """Leader-only: append + replicate + wait for commit.

        Survives leadership churn within the window: if this node is
        deposed mid-flight it waits for a re-election; the entry counts
        as committed only if the slot it was appended to still carries
        the term it was appended in (the standard client check), and is
        re-appended after a re-election when a competing leader's log
        truncated it away."""
        deadline = time.monotonic() + timeout
        with self._lock:
            if self.state != LEADER:
                return False
            index: int | None = None
            append_term = 0
            try:
                while time.monotonic() < deadline and \
                        not self._stop.is_set():
                    if index is None and self.state == LEADER:
                        self.log.append(LogEntry(self.current_term,
                                                 command))
                        self._save_state()
                        index = self._last_index_locked()
                        append_term = self.current_term
                        self._pending_proposals.add(index)
                        if not self.cfg.peers:  # single-node: instant
                            self.commit_index = index
                            self._apply_cv.notify_all()
                        else:
                            self._repl_cv.notify_all()
                    if index is not None and self.commit_index >= index:
                        if index > self.snap_index and \
                                self._term_at_locked(index) == append_term:
                            return True
                        # our slot was overwritten by a competing leader
                        # (or covered by ITS InstallSnapshot): commitment
                        # of OUR command is unverifiable — re-propose
                        # (at-least-once; master commands tolerate it)
                        self._pending_proposals.discard(index)
                        index = None
                        continue
                    if index is not None and self.state != LEADER and \
                            self._last_index_locked() < index:
                        # deposed AND our tail was truncated: re-append
                        # once this node regains leadership
                        self._pending_proposals.discard(index)
                        index = None
                    self._apply_cv.wait(
                        min(0.1, max(0.001,
                                     deadline - time.monotonic())))
            finally:
                if index is not None:
                    self._pending_proposals.discard(index)
        return False

    # -- RPC handlers (called by the transport server) -------------------

    def handle_request_vote(self, req: dict) -> dict:
        with self._lock:
            term = req["term"]
            my_last_idx = self._last_index_locked()
            my_last_term = self._term_at_locked(my_last_idx) \
                if my_last_idx >= 0 else 0
            up_to_date = (req["last_log_term"], req["last_log_index"]) \
                >= (my_last_term, my_last_idx)
            if req.get("pre"):
                # pre-vote (raft §9.6): no state change, no persistence —
                # granted only if we would vote AND we are not hearing
                # from a live leader (lease check), so a rejoining node
                # cannot depose a healthy one
                lease = self.cfg.election_timeout_ms[0] / 1000.0
                leaderless = self.state == CANDIDATE or \
                    (self.state != LEADER and
                     time.monotonic() - self._last_heartbeat >= lease)
                granted = term >= self.current_term and up_to_date and \
                    leaderless
                return {"term": self.current_term,
                        "vote_granted": bool(granted)}
            if term > self.current_term:
                self._become_follower(term, None)
            granted = False
            if term == self.current_term and \
                    self.voted_for in (None, req["candidate_id"]):
                if up_to_date:
                    granted = True
                    self.voted_for = req["candidate_id"]
                    self._save_state()
                    self._last_heartbeat = time.monotonic()
            return {"term": self.current_term, "vote_granted": granted}

    def handle_append_entries(self, req: dict) -> dict:
        with self._lock:
            term = req["term"]
            if term < self.current_term:
                return {"term": self.current_term, "success": False}
            if term > self.current_term or self.state != FOLLOWER:
                self._become_follower(term, req["leader_id"])
            self.leader_id = req["leader_id"]
            self._last_heartbeat = time.monotonic()
            prev_idx = req["prev_log_index"]
            entries = req["entries"]
            if prev_idx < self.snap_index:
                # a prefix of these entries is already inside our snapshot
                # (committed by definition): skip it
                cut = self.snap_index - prev_idx
                entries = entries[cut:]
                prev_idx = self.snap_index
            elif prev_idx >= 0:
                if prev_idx > self._last_index_locked() or \
                        (prev_idx > self.snap_index and
                         self._term_at_locked(prev_idx) !=
                         req["prev_log_term"]):
                    return {"term": self.current_term, "success": False}
            # append, truncating conflicts (positions are log-relative)
            idx = prev_idx + 1
            for e in entries:
                pos = idx - self.snap_index - 1
                if pos < len(self.log):
                    if self.log[pos].term != e["term"]:
                        del self.log[pos:]
                        self.log.append(LogEntry(e["term"], e["command"]))
                else:
                    self.log.append(LogEntry(e["term"], e["command"]))
                idx += 1
            if entries:
                self._save_state()
            if req["leader_commit"] > self.commit_index:
                self.commit_index = min(req["leader_commit"],
                                        self._last_index_locked())
                self._apply_cv.notify_all()
            return {"term": self.current_term, "success": True}

    def handle_install_snapshot(self, req: dict) -> dict:
        """Follower side of InstallSnapshot (raft §7): replace state with
        the leader's snapshot, keep any log tail that extends past it."""
        with self._lock:
            term = req["term"]
            if term < self.current_term:
                return {"term": self.current_term, "success": False}
            if term > self.current_term or self.state != FOLLOWER:
                self._become_follower(term, req["leader_id"])
            self.leader_id = req["leader_id"]
            self._last_heartbeat = time.monotonic()
            li = req["last_included_index"]
            lt = req["last_included_term"]
            if li <= self.snap_index:  # stale snapshot
                return {"term": self.current_term, "success": True}
            if li <= self._last_index_locked() and \
                    self._term_at_locked(li) == lt:
                self.log = self.log[li - self.snap_index:]
            else:
                self.log = []
            self.snap_index, self.snap_term = li, lt
            self._snapshot_data = req.get("data")
            if self.restore_snapshot and self._snapshot_data is not None:
                # _apply_mu excludes a concurrent apply_command batch; the
                # marker stops any already-captured batch from re-applying
                # entries the snapshot includes (lock order: _lock then
                # _apply_mu here; the apply loop never nests the reverse)
                with self._apply_mu:
                    self.restore_snapshot(self._snapshot_data)
                    self._restored_through = li
            self.commit_index = max(self.commit_index, li)
            self.last_applied = max(self.last_applied, li)
            self._save_state()
            return {"term": self.current_term, "success": True}
