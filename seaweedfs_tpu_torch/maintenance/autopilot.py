"""Autopilot: the master-side policy engine that ACTS on telemetry.

Counterpart of `seaweedfs_tpu/maintenance/autopilot.py`, whole.  The
senses (heat sketches, the history store with capacity forecasts and
alerts, the interference index) and the actuators (fleet EC
conversion, reduced-read repair, the rate governor) exist apart; this
engine connects them, so that hot chunks do not decode per read
forever, cold replicated volumes become EC, and a disk whose
``predicted_full_seconds`` alarm fires gets a move.  The SSD-array study (PAPERS.md, arXiv 1709.05365) shows online EC
systems lose their latency budget to exactly this kind of unscheduled
background placement work, and the warehouse study (arXiv 1309.0186)
shows placement decisions dominate cluster network cost — so the
decision layer sits HERE, as typed, dry-run-able, traced action plans.

Three policies, evaluated each tick against ``/cluster/heat``, the
health ledger, and the capacity forecasts:

- **tiering** — demote volumes that have been COLD for a sustained
  window (``COLD_RPS`` / ``WEEDTPU_AUTOPILOT_COLD_S``) to EC by
  enqueueing them on the fleet-conversion scheduler with ``seal=True``
  (the shard set mounts and the .dat retires once the conversion
  commits); promote EC volumes that have been HOT for a sustained
  window (``WEEDTPU_AUTOPILOT_HOT_RPS`` / ``_HOT_S``, measured by the
  heat sketches' monotone ``sustained_s`` clock — never inferred from
  decayed estimates) back to the replicated/mmap fast path through the
  volume server's ``/admin/volume/unconvert`` decode-and-thaw path.
- **balancing** — when a disk's ``predicted_full_seconds`` fires inside
  ``FULL_HORIZON_S``, plan a move of that node's
  coldest plain volume to the emptiest non-filling node, executed by
  the volume server's ``/admin/volume/move`` (staged copy, CRC verify,
  commit on target, retire on source; abortable mid-failure with no
  partial state; every byte books as netflow ``class=rebalance``).
- **codec selection** — per-volume erasure-code choice from the same
  heat evidence: a sustained-hot EC volume plans a recode to LRC
  (degraded reads touch one local parity group), a sustained-cold one
  to PM-MSR (repair ships d/(k*alpha) shard-equivalents instead of k),
  executed by the volume server's in-place ``/admin/ec/recode`` on the
  shard-majority node.  Paced by its own governed ``codec`` bucket
  (``WEEDTPU_AUTOPILOT_CODEC_RATE``/``CODEC_BURST``); warm middle-band
  volumes keep their codec.
- **action ledger** — every plan is a pinned trace plus a decision
  record with a state machine ``planned -> approved -> executing ->
  done | aborted``.  ``WEEDTPU_AUTOPILOT=plan`` (the DEFAULT) creates
  plans but executes NOTHING until an operator approves one
  (``cluster.autopilot -approve <id>``); ``execute`` auto-approves;
  ``0`` disables planning outright.  Hysteresis keeps flapping volumes
  from thrashing: cold/hot must be SUSTAINED (the cold clock resets on
  any warm sighting; the hot clock is the sketch entry's first_seen,
  which eviction resets), and every executed — or failed — action arms
  a per-volume ``COOLDOWN_S`` lockout before the volume can be planned
  again.  Per-policy token buckets (``TIER_RATE``/``BALANCE_RATE``)
  pace plan creation, and the
  interference governor retunes them live like any other background
  work class.

The autopilot itself never touches data: it only drives the existing
abort-safe actuators, and every actuator call increments
``actuator_calls`` so plan-only mode is PROVABLY inert (the test
asserts zero).  It has no device: a promote's or recode's decode is K1
on the card volume server it calls, a demote's conversion K2.

Knobs: ``WEEDTPU_AUTOPILOT`` (``plan``, ``execute`` or ``0``/``off``/
``false``/``no``; re-read per tick), ``_COLD_S``, ``_HOT_RPS``,
``_HOT_S`` and ``_CODEC_RATE``, read at construction.  A malformed value
raises ValueError where the reference falls back; the master reads them
all at construction, before its socket binds.  The reference's other
knobs, which nothing sets to a second value, are the constants
``COLD_RPS``, ``COOLDOWN_S``, ``FULL_HORIZON_S``, ``TIER_RATE``/
``TIER_BURST``, ``BALANCE_RATE``/``BALANCE_BURST``, ``CHUNK_RATE``/
``CHUNK_BURST``, ``CODEC_BURST``, ``CHUNK_RPS`` and ``CHUNK_S`` (the
constructor's keywords still override the ones the reference's do).
"""

from __future__ import annotations

import asyncio
import logging
import os
import time

from seaweedfs_tpu_torch.maintenance.repair import TokenBucket
from seaweedfs_tpu_torch.ops import codec_tags
from seaweedfs_tpu_torch.stats import metrics, netflow, trace
from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage.ec import layout
from seaweedfs_tpu_torch.utils import weedlog
from seaweedfs_tpu_torch.utils.hashring import RendezvousRing
from seaweedfs_tpu_torch.utils.http import post_json
from seaweedfs_tpu_torch.utils.resilience import _env_float

log = logging.getLogger("autopilot")

PLAN_STATES = ("planned", "approved", "executing", "done", "aborted")
POLICIES = ("tiering_demote", "tiering_promote", "balance_move",
            "chunk_promote", "codec_select")

COLD_RPS = 0.2            # a normal volume at or under this is cold
COOLDOWN_S = 900.0        # per-volume lockout after an executed action
FULL_HORIZON_S = 21600.0  # a disk full sooner gets a balance move
TIER_RATE, TIER_BURST = 0.5, 4.0        # plan buckets, plans/s and burst
BALANCE_RATE, BALANCE_BURST = 0.1, 2.0
CHUNK_RATE, CHUNK_BURST = 1.0, 8.0
CODEC_BURST = 2.0
CHUNK_RPS = 2.0           # a chunk at or over this, sustained
CHUNK_S = 30.0            # ... this long, is promoted


def autopilot_mode() -> str:
    """WEEDTPU_AUTOPILOT: ``plan`` (default — decide, record, execute
    nothing without operator approval), ``execute`` (closed loop), or
    ``0`` (off; also ``off``, ``false``, ``no``).  Read per tick so
    tests and operators can flip a live master.  Any other value raises
    ValueError (the reference plans)."""
    raw = os.environ.get("WEEDTPU_AUTOPILOT", "plan")
    m = raw.strip().lower() or "plan"
    if m in ("0", "off", "false", "no"):
        return "0"
    if m not in ("plan", "execute"):
        raise ValueError(f"WEEDTPU_AUTOPILOT={raw!r}: want plan, "
                         "execute or 0")
    return m


class Autopilot:
    """One per master.  ``tick()`` reads the telemetry planes and emits
    action plans; ``approve``/``abort`` drive the state machine;
    ``_execute`` is the ONLY place actuator calls happen."""

    KEEP_PLANS = 200  # terminal plans retained for the ledger view

    def __init__(self, master, *,
                 cold_rps: float | None = None,
                 cold_s: float | None = None,
                 hot_rps: float | None = None,
                 hot_s: float | None = None,
                 cooldown_s: float | None = None,
                 horizon_s: float | None = None,
                 tier_rate: float | None = None,
                 balance_rate: float | None = None):
        self.master = master
        self.cold_rps = cold_rps if cold_rps is not None else COLD_RPS
        self.cold_s = cold_s if cold_s is not None else \
            _env_float("WEEDTPU_AUTOPILOT_COLD_S", 900.0)
        self.hot_rps = hot_rps if hot_rps is not None else \
            _env_float("WEEDTPU_AUTOPILOT_HOT_RPS", 5.0)
        self.hot_s = hot_s if hot_s is not None else \
            _env_float("WEEDTPU_AUTOPILOT_HOT_S", 120.0)
        self.cooldown_s = cooldown_s if cooldown_s is not None else \
            COOLDOWN_S
        self.horizon_s = horizon_s if horizon_s is not None else \
            FULL_HORIZON_S
        # per-policy pacing: plans/second with a small burst.  The
        # governor retunes these live (targets autopilot_tier /
        # autopilot_balance) exactly like the repair and convert buckets
        self.buckets = {
            "tiering": TokenBucket(
                tier_rate if tier_rate is not None else TIER_RATE,
                TIER_BURST),
            "balance": TokenBucket(
                balance_rate if balance_rate is not None
                else BALANCE_RATE, BALANCE_BURST),
            "chunk": TokenBucket(CHUNK_RATE, CHUNK_BURST),
            "codec": TokenBucket(
                _env_float("WEEDTPU_AUTOPILOT_CODEC_RATE", 0.1),
                CODEC_BURST),
        }
        # chunk-granular promotion: sustained-hot chunks from the fleet
        # heat sketch are seeded into their hot-tier home filer (the
        # missing finer-grained sibling of volume tiering)
        self.chunk_rps = CHUNK_RPS
        self.chunk_s = CHUNK_S
        self._chunk_last: dict[str, float] = {}  # per-fid cooldown
        self.plans: dict[str, dict] = {}  # insertion-ordered ledger
        self._plan_seq = 0
        # hysteresis state: when each volume was FIRST seen cold (reset
        # on any warm sighting), and the per-volume action cooldown
        self._cold_since: dict[int, float] = {}
        # codec_select's own sustained-cold clock: a volume can be
        # tiering-stable yet still drift between codec temperature
        # bands, so the two hysteresis clocks are independent
        self._codec_cold_since: dict[int, float] = {}
        self._last_action: dict[int, tuple[float, str]] = {}
        self._tasks: set[asyncio.Task] = set()
        self.ticks = 0
        # incremented by EVERY actuator call (enqueue, unconvert POST,
        # move POST, shard retirement) — the plan-only proof reads this
        self.actuator_calls = 0
        # sustained-hot EC volumes that could NOT be planned because no
        # node holds k shards (promote needs shard consolidation,
        # which this engine does not do): counted + logged, never
        # silently dropped
        self.promote_blocked_spread = 0
        # codec_select plans that could not run because no node holds
        # k shards (recode decodes locally, like promote)
        self.recode_blocked_spread = 0

    # -- the tick ---------------------------------------------------------

    async def tick(self) -> list[dict]:
        """One policy pass.  Returns the plans CREATED this tick (the
        full ledger lives in status()).  In execute mode, freshly
        planned work is auto-approved and launched; in plan mode it
        waits for an operator."""
        mode = autopilot_mode()
        if mode == "0":
            return []
        self.ticks += 1
        now = time.time()
        try:
            heat_view = await asyncio.to_thread(self.master.cached_heat)
        except Exception as e:
            log.warning("autopilot: heat fan-out failed (%s); planning "
                        "from ledger/forecast only", e)
            heat_view = {}
        ledger = self.master.maintenance.ledger()
        vol_heat = self._volume_heat(heat_view)
        new: list[dict] = []
        new += self._plan_tiering(now, vol_heat, ledger)
        new += self._plan_balancing(now, vol_heat)
        new += self._plan_chunk_promote(now, heat_view)
        new += self._plan_codec_select(now, vol_heat, ledger)
        if mode == "execute":
            for plan in [p for p in self.plans.values()
                         if p["state"] == "planned"]:
                self.approve(plan["id"])
        self._gc_plans()
        return [self.serialize_plan(p) for p in new]

    async def wait_idle(self) -> None:
        while self._tasks:
            await asyncio.gather(*list(self._tasks),
                                 return_exceptions=True)

    # -- inputs -----------------------------------------------------------

    @staticmethod
    def _volume_heat(heat_view: dict) -> dict[int, dict]:
        """The fleet heat view's per-volume records, keyed by vid."""
        out: dict[int, dict] = {}
        for rec in (heat_view.get("volumes") or {}).get("top", []):
            try:
                out[int(rec["key"])] = rec
            except (KeyError, TypeError, ValueError):
                continue
        return out

    def _active_vids(self) -> set[int]:
        return {p["vid"] for p in self.plans.values()
                if p["state"] in ("planned", "approved", "executing")}

    def _in_cooldown(self, vid: int, now: float) -> bool:
        rec = self._last_action.get(vid)
        return rec is not None and now - rec[0] < self.cooldown_s

    # -- tiering policy ---------------------------------------------------

    def _plan_tiering(self, now: float, vol_heat: dict[int, dict],
                      ledger: dict[int, dict]) -> list[dict]:
        conv = self.master.convert
        # volumes already in the conversion pipeline — queued, active,
        # or parked in the re-queue backlog — must not be re-planned
        parked = set(conv.queued) | set(conv.active) | set(conv._backoff)
        active = self._active_vids()
        plans: list[dict] = []
        for vid, info in sorted(ledger.items()):
            rec = vol_heat.get(vid)
            rps = float(rec.get("rps", 0.0)) if rec else 0.0
            sustained = float(rec.get("sustained_s", 0.0)) if rec else 0.0
            if info["kind"] == "normal":
                if info["state"] != "healthy":
                    # degraded/under-replicated: repair's problem first
                    self._cold_since.pop(vid, None)
                    continue
                if rps > self.cold_rps:
                    # warm sighting: the sustained-cold clock restarts
                    self._cold_since.pop(vid, None)
                    continue
                since = self._cold_since.setdefault(vid, now)
                cold_for = now - since
                if cold_for < self.cold_s:
                    continue  # not sustained yet (hysteresis)
                if vid in parked or vid in active or \
                        self._in_cooldown(vid, now):
                    continue
                if not self.buckets["tiering"].try_acquire():
                    break  # paced: later ticks pick up the rest
                plans.append(self._new_plan(
                    "tiering_demote", vid,
                    collection=info.get("collection", ""),
                    reason={"rps": round(rps, 3),
                            "cold_for_s": round(cold_for, 1),
                            "threshold_rps": self.cold_rps}))
            elif info["kind"] == "ec":
                self._cold_since.pop(vid, None)
                if rec is None or rps < self.hot_rps:
                    continue
                if sustained < self.hot_s:
                    continue  # hot, but not SUSTAINED hot (hysteresis)
                if info["state"] != "healthy":
                    continue  # missing/corrupt shards: heal before tiering
                if vid in active or self._in_cooldown(vid, now):
                    continue
                node, others = self._promote_node(info)
                if node is None:
                    # no node holds k shards locally: this engine has
                    # no shard-consolidation actuator (ROADMAP
                    # follow-on), so the promote CANNOT run — say so
                    # (no silent caps) instead of skipping invisibly
                    self.promote_blocked_spread += 1
                    weedlog.warn_ratelimited(
                        f"autopilot_spread:{vid}", 300.0,
                        "autopilot: volume %d is sustained-hot EC but "
                        "no node holds %d+ shards; promote needs shard "
                        "consolidation (unbuilt) — not planned", vid,
                        layout.DATA_SHARDS, name="autopilot")
                    continue
                if not self.buckets["tiering"].try_acquire():
                    break
                plans.append(self._new_plan(
                    "tiering_promote", vid, node=node,
                    collection=info.get("collection", ""),
                    other_shard_nodes=others,
                    reason={"rps": round(rps, 3),
                            "sustained_s": round(sustained, 1),
                            "degraded_fraction":
                                rec.get("degraded_fraction", 0.0),
                            "threshold_rps": self.hot_rps}))
        return plans

    @staticmethod
    def _promote_node(info: dict,
                      k: int | None = None) -> tuple[str | None, dict]:
        """The node to decode on — it must hold at least k shards
        locally (rebuild_ec_files regenerates the rest in place) — plus
        {node: [shards]} for every OTHER node whose remnant shards the
        promote (or recode) retires afterwards.  `k` defaults to the
        volume's own codec stripe width from the ledger."""
        if k is None:
            k = codec_tags.parse_tag(info.get("codec")).k
        per_node: dict[str, list[int]] = {}
        for sid, nodes in (info.get("shard_locations") or {}).items():
            for url in nodes:
                per_node.setdefault(url, []).append(int(sid))
        if not per_node:
            return None, {}
        best = max(per_node, key=lambda u: len(per_node[u]))
        if len(per_node[best]) < k:
            return None, {}
        others = {u: sorted(s) for u, s in per_node.items() if u != best}
        return best, others

    # -- codec selection policy -------------------------------------------

    def _plan_codec_select(self, now: float, vol_heat: dict[int, dict],
                           ledger: dict[int, dict]) -> list[dict]:
        """Per-volume codec choice from the heat sketches: a
        sustained-HOT EC volume (lots of degraded/partial reads at
        stake) wants LRC — single-shard repair touches one local group
        instead of k-wide decode; a sustained-COLD archival volume
        wants PM-MSR — repair bandwidth drops to d/(k*alpha) shard
        equivalents and nobody is waiting on its read latency.  Same
        hysteresis discipline as tiering (the cold clock resets on any
        warm sighting; hot uses the sketch's monotone sustained_s),
        same per-volume cooldown, its own governed `codec` bucket.
        Warm middle-band volumes keep whatever codec they have — the
        policy only moves volumes OUT of a mismatched band."""
        if self.buckets["codec"].rate <= 0:
            return []
        active = self._active_vids()
        plans: list[dict] = []
        for vid, info in sorted(ledger.items()):
            if info.get("kind") != "ec":
                self._codec_cold_since.pop(vid, None)
                continue
            if info.get("state") != "healthy":
                # missing shards: heal first — a recode decodes the
                # stripe and would race the repair plane
                self._codec_cold_since.pop(vid, None)
                continue
            cur = codec_tags.parse_tag(info.get("codec"))
            rec = vol_heat.get(vid)
            rps = float(rec.get("rps", 0.0)) if rec else 0.0
            sustained = float(rec.get("sustained_s", 0.0)) if rec else 0.0
            target = reason = None
            if rps >= self.hot_rps:
                self._codec_cold_since.pop(vid, None)
                if sustained >= self.hot_s and cur.family != "lrc":
                    target = codec_tags.parse_tag("lrc").tag
                    reason = {"band": "hot", "rps": round(rps, 3),
                              "sustained_s": round(sustained, 1),
                              "threshold_rps": self.hot_rps}
            elif rps <= self.cold_rps:
                since = self._codec_cold_since.setdefault(vid, now)
                cold_for = now - since
                if cold_for >= self.cold_s and cur.family != "msr":
                    target = codec_tags.parse_tag("msr").tag
                    reason = {"band": "cold", "rps": round(rps, 3),
                              "cold_for_s": round(cold_for, 1),
                              "threshold_rps": self.cold_rps}
            else:
                self._codec_cold_since.pop(vid, None)
            if target is None or target == cur.tag:
                continue
            if vid in active or self._in_cooldown(vid, now):
                continue
            node, others = self._promote_node(info, k=cur.k)
            if node is None:
                self.recode_blocked_spread += 1
                weedlog.warn_ratelimited(
                    f"autopilot_recode_spread:{vid}", 300.0,
                    "autopilot: volume %d wants codec %s but no node "
                    "holds %d+ shards; recode needs shard "
                    "consolidation (unbuilt) — not planned", vid,
                    target, cur.k, name="autopilot")
                continue
            if not self.buckets["codec"].try_acquire():
                break
            plans.append(self._new_plan(
                "codec_select", vid, node=node,
                from_codec=cur.tag, to_codec=target,
                collection=info.get("collection", ""),
                other_shard_nodes=others, reason=reason))
        return plans

    # -- balancing policy -------------------------------------------------

    def _plan_balancing(self, now: float,
                        vol_heat: dict[int, dict]) -> list[dict]:
        fc = getattr(self.master, "forecaster", None)
        if fc is None:
            return []
        try:
            snap = fc.snapshot()
        except Exception:
            return []
        filling = [d for d in snap.get("disks", [])
                   if d.get("predicted_full_seconds", 1e18)
                   < self.horizon_s]
        if not filling:
            return []
        topo = self.master.topo
        with topo._lock:
            free = {n.url: n.free_slots for n in topo.nodes.values()}
            by_node = {n.url: {vid: (v.size, v.replica_placement)
                               for vid, v in n.volumes.items()}
                       for n in topo.nodes.values()}
        filling_nodes = {d["vs"] for d in filling}
        active = self._active_vids()
        plans: list[dict] = []
        planned_src: set[str] = set()
        for d in sorted(filling,
                        key=lambda r: r["predicted_full_seconds"]):
            src = d["vs"]
            if src in planned_src:
                continue  # one move per filling node per tick
            targets = [u for u in sorted(free, key=lambda u: -free[u])
                       if u != src and u not in filling_nodes
                       and free.get(u, 0) > 0]
            if not targets:
                continue
            cands = []
            for vid, (size, placement) in by_node.get(src, {}).items():
                if vid in active or self._in_cooldown(vid, now):
                    continue
                try:
                    copies = t.ReplicaPlacement.parse(
                        placement or "000").copy_count
                except (ValueError, KeyError):
                    copies = 1
                if copies > 1:
                    # the move protocol relocates the ONLY copy; fixing
                    # replicated placement is volume.fix.replication's
                    # job, not a rebalance
                    continue
                rec = vol_heat.get(vid)
                rps = float(rec.get("rps", 0.0)) if rec else 0.0
                # coldest first; among equally cold, move the LARGEST
                # (fewest moves to relieve the disk)
                cands.append((rps, -size, vid))
            if not cands:
                continue
            cands.sort()
            rps, neg_size, vid = cands[0]
            if not self.buckets["balance"].try_acquire():
                break
            planned_src.add(src)
            plans.append(self._new_plan(
                "balance_move", vid, source=src, target=targets[0],
                reason={"predicted_full_seconds":
                        d["predicted_full_seconds"],
                        "dir": d.get("dir", ""),
                        "volume_bytes": -neg_size,
                        "volume_rps": round(rps, 3),
                        "horizon_s": self.horizon_s}))
        return plans

    # -- chunk promotion policy -------------------------------------------

    def _live_filers(self) -> list[str]:
        now = time.time()
        return sorted(a for a, ts in
                      self.master.cluster_members.get("filer", {}).items()
                      if now - ts < 30.0)

    def _plan_chunk_promote(self, now: float,
                            heat_view: dict) -> list[dict]:
        """Chunk-granular promotion: a chunk the fleet heat sketch shows
        sustained-hot gets seeded into its hot-tier home filer (the same
        rendezvous ring every filer computes), so the whole cluster
        serves it from one warm copy before organic misses converge
        there.  One plan per home filer per tick, paced by the governed
        `chunk` bucket."""
        if self.buckets["chunk"].rate <= 0:
            return []
        top = (heat_view.get("chunks") or {}).get("top", [])
        if not top:
            return []
        filers = self._live_filers()
        if not filers:
            return []
        ring = RendezvousRing(filers)
        active_fids = {f for p in self.plans.values()
                       if p["policy"] == "chunk_promote"
                       and p["state"] in ("planned", "approved",
                                          "executing")
                       for f in p.get("fids", [])}
        by_home: dict[str, list[tuple[float, str]]] = {}
        for rec in top:
            fid = str(rec.get("key", ""))
            if "," not in fid:
                continue  # not a blob fid
            rps = float(rec.get("rps", 0.0))
            if rps < self.chunk_rps or \
                    float(rec.get("sustained_s", 0.0)) < self.chunk_s:
                continue
            last = self._chunk_last.get(fid)
            if last is not None and now - last < self.cooldown_s:
                continue
            if fid in active_fids:
                continue
            home = ring.home(fid)
            if home is not None:
                by_home.setdefault(home, []).append((rps, fid))
        plans: list[dict] = []
        for home in sorted(by_home):
            if not self.buckets["chunk"].try_acquire():
                break
            batch = sorted(by_home[home], reverse=True)[:32]
            fids = [f for _, f in batch]
            plans.append(self._new_plan(
                "chunk_promote",
                vid=int(fids[0].partition(",")[0]),
                node=home, fids=fids,
                reason={"hottest_rps": round(batch[0][0], 3),
                        "chunks": len(fids),
                        "rps_floor": self.chunk_rps,
                        "sustained_floor_s": self.chunk_s}))
        # bound the per-fid cooldown map (hot sets churn; dead entries
        # must not accrete forever)
        if len(self._chunk_last) > 4096:
            self._chunk_last = {f: ts for f, ts
                                in self._chunk_last.items()
                                if now - ts < self.cooldown_s}
        return plans

    # -- the plan ledger --------------------------------------------------

    def _new_plan(self, policy: str, vid: int, **fields) -> dict:
        """Create one plan: a decision record + its own pinned trace
        root (the runbook's `cluster.trace <trace_id>` waterfall shows
        planning AND every actuator hop the execution later makes)."""
        self._plan_seq += 1
        pid = f"ap{self._plan_seq}"
        root = trace.new_root(sampled=True)
        trace.pin_trace(root.trace_id)
        plan = {"id": pid, "policy": policy, "vid": vid,
                "state": "planned", "created": round(time.time(), 3),
                "mode": autopilot_mode(), "trace_id": root.trace_id,
                **fields, "_root": root}
        with trace.span("autopilot.plan", parent=root, policy=policy,
                        vid=vid, plan=pid, mode=plan["mode"]):
            pass  # the planning decision itself, on the pinned trace
        self.plans[pid] = plan
        metrics.AUTOPILOT_PLANS.labels(policy).inc()
        log.info("autopilot: planned %s %s vid=%d %s trace=%s",
                 pid, policy, vid, fields.get("reason", {}),
                 root.trace_id)
        return plan

    def serialize_plan(self, plan: dict) -> dict:
        return {k: v for k, v in plan.items() if not k.startswith("_")}

    def approve(self, pid: str) -> dict:
        """planned -> approved, and launch the execution task.  The
        operator's runbook step in plan mode; automatic in execute
        mode."""
        plan = self.plans.get(pid)
        if plan is None:
            raise KeyError(pid)
        if plan["state"] != "planned":
            raise ValueError(
                f"plan {pid} is {plan['state']}, not planned")
        plan["state"] = "approved"
        task = asyncio.create_task(self._execute(plan))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        return plan

    def abort(self, pid: str) -> dict:
        """planned/approved -> aborted.  An EXECUTING plan cannot be
        yanked from here — the actuators are abort-safe against their
        own failures, but an orphaned in-flight move would be worse
        than letting it finish or fail."""
        plan = self.plans.get(pid)
        if plan is None:
            raise KeyError(pid)
        if plan["state"] not in ("planned", "approved"):
            raise ValueError(
                f"plan {pid} is {plan['state']}; only planned/approved "
                "plans abort")
        plan["state"] = "aborted"
        plan["outcome"] = "operator abort"
        return plan

    def _gc_plans(self) -> None:
        terminal = [pid for pid, p in self.plans.items()
                    if p["state"] in ("done", "aborted")]
        for pid in terminal[:max(0, len(terminal) - self.KEEP_PLANS)]:
            del self.plans[pid]

    # -- execution (the ONLY actuator call site) --------------------------

    async def _post(self, node: str, path: str, body: dict,
                    timeout: float = 600.0) -> dict:
        self.actuator_calls += 1
        return await post_json(self.master._session, node, path, body,
                               timeout)

    async def _execute(self, plan: dict) -> None:
        if plan["state"] != "approved":
            # an abort landed between approve() scheduling this task
            # and the event loop running it: the operator was told the
            # plan died, so it must not execute
            return
        plan["state"] = "executing"
        policy, vid = plan["policy"], plan["vid"]
        t0 = time.monotonic()
        try:
            with trace.span("autopilot.execute", parent=plan.get("_root"),
                            policy=policy, vid=vid, plan=plan["id"]):
                if policy == "tiering_demote":
                    await self._exec_demote(plan)
                elif policy == "tiering_promote":
                    await self._exec_promote(plan)
                elif policy == "balance_move":
                    await self._exec_move(plan)
                elif policy == "chunk_promote":
                    await self._exec_chunk_promote(plan)
                elif policy == "codec_select":
                    await self._exec_recode(plan)
                else:
                    raise RuntimeError(f"unknown policy {policy}")
            plan["state"] = "done"
            metrics.AUTOPILOT_ACTIONS.labels(policy, "done").inc()
        except Exception as e:
            plan["state"] = "aborted"
            plan["error"] = str(e)
            metrics.AUTOPILOT_ACTIONS.labels(policy, "aborted").inc()
            log.warning("autopilot: %s %s vid=%d aborted: %s",
                        plan["id"], policy, vid, e)
        finally:
            # success AND failure arm the cooldown: a broken actuator
            # must not be retried at tick cadence.  Chunk plans cool
            # down per-fid (their vid is incidental — arming the volume
            # cooldown would block unrelated volume-level plans)
            if policy == "chunk_promote":
                for fid in plan.get("fids", []):
                    self._chunk_last[fid] = time.time()
            else:
                self._last_action[vid] = (time.time(), policy)
            plan["seconds"] = round(time.monotonic() - t0, 3)

    async def _exec_demote(self, plan: dict) -> None:
        """Hand the volume to the paced conversion pipeline, sealed:
        once the (tmp+rename) conversion commits, the scheduler mounts
        the shard set and retires the .dat.  The scheduler owns pacing,
        interference pauses, and dead-node re-queues from here."""
        self.actuator_calls += 1
        accepted = self.master.convert.enqueue([plan["vid"]], seal=True)
        plan["outcome"] = "enqueued" if accepted else "already queued"

    async def _exec_promote(self, plan: dict) -> None:
        """Decode-and-thaw on the shard-majority node, then retire
        remnant shards elsewhere.  Tiering traffic books as
        class=convert (the same plane its demote twin rides)."""
        vid, node = plan["vid"], plan["node"]
        with netflow.flow("convert"):
            data = await self._post(node, "/admin/volume/unconvert",
                                    {"volume": vid,
                                     "collection":
                                         plan.get("collection", "")})
            retired: dict[str, list[int]] = {}
            for url, sids in (plan.get("other_shard_nodes")
                              or {}).items():
                try:
                    await self._post(url, "/admin/ec/delete_shards",
                                     {"volume": vid, "shards": sids},
                                     timeout=60.0)
                    retired[url] = sids
                except Exception as e:
                    # the volume IS promoted; stray shards are garbage,
                    # not danger (heartbeat diffing sees them gone when
                    # the node returns and retries via a later plan)
                    log.warning("autopilot: remnant shard retirement "
                                "on %s failed: %s", url, e)
        plan["outcome"] = {"decoded": data.get("decoded"),
                           "thawed": data.get("thawed"),
                           "remnants_retired": retired}

    async def _exec_move(self, plan: dict) -> None:
        """One staged, CRC-verified, abort-safe volume move, driven by
        the source volume server."""
        with netflow.flow("rebalance"):
            data = await self._post(
                plan["source"], "/admin/volume/move",
                {"volume": plan["vid"], "target": plan["target"]})
        plan["outcome"] = {"crc": data.get("crc"),
                           "target": data.get("target")}

    async def _exec_recode(self, plan: dict) -> None:
        """One in-place codec change on the shard-majority node, then
        remnant-shard retirement elsewhere — the same shape as promote,
        riding the convert traffic class (it IS a re-encode)."""
        vid = plan["vid"]
        with netflow.flow("convert"):
            data = await self._post(plan["node"], "/admin/ec/recode",
                                    {"volume": vid,
                                     "codec": plan["to_codec"],
                                     "collection":
                                         plan.get("collection", "")},
                                    timeout=1800.0)
            retired: dict[str, list[int]] = {}
            for url, sids in (plan.get("other_shard_nodes")
                              or {}).items():
                try:
                    await self._post(url, "/admin/ec/delete_shards",
                                     {"volume": vid, "shards": sids},
                                     timeout=60.0)
                    retired[url] = sids
                except Exception as e:
                    log.warning("autopilot: remnant shard retirement "
                                "on %s failed: %s", url, e)
        plan["outcome"] = {"codec": data.get("codec"),
                           "from": data.get("from"),
                           "shards": data.get("shards"),
                           "remnants_retired": retired}

    async def _exec_chunk_promote(self, plan: dict) -> None:
        """Seed the batch into its home filer's hot tier.  The pull-
        through bytes are speculative, so they book as class=readahead
        — the governor's interference index sees and paces them."""
        with netflow.flow("readahead"):
            data = await self._post(plan["node"], "/__hot__/seed",
                                    {"fids": plan["fids"]}, timeout=120.0)
        plan["outcome"] = {"seeded": data.get("seeded"),
                           "skipped": data.get("skipped")}

    # -- views ------------------------------------------------------------

    def status(self) -> dict:
        now = time.time()
        counts = {s: 0 for s in PLAN_STATES}
        for p in self.plans.values():
            counts[p["state"]] = counts.get(p["state"], 0) + 1
        return {
            "mode": autopilot_mode(),
            "ticks": self.ticks,
            "actuator_calls": self.actuator_calls,
            "promote_blocked_spread": self.promote_blocked_spread,
            "recode_blocked_spread": self.recode_blocked_spread,
            "states": counts,
            "knobs": {"cold_rps": self.cold_rps, "cold_s": self.cold_s,
                      "hot_rps": self.hot_rps, "hot_s": self.hot_s,
                      "chunk_rps": self.chunk_rps,
                      "chunk_s": self.chunk_s,
                      "cooldown_s": self.cooldown_s,
                      "full_horizon_s": self.horizon_s},
            "buckets": {name: {"rate_per_s": b.rate, "burst": b.burst,
                               "tokens": round(b.tokens, 2)}
                        for name, b in self.buckets.items()},
            "hysteresis": {
                "cold_tracking": {str(v): round(now - ts, 1)
                                  for v, ts in self._cold_since.items()},
                "cooldowns": {str(v): {"policy": pol,
                                       "remaining_s": round(
                                           max(0.0, self.cooldown_s -
                                               (now - ts)), 1)}
                              for v, (ts, pol)
                              in self._last_action.items()
                              if now - ts < self.cooldown_s},
            },
            "plans": [self.serialize_plan(p)
                      for p in list(self.plans.values())[-50:]],
        }

    def headline(self) -> dict:
        """The compact block /maintenance/status embeds."""
        st = {s: 0 for s in PLAN_STATES}
        recent = []
        for p in self.plans.values():
            st[p["state"]] = st.get(p["state"], 0) + 1
        for p in list(self.plans.values())[-5:]:
            recent.append({"id": p["id"], "policy": p["policy"],
                           "vid": p["vid"], "state": p["state"]})
        return {"mode": autopilot_mode(), "ticks": self.ticks,
                "states": st, "recent": recent}
