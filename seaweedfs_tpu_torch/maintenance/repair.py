"""Automatic repair planner: the master's self-healing control loop.

Counterpart of `seaweedfs_tpu/maintenance/repair.py`, whole.  The
planner folds two signal streams into a per-volume health ledger:

- heartbeat shard maps (Topology.ec_shard_locations / node volume maps):
  a shard or replica that stops being reported is LOST — detection is a
  heartbeat diff, no scan needed;
- scrub verdicts (maintenance/scrub.py, POSTed to the master): a shard
  that is still reported but failed parity verification is CORRUPT.

Ledger states: healthy / degraded (EC volume missing shards but still
reconstructable) / under_replicated (normal volume with fewer replicas
than its placement wants) / corrupt (unresolved scrub verdict) /
critical (fewer than k shards survive — data loss, not repairable here).

Each tick plans repairs in urgency order — shards-lost ordering, so a
3-lost volume preempts a 1-lost one — and drives the volume servers'
existing rebuild routes (/admin/ec/rebuild, reduced or naive, with
/admin/ec/copy, /admin/ec/delete_shards and mount) through a
token-bucket-limited executor with per-node concurrency caps and
exponential backoff; every stage carries a trace span.  Corrupt shards
are deleted first (their ranges are already quarantined on the owning
server), which turns "corrupt" into "lost" and reuses the same rebuild
path — and guarantees the rebuild never uses the bad bytes as a
survivor.  The planner has no device and holds no tensor: the card
volume servers it calls run the kernels.

The planner yields to operators: while the shell holds the master admin
lock, the background loop skips its tick.

Knobs: WEEDTPU_REPAIR_REDUCED (0 or 1, re-read per repair) is read by
the master at construction too, and a malformed value raises there,
before the socket binds, where the reference treats anything but "0" as
on.  The reference's other knobs, which nothing sets to a second value,
are the constants `NODE_CONCURRENCY`, `RATE`, `BURST`, `XRACK_BUDGET`,
`XRACK_BURST` and `FORECAST_URGENT_S` (the keywords of `RepairPlanner`
still override them, as the reference's do).
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time

from seaweedfs_tpu_torch.ops import codec_tags
from seaweedfs_tpu_torch.security.tls import scheme as _tls_scheme
from seaweedfs_tpu_torch.stats import metrics, netflow, trace
from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.topology.topology import (locality_class,
                                                   locality_name)
from seaweedfs_tpu_torch.utils import resilience
from seaweedfs_tpu_torch.utils.resilience import env_switch

log = logging.getLogger("repair")

HEALTH_STATES = ("healthy", "degraded", "under_replicated", "corrupt",
                 "critical")


NODE_CONCURRENCY = 2          # active repairs per node
RATE, BURST = 1.0, 4.0        # repairs launched per second, and burst
XRACK_BUDGET = 256 * 1024 * 1024   # cross-rack repair bytes per second
XRACK_BURST = 1024 * 1024 * 1024   # ... and their burst
FORECAST_URGENT_S = 21600.0   # a disk full sooner raises its repairs


def reduced_enabled() -> bool:
    """WEEDTPU_REPAIR_REDUCED: 1 (default) rebuilds from helpers'
    partial sums, 0 copies survivors and rebuilds naively; any other
    value raises."""
    return env_switch("WEEDTPU_REPAIR_REDUCED")


class TokenBucket:
    """Classic token bucket: `rate` tokens/s refill up to `burst`.  Caps
    how many repairs one tick may launch — re-protection traffic must not
    starve foreground I/O (the 1309.0186 lesson: recovery traffic
    dominates steady-state load when unthrottled).

    Thread-safe: ``try_acquire`` runs on the planner's event loop while
    ``set_rate`` is called from the interference governor on the
    aggregator thread (stats/interference.py), so both hold one lock."""

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def _refill(self) -> None:
        now = time.monotonic()
        self.tokens = min(self.burst, self.tokens +
                          (now - self._last) * self.rate)
        self._last = now

    def try_acquire(self, n: float = 1.0) -> bool:
        # a request larger than burst (one production-sized shard can
        # exceed the whole cross-rack budget) is admitted once the
        # bucket is FULL and drives tokens negative: the long-run rate
        # stays bounded by `rate` paying off the debt, instead of the
        # request starving forever behind an unreachable threshold
        with self._lock:
            self._refill()
            if self.tokens >= min(n, self.burst):
                self.tokens -= n
                return True
            return False

    def set_rate(self, rate: float) -> None:
        """Retarget the refill rate live (the governor's seam).  Tokens
        accrued so far — including negative debt from an oversized
        admission — are settled at the OLD rate first, so a retune never
        forgives or inflates debt retroactively."""
        with self._lock:
            self._refill()
            self.rate = max(0.0, float(rate))

    def credit(self, n: float) -> None:
        """Refund tokens (clamped at burst like any refill) — used when
        a pre-debited repair never launched."""
        with self._lock:
            self.tokens = min(self.burst, self.tokens + n)

    def force_debit(self, n: float) -> None:
        """Unconditionally take tokens (may go negative): the naive-
        fallback path moves more bytes than the reduced estimate it
        debited, and the shortfall must still be paid off."""
        with self._lock:
            self.tokens -= n


def build_ledger(topo, scrub_reports: dict) -> dict[int, dict]:
    """Fold the topology's heartbeat-derived volume/shard maps and the
    stored scrub reports into {vid: health info}."""
    out: dict[int, dict] = {}
    with topo._lock:
        ec = {vid: {sid: [n.url for n in nodes]
                    for sid, nodes in per.items() if nodes}
              for vid, per in topo.ec_shard_locations.items()}
        ec_cols = dict(topo.ec_collections)
        ec_sizes = dict(topo.ec_shard_sizes)
        ec_codecs = dict(getattr(topo, "ec_codecs", {}))
        node_loc = {n.url: (n.dc, n.rack) for n in topo.nodes.values()}
        normal: dict[int, dict] = {}
        for node in topo.nodes.values():
            for vid, v in node.volumes.items():
                rec = normal.setdefault(vid, {
                    "replicas": [], "collection": v.collection,
                    "replica_placement": v.replica_placement})
                rec["replicas"].append(node.url)
        free_slots = {n.url: n.free_slots for n in topo.nodes.values()}

    for vid, shards in ec.items():
        present = sorted(shards)
        spec = codec_tags.parse_tag(ec_codecs.get(vid))
        missing = [s for s in range(spec.n)
                   if s not in shards]
        info = {
            "vid": vid, "kind": "ec", "collection": ec_cols.get(vid, ""),
            "codec": spec.tag,
            "shards_present": present, "shards_missing": missing,
            "shard_locations": shards,
            "shard_size": ec_sizes.get(vid, 0),
            "node_locality": {url: list(node_loc[url])
                              for nodes in shards.values()
                              for url in nodes if url in node_loc},
        }
        corrupt: list[dict] = []
        last_scrub = None
        quarantined: dict = {}
        for node, rep in (scrub_reports.get(vid) or {}).items():
            for c in rep.get("corrupt", []):
                corrupt.append(dict(c, node=node))
            ls = rep.get("last_scrub")
            if ls and (last_scrub is None or ls > last_scrub):
                last_scrub = ls
            q = rep.get("quarantined")
            if q:
                quarantined[node] = q
        info["corrupt"] = corrupt
        info["last_scrub"] = last_scrub
        info["quarantined"] = quarantined
        if len(present) < spec.k:
            info["state"] = "critical"
        elif corrupt:
            info["state"] = "corrupt"
        elif missing:
            info["state"] = "degraded"
        else:
            info["state"] = "healthy"
        # shards-lost ordering: a 3-lost volume preempts a 1-lost one,
        # and corruption counts like loss (the shard must be replaced)
        info["urgency"] = len(missing) + len(corrupt)
        out[vid] = info

    for vid, rec in normal.items():
        if vid in out:
            continue  # mid-EC-transition: the shard entry wins
        try:
            want = t.ReplicaPlacement.parse(
                rec.get("replica_placement", "000")).copy_count
        except (ValueError, KeyError):
            want = 1
        reps = sorted(set(rec["replicas"]))
        rep = (scrub_reports.get(vid) or {})
        crc = sum(r.get("crc_mismatches", 0) for r in rep.values())
        info = {
            "vid": vid, "kind": "normal",
            "collection": rec.get("collection", ""),
            "replicas": reps, "want_replicas": want,
            "crc_mismatches": crc,
            "last_scrub": max((r.get("last_scrub") or 0
                               for r in rep.values()), default=None),
            "free_slots": free_slots,
        }
        if crc:
            info["state"] = "corrupt"
            info["urgency"] = 1 + crc
        elif len(reps) < want:
            info["state"] = "under_replicated"
            info["urgency"] = want - len(reps)
        else:
            info["state"] = "healthy"
            info["urgency"] = 0
        out[vid] = info
    return out


class RepairPlanner:
    """Plans and executes repairs against the cluster's admin HTTP API.

    `master` provides .topo and ._session (and, when it has one,
    .forecaster); the per-node active-repair cap and the two token
    buckets default to `NODE_CONCURRENCY`, `RATE`/`BURST` and
    `XRACK_BUDGET`/`XRACK_BURST`."""

    def __init__(self, master, *, node_concurrency: int | None = None,
                 rate: float | None = None, burst: float | None = None,
                 backoff_base: float = 2.0, backoff_max: float = 300.0,
                 xrack_rate: float | None = None,
                 xrack_burst: float | None = None):
        self.master = master
        self.node_concurrency = node_concurrency if node_concurrency \
            else NODE_CONCURRENCY
        self.bucket = TokenBucket(
            rate if rate is not None else RATE,
            burst if burst is not None else BURST)
        # cross-rack repair-byte budget (bytes/s + burst): repairs whose
        # survivor plan must pull partials across racks acquire their
        # ESTIMATED cross-rack bytes here before launching; when the
        # bucket runs dry the remaining (lower-urgency — candidates are
        # urgency-ordered) repairs wait for a later tick instead of
        # melting the inter-rack fabric (the 1309.0186 failure mode)
        self.xrack_bucket = TokenBucket(
            xrack_rate if xrack_rate is not None else XRACK_BUDGET,
            xrack_burst if xrack_burst is not None else XRACK_BURST)
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        # vid -> {node -> last scrub report}
        self.scrub_reports: dict[int, dict[str, dict]] = {}
        self._active_vids: set[int] = set()
        self._active_nodes: dict[str, int] = {}
        self._backoff: dict[int, tuple[int, float]] = {}
        self._tasks: set[asyncio.Task] = set()
        self.history: list[dict] = []
        # survivor-selection audit trail: one record per EC repair with
        # the chosen rebuilder/helpers, locality classes, and estimated
        # vs actual repair bytes — surfaced in /maintenance/status
        self.decisions: list[dict] = []
        # repairs deferred by an exhausted cross-rack budget last tick
        self.waiting_xrack: list[int] = []
        # cumulative repair bytes by locality class (reduced path)
        self.locality_bytes: dict[str, int] = {}

    # -- scrub intake ---------------------------------------------------

    def record_scrub(self, node: str, payload: dict) -> None:
        for vid_s, rep in (payload.get("volumes") or {}).items():
            try:
                vid = int(vid_s)
            except ValueError:
                continue
            per = self.scrub_reports.setdefault(vid, {})
            per[node] = rep
        # bound: vid space is client-influenced; drop oldest-known first
        while len(self.scrub_reports) > 4096:
            self.scrub_reports.pop(next(iter(self.scrub_reports)))

    # -- ledger / status ------------------------------------------------

    def ledger(self) -> dict[int, dict]:
        led = build_ledger(self.master.topo, self.scrub_reports)
        # keep the exported health gauge fresh on every ledger build —
        # the background tick calls here, so /metrics shows live state
        # even when nobody polls /maintenance/status
        counts = {s: 0 for s in HEALTH_STATES}
        for info in led.values():
            counts[info["state"]] = counts.get(info["state"], 0) + 1
        for state, n in counts.items():
            metrics.VOLUME_HEALTH.labels(state).set(n)
        return led

    def status(self) -> dict:
        return {
            "tokens": round(self.bucket.tokens, 2),
            "node_concurrency": self.node_concurrency,
            "active": sorted(self._active_vids),
            "backoffs": {str(v): {"failures": f,
                                  "retry_in_s": round(max(0.0, ts -
                                                          time.monotonic()),
                                                      1)}
                         for v, (f, ts) in self._backoff.items()},
            "history": self.history[-20:],
            "xrack": {
                "budget_bytes_per_s": self.xrack_bucket.rate,
                "burst_bytes": self.xrack_bucket.burst,
                "tokens": round(self.xrack_bucket.tokens),
                "waiting": sorted(self.waiting_xrack),
            },
            "decisions": self.decisions[-10:],
            "repair_bytes_by_locality": dict(self.locality_bytes),
        }

    # -- planning -------------------------------------------------------

    def _repair_node(self, info: dict) -> str | None:
        """The node a repair would run on (for the per-node cap): the EC
        rebuilder holding the most shards, or the copy target for an
        under-replicated volume."""
        if info["kind"] == "ec":
            counts: dict[str, int] = {}
            for nodes in info.get("shard_locations", {}).values():
                for url in nodes:
                    counts[url] = counts.get(url, 0) + 1
            return max(counts, key=counts.get) if counts else None
        free = info.get("free_slots", {})
        have = set(info.get("replicas", []))
        for url in sorted(free, key=lambda u: -free[u]):
            if url not in have and free[url] > 0:
                return url
        return None

    def _plan_survivors(self, info: dict,
                        shards: dict | None = None) -> dict | None:
        """Locality-aware survivor selection for one degraded EC volume.

        Ranks survivor sources by locality class relative to the chosen
        rebuilder (same node < same rack < same DC < other DC, labels
        from the heartbeat topology) and picks the MINIMAL set of helper
        nodes covering k survivors — with partial-sum aggregation every
        extra node costs one more shard-range of repair traffic, so
        fewer, closer nodes is strictly better.  Returns the plan plus
        exact-or-upper-bound byte estimates for both the reduced path
        and the naive copy-survivors baseline (the cross-rack budget
        debits whichever path will run); None when the volume is not a
        reducible EC repair (nothing missing, < k survivors, or no
        shard-size report yet)."""
        if info.get("kind") != "ec":
            return None
        spec = codec_tags.parse_tag(info.get("codec"))
        shards = {int(s): list(n) for s, n in
                  (shards if shards is not None
                   else info.get("shard_locations") or {}).items()
                  if n}
        missing = [s for s in range(spec.n)
                   if s not in shards]
        if not missing or len(shards) < spec.k:
            return None
        shard_size = int(info.get("shard_size") or 0)
        if shard_size <= 0:
            # no shard-size report (pre-upgrade helpers): every byte
            # estimate would be 0 and the cross-rack budget silently
            # bypassed — and such helpers can't serve /admin/ec/partial
            # anyway, so degrade honestly to the naive path
            return None
        node_loc = info.get("node_locality") or {}
        counts: dict[str, int] = {}
        for nodes in shards.values():
            for url in nodes:
                counts[url] = counts.get(url, 0) + 1
        rebuilder = max(counts, key=counts.get)
        rdc, rrack = node_loc.get(rebuilder, ("", ""))

        def loc_of(url: str) -> int:
            dc, rack = node_loc.get(url, ("", ""))
            return locality_class(rdc, rrack, dc, rack,
                                  same_node=url == rebuilder)

        local = sorted(s for s, nodes in shards.items()
                       if rebuilder in nodes)
        # codec-aware survivor demand: which shards the rebuild actually
        # reads, and how many bytes each helper shard ships per lost
        # shard.  RS: any k, full shard rows.  LRC: the lost shard's
        # local group (repair_support) — single-group fan-in, no wide
        # reads.  MSR: d whole helper files, each shipping one combined
        # sub-row (shard_size/alpha bytes) per lost shard.
        needed: set[int] | None = None  # None = any-k (MDS)
        per_helper_shard = shard_size
        need = spec.k - len(local)
        if spec.family == "lrc":
            from seaweedfs_tpu_torch.ops import lrc as _lrc
            code = _lrc.get_code(*spec.params)
            needed = set()
            cur = set(shards)
            for sid in missing:
                sup = code.repair_support(sid, sorted(cur))
                if sup is None:
                    needed = None
                    break
                needed |= set(sup) - {s for s in sup if s in missing}
                cur.add(sid)  # rebuilt: a survivor for the next loss
            if needed is None:
                try:
                    needed = set(code.decode_select(sorted(shards),
                                                    list(missing)))
                except ValueError:
                    return None
            need = len(needed - set(local))
        elif spec.family == "msr":
            d_helpers = spec.params[1]
            if len(shards) < d_helpers:
                # fewer than d survivors: the regenerating plan cannot
                # run; let the naive copy+rebuild path handle it
                return None
            need = d_helpers - len(local)
            per_helper_shard = shard_size // max(1, spec.alpha)
        remote_by_node: dict[str, list[int]] = {}
        naive_xrack = 0
        naive_by_loc: dict[str, int] = {}
        for sid, nodes in sorted(shards.items()):
            if rebuilder in nodes:
                continue
            if needed is not None and sid not in needed:
                continue  # outside the codec's survivor demand
            best = min(nodes, key=loc_of)
            remote_by_node.setdefault(best, []).append(sid)
            # the naive baseline copies EVERY survivor not already on
            # the rebuilder, from its first listed location
            src_loc = loc_of(nodes[0])
            if src_loc >= 2:
                naive_xrack += shard_size
            src = locality_name(src_loc)
            naive_by_loc[src] = naive_by_loc.get(src, 0) + shard_size
        ordered = sorted(remote_by_node.items(),
                         key=lambda kv: (loc_of(kv[0]), -len(kv[1]),
                                         kv[0]))
        groups: list[dict] = []
        have = 0
        for url, sids in ordered:
            if have >= need:
                break
            groups.append({"node": url, "shards": sorted(sids),
                           "locality": loc_of(url),
                           "shard_size": shard_size})
            have += len(sids)
        covered = len(local) + have if needed is None else \
            len([s for s in local if s in needed]) + have
        floor = need + (len(local) if needed is None
                        else len([s for s in local if s in needed]))
        if covered < floor or covered < min(
                spec.k, floor if needed is not None else spec.k):
            return None
        n_lost = len(missing)
        est_remote = n_lost * per_helper_shard * len(groups)
        est_xrack = n_lost * per_helper_shard * sum(
            1 for g in groups if g["locality"] >= 2)
        return {
            "rebuilder": rebuilder, "lost": missing, "groups": groups,
            "codec": spec.tag,
            "local_shards": local, "shard_size": shard_size,
            "est_remote_bytes": est_remote,
            "est_xrack_bytes": est_xrack,
            "naive_remote_bytes":
                (len(shards) - len(local)) * shard_size,
            "naive_xrack_bytes": naive_xrack,
            "naive_by_locality": naive_by_loc,
            "locality_classes": {g["node"]: g["locality"]
                                 for g in groups},
        }

    def _capacity_boost(self, infos) -> None:
        """Forward-looking urgency input from the capacity forecaster
        (stats/history.py): a repair whose survivors sit on a disk
        predicted to fill within FORECAST_URGENT_S moves up the
        queue — rebuild it while the bytes still have somewhere to go,
        instead of discovering the full disk mid-copy."""
        fc = getattr(self.master, "forecaster", None)
        if fc is None:
            return
        try:
            urgent = fc.filling_nodes(FORECAST_URGENT_S)
        except Exception:
            return
        if not urgent:
            return
        for info in infos:
            if info["kind"] == "ec":
                nodes = {url for locs in
                         info.get("shard_locations", {}).values()
                         for url in locs}
            else:
                nodes = set(info.get("replicas", []))
            if nodes & urgent:
                info["urgency"] += 1
                info["capacity_urgent"] = True

    async def tick(self) -> list[dict]:
        """One planning pass: launch repair tasks for the most urgent
        repairable volumes, bounded by the token bucket and per-node
        caps.  Returns the actions launched (not their outcomes — await
        wait_idle() for those)."""
        led = self.ledger()
        cands = [i for i in led.values()
                 if i["state"] in ("degraded", "corrupt",
                                   "under_replicated")]
        self._capacity_boost(cands)
        # urgency first (shards lost), then fewest survivors: the volume
        # closest to k survivors is one failure from data loss and must
        # reach the front of the queue — and of the cross-rack budget
        cands.sort(key=lambda i: (-i["urgency"],
                                  len(i.get("shards_present", ()))))
        now = time.monotonic()
        actions: list[dict] = []
        waiting_xrack: list[int] = []
        for info in cands:
            vid = info["vid"]
            if vid in self._active_vids:
                continue
            bo = self._backoff.get(vid)
            if bo and now < bo[1]:
                continue
            if info["kind"] == "normal" and info["state"] == "corrupt":
                # a corrupt store needle heals by replica reads + vacuum;
                # nothing to rebuild unless also under-replicated
                if len(info["replicas"]) >= info["want_replicas"]:
                    continue
            node = self._repair_node(info)
            if node is None:
                continue
            if self._active_nodes.get(node, 0) >= self.node_concurrency:
                continue
            # cross-rack budget: debit the estimated cross-rack bytes of
            # whichever path will run BEFORE launching; a repair the
            # bucket cannot cover waits for a later tick (refill), while
            # zero-cross-rack repairs further down the queue still run
            plan = self._plan_survivors(info)
            if plan is not None:
                info["_plan"] = plan
                est_x = plan["est_xrack_bytes"] if reduced_enabled() \
                    else plan["naive_xrack_bytes"]
                if est_x > 0 and not self.xrack_bucket.try_acquire(est_x):
                    waiting_xrack.append(vid)
                    continue
            if not self.bucket.try_acquire():
                if plan is not None:
                    # refund the cross-rack debit of a repair that never
                    # launched (clamped at burst like any refill)
                    self.xrack_bucket.credit(
                        plan["est_xrack_bytes"]
                        if reduced_enabled()
                        else plan["naive_xrack_bytes"])
                break  # rate-limited: later ticks pick up the rest
            self._active_vids.add(vid)
            self._active_nodes[node] = self._active_nodes.get(node, 0) + 1
            task = asyncio.create_task(self._run_one(info, node))
            self._tasks.add(task)
            task.add_done_callback(self._tasks.discard)
            actions.append({"vid": vid, "kind": info["kind"],
                            "state": info["state"], "node": node,
                            "urgency": info["urgency"]})
        self.waiting_xrack = waiting_xrack
        return actions

    async def wait_idle(self) -> None:
        while self._tasks:
            await asyncio.gather(*list(self._tasks),
                                 return_exceptions=True)

    # -- execution ------------------------------------------------------

    async def _post(self, url: str, path: str, body: dict) -> dict:
        import aiohttp
        # the master session's default 30s total timeout would abort a
        # realistically-sized shard copy or rebuild mid-flight (the shell
        # gives these 600s too)
        async with self.master._session.post(
                f"{_tls_scheme()}://{url}{path}", json=body,
                timeout=aiohttp.ClientTimeout(total=600)) as r:
            try:
                data = await r.json()
            except Exception:
                data = {}
            if r.status != 200:
                raise RuntimeError(
                    f"{url}{path}: HTTP {r.status} "
                    f"{data.get('error', '')}".strip())
            return data

    async def _run_one(self, info: dict, node: str) -> None:
        vid = info["vid"]
        t0 = time.monotonic()
        root = trace.new_root()
        outcome = "ok"
        try:
            # every byte this repair moves — survivor copies, purges,
            # rebuild orchestration, and the shard pulls the target
            # volume server makes on our behalf (the class header
            # re-enters its middleware) — books as class=repair
            with netflow.flow("repair"), \
                    trace.span("repair.volume", parent=root, vid=vid,
                               kind=info["kind"], state=info["state"],
                               urgency=info["urgency"]):
                if info["kind"] == "ec":
                    resolved = await self._repair_ec(vid, info)
                else:
                    await self._replicate_volume(vid, info, node)
                    resolved = set()
            self._backoff.pop(vid, None)
            # clear ONLY the verdicts this repair actually resolved
            # (purged + rebuilt); unlocalized or unpurgeable corruption
            # stays on the ledger until a scrub pass re-verifies it
            for rep in (self.scrub_reports.get(vid) or {}).values():
                rep["corrupt"] = [c for c in rep.get("corrupt", [])
                                  if c.get("shard", -1) not in resolved]
            metrics.REPAIR_ACTIONS.labels(info["kind"], "ok").inc()
        except Exception as e:
            n = self._backoff.get(vid, (0, 0.0))[0] + 1
            # decorrelated jitter (utils/resilience.py): N volumes whose
            # repairs failed together must not retry together
            delay = resilience.backoff_delay(n, self.backoff_base,
                                             self.backoff_max)
            self._backoff[vid] = (n, time.monotonic() + delay)
            metrics.REPAIR_ACTIONS.labels(info["kind"], "error").inc()
            outcome = f"error: {e}"
            log.warning("repair of volume %d failed (attempt %d, backoff "
                        "%.1fs): %s", vid, n, delay, e)
        finally:
            self._active_vids.discard(vid)
            left = self._active_nodes.get(node, 1) - 1
            if left <= 0:
                self._active_nodes.pop(node, None)
            else:
                self._active_nodes[node] = left
        self.history.append({"vid": vid, "kind": info["kind"],
                             "state": info["state"], "outcome": outcome,
                             "seconds": round(time.monotonic() - t0, 3)})
        del self.history[:-100]

    async def _repair_ec(self, vid: int, info: dict) -> set[int]:
        """Mirror of the shell's ec.rebuild for ONE volume, preceded by a
        purge of scrub-verdicted corrupt shards so the rebuild can never
        pick bad bytes as a survivor.  Returns the corrupt shard ids this
        run resolved; raises when corruption remains unresolved — a
        rebuild from possibly-corrupt survivors is worse than staying
        degraded behind the read-path quarantine."""
        shards = {sid: list(nodes)
                  for sid, nodes in info.get("shard_locations", {}).items()}
        resolved: set[int] = set()
        unresolved: list[str] = []
        for c in info.get("corrupt", []):
            sid, node = c.get("shard", -1), c.get("node")
            if sid < 0:
                # unlocalized: quarantine (when any) guards reads, but we
                # cannot pick a shard to replace — needs operator eyes
                unresolved.append("unlocalized corruption "
                                  f"at [{c.get('offset')}, "
                                  f"+{c.get('size')})")
                continue
            owners = shards.get(sid, [])
            if node not in owners:
                # remote-scrub verdicts name the REPORTING node; purge on
                # a node that actually owns the shard
                node = owners[0] if owners else None
            if node is None:
                resolved.add(sid)  # already gone: the loss path rebuilds
                continue
            # len(shards) tracks earlier purges in this loop already
            k_min = codec_tags.parse_tag(info.get("codec")).k
            if sid in shards and len(shards) - 1 < k_min:
                unresolved.append(
                    f"shard {sid} corrupt but only {len(shards)} shards "
                    "present — purging would drop below k")
                continue
            with trace.span("repair.purge_corrupt", vid=vid, shard=sid,
                            peer=node):
                await self._post(node, "/admin/ec/delete_shards",
                                 {"volume": vid, "shards": [sid]})
            nodes = shards.get(sid, [])
            if node in nodes:
                nodes.remove(node)
            if not nodes:
                shards.pop(sid, None)
            resolved.add(sid)
        if unresolved:
            # do NOT rebuild: /admin/ec/copy streams raw shard files (the
            # quarantine only guards needle reads), so a rebuild here
            # could bake the bad bytes into fresh shards
            raise RuntimeError("; ".join(unresolved))
        spec = codec_tags.parse_tag(info.get("codec"))
        present = set(shards)
        missing = [s for s in range(spec.n)
                   if s not in present]
        if not missing:
            return resolved
        if len(present) < spec.k:
            raise RuntimeError(
                f"only {len(present)} shards survive, need "
                f"{spec.k}")
        collection = info.get("collection", "")
        # survivor plan: the tick's (budget-debited) plan when the purge
        # loop above didn't change the shard map, else a fresh one
        plan = info.get("_plan")
        if plan is None or resolved or \
                sorted(plan["lost"]) != sorted(missing):
            plan = self._plan_survivors(info, shards=shards)
        # reduced pays whenever bytes would otherwise cross the network
        # (helper partials needed, or naive would copy survivors the
        # rebuilder doesn't even need).  With EVERY survivor already
        # local the plain rebuild moves zero repair bytes too and keeps
        # the faster native zero-copy decode path.
        if plan is not None and reduced_enabled() and \
                (plan["groups"] or plan["naive_remote_bytes"] > 0):
            rebuilder = plan["rebuilder"]
            with trace.span("repair.survivors", vid=vid,
                            rebuilder=rebuilder,
                            lost=",".join(map(str, missing)),
                            helpers=",".join(
                                f"{g['node']}:{g['locality']}"
                                for g in plan["groups"]),
                            est_remote_bytes=plan["est_remote_bytes"],
                            est_xrack_bytes=plan["est_xrack_bytes"]):
                try:
                    resp = await self._post(
                        rebuilder, "/admin/ec/rebuild",
                        {"volume": vid, "codec": spec.tag,
                         "reduced": {"lost": missing,
                                     "groups": plan["groups"],
                                     "shard_size": plan["shard_size"]}})
                except Exception as e:
                    # graceful degradation: the survivor-copy path below
                    # still heals (at naive cost); record why we fell back
                    log.warning("reduced rebuild of volume %d on %s "
                                "failed (%s); falling back to survivor "
                                "copies", vid, rebuilder, e)
                    self._record_decision(plan, vid, mode="naive_fallback",
                                          error=str(e))
                    # the tick debited only the reduced estimate; the
                    # survivor-copy path below moves naive-level
                    # cross-rack bytes, so force the shortfall into the
                    # bucket as debt — a cluster-wide fallback storm must
                    # still be throttled at the bytes it actually moves
                    self.xrack_bucket.force_debit(max(
                        0.0, plan["naive_xrack_bytes"]
                        - plan["est_xrack_bytes"]))
                    plan = None  # the tail must not record this twice
                else:
                    with trace.span("repair.mount", vid=vid,
                                    node=rebuilder):
                        await self._post(rebuilder, "/admin/ec/mount",
                                         {"volume": vid,
                                          "collection": collection})
                    self._record_decision(plan, vid, mode="reduced",
                                          result=resp)
                    log.info("repair: volume %d reduced-rebuilt shards "
                             "%s on %s (%d remote bytes, %d replans, "
                             "purged %d corrupt)", vid, missing,
                             rebuilder,
                             sum((resp.get("helper_bytes") or {})
                                 .values()),
                             resp.get("replans", 0), len(resolved))
                    return resolved
        counts: dict[str, int] = {}
        for nodes in shards.values():
            for url in nodes:
                counts[url] = counts.get(url, 0) + 1
        rebuilder = max(counts, key=counts.get)
        borrowed: list[int] = []
        for sid, nodes in sorted(shards.items()):
            if rebuilder in nodes:
                continue
            with trace.span("repair.copy_survivor", vid=vid, shard=sid,
                            source=nodes[0], target=rebuilder):
                await self._post(rebuilder, "/admin/ec/copy",
                                 {"volume": vid, "collection": collection,
                                  "source": nodes[0], "shards": [sid],
                                  "copy_ecx": False})
            borrowed.append(sid)
        with trace.span("repair.rebuild", vid=vid, node=rebuilder,
                        missing=len(missing)):
            await self._post(rebuilder, "/admin/ec/rebuild",
                             {"volume": vid, "codec": spec.tag})
        if borrowed:
            await self._post(rebuilder, "/admin/ec/delete_shards",
                             {"volume": vid, "shards": borrowed})
        with trace.span("repair.mount", vid=vid, node=rebuilder):
            await self._post(rebuilder, "/admin/ec/mount",
                             {"volume": vid, "collection": collection})
        if plan is not None:
            self._record_decision(plan, vid, mode="naive")
        log.info("repair: volume %d rebuilt shards %s on %s "
                 "(purged %d corrupt)", vid, missing, rebuilder,
                 len(resolved))
        return resolved

    def _record_decision(self, plan: dict, vid: int, mode: str,
                         result: dict | None = None,
                         error: str | None = None) -> None:
        """One survivor-selection audit record (surfaced in
        /maintenance/status) + the repair-byte-by-locality ledger."""
        rec = {"ts": round(time.time(), 3), "vid": vid, "mode": mode,
               "codec": plan.get("codec", "rs_10_4"),
               "rebuilder": plan["rebuilder"], "lost": plan["lost"],
               "helpers": [{"node": g["node"], "shards": g["shards"],
                            "locality": g["locality"]}
                           for g in plan["groups"]],
               "est_remote_bytes": plan["est_remote_bytes"],
               "est_xrack_bytes": plan["est_xrack_bytes"],
               "naive_remote_bytes": plan["naive_remote_bytes"]}
        if error:
            rec["error"] = error
        by_loc: dict[str, int] = {}
        if result is not None:
            rec["actual_bytes"] = sum(
                (result.get("helper_bytes") or {}).values())
            rec["replans"] = result.get("replans", 0)
            by_loc = dict(result.get("by_locality") or {})
        elif mode in ("naive", "naive_fallback"):
            # the naive path copies EVERY off-rebuilder survivor (not
            # just the reduced plan's minimal helper groups); attribute
            # them by each copy's first-listed source (estimate: the
            # copy handler doesn't report per-source bytes)
            by_loc = dict(plan.get("naive_by_locality") or {})
        for name, n in by_loc.items():
            self.locality_bytes[name] = \
                self.locality_bytes.get(name, 0) + n
            if result is None:
                # reduced-path bytes were already metered at the
                # rebuilder's fetch hop; the master only books the
                # naive-copy estimate nobody else measures
                metrics.REPAIR_BYTES.labels(name).inc(n)
        self.decisions.append(rec)
        del self.decisions[:-50]

    async def _replicate_volume(self, vid: int, info: dict,
                                target: str) -> None:
        source = (info.get("replicas") or [None])[0]
        if source is None:
            raise RuntimeError("no surviving replica to copy from")
        with trace.span("repair.replicate", vid=vid, source=source,
                        target=target):
            await self._post(target, "/admin/volume/copy",
                             {"volume": vid, "source": source,
                              "collection": info.get("collection", "")})
        log.info("repair: volume %d re-replicated %s -> %s", vid, source,
                 target)
