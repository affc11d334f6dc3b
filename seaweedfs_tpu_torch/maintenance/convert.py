"""Master-side fleet-conversion scheduler: paced background EC encode.

Counterpart of `seaweedfs_tpu/maintenance/convert.py`, whole.  The data
plane (ops/fleet_convert.py + the volume server's
/admin/ec/fleet_convert) can saturate every chip on a node; THIS module
decides when it is allowed to.  Conversion is planned background work —
the online-EC interference study (PAPERS.md, arXiv 1709.05365) shows a
foreground-speed conversion burst is indistinguishable from a repair
storm to the serving path — so the scheduler:

- queues volumes (``/maintenance/convert`` POST, the shell, or the
  autopilot demote path) and groups them by owning volume server, up to
  `NODE_BATCH` volumes per node call so each node's device stream gets
  real multi-volume batches to interleave;
- paces launches through a token bucket (`RATE` volumes/s, `BURST`)
  and never converts on a node the repair planner
  is actively repairing — loss recovery always outranks conversion;
- PAUSES while any alert EXACTLY named in WEEDTPU_CONVERT_PAUSE_ALERTS
  fires (default: ``interference_high,disk_full_soon``; exact-name
  matching — substring matching let a rule like
  ``no_interference_baseline`` pause conversion, the same bug class as
  the internal-path prefix fix).  When the interference governor
  (stats/interference.py) is active it supersedes the
  ``interference_high`` pause: continuous rate backoff replaces the
  binary stop, while capacity pauses (``disk_full_soon``) still halt
  conversion outright — a full disk is not a pacing problem;
- books every orchestration byte as netflow class=convert and rides the
  process retry budget (class ``convert``) with decorrelated-jitter
  backoff: a node that dies mid-conversion gets its volumes RE-QUEUED,
  not dropped — the volume server's tmp+rename contract means nothing
  partial is ever visible there.

Ticked by the master's background loop next to the repair planner, and
deterministically via POST /maintenance/convert {"tick": true}.  The
scheduler has no device: each node batch is one K2 launch stream on
the card volume server it calls.

Knobs: WEEDTPU_CONVERT_PAUSE_ALERTS (comma-separated alert names, read
at construction).  The reference's WEEDTPU_CONVERT_RATE, _BURST and
_BATCH, which nothing sets to a second value, are the constants
`RATE`, `BURST` and `NODE_BATCH` (the keywords still override them).
"""

from __future__ import annotations

import logging
import os
import time

from seaweedfs_tpu_torch.maintenance.repair import TokenBucket
from seaweedfs_tpu_torch.security.tls import scheme as _tls_scheme
from seaweedfs_tpu_torch.stats import interference, metrics, netflow, trace
from seaweedfs_tpu_torch.utils import resilience
from seaweedfs_tpu_torch.utils.http import post_json

log = logging.getLogger("convert")

RATE, BURST = 2.0, 8.0  # node-batch volumes launched per second, burst
NODE_BATCH = 4          # volumes per node call


class ConvertScheduler:
    """Queue + pacing for fleet EC conversion, one per master."""

    def __init__(self, master, *, rate: float | None = None,
                 burst: float | None = None,
                 node_batch: int | None = None):
        self.master = master
        self.bucket = TokenBucket(
            rate if rate is not None else RATE,
            burst if burst is not None else BURST)
        self.node_batch = node_batch if node_batch else NODE_BATCH
        self.pause_alerts = tuple(
            s.strip() for s in os.environ.get(
                "WEEDTPU_CONVERT_PAUSE_ALERTS",
                "interference_high,disk_full_soon").split(",")
            if s.strip())
        self.queued: list[int] = []
        self._queued_set: set[int] = set()
        self.active: set[int] = set()
        self._backoff: dict[int, tuple[int, float]] = {}
        self.history: list[dict] = []
        self.converted = 0
        self.failed_final = 0
        self.paused_reason: str | None = None
        # re-queue bookkeeping, surfaced as weedtpu_convert_requeued_total
        # and the /maintenance/convert "requeued" block: re-queues were
        # only visible in logs, and the autopilot must see the parked
        # backlog to avoid re-planning volumes already waiting here
        self.requeued_by_reason: dict[str, int] = {}
        # vids whose conversion should be SEALED on success: mount the
        # shard set and delete the .dat/.idx, so the EC set SERVES (the
        # autopilot demote's full tiering semantics; plain conversions
        # keep the frozen .dat as the fast read path)
        self._seal: set[int] = set()
        # seals that converted but then half-failed (mounted, .dat not
        # deleted — or neither): once the mount landed the ledger reads
        # the vid as EC, so the autopilot never re-plans it; the tick
        # retries these until the .dat is gone
        self._seal_stuck: set[int] = set()

    # -- intake ----------------------------------------------------------

    def enqueue(self, vids, seal: bool = False) -> list[int]:
        """Queue volumes for conversion (idempotent per vid).  With
        ``seal=True`` a successful conversion also mounts the shard set
        and deletes the source .dat — the demote-to-EC tiering step."""
        accepted = []
        for v in vids:
            try:
                vid = int(v)
            except (TypeError, ValueError):
                continue
            if seal:
                self._seal.add(vid)
            if vid in self._queued_set or vid in self.active:
                continue
            self.queued.append(vid)
            self._queued_set.add(vid)
            accepted.append(vid)
        return accepted

    def requeue(self, vids, error: str,
                reason: str = "node_error") -> None:
        """A node call failed: its volumes go back on the queue with
        per-vid exponential backoff (decorrelated jitter), never lost."""
        now = time.monotonic()
        for vid in vids:
            n = self._backoff.get(vid, (0, 0.0))[0] + 1
            delay = resilience.backoff_delay(n, 2.0, 300.0)
            self._backoff[vid] = (n, now + delay)
            if vid not in self._queued_set:
                self.queued.append(vid)
                self._queued_set.add(vid)
            metrics.CONVERT_REQUEUED.labels(reason).inc()
        self.requeued_by_reason[reason] = \
            self.requeued_by_reason.get(reason, 0) + len(vids)
        log.warning("conversion re-queued %s after: %s",
                    sorted(vids), error)

    # -- pacing gates ----------------------------------------------------

    def _paused_by_alert(self) -> str | None:
        """Name of a firing alert that pauses conversion, if any.
        EXACT-name matching against WEEDTPU_CONVERT_PAUSE_ALERTS — a
        rule named ``no_interference_baseline`` must not pause anything
        (the internal-path exact-or-slash rule, applied to alert
        names).  The
        interference-pacing rule is skipped while the governor is
        active: continuous backoff replaces the binary pause."""
        alerts = getattr(self.master, "alerts", None)
        if alerts is None or not self.pause_alerts:
            return None
        governed: str | None = None
        gov = getattr(self.master, "governor", None)
        if gov is not None:
            if interference.governor_enabled():
                governed = gov.INTERFERENCE_ALERT
        try:
            for rule in alerts.status().get("rules", []):
                if rule.get("state") != "firing":
                    continue
                name = rule.get("name", "")
                if name == governed:
                    continue  # the governor paces this one instead
                if name in self.pause_alerts:
                    return name
        except Exception:
            return None
        return None

    def _node_of(self, vid: int) -> str | None:
        """The volume server holding `vid` as a plain (non-EC) volume."""
        topo = self.master.topo
        with topo._lock:
            for url, node in topo.nodes.items():
                if vid in node.volumes:
                    return url
        return None

    # -- status ----------------------------------------------------------

    def status(self) -> dict:
        now = time.monotonic()
        return {
            "queued": list(self.queued),
            "active": sorted(self.active),
            "tokens": round(self.bucket.tokens, 2),
            "rate_per_s": self.bucket.rate,
            "node_batch": self.node_batch,
            "paused": self.paused_reason,
            "pause_alerts": list(self.pause_alerts),
            "converted": self.converted,
            "failed": self.failed_final,
            "backoffs": {str(v): {"failures": f,
                                  "retry_in_s": round(max(0.0, ts - now),
                                                      1)}
                         for v, (f, ts) in self._backoff.items()},
            # the re-queue backlog as structured data: total per reason
            # plus the vids currently parked behind a backoff — the
            # autopilot reads this (and `queued`/`active` above) so it
            # never re-plans a volume already in the pipeline
            "requeued": {
                "total": sum(self.requeued_by_reason.values()),
                "by_reason": dict(self.requeued_by_reason),
                "parked": sorted(self._backoff),
            },
            "sealing": sorted(self._seal),
            "seal_stuck": sorted(self._seal_stuck),
            "history": self.history[-10:],
        }

    # -- execution -------------------------------------------------------

    async def tick(self) -> list[dict]:
        """Launch as many paced node-batches as tokens allow.  Returns
        the launched action records (awaited to completion: conversion
        ticks are deterministic for tests and the chaos driver, and the
        per-node HTTP call itself is the long-running part)."""
        self.paused_reason = self._paused_by_alert()
        if self.paused_reason:
            return []
        await self._retry_stuck_seals()
        if not self.queued:
            return []
        repair_active = dict(getattr(self.master.maintenance,
                                     "_active_nodes", {}))
        now = time.monotonic()
        by_node: dict[str, list[int]] = {}
        unplaceable: list[int] = []
        for vid in list(self.queued):
            bk = self._backoff.get(vid)
            if bk and bk[1] > now:
                continue  # backing off: stays queued for a later tick
            node = self._node_of(vid)
            if node is None:
                if vid in self._backoff:
                    # its node failed a conversion recently and may have
                    # aged out of the topology while down: keep the vid
                    # queued for the node's return (re-queued, never
                    # dropped) instead of declaring it unplaceable
                    continue
                unplaceable.append(vid)
                continue
            if repair_active.get(node):
                continue  # repair on that node outranks conversion
            if len(by_node.setdefault(node, [])) < self.node_batch:
                by_node[node].append(vid)
        # volumes with no locatable .dat (already EC, deleted) drop out
        for vid in unplaceable:
            self._drop(vid)
            self._seal.discard(vid)
            self.history.append({"vid": vid, "outcome": "unplaceable"})
        actions: list[dict] = []
        for node, vids in by_node.items():
            granted = [v for v in vids if self.bucket.try_acquire(1.0)]
            if not granted:  # dry bucket: the rest stays queued
                continue
            for v in granted:
                self._drop(v)
                self.active.add(v)
            actions.append(await self._convert_on(node, granted))
        del self.history[:-100]
        return actions

    def _drop(self, vid: int) -> None:
        if vid in self._queued_set:
            self._queued_set.discard(vid)
            try:
                self.queued.remove(vid)
            except ValueError:
                pass

    async def _convert_on(self, node: str, vids: list[int]) -> dict:
        import aiohttp
        t0 = time.monotonic()
        rec = {"node": node, "volumes": list(vids)}
        try:
            # class=convert on every hop (the volume server's middleware
            # re-enters the class for the hops IT makes on our behalf);
            # retries ride the process-wide budget under their own class
            # so a conversion storm can't starve repair retries
            with netflow.flow("convert"), \
                    trace.span("convert.batch", node=node,
                               volumes=len(vids)):
                async def _once():
                    async with self.master._session.post(
                            f"{_tls_scheme()}://{node}"
                            f"/admin/ec/fleet_convert",
                            json={"volumes": vids},
                            timeout=aiohttp.ClientTimeout(total=600)
                    ) as r:
                        try:
                            data = await r.json()
                        except Exception:
                            data = {}
                        if r.status != 200:
                            raise RuntimeError(
                                f"{node}: HTTP {r.status} "
                                f"{data.get('error', '')}".strip())
                        return data

                # inline-retry ONLY connection-level failures (refused,
                # reset): a timeout may mean the conversion is STILL
                # RUNNING server-side, and an HTTP error won't change on
                # replay — both fall through to requeue-with-backoff,
                # which revisits once the node's job table settles
                data = await resilience.retry_async(
                    _once, attempts=2, cls="convert",
                    retry_on=(ConnectionError,
                              aiohttp.ClientConnectionError))
            done = [int(v) for v in data.get("converted", [])]
            rec.update(outcome="ok", converted=done,
                       bytes=data.get("bytes"),
                       wall_s=data.get("wall_s"))
            self.converted += len(done)
            for vid in vids:
                self._backoff.pop(vid, None)
            sealed = await self._seal_converted(node, done)
            if sealed:
                rec["sealed"] = sealed
            missed = [v for v in vids if v not in done]
            if missed:
                # the node skipped some (busy/not found): try again later
                self.requeue(missed, f"skipped by {node}",
                             reason="skipped")
        except Exception as e:
            rec.update(outcome=f"error: {e}")
            self.requeue(vids, str(e))
        finally:
            for vid in vids:
                self.active.discard(vid)
        rec["seconds"] = round(time.monotonic() - t0, 3)
        self.history.append(rec)
        return rec

    async def _seal_converted(self, node: str, done: list[int]
                              ) -> list[int]:
        """Finish the demote for seal-flagged conversions: mount the
        committed shard set and delete the source .dat/.idx, so the EC
        set SERVES (and the disk space comes back).  Runs only AFTER
        the tmp+rename commit — a seal failure leaves the safe
        intermediate state (frozen .dat + full shard set), parked on
        _seal_stuck and retried by later ticks (once the mount landed
        the ledger reads the vid as EC, so the AUTOPILOT cannot re-plan
        it — the retry must live here), never a volume with neither
        copy."""
        sealed: list[int] = []
        for vid in done:
            if vid not in self._seal:
                continue
            try:
                with netflow.flow("convert"), \
                        trace.span("convert.seal", node=node, vid=vid):
                    for path in ("/admin/ec/mount",
                                 "/admin/volume/delete"):
                        await post_json(self.master._session, node,
                                        path, {"volume": vid},
                                        timeout=60.0)
                self._seal.discard(vid)
                self._seal_stuck.discard(vid)
                sealed.append(vid)
            except Exception as e:
                self._seal_stuck.add(vid)
                log.warning("seal of converted volume %d on %s failed "
                            "(stays frozen with its shard set; will "
                            "retry): %s", vid, node, e)
        return sealed

    async def _retry_stuck_seals(self) -> None:
        """Finish seals whose mount/delete hop failed after the
        conversion committed.  Both steps are idempotent (re-mount of a
        mounted set is a no-op, delete of a deleted .dat is a no-op),
        so retrying is always safe; a vid whose node is gone stays
        parked for the node's return."""
        for vid in list(self._seal_stuck):
            if vid in self.active:
                continue
            node = self._node_of(vid)
            if node is None:
                # .dat already gone (delete succeeded, mount was the
                # failure — or the node left): nothing further to seal
                # here once no node reports the plain volume
                self._seal_stuck.discard(vid)
                self._seal.discard(vid)
                continue
            await self._seal_converted(node, [vid])
