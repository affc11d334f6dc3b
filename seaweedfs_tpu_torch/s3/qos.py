"""Per-tenant QoS admission at the s3 edge.

One abusive tenant must degrade into its own 429s, not into another
tenant's latency SLO.  The gateway holds a token bucket per tenant
(maintenance/repair.py's TokenBucket — the same primitive the repair
and autopilot planes are paced and governed by) and sheds a request
BEFORE any filer work happens when its tenant's bucket is dry.

Shares are heat-driven: the configured per-tenant weights
(`WEEDTPU_S3_QOS_WEIGHTS`, e.g. "alice=4,bob=1,default=1") are
normalized over the tenants the local heat sketch says are ACTIVE, so
an idle premium tenant does not dilute the live ones — its share snaps
back the refresh after it returns.  Total admission rate is
`WEEDTPU_S3_QOS_RATE` requests/s (0 disables admission entirely); the
`set_rate` seam makes the whole plane retunable by the governor exactly
like every other TokenBucket it owns.

Counterpart of `seaweedfs_tpu/s3/qos.py`, whole but for its knobs: a
malformed `WEEDTPU_S3_QOS_RATE`, `_BURST`, `_REFRESH` or `_WEIGHTS` raises
ValueError when the gateway is constructed, as the port's other knobs do,
where the reference falls back to the default (`_WEIGHTS` raises on a
pair that `parse_weights` would drop).
"""

from __future__ import annotations

import os
import threading
import time

from seaweedfs_tpu_torch.maintenance.repair import TokenBucket
from seaweedfs_tpu_torch.stats import heat, metrics
from seaweedfs_tpu_torch.utils.resilience import _env_float

# a tenant absent from the heat sketch still gets a bucket on first
# sight; it joins the weighted split at the next refresh
MAX_TENANT_BUCKETS = 1024


def parse_weights(spec: str) -> dict[str, float]:
    """"alice=4,bob=1,default=1" -> {"alice": 4.0, ...}.  Unparseable
    pairs are dropped; the implicit default weight is 1.0."""
    out: dict[str, float] = {}
    for pair in (spec or "").split(","):
        name, sep, val = pair.partition("=")
        name = name.strip()
        if not sep or not name:
            continue
        try:
            w = float(val)
        except ValueError:
            continue
        if w >= 0:
            out[name] = w
    return out


def _env_weights(name: str) -> dict[str, float]:
    """The weights knob, strictly: a pair `parse_weights` would drop
    raises ValueError."""
    spec = os.environ.get(name, "")
    weights = parse_weights(spec)
    pairs = [p for p in spec.split(",") if p.strip()]
    if len(weights) != len(pairs):
        raise ValueError(f"{name}={spec!r}: want name=weight pairs, "
                         "weights >= 0")
    return weights


class TenantQoS:
    def __init__(self, rate: float | None = None,
                 burst_s: float | None = None,
                 weights: dict[str, float] | None = None,
                 refresh_s: float | None = None):
        self.total_rate = rate if rate is not None else \
            _env_float("WEEDTPU_S3_QOS_RATE", 0.0)
        # burst is expressed in SECONDS of a tenant's rate, so a heavy
        # tenant gets a proportionally deeper bucket than a light one
        self.burst_s = burst_s if burst_s is not None else \
            _env_float("WEEDTPU_S3_QOS_BURST", 2.0)
        self.weights = weights if weights is not None else \
            _env_weights("WEEDTPU_S3_QOS_WEIGHTS")
        self.refresh_s = refresh_s if refresh_s is not None else \
            _env_float("WEEDTPU_S3_QOS_REFRESH", 2.0)
        self._buckets: dict[str, TokenBucket] = {}
        self._shares: dict[str, float] = {}
        self._next_refresh = 0.0
        self._lock = threading.Lock()
        self.admitted = 0
        self.shed = 0
        self.shed_by_tenant: dict[str, int] = {}
        self.refreshes = 0

    @property
    def enabled(self) -> bool:
        return self.total_rate > 0

    def weight(self, tenant: str) -> float:
        return self.weights.get(tenant, self.weights.get("default", 1.0))

    # -- admission -------------------------------------------------------

    def admit(self, tenant: str) -> bool:
        """One request from `tenant` wants in.  True admits; False means
        the edge sheds it as a 429 before any filer work happens."""
        if not self.enabled:
            return True
        now = time.time()
        with self._lock:
            if now >= self._next_refresh:
                self._refresh_locked()
                self._next_refresh = now + self.refresh_s
            bucket = self._buckets.get(tenant)
            if bucket is None:
                bucket = self._make_bucket_locked(tenant)
        ok = bucket.try_acquire()
        if ok:
            self.admitted += 1
            metrics.S3_QOS.labels("admitted").inc()
        else:
            self.shed += 1
            self.shed_by_tenant[tenant] = \
                self.shed_by_tenant.get(tenant, 0) + 1
            metrics.S3_QOS.labels("shed").inc()
        return ok

    def _make_bucket_locked(self, tenant: str) -> TokenBucket:
        """First sight of a tenant between refreshes: give it the share
        it WOULD have had in the current split (the next refresh folds
        it in properly)."""
        rate = self._shares.get(tenant)
        if rate is None:
            known = set(self._shares) | {tenant}
            total_w = sum(self.weight(t) for t in known) or 1.0
            rate = self.total_rate * self.weight(tenant) / total_w
        b = TokenBucket(rate, max(1.0, rate * self.burst_s))
        self._buckets[tenant] = b
        return b

    def _active_tenants(self) -> set[str]:
        """Tenants the local heat sketch shows live traffic for (the
        sketch decays, so a gone-quiet tenant ages out on its own)."""
        try:
            view = heat.merge_serialized([heat.serialize()])
        except Exception:
            return set()
        return {str(e["key"]) for e
                in (view.get("tenants") or {}).get("top", [])
                if e.get("rps", 0) > 0.01}

    def _refresh_locked(self) -> None:
        """Recompute the weighted split over active tenants (plus every
        explicitly weighted one) and retune the live buckets.  set_rate
        settles accrued tokens at the old rate first, so a tenant's
        earned burst survives the retune."""
        self.refreshes += 1
        active = self._active_tenants()
        active |= {t for t in self.weights if t != "default"}
        active |= set(self._buckets)
        if not active:
            return
        total_w = sum(self.weight(t) for t in active) or 1.0
        self._shares = {t: self.total_rate * self.weight(t) / total_w
                        for t in active}
        for t, rate in self._shares.items():
            b = self._buckets.get(t)
            if b is not None:
                b.set_rate(rate)
                b.burst = max(1.0, rate * self.burst_s)
        # bound the table: drop buckets for tenants that fell out of the
        # active set (they re-enter through _make_bucket_locked)
        if len(self._buckets) > MAX_TENANT_BUCKETS:
            for t in list(self._buckets):
                if t not in active:
                    del self._buckets[t]

    # -- governor / operator seam ---------------------------------------

    def set_rate(self, total: float) -> None:
        """Retune the total admission rate; per-tenant splits follow at
        the next refresh (forced now)."""
        with self._lock:
            self.total_rate = max(0.0, float(total))
            self._next_refresh = 0.0

    def configure(self, rate: float | None = None,
                  burst_s: float | None = None,
                  weights: dict[str, float] | None = None) -> None:
        """Live reconfiguration (the /__qos__ POST face and the chaos
        harness use this)."""
        with self._lock:
            if rate is not None:
                self.total_rate = max(0.0, float(rate))
            if burst_s is not None:
                self.burst_s = max(0.0, float(burst_s))
            if weights is not None:
                self.weights = dict(weights)
            self._next_refresh = 0.0

    def status(self) -> dict:
        with self._lock:
            return {"enabled": self.enabled,
                    "total_rate": self.total_rate,
                    "burst_s": self.burst_s,
                    "refresh_s": self.refresh_s,
                    "weights": dict(self.weights),
                    "admitted": self.admitted, "shed": self.shed,
                    "refreshes": self.refreshes,
                    "shed_by_tenant": dict(self.shed_by_tenant),
                    "tenants": {t: {"rate_per_s": round(b.rate, 3),
                                    "burst": round(b.burst, 2),
                                    "tokens": round(b.tokens, 2)}
                                for t, b in self._buckets.items()}}
