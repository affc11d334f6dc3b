"""Byte-flow accounting: network bytes per traffic class, per direction.

Counterpart of `seaweedfs_tpu/stats/netflow.py`.  Every byte that crosses
a process boundary is counted into
``weedtpu_net_bytes_total{direction,class,peer_role}`` (body bytes, so
sender and receiver totals conserve per class).  The traffic class rides
a contextvar (``flow("repair")``): a call site declares its class once
and every hop made under it inherits it.  The port's data plane declares
``repair`` around `rebuild_ec_files` and `rebuild_ec_reduced` and
``convert`` around `convert_volumes` (each of its threads), as the
reference does.  The pooled client (utils/http.py) stamps the class and
its own role on every request (``X-Weedtpu-Class``, ``X-Weedtpu-Role``:
`inject`) and books the bytes it moves; a server reads the class back
with `extract_class`.  The aiohttp role-stamping hook and the
reference's ``WEEDTPU_NETFLOW`` switch come with the servers (ROADMAP
1.15a.3).

Classes: ``data``, ``replication``, ``repair``, ``convert``,
``rebalance``, ``scrub``, ``readahead``, ``internal``.  Unlabelled
traffic classifies by path: cluster-internal surfaces are ``internal``,
everything else ``data``.
"""

from __future__ import annotations

from contextvars import ContextVar

from seaweedfs_tpu_torch.stats import metrics

CLASS_HEADER = "X-Weedtpu-Class"
ROLE_HEADER = "X-Weedtpu-Role"

CLASSES = frozenset({"data", "replication", "repair", "convert",
                     "rebalance", "scrub", "readahead", "internal"})

# cluster-internal surfaces (monitoring, heartbeats, raft, debug,
# maintenance, admin control traffic)
INTERNAL_PREFIXES = ("/metrics", "/heartbeat", "/raft", "/debug",
                     "/cluster", "/maintenance", "/admin",
                     "/__meta__", "/__admin__", "/__ui__", "/status")

# exact-path-only internal surfaces: a bucket named "heat" keeps its
# object traffic (/heat/obj) on the data plane
INTERNAL_EXACT = ("/heat", "/perf")


def is_internal(path: str) -> bool:
    """Exact-or-slash matching: /status-reports/x is data-plane traffic,
    not internal."""
    return path in INTERNAL_EXACT or \
        any(path == p or path.startswith(p + "/")
            for p in INTERNAL_PREFIXES)


def classify(path: str) -> str:
    """Default class for traffic nobody labelled explicitly."""
    return "internal" if is_internal(path) else "data"


_flow: ContextVar[str | None] = ContextVar("weedtpu_netflow", default=None)

# the remote region a call is about to cross a WAN boundary toward; while
# set, account() books the same bytes again into weedtpu_wan_bytes_total
_wan_region: ContextVar[str | None] = ContextVar(
    "weedtpu_wan_region", default=None)


def current_class() -> str | None:
    return _flow.get()


class wan:
    """``with wan("region-b"):`` books every request made inside as WAN
    traffic toward that remote region, on top of the per-class ledger."""

    __slots__ = ("region", "_token")

    def __init__(self, region: str):
        self.region = region

    def __enter__(self):
        self._token = _wan_region.set(self.region)
        return self

    def __exit__(self, *exc):
        _wan_region.reset(self._token)
        return False


def set_class(cls: str | None):
    """Raw contextvar set -> reset token (for code that must stamp a
    class on a thread it does not bracket; call sites prefer `flow`)."""
    return _flow.set(cls)


def reset(token) -> None:
    _flow.reset(token)


class flow:
    """``with flow("repair"):`` gives every request made inside (same
    thread, or asyncio work spawned from it) that traffic class.  A
    contextvar does not cross into threads: a pipeline re-stamps it on
    each of its own threads (`set_class`)."""

    __slots__ = ("cls", "_token")

    def __init__(self, cls: str):
        self.cls = cls if cls in CLASSES else "data"

    def __enter__(self):
        self._token = _flow.set(self.cls)
        return self

    def __exit__(self, *exc):
        _flow.reset(self._token)
        return False


def account(direction: str, cls: str | None, peer_role: str,
            nbytes: int) -> None:
    """Book `nbytes` body bytes moving `direction` for traffic class `cls`
    against `peer_role`.  Zero-byte moves are not booked.  Inside an
    ambient ``wan(region)`` the same bytes also go to the WAN ledger
    against that remote region."""
    if nbytes <= 0:
        return
    if cls not in CLASSES:
        cls = "data"
    metrics.NET_BYTES.labels(direction, cls,
                             peer_role or "client").inc(nbytes)
    region = _wan_region.get()
    if region:
        metrics.WAN_BYTES.labels(direction, cls, region).inc(nbytes)


def class_total(direction: str, cls: str) -> float:
    """This process's ledger for one (direction, class), summed over
    peer roles."""
    total = 0.0
    for labels, child in metrics.NET_BYTES._pairs():
        ld = dict(labels)
        if ld.get("direction") == direction and ld.get("class") == cls:
            total += child.value
    return total


def wan_total(direction: str, region: str | None = None) -> float:
    """The WAN ledger for one direction (and one remote region, when
    given), summed over classes."""
    total = 0.0
    for labels, child in metrics.WAN_BYTES._pairs():
        ld = dict(labels)
        if ld.get("direction") != direction:
            continue
        if region is not None and ld.get("region") != region:
            continue
        total += child.value
    return total


def inject(headers: dict, path: str = "", role: str | None = None) -> dict:
    """Stamp the outgoing class (the ambient flow class, else the path's
    default) and the caller's role onto a header dict, in place."""
    headers[CLASS_HEADER] = _flow.get() or classify(path)
    if role:
        headers[ROLE_HEADER] = role
    return headers


def extract_class(headers, path: str) -> str:
    """Server-side class: the caller's declared class when valid, else
    the path's default."""
    cls = headers.get(CLASS_HEADER, "")
    return cls if cls in CLASSES else classify(path)
