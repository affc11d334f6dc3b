"""Fault injection: damage a store, cut links or fail a disk on purpose.

Counterpart of `seaweedfs_tpu/maintenance/faults.py`.

**Store faults**, applied to one volume server's Store, from the
WEEDTPU_FAULTS environment variable at the server's start or live through
its loopback-only /admin/faults:

  delete_shard:vid:sid          remove one EC shard file and close its fd
                                in the mounted EcVolume ("disk died")
  flip_bit:vid:sid:offset[:bit] XOR one bit of a shard file in place:
                                silent corruption the scrubber must find
  delay_shard_read:ms           stall every /admin/ec/shard_read and
                                /admin/ec/partial answer (server state)
  delay_file_pull:ms            stall every /admin/file peer pull (server
                                state): holds a volume copy or move open

**Process-wide faults**, a module registry that the HTTP clients
(`PooledHTTP`, the servers' aiohttp sessions), the volume server's shard
reader and partial fetcher and the EC shard writers consult, so servers
sharing one interpreter can cut links and fail disks:

  partition:a:b                 refuse dials between a and b (each a role
                                such as "volume", a netloc,
                                "region:<name>" or "*"); both ways
  unpartition:a:b               lift it
  peer_latency:dst:ms[:jitter]  add latency to every dial toward dst
                                (role or netloc)
  region_partition:a:b          refuse every dial crossing the a<->b
                                region boundary (register_region)
  region_unpartition:a:b        lift it
  wan_latency:a:b:ms[:jitter]   add latency only to dials crossing the
                                a<->b region boundary
  peer_error:dst:pct            fail requests toward dst with probability
                                pct/100 (an injected ConnectionResetError)
  shard_write_error:EIO|ENOSPC  every EC shard write (encode, rebuild,
                                reduced repair, fleet conversion) raises
                                that OSError before any `.tmp` shard file
                                opens; "off" clears
  clear_net                     drop every process-wide fault

Env spec: directives joined by ';', e.g.
  WEEDTPU_FAULTS="delete_shard:1:3;flip_bit:1:7:4096;partition:volume:*"

Servers call ``register_node(netloc, role)`` at start, so a role's
partition finds a dial's destination netloc.  Every check is a test of
one module global (`NET_ACTIVE`) while nothing is armed.  An unknown or
malformed directive raises ValueError (the reference drops it).
"""

from __future__ import annotations

import errno as _errno
import logging
import os
import random
import threading

from seaweedfs_tpu_torch.storage.ec import layout

log = logging.getLogger("faults")

STORE_ACTIONS = ("delete_shard", "flip_bit", "delay_shard_read",
                 "delay_file_pull")
NET_ACTIONS = ("partition", "unpartition", "region_partition",
               "region_unpartition", "wan_latency", "peer_latency",
               "peer_error", "shard_write_error", "clear_net")

_rand = random.Random()

# -- the process-wide registry ------------------------------------------

_lock = threading.Lock()
_partitions: set[tuple[str, str]] = set()        # both ways
_latency: dict[str, tuple[float, float]] = {}    # dst -> (ms, jitter_ms)
_error_rate: dict[str, float] = {}               # dst -> probability 0..1
_disk_shard_write: str | None = None             # "EIO" | "ENOSPC" | None
_roles: dict[str, str] = {}                      # netloc -> role
_regions: dict[str, str] = {}                    # netloc -> region name
# unordered region pair -> (ms, jitter_ms), charged only to a dial that
# crosses that boundary
_wan_latency: dict[tuple[str, str], tuple[float, float]] = {}
NET_ACTIVE = False  # the hot paths' gate: True while any fault is armed


def register_node(netloc: str, role: str) -> None:
    """Record netloc -> role, so a role's partition matches a dial's
    destination.  Every server calls it at start."""
    _roles[netloc] = role


def register_region(netloc: str, region: str) -> None:
    """Record netloc -> region for region_partition and wan_latency."""
    if region:
        _regions[netloc] = region


def _recompute_active() -> None:
    global NET_ACTIVE
    NET_ACTIVE = bool(_partitions or _latency or _error_rate
                      or _wan_latency or _disk_shard_write)


def clear_net() -> None:
    global _disk_shard_write
    with _lock:
        _partitions.clear()
        _latency.clear()
        _error_rate.clear()
        _wan_latency.clear()
        _disk_shard_write = None
        _recompute_active()


def add_partition(a: str, b: str) -> None:
    with _lock:
        _partitions.add((a, b))
        _recompute_active()


def remove_partition(a: str, b: str) -> None:
    with _lock:
        _partitions.discard((a, b))
        _partitions.discard((b, a))
        _recompute_active()


def set_peer_latency(dst: str, ms: float, jitter_ms: float = 0.0) -> None:
    with _lock:
        if ms <= 0 and jitter_ms <= 0:
            _latency.pop(dst, None)
        else:
            _latency[dst] = (ms, jitter_ms)
        _recompute_active()


def set_peer_error_rate(dst: str, pct: float) -> None:
    with _lock:
        if pct <= 0:
            _error_rate.pop(dst, None)
        else:
            _error_rate[dst] = min(1.0, pct / 100.0)
        _recompute_active()


def set_shard_write_error(kind: str | None) -> None:
    """Arm "EIO" or "ENOSPC"; anything else ("off", None) clears."""
    global _disk_shard_write
    with _lock:
        _disk_shard_write = kind if kind in ("EIO", "ENOSPC") else None
        _recompute_active()


def set_wan_latency(region_a: str, region_b: str, ms: float,
                    jitter_ms: float = 0.0) -> None:
    key = (min(region_a, region_b), max(region_a, region_b))
    with _lock:
        if ms <= 0 and jitter_ms <= 0:
            _wan_latency.pop(key, None)
        else:
            _wan_latency[key] = (ms, jitter_ms)
        _recompute_active()


def net_snapshot() -> dict:
    with _lock:
        return {"partitions": sorted(list(p) for p in _partitions),
                "latency_ms": {d: list(v) for d, v in _latency.items()},
                "wan_latency_ms": {f"{a}<->{b}": list(v)
                                   for (a, b), v in _wan_latency.items()},
                "error_rate": {d: round(p * 100.0, 1)
                               for d, p in _error_rate.items()},
                "shard_write_error": _disk_shard_write,
                "nodes": dict(_roles),
                "regions": dict(_regions)}


def _ids(netloc_or_role: str) -> set[str]:
    """Every identity a side of a dial answers to: its name, its
    registered role and region, and the wildcard."""
    out = {netloc_or_role, "*"}
    role = _roles.get(netloc_or_role)
    if role:
        out.add(role)
    region = _regions.get(netloc_or_role)
    if region:
        out.add("region:" + region)
    return out


def _side_ids(src) -> set[str]:
    """The caller side's identities: a role string, or an iterable of
    identities (a role and "region:<r>")."""
    if isinstance(src, str):
        return _ids(src)
    out: set[str] = set()
    for s in src:
        out |= _ids(s)
    return out or {"*"}


def check_dial(src, dst_netloc: str) -> None:
    """Raise ConnectionRefusedError when (src, dst) crosses an armed
    partition.  `src` is the caller's role (a client knows no netloc of
    its own) or an iterable of identities."""
    if not NET_ACTIVE:
        return
    srcs = _side_ids(src)
    dsts = _ids(dst_netloc)
    with _lock:
        parts = list(_partitions)
    for a, b in parts:
        if (a in srcs and b in dsts) or (a in dsts and b in srcs):
            raise ConnectionRefusedError(
                _errno.ECONNREFUSED,
                f"faults: partition {a}<->{b} refuses {src} -> "
                f"{dst_netloc}")


def dial_latency_s(dst_netloc: str) -> float:
    """The latency (seconds) armed toward dst, 0 when none is."""
    if not NET_ACTIVE:
        return 0.0
    with _lock:
        lat = dict(_latency)
    for key in _ids(dst_netloc):
        if key in lat:
            ms, jitter = lat[key]
            return max(0.0, ms + _rand.uniform(-jitter, jitter)) / 1000.0
    return 0.0


def maybe_inject_error(dst_netloc: str) -> None:
    """Raise ConnectionResetError with the probability armed for dst."""
    if not NET_ACTIVE:
        return
    with _lock:
        rates = dict(_error_rate)
    for key in _ids(dst_netloc):
        p = rates.get(key)
        if p is not None and _rand.random() < p:
            raise ConnectionResetError(
                _errno.ECONNRESET,
                f"faults: injected error toward {dst_netloc}")


def wan_latency_s(src, dst_netloc: str) -> float:
    """The WAN latency (seconds) of a dial that crosses an armed region
    boundary, 0 otherwise."""
    if not NET_ACTIVE:
        return 0.0
    with _lock:
        lat = dict(_wan_latency)
    if not lat:
        return 0.0
    srcs = _side_ids(src)
    dsts = _ids(dst_netloc)
    for (a, b), (ms, jitter) in lat.items():
        ra, rb = "region:" + a, "region:" + b
        if (ra in srcs and rb in dsts) or (ra in dsts and rb in srcs):
            return max(0.0, ms + _rand.uniform(-jitter, jitter)) / 1000.0
    return 0.0


def check_net(src, dst_netloc: str) -> float:
    """The clients' one hook: the partition check and the error
    injection; returns the latency (seconds) the caller sleeps."""
    if not NET_ACTIVE:
        return 0.0
    check_dial(src, dst_netloc)
    maybe_inject_error(dst_netloc)
    return dial_latency_s(dst_netloc) + wan_latency_s(src, dst_netloc)


def check_shard_write(path: str) -> None:
    """Raise the armed disk error before an EC shard write."""
    kind = _disk_shard_write
    if kind is None:
        return
    if kind == "ENOSPC":
        raise OSError(_errno.ENOSPC,
                      f"faults: injected ENOSPC writing shards for {path}")
    raise OSError(_errno.EIO,
                  f"faults: injected EIO writing shards for {path}")


# -- env / admin parsing -------------------------------------------------

def parse_env(spec: str) -> list[dict]:
    """WEEDTPU_FAULTS -> parsed faults, in the reference's form.  An
    unknown or malformed directive raises ValueError naming it (the
    reference logs and drops it): a fault plan with a typo must not start
    a server that injects nothing."""
    out: list[dict] = []
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        action = fields[0]
        if action not in STORE_ACTIONS + NET_ACTIONS:
            raise ValueError(f"WEEDTPU_FAULTS: unknown directive {part!r}")
        try:
            if action == "delete_shard":
                out.append({"action": action, "volume": int(fields[1]),
                            "shard": int(fields[2])})
            elif action == "flip_bit":
                out.append({"action": action, "volume": int(fields[1]),
                            "shard": int(fields[2]),
                            "offset": int(fields[3]),
                            "bit": int(fields[4]) if len(fields) > 4 else 0})
            elif action in ("delay_shard_read", "delay_file_pull"):
                out.append({"action": action, "ms": float(fields[1])})
            elif action in ("partition", "unpartition",
                            "region_partition", "region_unpartition"):
                out.append({"action": action, "a": fields[1],
                            "b": fields[2]})
            elif action == "wan_latency":
                out.append({"action": action, "a": fields[1],
                            "b": fields[2], "ms": float(fields[3]),
                            "jitter": float(fields[4])
                            if len(fields) > 4 else 0.0})
            elif action == "peer_latency":
                out.append({"action": action, "dst": fields[1],
                            "ms": float(fields[2]),
                            "jitter": float(fields[3])
                            if len(fields) > 3 else 0.0})
            elif action == "peer_error":
                out.append({"action": action, "dst": fields[1],
                            "pct": float(fields[2])})
            elif action == "shard_write_error":
                out.append({"action": action, "kind": fields[1]})
            else:  # clear_net
                out.append({"action": action})
        except (IndexError, ValueError) as e:
            raise ValueError(
                f"WEEDTPU_FAULTS: malformed directive {part!r}") from e
    return out


def apply_net(fault: dict) -> bool:
    """Apply one parsed process-wide fault; False when it is not one
    (store faults go through apply())."""
    action = fault.get("action")
    if action == "partition":
        add_partition(str(fault["a"]), str(fault["b"]))
    elif action == "unpartition":
        remove_partition(str(fault["a"]), str(fault["b"]))
    elif action == "region_partition":
        add_partition("region:" + str(fault["a"]),
                      "region:" + str(fault["b"]))
    elif action == "region_unpartition":
        remove_partition("region:" + str(fault["a"]),
                         "region:" + str(fault["b"]))
    elif action == "wan_latency":
        set_wan_latency(str(fault["a"]), str(fault["b"]),
                        float(fault["ms"]),
                        float(fault.get("jitter", 0.0)))
    elif action == "peer_latency":
        set_peer_latency(str(fault["dst"]), float(fault["ms"]),
                         float(fault.get("jitter", 0.0)))
    elif action == "peer_error":
        set_peer_error_rate(str(fault["dst"]), float(fault["pct"]))
    elif action == "shard_write_error":
        set_shard_write_error(str(fault.get("kind", "")) or None)
    elif action == "clear_net":
        clear_net()
    else:
        return False
    log.warning("faults: applied %s", fault)
    return True


# -- store faults --------------------------------------------------------

def _ec_base(store, vid: int) -> str | None:
    for loc in store.locations:
        for cand in (loc.base_path(vid, loc.collections.get(vid, "")),
                     loc.base_path(vid)):
            if os.path.exists(cand + ".ecx") or any(
                    os.path.exists(cand + layout.to_ext(i))
                    for i in range(layout.MAX_TOTAL_SHARDS)):
                return cand
    return None


def delete_shard(store, vid: int, sid: int) -> bool:
    """Remove one shard file; the mounted EcVolume drops its fd so the
    next heartbeat reports the loss."""
    base = _ec_base(store, vid)
    if base is None:
        return False
    p = base + layout.to_ext(sid)
    if os.path.exists(p):
        os.remove(p)
    ev = store.get_ec_volume(vid)
    if ev is not None:
        f = ev.shards.pop(sid, None)
        if f is not None:
            f.close()
        ev.clear_quarantine(sid)
    log.warning("faults: deleted shard %d of volume %d", sid, vid)
    return True


def flip_bit(store, vid: int, sid: int, offset: int, bit: int = 0) -> bool:
    """XOR one bit of a shard file in place (the mounted EcVolume reads
    through the page cache, so the corruption is live at once).  The
    write goes to the file's inode: a hard link shares it."""
    base = _ec_base(store, vid)
    if base is None:
        return False
    p = base + layout.to_ext(sid)
    if not os.path.exists(p):
        return False
    size = os.path.getsize(p)
    if not size:
        return False
    offset %= size
    with open(p, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ (1 << (bit % 8))]))
    log.warning("faults: flipped bit %d at offset %d of volume %d "
                "shard %d", bit, offset, vid, sid)
    return True


def apply(store, fault: dict) -> dict:
    """Apply one parsed fault to a Store; returns {**fault, ok: bool}.
    The two delays are server state: the volume server handles them
    before calling here.  Process-wide faults go through apply_net."""
    action = fault.get("action")
    if action == "delete_shard":
        ok = delete_shard(store, int(fault["volume"]), int(fault["shard"]))
    elif action == "flip_bit":
        ok = flip_bit(store, int(fault["volume"]), int(fault["shard"]),
                      int(fault["offset"]), int(fault.get("bit", 0)))
    else:
        ok = apply_net(fault)
    return dict(fault, ok=ok)
