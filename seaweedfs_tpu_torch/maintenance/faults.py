"""Fault injection: damage a store or fail a disk on purpose.

Counterpart of the store and disk halves of
`seaweedfs_tpu/maintenance/faults.py`.

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
                                state)

**The disk fault**, process-wide: an armed ``shard_write_error`` (EIO or
ENOSPC) makes every EC shard write of the process (encode, rebuild,
reduced repair, fleet conversion) raise that OSError before any `.tmp`
shard file is opened, so the previous shard set stays intact.  The hook
is a test of one module global while nothing is armed.

Env spec: directives joined by ';', e.g.
  WEEDTPU_FAULTS="delete_shard:1:3;flip_bit:1:7:4096"

The network faults (partitions, peer latency and error rates, WAN
latency, `clear_net`) come with the rest of the volume server (ROADMAP
1.15a.3b): until then `parse_env` parses them as the reference does and
`apply` answers them `ok: false` with an error that names the action.
An unknown or malformed directive raises ValueError.
"""

from __future__ import annotations

import errno as _errno
import logging
import os

from seaweedfs_tpu_torch.storage.ec import layout

log = logging.getLogger("faults")

STORE_ACTIONS = ("delete_shard", "flip_bit", "delay_shard_read",
                 "delay_file_pull", "shard_write_error")
# the reference's network directives, not served here yet
NET_ACTIONS = ("partition", "unpartition", "region_partition",
               "region_unpartition", "wan_latency", "peer_latency",
               "peer_error", "clear_net")

_disk_shard_write: str | None = None  # "EIO" | "ENOSPC" | None


def set_shard_write_error(kind: str | None) -> None:
    """Arm "EIO" or "ENOSPC"; anything else ("off", None) clears."""
    global _disk_shard_write
    _disk_shard_write = kind if kind in ("EIO", "ENOSPC") else None


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
    before calling here.  A network fault answers ok: false with an
    error naming it."""
    action = fault.get("action")
    if action == "delete_shard":
        ok = delete_shard(store, int(fault["volume"]), int(fault["shard"]))
    elif action == "flip_bit":
        ok = flip_bit(store, int(fault["volume"]), int(fault["shard"]),
                      int(fault["offset"]), int(fault.get("bit", 0)))
    elif action == "shard_write_error":
        set_shard_write_error(str(fault.get("kind", "")) or None)
        log.warning("faults: applied %s", fault)
        ok = True
    elif action in NET_ACTIONS:
        return dict(fault, ok=False,
                    error=f"network fault {action!r} is not served by "
                          f"this volume server")
    else:
        ok = False
    return dict(fault, ok=ok)
