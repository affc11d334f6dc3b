"""Fault injection for the shard writers: fail a disk on purpose.

Counterpart of the disk half of `seaweedfs_tpu/maintenance/faults.py`'s
process-wide registry.  An armed ``shard_write_error`` (EIO or ENOSPC)
makes every EC shard write of the process (encode, rebuild, reduced
repair, fleet conversion) raise that OSError, before any `.tmp` shard
file is opened, so the previous shard set stays intact.  The hook is a
test of one module global while nothing is armed.  The network faults,
the store faults, the registry's snapshot and clear-all, and the admin
and environment parsing come with the servers (ROADMAP 1.15a).
"""

from __future__ import annotations

import errno as _errno

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
