"""filer.sync's loop-prevention signature.

Counterpart of `seaweedfs_tpu/replication/filer_sync.py`, cut to
`filer_signature`, which the filer server's peer aggregator stamps on the
events it relays (reference: the signature scheme of
weed/command/filer_sync.go: an event already stamped with a filer's
signature is not echoed back to it).  The sync pump itself, its resume
offsets and its observatory come with replication (ROADMAP 1.22a).
"""

from __future__ import annotations

import zlib


def filer_signature(filer_url: str) -> int:
    return zlib.crc32(filer_url.encode()) & 0x7FFFFFFF or 1
