"""Store: every volume (normal + EC) on one volume server.

Counterpart of `seaweedfs_tpu/storage/store.py` (reference:
weed/storage/store.go:57-77, disk_location.go, store_ec.go): disk
locations own the volumes found on disk at boot; the store routes volume
ids and assembles heartbeat payloads for the master.

Differences from the reference, kept on purpose:
- the store resolves its device once, at construction (None: the card,
  raising without one; "cpu": the plain version), and every EC volume a
  location mounts runs its codec there;
- volumes are served on the mmap backend always (the reference reads
  WEEDTPU_VOLUME_BACKEND, whose default this is);
- a volume tiered out (its `.tier` marker and `.idx`, no `.dat`) mounts
  at boot, reading through the remote; the reference's boot looks for
  `.dat` files only and leaves it out of service (ROADMAP fault 3.6).
"""

from __future__ import annotations

import glob
import os
import re
import threading
import time

from seaweedfs_tpu_torch.ops import gf_cuda
from seaweedfs_tpu_torch.storage import needle as ndl
from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage.ec import ec_volume as ecv
from seaweedfs_tpu_torch.storage.ec import layout
from seaweedfs_tpu_torch.storage.volume import Volume

_VOL_RE = re.compile(r"^(?:(?P<col>.+)_)?(?P<vid>\d+)\.dat$")
_ECX_RE = re.compile(r"^(?:(?P<col>.+)_)?(?P<vid>\d+)\.ecx$")
_TIER_RE = re.compile(r"^(?:(?P<col>.+)_)?(?P<vid>\d+)\.tier$")

# backend of store-served volumes: blob GETs slice the page cache
# directly instead of paying a read syscall per request; appends still go
# through the file descriptor
VOLUME_BACKEND = "mmap"


class DiskLocation:
    """One data directory; loads .dat volumes and .ecx EC volumes at boot
    (reference: weed/storage/disk_location.go, disk_location_ec.go).  EC
    volumes mount eagerly, each building its codec on `device`.
    `load_s` holds the seconds the last `load_existing` took."""

    def __init__(self, directory: str, max_volumes: int = 8, device=None):
        self.directory = directory
        self.max_volumes = max_volumes
        self.device = device
        os.makedirs(directory, exist_ok=True)
        self.volumes: dict[int, Volume] = {}
        self.ec_volumes: dict[int, ecv.EcVolume] = {}
        self.collections: dict[int, str] = {}
        self.load_existing()

    def load_existing(self) -> None:
        t0 = time.perf_counter()
        # crash leftovers of an interrupted copy, move, vacuum or decode
        # never held the only copy of anything: a restarted server
        # deletes them instead of letting them pile up
        for ext in ("*.cpd", "*.cpx", "*.cptail", "*.dat.unc",
                    "*.idx.unc"):
            for path in glob.glob(os.path.join(self.directory, ext)):
                try:
                    os.remove(path)
                except OSError:
                    pass
        for path in glob.glob(os.path.join(self.directory, "*.dat")):
            m = _VOL_RE.match(os.path.basename(path))
            if not m:
                continue
            vid = int(m.group("vid"))
            col = m.group("col") or ""
            if os.path.exists(path[: -len(".dat")] + ".staging"):
                # half-moved copy from a crashed volume move: the source
                # still holds the live volume, so this copy is garbage
                for ext in (".dat", ".idx", ".staging"):
                    try:
                        os.remove(path[: -len(".dat")] + ext)
                    except OSError:
                        pass
                continue
            if vid not in self.volumes:
                self.volumes[vid] = Volume(self.directory, col, vid,
                                           backend=VOLUME_BACKEND)
                self.collections[vid] = col
        for path in glob.glob(os.path.join(self.directory, "*.tier")):
            # tiered out (ROADMAP fault 3.6): the .dat lives on the
            # remote, and the Volume mounts it read-only from the marker
            m = _TIER_RE.match(os.path.basename(path))
            if not m or int(m.group("vid")) in self.volumes:
                continue
            vid, col = int(m.group("vid")), m.group("col") or ""
            self.volumes[vid] = Volume(self.directory, col, vid)
            self.collections[vid] = col
        for path in glob.glob(os.path.join(self.directory, "*.ecx")):
            m = _ECX_RE.match(os.path.basename(path))
            if not m:
                continue
            vid = int(m.group("vid"))
            base = path[: -len(".ecx")]
            has_shards = any(os.path.exists(base + layout.to_ext(i))
                             for i in range(layout.MAX_TOTAL_SHARDS))
            if vid not in self.ec_volumes and has_shards:
                self.ec_volumes[vid] = ecv.EcVolume(base, device=self.device)
                self.collections.setdefault(vid, m.group("col") or "")
        self.load_s = time.perf_counter() - t0


class Store:
    def __init__(self, directories: list[str], max_volumes: int = 8,
                 public_url: str = "", device=None):
        self.device = gf_cuda.resolve_device(device)
        self.locations = [DiskLocation(d, max_volumes, self.device)
                          for d in directories]
        self.public_url = public_url
        self._lock = threading.RLock()

    # -- lookup --------------------------------------------------------

    def get_volume(self, vid: int) -> Volume | None:
        for loc in self.locations:
            v = loc.volumes.get(vid)
            if v is not None:
                return v
        return None

    def get_ec_volume(self, vid: int) -> ecv.EcVolume | None:
        for loc in self.locations:
            v = loc.ec_volumes.get(vid)
            if v is not None:
                return v
        return None

    def location_of(self, vid: int) -> DiskLocation | None:
        for loc in self.locations:
            if vid in loc.volumes or vid in loc.ec_volumes:
                return loc
        return None

    # -- volume lifecycle ---------------------------------------------

    def allocate_volume(self, vid: int, collection: str = "",
                        replica_placement: str = "000", ttl: str = "") -> Volume:
        with self._lock:
            if self.get_volume(vid) is not None:
                raise FileExistsError(f"volume {vid} already exists")
            loc = min(self.locations, key=lambda l: len(l.volumes))
            if len(loc.volumes) >= loc.max_volumes:
                raise OSError("no free volume slots")
            v = Volume(loc.directory, collection, vid,
                       replica_placement=replica_placement, ttl=ttl,
                       backend=VOLUME_BACKEND)
            loc.volumes[vid] = v
            loc.collections[vid] = collection
            return v

    def delete_volume(self, vid: int) -> None:
        with self._lock:
            for loc in self.locations:
                v = loc.volumes.pop(vid, None)
                if v is not None:
                    v.close()
                    # .staging too: deleting a staged (mid-move) copy
                    # must not leave its marker behind as an orphan; and
                    # .tier, which the next boot would mount
                    for ext in (".dat", ".idx", ".staging", ".tier"):
                        p = v._base + ext
                        if os.path.exists(p):
                            os.remove(p)

    # -- blob ops ------------------------------------------------------

    def write_needle(self, vid: int, n: ndl.Needle) -> int:
        v = self.get_volume(vid)
        if v is None:
            raise KeyError(f"volume {vid} not found")
        _, size = v.append_needle(n)
        return size

    def read_needle(self, vid: int, needle_id: int,
                    cookie: int | None = None,
                    shard_reader=None) -> ndl.Needle:
        """A needle of a volume or, through `shard_reader` for shards on
        peers (`ec_volume.ShardReader`), of an EC volume."""
        v = self.get_volume(vid)
        if v is not None:
            return v.read_needle(needle_id, cookie)
        ev = self.get_ec_volume(vid)
        if ev is not None:
            n = ev.read_needle(needle_id, shard_reader)
            if cookie is not None and n.cookie != cookie:
                raise PermissionError("cookie mismatch")
            return n
        raise KeyError(f"volume {vid} not found")

    def read_needle_inline(self, vid: int, needle_id: int,
                           cookie: int | None = None,
                           max_bytes: int = 64 * 1024) -> "ndl.Needle | None":
        """Event-loop-safe fast path for SMALL plain-volume reads: returns
        the needle when it can be served by a bounded lock-free pread
        (page-cache latency), or None when the caller must take the
        thread-pool path (EC volume, missing/deleted needle, big record,
        or a backend without pread — a remote tier would block the loop
        on the network)."""
        v = self.get_volume(vid)
        if v is None:
            return None
        if getattr(v._dat, "pread", None) is None:
            return None
        loc = v.nm.get(needle_id)
        if loc is None:
            return None
        if t.actual_size(loc[1], v.version) > max_bytes:
            return None
        return v.read_needle(needle_id, cookie)

    def delete_needle(self, vid: int, needle_id: int,
                      cookie: int | None = None) -> int:
        v = self.get_volume(vid)
        if v is not None:
            return v.delete_needle(needle_id, cookie)
        ev = self.get_ec_volume(vid)
        if ev is not None:
            ev.delete_needle(needle_id)
            return 0
        raise KeyError(f"volume {vid} not found")

    # -- heartbeat payload --------------------------------------------

    def collect_heartbeat(self) -> dict:
        """Volume + EC shard report for the master
        (reference: store.go CollectHeartbeat, store_ec.go:25-49)."""
        vols, ec_shards = [], []
        max_slots = 0
        max_file_key = 0
        for loc in self.locations:
            max_slots += loc.max_volumes
            for vid, v in loc.volumes.items():
                max_file_key = max(max_file_key, v.max_file_key())
                info = v.info()
                vols.append({
                    "id": vid, "collection": info.collection,
                    "size": info.size, "file_count": info.file_count,
                    "delete_count": info.delete_count,
                    "deleted_bytes": info.deleted_bytes,
                    "read_only": info.read_only,
                    "replica_placement": info.replica_placement,
                    "ttl": info.ttl, "version": info.version,
                    "modified_at": v.last_modified,
                })
            for vid, ev in loc.ec_volumes.items():
                ec_shards.append({
                    "id": vid,
                    "collection": loc.collections.get(vid, ""),
                    "shard_ids": ev.shard_ids(),
                    # repair-byte estimates need the shard file size,
                    # which only this node knows
                    "shard_size": ev.shard_size,
                    "codec": ev.codec_tag,
                })
        return {"volumes": vols, "ec_shards": ec_shards,
                "max_volume_count": max_slots,
                "public_url": self.public_url,
                # the master advances its sequencer past the highest key
                # so ids never repeat after a master restart
                "max_file_key": max_file_key}

    def close(self) -> None:
        for loc in self.locations:
            for v in loc.volumes.values():
                v.close()
            for ev in loc.ec_volumes.values():
                ev.close()
