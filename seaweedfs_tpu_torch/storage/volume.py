"""Volume: one append-only .dat file plus its .idx needle log.

Counterpart of `seaweedfs_tpu/storage/volume.py` (reference:
weed/storage/volume.go, volume_write.go, volume_read.go,
volume_vacuum.go, volume_checking.go, volume_tier.go): append, read,
paged and meta reads, delete, vacuum, replica catch-up and the remote
tier, on a .dat behind a backend (`storage/backend.py`: disk, mmap or a
remote tier) with a needle map of the compact, dict or sorted-file kind.
A single writer lock stands in for the reference's per-volume batcher,
with the same crash-safety order (data before index, torn tails
truncated at load).  It writes the same `.dat` and `.idx` bytes as the
reference package for the same needles, and a volume either package
wrote, compacted or tiered mounts in the other.

Unlike the reference's, a tier move's upload, a tier download and a
read through the remote tier hold no volume lock across the network
(ROADMAP fault 3.14): the volume is sealed first, and the lock is taken
only to switch the backend.  While the transfer runs the volume is
`tiering`: writes, deletes, compaction, a replica catch-up and a
placement rewrite refuse, and the switch aborts if the .dat's size or
compaction revision moved since the seal.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
from dataclasses import dataclass


from seaweedfs_tpu_torch.remote_storage import make_remote
from seaweedfs_tpu_torch.storage import idx as idxf
from seaweedfs_tpu_torch.storage import needle as ndl
from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage.backend import RemoteFile, open_backend
from seaweedfs_tpu_torch.storage.needle_map import (SortedFileNeedleMap,
                                                    load_needle_map)
from seaweedfs_tpu_torch.storage.super_block import SUPER_BLOCK_SIZE, SuperBlock


@dataclass
class VolumeInfo:
    id: int
    size: int
    collection: str
    file_count: int
    delete_count: int
    deleted_bytes: int
    read_only: bool
    replica_placement: str
    ttl: str
    version: int
    compact_revision: int


class Volume:
    def __init__(self, dirname: str, collection: str, vid: int,
                 replica_placement: str = "000", ttl: str = "",
                 version: int = t.CURRENT_VERSION, backend: str = "disk",
                 needle_map_kind: str = "compact"):
        self.dir = dirname
        self.collection = collection
        self.id = vid
        self.needle_map_kind = needle_map_kind
        self.read_only = False
        # a volume copy's target while its move runs: read-only and out
        # of the heartbeat until the move's finalize
        self.staging = False
        # a tier move's or download's transfer runs (outside the lock):
        # nothing may change the .dat until its switch
        self.tiering = False
        self.last_modified = 0.0
        self._lock = threading.RLock()
        base = f"{collection}_{vid}" if collection else str(vid)
        self._base = os.path.join(dirname, base)
        self.dat_path = self._base + ".dat"
        self.idx_path = self._base + ".idx"

        existing = os.path.exists(self.dat_path)
        self.backend_kind = backend
        self.tier_path = self._base + ".tier"
        if os.path.exists(self.tier_path):
            # sealed volume moved to a remote tier (reference:
            # volume_tier.go + backend/s3_backend): .dat bytes live on the
            # remote, reads ride RemoteFile, writes are refused
            with open(self.tier_path) as f:
                tier = json.load(f)
            remote = make_remote(tier["kind"], **tier.get("options", {}))
            self._dat = RemoteFile(remote, tier["key"], tier["size"])
            self.backend_kind = "remote"
            self.read_only = True
            existing = True
        else:
            self._dat = open_backend(self.dat_path, backend)
        if existing:
            head = self._dat.read_at(0, SUPER_BLOCK_SIZE + 64 * 1024)
            self.super_block = SuperBlock.from_bytes(head)
            try:
                # a rebooted server must report when the volume last took a
                # write (ec.encode -quietFor selection), not 0 = "forever"
                self.last_modified = os.path.getmtime(self.dat_path)
            except OSError:
                pass
        else:
            self.super_block = SuperBlock(
                version=version,
                replica_placement=t.ReplicaPlacement.parse(replica_placement),
                ttl=t.TTL.parse(ttl))
            self._dat.append(self.super_block.to_bytes())
            self._dat.flush()
        self.version = self.super_block.version

        if needle_map_kind == "sorted_file":
            # low-memory read-only kind (reference:
            # needle_map_sorted_file.go): binary search in a sorted .sdx;
            # the .idx is never opened for append (doing so would recreate
            # a deleted .idx and poison the next .sdx rebuild)
            self.nm = SortedFileNeedleMap.open_for(
                self.idx_path, self._base + ".sdx")
            self.read_only = True
            self._idx = None
        else:
            self.nm = load_needle_map(needle_map_kind, self.idx_path)
            if self.backend_kind != "remote":
                self.check_and_fix_integrity()
            self._idx = open(self.idx_path, "ab", buffering=0)
            self.nm.attach_idx(self._idx)

    # -- geometry ------------------------------------------------------

    def data_size(self) -> int:
        with self._lock:
            return self._dat.size()

    def check_and_fix_integrity(self) -> None:
        """Crash recovery at load (reference: volume_checking.go:17):
        - drop .idx entries that point past the end of the .dat (torn writes
          where data never made it);
        - walk the .dat tail beyond the last indexed entry and truncate at
          the first incomplete record (tombstone records legitimately live
          there — they are complete and are kept)."""
        file_end = self._dat.size()

        end = self.super_block.block_size
        torn = []
        for nid, (off, size) in self.nm.items():
            if not t.size_is_valid(size):
                continue
            entry_end = t.from_offset_units(off) + t.actual_size(size, self.version)
            if entry_end > file_end:
                torn.append(nid)
            else:
                end = max(end, entry_end)
        if torn:
            # tombstone torn ids ON DISK too — dropping them only from the
            # in-memory map lets them resurrect on the next load, pointing
            # into whatever bytes were appended after the truncate
            with open(self.idx_path, "ab") as f:
                for nid in torn:
                    self.nm.drop(nid)
                    f.write(idxf.pack_entry(nid, 0, t.TOMBSTONE_FILE_SIZE))

        # a record a tombstone entry of the log points at is indexed too:
        # a needle deleted on its EC volume keeps its record in the
        # decoded .dat with no tombstone record after it, and a walk from
        # the last LIVE record would re-index it (the reference does:
        # ROADMAP fault 3.7).  Records never overlap, so the furthest one
        # the map's load saw bounds them all
        dead = t.from_offset_units(self.nm.max_tombstoned)
        if end <= dead and dead + t.NEEDLE_HEADER_SIZE <= file_end:
            n = ndl.Needle.parse_header(
                self._dat.read_at(dead, t.NEEDLE_HEADER_SIZE))
            rec_end = dead + t.actual_size(max(n.size, 0), self.version)
            if rec_end <= file_end:
                end = rec_end

        # walk complete records after the last indexed one, re-indexing them
        # (a killed process may have appended data the .idx never saw; the
        # reference leaves these for `weed fix`, but since the walk already
        # parses each header, healing the map at boot is free), and truncate
        # at the first incomplete record
        offset = end + (-end) % t.NEEDLE_PADDING_SIZE
        recovered: list[tuple[int, int, int]] = []
        while offset + t.NEEDLE_HEADER_SIZE <= file_end:
            header = self._dat.read_at(offset, t.NEEDLE_HEADER_SIZE)
            n = ndl.Needle.parse_header(header)
            if n.size < -1 or n.size > t.MAX_POSSIBLE_VOLUME_SIZE:
                break
            rec_len = t.NEEDLE_HEADER_SIZE + t.needle_body_length(
                max(n.size, 0), self.version)
            if offset + rec_len > file_end:
                break
            recovered.append((n.id, t.to_offset_units(offset), n.size))
            offset += rec_len
        if recovered:
            with open(self.idx_path, "ab") as f:
                for nid, off_units, size in recovered:
                    if size > 0:
                        self.nm.put(nid, off_units, size)
                        f.write(idxf.pack_entry(nid, off_units, size))
                    else:  # zero-data record = tombstone (delete_needle)
                        self.nm.delete(nid)
                        f.write(idxf.pack_entry(
                            nid, off_units, t.TOMBSTONE_FILE_SIZE))
        if offset < file_end:
            self._dat.truncate(max(offset, self.super_block.block_size))

    # -- write path ----------------------------------------------------

    def append_needle(self, n: ndl.Needle, fsync: bool = False) -> tuple[int, int]:
        """Append one needle; returns (byte_offset, size). Thread-safe."""
        if self.read_only:
            raise PermissionError(f"volume {self.id} is read-only")
        record = n.to_bytes(self.version)
        with self._lock:
            if self.read_only or self.tiering:  # sealed since the check
                raise PermissionError(f"volume {self.id} is read-only")
            offset = self._dat.size()
            if offset % t.NEEDLE_PADDING_SIZE != 0:
                pad = t.NEEDLE_PADDING_SIZE - offset % t.NEEDLE_PADDING_SIZE
                self._dat.append(bytes(pad))
                offset += pad
            if offset + len(record) > t.MAX_POSSIBLE_VOLUME_SIZE:
                raise OSError(f"volume {self.id} exceeds max size")
            self._dat.append(record)
            self._dat.flush()
            if fsync:
                self._dat.sync()
            self.nm.put(n.id, t.to_offset_units(offset), n.size)
            self.last_modified = time.time()
        return offset, n.size

    def delete_needle(self, needle_id: int, cookie: int | None = None) -> int:
        """Tombstone a needle; appends a zero-data record then marks the map
        (same order as the reference so replay stays consistent)."""
        if self.read_only:
            raise PermissionError(f"volume {self.id} is read-only")
        with self._lock:
            if self.read_only or self.tiering:  # sealed since the check
                raise PermissionError(f"volume {self.id} is read-only")
            existing = self.nm.get(needle_id)
            if existing is None:
                return 0
            if cookie is not None:
                stored = self._read_at(existing[0], existing[1])
                if stored.cookie != cookie:
                    raise PermissionError("cookie mismatch")
            tomb = ndl.Needle(id=needle_id, cookie=cookie or 0)
            record = tomb.to_bytes(self.version)
            self._dat.append(record)
            self._dat.flush()
            freed = self.nm.delete(needle_id)
            self.last_modified = time.time()
            return freed

    # -- read path -----------------------------------------------------

    def _pread_at(self, offset: int, length: int) -> bytes:
        """Lock-free positional read when the backend supports it
        (DiskFile.pread): concurrent GETs of one volume stop serializing
        on the shared file handle's seek position.  Falls back to the
        locked path on backends without pread, and on the (vacuum-swap)
        race where the backing fd was just replaced.  A remote tier's
        read is a positional request and takes no lock either: held
        across the network, the lock would stall the heartbeat (which
        reads the volume's size under it) for the request's length."""
        if self.backend_kind == "remote":
            return self._dat.read_at(offset, length)
        pread = getattr(self._dat, "pread", None)
        if pread is not None:
            try:
                return pread(offset, length)
            except (OSError, ValueError):
                pass  # fd swapped mid-read (compact): retry under lock
        with self._lock:
            return self._dat.read_at(offset, length)

    def _read_at(self, offset_units: int, size: int,
                 verify_checksum: bool = True) -> ndl.Needle:
        offset = t.from_offset_units(offset_units)
        length = t.actual_size(size, self.version)
        record = self._pread_at(offset, length)
        if len(record) < length:
            raise EOFError(f"truncated needle at {offset}")
        try:
            return ndl.Needle.from_record(record, self.version, verify_checksum)
        except (IndexError, struct.error) as e:
            raise ValueError(
                f"corrupt needle record at offset {offset}: {e}") from e

    def read_needle(self, needle_id: int, cookie: int | None = None) -> ndl.Needle:
        loc = self.nm.get(needle_id)
        if loc is None:
            raise KeyError(f"needle {needle_id:x} not found in volume {self.id}")
        n = self._read_at(loc[0], loc[1])
        if cookie is not None and n.cookie != cookie:
            raise PermissionError("cookie mismatch")
        # TTL enforcement on read (reference: the volume server's read
        # handler rejects needles past volume TTL; whole expired TTL
        # volumes are reaped by the master scan)
        ttl = self.super_block.ttl
        if ttl and ttl.minutes > 0 and n.last_modified:
            if n.last_modified + ttl.minutes * 60 < time.time():
                raise KeyError(f"needle {needle_id:x} expired")
        return n

    def read_needle_meta(self, needle_id: int,
                         cookie: int | None = None) -> "ndl.Needle":
        """Header + post-data meta tail only (name/mime/last_modified,
        checksum field) — the cheap probe for paged Range reads; enforces
        cookie and TTL like read_needle.  Returns a Needle whose `size`
        holds the total DATA size and whose data is empty."""
        loc = self.nm.get(needle_id)
        if loc is None:
            raise KeyError(
                f"needle {needle_id:x} not found in volume {self.id}")
        if self.version == t.VERSION1:
            raise ValueError("paged meta read needs a v2/v3 volume")
        offset = t.from_offset_units(loc[0])
        head = self._pread_at(offset, t.NEEDLE_HEADER_SIZE + 4)
        if len(head) < t.NEEDLE_HEADER_SIZE + 4:
            raise EOFError(f"truncated needle at {offset}")
        hcookie, _hid, hsize = struct.unpack(
            ">IQi", head[: t.NEEDLE_HEADER_SIZE])
        if cookie is not None and hcookie != cookie:
            raise PermissionError("cookie mismatch")
        n = ndl.Needle(id=needle_id, cookie=hcookie, size=max(hsize, 0))
        if hsize <= 0:
            n.size = 0
            return n
        (data_size,) = struct.unpack(">I", head[t.NEEDLE_HEADER_SIZE:])
        tail_len = hsize - 4 - data_size  # flags..pairs block
        if tail_len > 0:
            tail = self._pread_at(
                offset + t.NEEDLE_HEADER_SIZE + 4 + data_size, tail_len)
            n.parse_meta_tail(tail)
        # checksum sits right after the meta block
        crc_raw = self._pread_at(
            offset + t.NEEDLE_HEADER_SIZE + hsize,
            t.NEEDLE_CHECKSUM_SIZE)
        if len(crc_raw) == t.NEEDLE_CHECKSUM_SIZE:
            (n.checksum,) = struct.unpack(">I", crc_raw)
        n.size = data_size
        ttl = self.super_block.ttl
        if ttl and ttl.minutes > 0 and n.last_modified:
            if n.last_modified + ttl.minutes * 60 < time.time():
                raise KeyError(f"needle {needle_id:x} expired")
        return n

    def read_needle_page(self, needle_id: int, page_offset: int,
                         page_size: int, cookie: int | None = None
                         ) -> bytes:
        """Read only [page_offset, page_offset+page_size) of a needle's
        data without loading the whole record (reference:
        weed/storage/needle/needle_read_page.go; page reads skip the CRC
        like the reference's paged path).  V2/V3 layout: header(16) |
        DataSize(4) | Data | ..."""
        loc = self.nm.get(needle_id)
        if loc is None:
            raise KeyError(
                f"needle {needle_id:x} not found in volume {self.id}")
        if self.version == t.VERSION1:
            raise ValueError("paged read needs a v2/v3 volume")
        offset = t.from_offset_units(loc[0])
        head = self._pread_at(offset, t.NEEDLE_HEADER_SIZE + 4)
        if len(head) < t.NEEDLE_HEADER_SIZE + 4:
            raise EOFError(f"truncated needle at {offset}")
        hcookie, _hid, hsize = struct.unpack(
            ">IQi", head[: t.NEEDLE_HEADER_SIZE])
        if cookie is not None and hcookie != cookie:
            raise PermissionError("cookie mismatch")
        if hsize <= 0:
            return b""
        (data_size,) = struct.unpack(">I", head[t.NEEDLE_HEADER_SIZE:])
        lo = max(0, min(page_offset, data_size))
        ln = max(0, min(page_size, data_size - lo))
        if ln == 0:
            return b""
        return self._pread_at(
            offset + t.NEEDLE_HEADER_SIZE + 4 + lo, ln)

    def has_needle(self, needle_id: int) -> bool:
        return self.nm.get(needle_id) is not None

    # -- maintenance ---------------------------------------------------

    def garbage_ratio(self) -> float:
        size = self.data_size()
        if size <= SUPER_BLOCK_SIZE:
            return 0.0
        return self.nm.deleted_bytes / size

    def max_file_key(self) -> int:
        """Highest needle id ever stored (heartbeat max_file_key) — part of
        every needle-map kind's surface, so no reaching into map internals."""
        with self._lock:
            return self.nm.maximum_key

    def compact(self) -> None:
        """Vacuum: copy live needles to .cpd/.cpx then atomically swap
        (reference: volume_vacuum.go Compact2/CommitCompact)."""
        if self.backend_kind == "remote":
            raise PermissionError(
                f"volume {self.id} lives on a remote tier; decode it back "
                f"before compacting")
        if self._idx is None:
            raise PermissionError(
                f"volume {self.id} is opened with a read-only needle map; "
                f"reopen with a writable needle map kind to compact")
        with self._lock:
            self._refuse_while_tiering("compact")
            cpd, cpx = self._base + ".cpd", self._base + ".cpx"
            new_sb = SuperBlock(
                version=self.version,
                replica_placement=self.super_block.replica_placement,
                ttl=self.super_block.ttl,
                compaction_revision=self.super_block.compaction_revision + 1)
            with open(cpd, "wb") as dat, open(cpx, "wb") as ix:
                dat.write(new_sb.to_bytes())
                for nid, (off, size) in sorted(
                        self.nm.items(), key=lambda kv: kv[1][0]):
                    if not t.size_is_valid(size):
                        continue
                    n = self._read_at(off, size, verify_checksum=False)
                    record = n.to_bytes(self.version)
                    pos = dat.tell()
                    dat.write(record)
                    ix.write(idxf.pack_entry(nid, t.to_offset_units(pos), n.size))
            # commit: swap files, reload map
            self._dat.close()
            self._idx.close()
            os.replace(cpd, self.dat_path)
            os.replace(cpx, self.idx_path)
            self._dat = open_backend(self.dat_path, self.backend_kind)
            self.super_block = new_sb
            self.nm = load_needle_map(self.needle_map_kind, self.idx_path)
            self._idx = open(self.idx_path, "ab", buffering=0)
            self.nm.attach_idx(self._idx)

    def apply_catch_up(self, base_size: int, tail_path: str,
                       idx_raw: bytes) -> int:
        """Atomically apply an incremental replica catch-up staged by the
        volume server (reference: volume_grpc_copy_incremental.go):
        append the pulled .dat tail and swap in the source's .idx, all
        under the volume lock so concurrent writers are excluded.  Fails
        if the volume changed since `base_size` was observed."""
        if self._idx is None:
            raise PermissionError("read-only needle map")
        appended = 0
        with self._lock:
            self._refuse_while_tiering("catch up")
            if self._dat.size() != base_size:
                raise RuntimeError(
                    "volume changed during catch-up; retry")
            with open(tail_path, "rb") as f:
                while True:
                    chunk = f.read(1 << 20)
                    if not chunk:
                        break
                    self._dat.append(chunk)
                    appended += len(chunk)
            self._dat.flush()
            self._idx.close()
            with open(self.idx_path, "wb") as f:
                f.write(idx_raw)
            self.nm = load_needle_map(self.needle_map_kind, self.idx_path)
            self._idx = open(self.idx_path, "ab", buffering=0)
            self.nm.attach_idx(self._idx)
            self.last_modified = time.time()
        return appended

    def set_replica_placement(self, rp: "t.ReplicaPlacement") -> None:
        """Rewrite the placement byte (super block offset 1) in place
        (reference: volume_super_block.go MaybeWriteSuperBlock +
        VolumeConfigure)."""
        with self._lock:
            self._refuse_while_tiering("rewrite the placement of")
            if self.backend_kind == "remote":
                raise PermissionError("remote-tier volume is read-only")
            # write the file first; only mutate memory on success so the
            # two views can't diverge on error
            self._dat.flush()
            with open(self.dat_path, "r+b") as f:
                f.seek(1)
                f.write(bytes([rp.to_byte()]))
            self.super_block.replica_placement = rp

    def _refuse_while_tiering(self, what: str) -> None:
        if self.tiering:
            raise PermissionError(
                f"cannot {what} volume {self.id}: a tier transfer is running")

    def tier_move(self, kind: str, options: dict, key: str | None = None
                  ) -> None:
        """Move this sealed volume's .dat to a remote tier; reads keep
        working through the RemoteFile backend (reference:
        weed/storage/volume_tier.go + shell volume.tier.move).  The
        volume is sealed under its lock, then uploaded without it (the
        heartbeat and readers go on reading the local .dat; the
        reference holds the lock for the whole upload), then switched
        over under it, unless the .dat changed since the seal."""
        with self._lock:
            if self.backend_kind == "remote":
                return
            self._refuse_while_tiering("tier")
            self._dat.flush()
            self.nm.flush()
            size = self._dat.size()
            revision = self.super_block.compaction_revision
            key = key or f"{self.collection or 'default'}/{self.id}.dat"
            was_read_only, self.read_only = self.read_only, True
            self.tiering = True
        try:
            remote = make_remote(kind, **options)
            remote.upload_file(key, self.dat_path)
        except BaseException:
            with self._lock:
                self.read_only, self.tiering = was_read_only, False
            raise
        with self._lock:
            try:
                if (self._dat.size(), self.super_block.compaction_revision
                        ) != (size, revision):
                    self.read_only = was_read_only
                    remote.delete_file(key)
                    raise RuntimeError(
                        f"volume {self.id} changed during its tier move; "
                        f"the local .dat stays")
            finally:
                self.tiering = False
            tmp = self.tier_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"kind": kind, "options": options, "key": key,
                            "size": size}, f)
            os.replace(tmp, self.tier_path)
            self._dat.close()
            self._dat = RemoteFile(remote, key, size)
            self.backend_kind = "remote"
            self.read_only = True
            os.remove(self.dat_path)

    def tier_download(self, delete_remote: bool = False) -> None:
        """Bring a tiered volume's .dat back to local disk and resume
        normal (writable) service — the inverse of tier_move (reference:
        shell volume.tier.download + volume_tier.go); `delete_remote`
        also removes the remote copy.  The download runs outside the
        volume's lock, as `tier_move`'s upload does; reads go on through
        the remote until the switch."""
        with self._lock:
            if self.backend_kind != "remote":
                return
            self._refuse_while_tiering("download")
            with open(self.tier_path) as f:
                tier = json.load(f)
            self.tiering = True
        tmp = self.dat_path + ".dl"
        try:
            remote = make_remote(tier["kind"], **tier.get("options", {}))
            with open(tmp, "wb") as f:
                size = tier["size"]
                off = 0
                while off < size:
                    n = min(8 << 20, size - off)
                    f.write(remote.read_range(tier["key"], off, n))
                    off += n
        except BaseException:
            with self._lock:
                self.tiering = False
            if os.path.exists(tmp):
                os.remove(tmp)
            raise
        with self._lock:
            self.tiering = False
            os.replace(tmp, self.dat_path)
            self._dat.close()
            self._dat = open_backend(self.dat_path, "disk")
            self.backend_kind = "disk"
            self.read_only = False
            os.remove(self.tier_path)
            if delete_remote:
                remote.delete_file(tier["key"])

    def info(self) -> VolumeInfo:
        return VolumeInfo(
            id=self.id, size=self.data_size(), collection=self.collection,
            file_count=self.nm.file_count, delete_count=self.nm.deleted_count,
            deleted_bytes=self.nm.deleted_bytes, read_only=self.read_only,
            replica_placement=str(self.super_block.replica_placement),
            ttl=str(self.super_block.ttl), version=self.version,
            compact_revision=self.super_block.compaction_revision)

    def flush(self) -> None:
        """Flush buffered .dat/.idx writes to the OS (peer pulls read the
        files directly, reference: volume_grpc_copy.go CopyFile)."""
        with self._lock:
            self._dat.flush()
            self.nm.flush()

    def close(self) -> None:
        with self._lock:
            self.nm.flush()
            if hasattr(self.nm, "close"):
                self.nm.close()
            if self._idx is not None:
                self._idx.close()
            self._dat.close()

    # -- scan (export/fix/EC encode feed) ------------------------------

    def scan(self, verify_checksum: bool = False):
        """Yield (offset, Needle) for every record in .dat file order."""
        with self._lock:
            end = self._dat.size()
        offset = self.super_block.block_size
        offset += (-offset) % t.NEEDLE_PADDING_SIZE
        while offset + t.NEEDLE_HEADER_SIZE <= end:
            with self._lock:
                header = self._dat.read_at(offset, t.NEEDLE_HEADER_SIZE)
                n = ndl.Needle.parse_header(header)
                body_len = t.needle_body_length(max(n.size, 0), self.version)
                body = self._dat.read_at(
                    offset + t.NEEDLE_HEADER_SIZE, body_len)
            if len(body) < body_len:
                return
            n.parse_body(body, self.version, verify_checksum)
            yield offset, n
            offset += t.NEEDLE_HEADER_SIZE + body_len
