"""EC volume runtime: serve needle reads and deletes from local shard files.

Counterpart of `seaweedfs_tpu/storage/ec/ec_volume.py` (reference:
weed/storage/erasure_coding/ec_volume.go, ec_shard.go, store_ec.go).  The
.ecx index is loaded as numpy columns and binary-searched in memory; the
file stays the source of truth and deletes are written through (plus the
.ecj journal, replayed at open).

A needle read plans every interval up front, coalesces adjacent ranges of
one shard file, reads what the local shards hold, and rebuilds every
missing range in ONE codec dispatch: the survivor slices of all failed
ranges concatenate column-wise into a single GF(2^8) apply (RS and LRC
decode byte position by byte position, MSR alpha-block by alpha-block, so
concatenated ranges rebuild exactly as they would one by one).

The volume's code comes from its `.vif` (`spec`).  The survivors a
degraded read gathers are the codec's basis (`codec.basis`): an LRC single loss reads its
own local group (r + 1 shards at most), never k; an MSR read widens each
range to alpha boundaries and slices the lead back off after the decode.

Each read records the reference's spans under a sampled trace
(`ec.plan`, `ec.coalesce`, `ec.local_pread`, `ec.gather_survivors`,
`ec.reconstruct_batch`), books its stages into the process's `ec_read`
flow account (`local_pread`, `gather_survivors`, `reconstruct`), and a
read that reconstructs under foreground traffic marks the volume
`degraded` in the heat tracker.  The remote shard readers, their
`ec.remote_fetch` span and the hedging counters come with the volume
server (ROADMAP 1.15a).
"""

from __future__ import annotations

import os

import numpy as np

from seaweedfs_tpu_torch.ops import codecs
from seaweedfs_tpu_torch.stats import heat, pipeline, trace
from seaweedfs_tpu_torch.storage import idx as idxf
from seaweedfs_tpu_torch.storage import needle as ndl
from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage.ec import ec_files, layout


class EcVolume:
    def __init__(self, base: str,
                 large_block: int = layout.LARGE_BLOCK_SIZE,
                 small_block: int = layout.SMALL_BLOCK_SIZE,
                 version: int = t.CURRENT_VERSION, device=None):
        self.base = base
        # the volume id, the heat tracker's key: base names are "<vid>" or
        # "<collection>_<vid>"
        self.vid = os.path.basename(base).rsplit("_", 1)[-1]
        self.large_block = large_block
        self.small_block = small_block
        vif = ec_files.read_vif(base)
        self.version = vif.get("version", version) if vif else version
        self.spec = codecs.parse_tag((vif or {}).get("codec"))
        self.codec_tag = self.spec.tag
        # the codec resolves the device: the card (raising without one)
        # unless the caller named the CPU or the native host codec
        self.codec = ec_files._get_codec(device, self.spec.tag)
        self.device = self.codec.device

        # replay any crash-left journal into the .ecx, as the reference
        # does at mount (RebuildEcxFile, ec_volume_delete.go:51-98)
        self._replay_ecj()
        self._ecx = open(base + ".ecx", "r+b")
        self.ids, self.offs, self.sizes = idxf.read_columns(self._ecx.read())

        self.shards: dict[int, object] = {}
        for i in range(self.spec.n):
            p = base + layout.to_ext(i)
            if os.path.exists(p):
                self.shards[i] = open(p, "rb")
        # every shard file has the same size; the scrubber walks it
        self.shard_size = os.fstat(next(iter(self.shards.values())).fileno()
                                   ).st_size if self.shards else 0
        self.dat_size = ec_files.find_dat_file_size(base, self.version)
        self.read_stats = {"local_shard_reads": 0, "intervals_coalesced": 0,
                           "reconstruct_batches": 0,
                           "reconstruct_intervals": 0}

    # -- index ---------------------------------------------------------

    def _replay_ecj(self) -> None:
        ecj = self.base + ".ecj"
        deleted = ec_files.read_ecj(ecj)
        if not deleted:
            return
        with open(self.base + ".ecx", "r+b") as f:
            ids, _, _ = idxf.read_columns(f.read())
            for nid in deleted:
                pos = int(np.searchsorted(ids, nid))
                if pos < len(ids) and ids[pos] == nid:
                    f.seek(pos * 16 + 12)
                    f.write(t.TOMBSTONE_FILE_SIZE.to_bytes(4, "big", signed=True))
        os.remove(ecj)

    def find_needle(self, needle_id: int) -> tuple[int, int]:
        """-> (dat_offset_bytes, size); raises KeyError if absent/deleted."""
        pos = int(np.searchsorted(self.ids, needle_id))
        if pos >= len(self.ids) or self.ids[pos] != needle_id:
            raise KeyError(f"needle {needle_id:x} not in ec volume")
        size = int(self.sizes[pos])
        if not t.size_is_valid(size):
            raise KeyError(f"needle {needle_id:x} deleted")
        return t.from_offset_units(int(self.offs[pos])), size

    def delete_needle(self, needle_id: int) -> None:
        """Tombstone in .ecx (in place) + append to the .ecj journal."""
        pos = int(np.searchsorted(self.ids, needle_id))
        if pos >= len(self.ids) or self.ids[pos] != needle_id:
            return
        self.sizes[pos] = t.TOMBSTONE_FILE_SIZE
        self._ecx.seek(pos * 16 + 12)
        self._ecx.write(t.TOMBSTONE_FILE_SIZE.to_bytes(4, "big", signed=True))
        self._ecx.flush()
        with open(self.base + ".ecj", "ab") as j:
            j.write(needle_id.to_bytes(8, "big"))

    # -- reads ----------------------------------------------------------

    def _read_local(self, shard_id: int, offset: int, size: int) -> bytes | None:
        """Positional read of one shard range; None when the shard is
        absent or reads short."""
        f = self.shards.get(shard_id)
        if f is None:
            return None
        try:
            data = os.pread(f.fileno(), size, offset)
        except OSError:
            return None
        return data if len(data) == size else None

    def read_interval(self, shard_id: int, offset: int, size: int) -> bytes:
        data = self._read_local(shard_id, offset, size)
        if data is not None:
            self.read_stats["local_shard_reads"] += 1
            return data
        return self._reconstruct_ranges([(shard_id, offset, size)])[0]

    def _gather_survivors(self, exclude: set[int],
                          segs: list[tuple[int, int]],
                          want: list[int] | None = None,
                          need: int | None = None
                          ) -> dict[int, np.ndarray]:
        """Survivor rows covering every segment, the segments of each
        shard concatenated, in shard order.

        `want` restricts reads to a codec-chosen basis (an LRC local
        group); `need` is how many rows suffice (default len(want), else
        k).  Raises IOError when fewer are readable, so the caller can
        retry unrestricted."""
        universe = want if want is not None else range(self.spec.n)
        need = need if need is not None else \
            (len(want) if want is not None else self.spec.k)
        rows: dict[int, np.ndarray] = {}
        for sid in universe:
            if sid in exclude or sid not in self.shards:
                continue
            parts = [self._read_local(sid, off, size) for off, size in segs]
            if any(p is None for p in parts):
                continue
            rows[sid] = np.frombuffer(b"".join(parts), dtype=np.uint8)
            self.read_stats["local_shard_reads"] += len(segs)
            if len(rows) == need:
                return rows
        raise IOError(
            f"ec volume {self.base}: only {len(rows)} shards readable, need "
            f"{need} to reconstruct shard(s) {sorted(exclude)}")

    def _reconstruct_ranges(self, ranges: list[tuple[int, int, int]]
                            ) -> list[bytes]:
        """Rebuild several (shard_id, offset, size) ranges in ONE batched
        codec dispatch: each survivor's slices concatenate into a single
        row, the decode runs once over the whole concatenation (for every
        wanted shard), and the rebuilt rows split back per range."""
        wanted = sorted({sid for sid, _, _ in ranges})
        segs = [(off, size) for _, off, size in ranges]
        # MSR works on byte-interleaved alpha blocks: widen each segment
        # to alpha boundaries, slice the lead back off after the decode
        # (alpha = 1 for rs/lrc: no-op)
        a = self.spec.alpha
        leads = [off % a for off, _ in segs]
        gsegs = [(off - lead, -(-(lead + size) // a) * a)
                 for (off, size), lead in zip(segs, leads)]
        # the codec's basis over every shard but the wanted: an LRC single
        # loss reads one local group, MSR any k whole files.  Without one
        # (RS, or a basis shard absent or unreadable) read unrestricted;
        # one survivor beyond k keeps every LRC pattern within its
        # tolerance decodable
        basis = self._basis(wanted)
        rows = None
        seg_bytes = sum(size for _, size in gsegs)
        flow = pipeline.flow("ec_read")
        with trace.span("ec.gather_survivors", shards_lost=len(wanted),
                        segs=len(gsegs)), \
                flow.stage("gather_survivors",
                           nbytes=self.spec.k * seg_bytes):
            if basis is not None:
                try:
                    rows = self._gather_survivors(set(wanted), gsegs,
                                                  want=basis)
                except IOError:
                    pass
            if rows is None:
                rows = self._gather_survivors(
                    set(wanted), gsegs,
                    need=self.spec.k + (self.spec.family == "lrc"))
        with trace.span("ec.reconstruct_batch", intervals=len(ranges),
                        shards=len(wanted), bytes=seg_bytes), \
                flow.stage("reconstruct", nbytes=seg_bytes):
            rebuilt = ec_files._reconstruct_batch(self.codec, rows, wanted)
        self.read_stats["reconstruct_batches"] += 1
        self.read_stats["reconstruct_intervals"] += len(ranges)
        if heat.ambient_is_data():
            # a read that reconstructed, under foreground traffic; weight
            # 0: the serving path's read record counts the request itself
            heat.record("volume", self.vid, 0, "degraded", weight=0.0)
        out = []
        pos = 0
        for (sid, _, size), lead, (_, gsize) in zip(ranges, leads, gsegs):
            out.append(rebuilt[sid][pos + lead:pos + lead + size].tobytes())
            pos += gsize
        return out

    def _basis(self, wanted: list[int]) -> list[int] | None:
        """The codec's survivor basis for `wanted` when every other shard
        is assumed present (as the reference assumes); None for RS, which
        reads the first k readable, and when a basis shard is already
        known absent, which no restricted read can get past."""
        if self.spec.family == "rs":
            return None
        basis = self.codec.basis(
            sorted(set(range(self.spec.n)) - set(wanted)), wanted)
        if any(s not in self.shards for s in basis):
            return None
        return list(basis)

    def _read_ranges(self, plan: list[tuple[int, int, int]]) -> list[bytes]:
        """Coalesce adjacent per-shard ranges, read them locally, and repair
        everything missing in one reconstruction dispatch."""
        with trace.span("ec.coalesce", intervals=len(plan)) as csp:
            per_shard: dict[int, list[tuple[int, int, int]]] = {}
            for i, (sid, off, size) in enumerate(plan):
                per_shard.setdefault(sid, []).append((off, size, i))
            reads: list[list] = []  # [sid, off, size, [(idx, rel, sz)..]]
            for sid, lst in per_shard.items():
                lst.sort()
                cur: list | None = None
                for off, size, idx in lst:
                    if cur is not None and cur[1] + cur[2] == off:
                        cur[3].append((idx, cur[2], size))
                        cur[2] += size
                    else:
                        cur = [sid, off, size, [(idx, 0, size)]]
                        reads.append(cur)
            csp.set(reads=len(reads))
        self.read_stats["intervals_coalesced"] += len(plan) - len(reads)

        blobs: dict[int, bytes] = {}
        failed: list[int] = []
        with trace.span("ec.local_pread", reads=len(reads)) as lsp, \
                pipeline.flow("ec_read").stage(
                    "local_pread", nbytes=sum(r[2] for r in reads)):
            for ri, (sid, off, size, _) in enumerate(reads):
                data = self._read_local(sid, off, size)
                if data is None:
                    failed.append(ri)
                else:
                    blobs[ri] = data
                    self.read_stats["local_shard_reads"] += 1
            lsp.set(missed=len(failed))
        if failed:
            rebuilt = self._reconstruct_ranges(
                [tuple(reads[ri][:3]) for ri in failed])
            for ri, data in zip(failed, rebuilt):
                blobs[ri] = data
        parts: list[bytes] = [b""] * len(plan)
        for ri, (_, _, _, members) in enumerate(reads):
            for idx, rel, size in members:
                parts[idx] = blobs[ri][rel:rel + size]
        return parts

    def read_needle(self, needle_id: int) -> ndl.Needle:
        """Full needle read: locate -> plan all intervals -> local shard
        reads + one-shot reconstruction -> parse (CRC checked)."""
        with trace.span("ec.plan", needle=f"{needle_id:x}") as psp:
            dat_offset, size = self.find_needle(needle_id)
            length = t.actual_size(size, self.version)
            plan = []
            for iv in layout.locate_data(self.large_block, self.small_block,
                                         self.dat_size, dat_offset, length,
                                         data_shards=self.spec.k):
                sid, off = iv.to_shard_id_and_offset(self.large_block,
                                                     self.small_block)
                plan.append((sid, off, iv.size))
            psp.set(intervals=len(plan), bytes=length)
        record = b"".join(self._read_ranges(plan))
        n = ndl.Needle.from_record(record, self.version)
        if n.id != needle_id:
            raise IOError(f"ec read returned needle {n.id:x}, wanted {needle_id:x}")
        return n

    def shard_ids(self) -> list[int]:
        return sorted(self.shards)

    def close(self) -> None:
        self._ecx.close()
        for f in self.shards.values():
            f.close()
