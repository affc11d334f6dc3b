"""On-disk scalar types and constants of the needle store.

Byte-compatible with the reference formats (all integers big-endian):
- needle header [Cookie 4B][NeedleId 8B][Size 4B]
  (reference: weed/storage/types/needle_types.go:33-41)
- .idx entries [NeedleId 8B][Offset 4B][Size 4B], offset in units of 8 bytes
  (reference: weed/storage/types/offset_4bytes.go:14-17 — 32GB max volume)
- tombstone Size == -1 (reference: needle_types.go TombstoneFileSize)
"""

from __future__ import annotations

from dataclasses import dataclass

COOKIE_SIZE = 4
NEEDLE_ID_SIZE = 8
SIZE_SIZE = 4
NEEDLE_HEADER_SIZE = COOKIE_SIZE + NEEDLE_ID_SIZE + SIZE_SIZE  # 16
NEEDLE_CHECKSUM_SIZE = 4
TIMESTAMP_SIZE = 8
NEEDLE_PADDING_SIZE = 8
NEEDLE_MAP_ENTRY_SIZE = NEEDLE_ID_SIZE + 4 + SIZE_SIZE  # 16
OFFSET_SIZE = 4
TOMBSTONE_FILE_SIZE = -1
MAX_POSSIBLE_VOLUME_SIZE = 4 * 1024 * 1024 * 1024 * 8  # 32GB (4B offset x8)

VERSION1 = 1
VERSION2 = 2
VERSION3 = 3
CURRENT_VERSION = VERSION3


def size_is_deleted(size: int) -> bool:
    return size < 0 or size == TOMBSTONE_FILE_SIZE


def size_is_valid(size: int) -> bool:
    return size > 0 and size != TOMBSTONE_FILE_SIZE


def padding_length(size: int, version: int = CURRENT_VERSION) -> int:
    """Bytes of zero padding after a needle record.

    Deliberately reproduces the reference quirk of padding a FULL extra
    block when the record is already aligned (8 - x%8, never 0; reference:
    weed/storage/needle/needle_read.go:208-214)."""
    if version == VERSION3:
        x = NEEDLE_HEADER_SIZE + size + NEEDLE_CHECKSUM_SIZE + TIMESTAMP_SIZE
    else:
        x = NEEDLE_HEADER_SIZE + size + NEEDLE_CHECKSUM_SIZE
    return NEEDLE_PADDING_SIZE - (x % NEEDLE_PADDING_SIZE)


def needle_body_length(size: int, version: int = CURRENT_VERSION) -> int:
    if version == VERSION3:
        return size + NEEDLE_CHECKSUM_SIZE + TIMESTAMP_SIZE + padding_length(size, version)
    return size + NEEDLE_CHECKSUM_SIZE + padding_length(size, version)


def actual_size(size: int, version: int = CURRENT_VERSION) -> int:
    """Total on-disk bytes of a needle record with body size `size`."""
    return NEEDLE_HEADER_SIZE + needle_body_length(size, version)


def to_offset_units(byte_offset: int) -> int:
    assert byte_offset % NEEDLE_PADDING_SIZE == 0, byte_offset
    return byte_offset // NEEDLE_PADDING_SIZE


def from_offset_units(units: int) -> int:
    return units * NEEDLE_PADDING_SIZE


@dataclass(frozen=True)
class FileId:
    """`vid,keyhex+cookie8hex` — the client-visible blob id.

    reference: weed/storage/needle/file_id.go:60-75 (leading zero bytes of
    the 12-byte key+cookie are trimmed at byte granularity).
    """

    volume_id: int
    key: int
    cookie: int

    def __str__(self) -> str:
        raw = self.key.to_bytes(8, "big") + self.cookie.to_bytes(4, "big")
        i = 0
        while i < 7 and raw[i] == 0:  # keep at least 1 key byte + cookie
            i += 1
        return f"{self.volume_id},{raw[i:].hex()}"

    @classmethod
    def parse(cls, fid: str) -> "FileId":
        vid_str, _, kc = fid.partition(",")
        if not kc:
            raise ValueError(f"bad file id {fid!r}")
        kc = kc.partition("_")[0]  # strip alternate-key suffix
        if len(kc) <= 8:
            raise ValueError(f"file id {fid!r} too short for key+cookie")
        if len(kc) % 2:
            kc = "0" + kc
        raw = bytes.fromhex(kc)
        return cls(volume_id=int(vid_str),
                   key=int.from_bytes(raw[:-4], "big"),
                   cookie=int.from_bytes(raw[-4:], "big"))


class TTL:
    """2-byte count+unit TTL (reference: weed/storage/needle/volume_ttl.go)."""

    UNITS = {"": 0, "m": 1, "h": 2, "d": 3, "w": 4, "M": 5, "y": 6}
    _MINUTES = {0: 0, 1: 1, 2: 60, 3: 24 * 60, 4: 7 * 24 * 60,
                5: 31 * 24 * 60, 6: 365 * 24 * 60}

    def __init__(self, count: int = 0, unit: int = 0):
        self.count = count
        self.unit = unit

    @classmethod
    def parse(cls, s: str) -> "TTL":
        if not s:
            return cls()
        if s[-1].isdigit():
            return cls(int(s), cls.UNITS["m"])
        return cls(int(s[:-1] or 0), cls.UNITS[s[-1]])

    def to_bytes(self) -> bytes:
        return bytes([self.count & 0xFF, self.unit & 0xFF])

    @classmethod
    def from_bytes(cls, b: bytes) -> "TTL":
        return cls(b[0], b[1])

    @property
    def minutes(self) -> int:
        return self.count * self._MINUTES.get(self.unit, 0)

    def __bool__(self) -> bool:
        return self.count != 0 and self.unit != 0

    def __eq__(self, other) -> bool:
        return isinstance(other, TTL) and (self.count, self.unit) == (other.count, other.unit)

    def __str__(self) -> str:
        if not self:
            return ""
        names = {v: k for k, v in self.UNITS.items()}
        return f"{self.count}{names.get(self.unit, '')}"


class ReplicaPlacement:
    """xyz digit code: x other-DC, y other-rack, z same-rack copies
    (reference: weed/storage/super_block/replica_placement.go)."""

    def __init__(self, diff_dc: int = 0, diff_rack: int = 0, same_rack: int = 0):
        self.diff_dc = diff_dc
        self.diff_rack = diff_rack
        self.same_rack = same_rack

    @classmethod
    def parse(cls, s: str) -> "ReplicaPlacement":
        s = (s or "000").zfill(3)
        if len(s) != 3 or not s.isdigit():
            raise ValueError(f"bad replica placement {s!r} (want xyz digits)")
        rp = cls(int(s[0]), int(s[1]), int(s[2]))
        if rp.to_byte() > 255:
            raise ValueError(f"replica placement {s!r} exceeds one byte")
        return rp

    @classmethod
    def from_byte(cls, b: int) -> "ReplicaPlacement":
        return cls(b // 100, (b // 10) % 10, b % 10)

    def to_byte(self) -> int:
        return self.diff_dc * 100 + self.diff_rack * 10 + self.same_rack

    @property
    def copy_count(self) -> int:
        return self.diff_dc + self.diff_rack + self.same_rack + 1

    def __str__(self) -> str:
        return f"{self.diff_dc}{self.diff_rack}{self.same_rack}"

    def __eq__(self, other) -> bool:
        return isinstance(other, ReplicaPlacement) and self.to_byte() == other.to_byte()
