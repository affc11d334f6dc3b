"""Needle codec: one blob record in a volume file.

Byte-compatible with the reference's V1/V2/V3 formats
(reference: weed/storage/needle/needle_write.go:25-130 for layout,
needle_read.go:120-200 for parsing, crc.go for CRC32-Castagnoli):

V3 record =
  [Cookie 4][NeedleId 8][Size 4]                      # header
  [DataSize 4][Data][Flags 1]                         # body (if DataSize>0)
  [NameSize 1][Name]?   (flag 0x02)
  [MimeSize 1][Mime]?   (flag 0x04)
  [LastModified 5]?     (flag 0x08)
  [Ttl 2]?              (flag 0x10)
  [PairsSize 2][Pairs]? (flag 0x20)
  [Checksum 4][AppendAtNs 8][zero padding to 8B]

`Size` is the body length between header and checksum; a tombstone has
Size == -1 on the .idx side and a zero-data record in the .dat file.
"""

from __future__ import annotations

import struct
import time
from dataclasses import dataclass, field

from seaweedfs_tpu_torch.storage import types as t

FLAG_IS_COMPRESSED = 0x01
FLAG_HAS_NAME = 0x02
FLAG_HAS_MIME = 0x04
FLAG_HAS_LAST_MODIFIED = 0x08
FLAG_HAS_TTL = 0x10
FLAG_HAS_PAIRS = 0x20
FLAG_IS_CHUNK_MANIFEST = 0x80

LAST_MODIFIED_BYTES = 5
TTL_BYTES = 2


def _crc32c_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c_plain(data: bytes) -> int:
    """CRC32-C (Castagnoli) one byte at a time from a table: the plain
    version the host library is tested against."""
    crc = 0xFFFFFFFF
    for b in bytes(data):
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def crc32c(data: bytes) -> int:
    """CRC32-C of `data` by the port's host library (csrc/crc32c.cc, built
    at first use)."""
    from seaweedfs_tpu_torch import _build
    if not isinstance(data, bytes):
        data = bytes(data)
    return int(_build.load("crc32c").wn_crc32c(data, len(data), 0))


def crc_legacy_value(c: int) -> int:
    """Pre-2021 volumes stored this rotated form of the CRC; readers accept
    both (reference: weed/storage/needle/crc.go:27, needle_read.go:76)."""
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


@dataclass
class Needle:
    cookie: int = 0
    id: int = 0
    data: bytes = b""
    name: bytes = b""
    mime: bytes = b""
    pairs: bytes = b""
    flags: int = 0
    last_modified: int = 0
    ttl: t.TTL | None = None
    checksum: int = 0
    append_at_ns: int = 0
    size: int = field(default=0)  # filled by encode/parse

    # -- flag helpers --------------------------------------------------

    def has(self, flag: int) -> bool:
        return bool(self.flags & flag)

    def set_flags(self) -> None:
        if self.name:
            self.flags |= FLAG_HAS_NAME
        if self.mime:
            self.flags |= FLAG_HAS_MIME
        if self.last_modified:
            self.flags |= FLAG_HAS_LAST_MODIFIED
        if self.ttl and bool(self.ttl):
            self.flags |= FLAG_HAS_TTL
        if self.pairs:
            self.flags |= FLAG_HAS_PAIRS

    # -- encode --------------------------------------------------------

    def body_size(self, version: int = t.CURRENT_VERSION) -> int:
        if version == t.VERSION1:
            return len(self.data)
        if not self.data:
            return 0
        size = 4 + len(self.data) + 1
        if self.has(FLAG_HAS_NAME):
            size += 1 + min(len(self.name), 255)
        if self.has(FLAG_HAS_MIME):
            size += 1 + len(self.mime)
        if self.has(FLAG_HAS_LAST_MODIFIED):
            size += LAST_MODIFIED_BYTES
        if self.has(FLAG_HAS_TTL):
            size += TTL_BYTES
        if self.has(FLAG_HAS_PAIRS):
            size += 2 + len(self.pairs)
        return size

    def to_bytes(self, version: int = t.CURRENT_VERSION) -> bytes:
        """Full on-disk record including padding. Sets self.size/checksum."""
        self.set_flags()
        self.checksum = crc32c(self.data)
        if version == t.VERSION1:
            self.size = len(self.data)
            out = bytearray()
            out += struct.pack(">IQi", self.cookie, self.id, self.size)
            out += self.data
            out += struct.pack(">I", self.checksum)
            out += bytes(t.padding_length(self.size, version))
            return bytes(out)

        self.size = self.body_size(version)
        out = bytearray()
        out += struct.pack(">IQi", self.cookie, self.id, self.size)
        if self.data:
            out += struct.pack(">I", len(self.data))
            out += self.data
            out += bytes([self.flags])
            if self.has(FLAG_HAS_NAME):
                name = self.name[:255]
                out += bytes([len(name)]) + name
            if self.has(FLAG_HAS_MIME):
                out += bytes([len(self.mime)]) + self.mime
            if self.has(FLAG_HAS_LAST_MODIFIED):
                out += self.last_modified.to_bytes(8, "big")[8 - LAST_MODIFIED_BYTES:]
            if self.has(FLAG_HAS_TTL):
                out += (self.ttl or t.TTL()).to_bytes()
            if self.has(FLAG_HAS_PAIRS):
                out += struct.pack(">H", len(self.pairs)) + self.pairs
        out += struct.pack(">I", self.checksum)
        if version == t.VERSION3:
            if not self.append_at_ns:
                self.append_at_ns = time.time_ns()
            out += struct.pack(">Q", self.append_at_ns)
        out += bytes(t.padding_length(self.size, version))
        return bytes(out)

    # -- decode --------------------------------------------------------

    @classmethod
    def parse_header(cls, header: bytes) -> "Needle":
        cookie, nid, size = struct.unpack(">IQi", header[: t.NEEDLE_HEADER_SIZE])
        n = cls(cookie=cookie, id=nid)
        n.size = size
        return n

    def parse_body(self, body: bytes, version: int = t.CURRENT_VERSION,
                   verify_checksum: bool = True) -> None:
        """`body` is the record after the 16-byte header (size from header)."""
        size = self.size
        if size <= 0:
            self.data = b""
            if version == t.VERSION3 and len(body) >= t.NEEDLE_CHECKSUM_SIZE + t.TIMESTAMP_SIZE:
                (self.append_at_ns,) = struct.unpack(
                    ">Q", body[t.NEEDLE_CHECKSUM_SIZE: t.NEEDLE_CHECKSUM_SIZE + 8])
            return
        if version == t.VERSION1:
            self.data = body[:size]
            (self.checksum,) = struct.unpack(">I", body[size: size + 4])
        else:
            (data_size,) = struct.unpack(">I", body[:4])
            pos = 4
            self.data = body[pos: pos + data_size]
            pos += data_size
            self.flags = body[pos]
            pos += 1
            if self.has(FLAG_HAS_NAME):
                ln = body[pos]
                self.name = body[pos + 1: pos + 1 + ln]
                pos += 1 + ln
            if self.has(FLAG_HAS_MIME):
                ln = body[pos]
                self.mime = body[pos + 1: pos + 1 + ln]
                pos += 1 + ln
            if self.has(FLAG_HAS_LAST_MODIFIED):
                self.last_modified = int.from_bytes(
                    body[pos: pos + LAST_MODIFIED_BYTES], "big")
                pos += LAST_MODIFIED_BYTES
            if self.has(FLAG_HAS_TTL):
                self.ttl = t.TTL.from_bytes(body[pos: pos + TTL_BYTES])
                pos += TTL_BYTES
            if self.has(FLAG_HAS_PAIRS):
                (psize,) = struct.unpack(">H", body[pos: pos + 2])
                self.pairs = body[pos + 2: pos + 2 + psize]
                pos += 2 + psize
            (self.checksum,) = struct.unpack(">I", body[size: size + 4])
            if version == t.VERSION3:
                (self.append_at_ns,) = struct.unpack(
                    ">Q", body[size + 4: size + 12])
        if verify_checksum:
            c = crc32c(self.data)
            if self.checksum not in (c, crc_legacy_value(c)):
                raise ValueError(
                    f"needle {self.id:x} CRC mismatch: "
                    f"stored {self.checksum:#x} != computed {c:#x}")

    def parse_meta_tail(self, tail: bytes) -> None:
        """Parse the post-data metadata block (flags | name | mime |
        last_modified | ttl | pairs) without the data bytes — the paged
        read path reads only header + this small tail
        (reference: needle_read_page.go reads meta separately too)."""
        if not tail:
            return
        try:
            self.flags = tail[0]
            pos = 1
            if self.has(FLAG_HAS_NAME):
                ln = tail[pos]
                self.name = tail[pos + 1: pos + 1 + ln]
                pos += 1 + ln
            if self.has(FLAG_HAS_MIME):
                ln = tail[pos]
                self.mime = tail[pos + 1: pos + 1 + ln]
                pos += 1 + ln
            if self.has(FLAG_HAS_LAST_MODIFIED):
                self.last_modified = int.from_bytes(
                    tail[pos: pos + LAST_MODIFIED_BYTES], "big")
                pos += LAST_MODIFIED_BYTES
            if self.has(FLAG_HAS_TTL):
                self.ttl = t.TTL.from_bytes(tail[pos: pos + TTL_BYTES])
                pos += TTL_BYTES
        except IndexError as e:
            raise ValueError(f"truncated needle meta tail: {e}") from e

    @classmethod
    def from_record(cls, record: bytes, version: int = t.CURRENT_VERSION,
                    verify_checksum: bool = True) -> "Needle":
        n = cls.parse_header(record)
        n.parse_body(record[t.NEEDLE_HEADER_SIZE:], version, verify_checksum)
        return n
