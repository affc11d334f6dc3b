""".idx file codec: 16-byte entries [NeedleId 8][Offset 4][Size 4], offsets
in 8-byte units (reference: weed/storage/idx/walk.go:12-40).

Read side is vectorised with numpy — a 32GB volume's index is ~16M entries
and walking it with a Python loop would take seconds; as three numpy columns
it is milliseconds and feeds the EC `.ecx` sort for free.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Iterator

import numpy as np

from seaweedfs_tpu_torch.storage import types as t

ENTRY = struct.Struct(">QIi")


def pack_entry(needle_id: int, offset_units: int, size: int) -> bytes:
    return ENTRY.pack(needle_id, offset_units, size)


def unpack_entry(b: bytes) -> tuple[int, int, int]:
    return ENTRY.unpack(b)


def read_columns(data: bytes) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Whole .idx buffer -> (ids u64, offset_units u32, sizes i32) columns."""
    n = len(data) // t.NEEDLE_MAP_ENTRY_SIZE
    arr = np.frombuffer(data, dtype=np.uint8, count=n * 16).reshape(n, 16)
    ids = arr[:, :8].copy().view(">u8").reshape(n).astype(np.uint64)
    offs = arr[:, 8:12].copy().view(">u4").reshape(n).astype(np.uint32)
    sizes = arr[:, 12:16].copy().view(">i4").reshape(n).astype(np.int32)
    return ids, offs, sizes


def walk(f: BinaryIO) -> Iterator[tuple[int, int, int]]:
    """Yield (needle_id, offset_units, size) in file order."""
    while True:
        chunk = f.read(t.NEEDLE_MAP_ENTRY_SIZE * 4096)
        if not chunk:
            return
        n = len(chunk) // t.NEEDLE_MAP_ENTRY_SIZE
        for i in range(n):
            yield ENTRY.unpack_from(chunk, i * t.NEEDLE_MAP_ENTRY_SIZE)
