"""Backend abstraction for volume .dat IO.

Counterpart of `seaweedfs_tpu/storage/backend.py` (reference:
weed/storage/backend/backend.go:15-31, disk_file.go, memory_map/,
s3_backend/).  A volume's data file is reached through this seam so its
bytes can live on local disk (buffered or mmap) or on a remote tier:
`Volume.tier_move` swaps a sealed volume's .dat to a `RemoteFile` over
any RemoteStorageClient (`seaweedfs_tpu_torch/remote_storage.py`).
"""

from __future__ import annotations

import mmap
import os


class BackendStorageFile:
    """File-like seam: read_at/write_at/size/flush/sync/close."""

    name = "abstract"

    def read_at(self, offset: int, size: int) -> bytes:
        raise NotImplementedError

    def append(self, data: bytes) -> int:
        """Append; returns the offset the data landed at."""
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError

    def truncate(self, size: int) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def sync(self) -> None:
        pass

    def close(self) -> None:
        pass


class DiskFile(BackendStorageFile):
    """Buffered local file (reference: backend/disk_file.go)."""

    name = "disk"

    def __init__(self, path: str):
        self.path = path
        existing = os.path.exists(path)
        self._f = open(path, "r+b" if existing else "w+b")

    def read_at(self, offset: int, size: int) -> bytes:
        self._f.seek(offset)
        return self._f.read(size)

    def pread(self, offset: int, size: int) -> bytes:
        """Positional read on the raw fd — no shared seek position, so
        concurrent readers need no lock.  Coherent with append() because
        append flushes the userspace buffer before returning."""
        return os.pread(self._f.fileno(), size, offset)

    def append(self, data: bytes) -> int:
        self._f.seek(0, os.SEEK_END)
        offset = self._f.tell()
        self._f.write(data)
        # flush so lock-free pread() readers see the bytes the moment the
        # needle becomes visible in the needle map (append returns first)
        self._f.flush()
        return offset

    def size(self) -> int:
        self._f.seek(0, os.SEEK_END)
        return self._f.tell()

    def truncate(self, size: int) -> None:
        self._f.truncate(size)
        self._f.flush()

    def flush(self) -> None:
        self._f.flush()

    def sync(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        self._f.close()


class MmapFile(BackendStorageFile):
    """mmap-backed reads with file-append writes (reference:
    backend/memory_map) — page cache serves hot reads without syscalls."""

    name = "mmap"

    def __init__(self, path: str):
        self.path = path
        existing = os.path.exists(path)
        self._f = open(path, "r+b" if existing else "w+b")
        self._mm: mmap.mmap | None = None
        self._remap()

    def _remap(self) -> None:
        if self._mm is not None:
            self._mm.close()
            self._mm = None
        self._f.seek(0, os.SEEK_END)
        if self._f.tell() > 0:
            self._mm = mmap.mmap(self._f.fileno(), 0,
                                 access=mmap.ACCESS_READ)

    def read_at(self, offset: int, size: int) -> bytes:
        if self._mm is None or offset + size > len(self._mm):
            self._f.flush()
            self._remap()
        if self._mm is not None and offset + size <= len(self._mm):
            return bytes(self._mm[offset:offset + size])
        self._f.seek(offset)
        return self._f.read(size)

    def pread(self, offset: int, size: int) -> bytes:
        """Lock-free read out of the current mapping — a memcpy, zero
        syscalls.  Raises OSError when the window is stale (file grew
        past it, or a truncate/close swapped the map): the caller falls
        back to the locked read_at, which remaps."""
        mm = self._mm
        if mm is None:
            raise OSError("no mapping yet")
        try:
            if offset + size > len(mm):
                raise OSError("read past mmap window")
            return mm[offset:offset + size]
        except ValueError as e:  # mapping closed under us (remap/close)
            raise OSError(str(e)) from e

    def append(self, data: bytes) -> int:
        self._f.seek(0, os.SEEK_END)
        offset = self._f.tell()
        self._f.write(data)
        return offset

    def size(self) -> int:
        self._f.seek(0, os.SEEK_END)
        return self._f.tell()

    def truncate(self, size: int) -> None:
        self._f.truncate(size)
        self._f.flush()
        self._remap()

    def flush(self) -> None:
        self._f.flush()

    def sync(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        if self._mm is not None:
            self._mm.close()
        self._f.close()


class RemoteFile(BackendStorageFile):
    """Read-only .dat served from a remote tier (reference:
    backend/s3_backend/s3_backend.go) — sealed volumes moved to cold
    storage keep serving reads through the same seam."""

    name = "remote"

    def __init__(self, remote, key: str, size: int):
        self.remote = remote  # RemoteStorageClient
        self.key = key
        self._size = size

    def read_at(self, offset: int, size: int) -> bytes:
        return self.remote.read_range(self.key, offset, size)

    def append(self, data: bytes) -> int:
        raise PermissionError("remote-tier volume is read-only")

    def truncate(self, size: int) -> None:
        raise PermissionError("remote-tier volume is read-only")

    def size(self) -> int:
        return self._size


BACKENDS = {"disk": DiskFile, "mmap": MmapFile}


def open_backend(path: str, kind: str = "disk") -> BackendStorageFile:
    try:
        return BACKENDS[kind](path)
    except KeyError:
        raise ValueError(f"unknown backend {kind!r} (have {sorted(BACKENDS)})")
