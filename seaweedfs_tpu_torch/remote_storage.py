"""Remote storage tier: the client seam that sealed volumes move to.

Counterpart of `seaweedfs_tpu/remote_storage.py` (reference:
weed/remote_storage/ — s3/gcs/azure clients behind RemoteStorageClient,
traverse_bfs.go), cut to what `Volume.tier_move` and `tier_download`
call: the SPI and its local-directory client, an rclone-style adapter
that stands in for a bucket.  The S3, GCS and Azure clients, the filer
mount and `parse_remote_spec` come with replication (ROADMAP 1.22).
"""

from __future__ import annotations

import os
from dataclasses import dataclass


@dataclass
class RemoteEntry:
    key: str
    size: int
    mtime: float
    is_directory: bool = False


class RemoteStorageClient:
    """SPI (reference: remote_storage.go RemoteStorageClient interface)."""

    name = "abstract"

    def traverse(self, prefix: str = ""):
        """Yield RemoteEntry for every object under prefix (BFS order,
        reference: traverse_bfs.go)."""
        raise NotImplementedError

    def read_file(self, key: str) -> bytes:
        raise NotImplementedError

    def read_range(self, key: str, offset: int, size: int) -> bytes:
        return self.read_file(key)[offset:offset + size]

    def write_file(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def upload_file(self, key: str, local_path: str) -> None:
        with open(local_path, "rb") as f:
            self.write_file(key, f.read())

    def delete_file(self, key: str) -> None:
        raise NotImplementedError


class LocalDirRemote(RemoteStorageClient):
    """A directory as the 'remote bucket' — test/dev stand-in with the
    exact semantics the cloud clients implement."""

    name = "local"

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def _p(self, key: str) -> str:
        return os.path.join(self.dir, key.lstrip("/"))

    def traverse(self, prefix: str = ""):
        root = self._p(prefix)
        if not os.path.isdir(root):
            return
        for dirpath, dirnames, filenames in os.walk(root):
            rel_dir = os.path.relpath(dirpath, self.dir)
            def norm(key: str) -> str:
                key = key.replace("\\", "/")
                return key[2:] if key.startswith("./") else key

            for d in sorted(dirnames):
                yield RemoteEntry(norm(os.path.join(rel_dir, d)), 0, 0,
                                  is_directory=True)
            for f in sorted(filenames):
                p = os.path.join(dirpath, f)
                st = os.stat(p)
                yield RemoteEntry(norm(os.path.join(rel_dir, f)),
                                  st.st_size, st.st_mtime)

    def read_file(self, key: str) -> bytes:
        with open(self._p(key), "rb") as f:
            return f.read()

    def read_range(self, key: str, offset: int, size: int) -> bytes:
        with open(self._p(key), "rb") as f:
            f.seek(offset)
            return f.read(size)

    def write_file(self, key: str, data: bytes) -> None:
        p = self._p(key)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "wb") as f:
            f.write(data)

    def upload_file(self, key: str, local_path: str) -> None:
        """Streamed upload (tier-move of multi-GB .dat files must not
        buffer in RAM)."""
        import shutil
        p = self._p(key)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        shutil.copyfile(local_path, p)

    def delete_file(self, key: str) -> None:
        try:
            os.remove(self._p(key))
        except FileNotFoundError:
            pass


REMOTES = {"local": LocalDirRemote}


def make_remote(kind: str, **options) -> RemoteStorageClient:
    try:
        return REMOTES[kind](**options)
    except KeyError:
        raise ValueError(f"unknown remote {kind!r} (have {sorted(REMOTES)})")
