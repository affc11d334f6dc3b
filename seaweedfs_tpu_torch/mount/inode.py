"""Inode <-> path bookkeeping (reference: weed/mount/inode_to_path.go;
counterpart of `seaweedfs_tpu/mount/inode.py`).

FUSE speaks inodes; the filer speaks paths.  Paths get stable inode
numbers for their lifetime; renames move the path but keep the inode.
"""

from __future__ import annotations

import threading

ROOT_INODE = 1


class InodeToPath:
    def __init__(self, root: str = "/"):
        self.root = root
        self._lock = threading.Lock()
        self._path_to_inode: dict[str, int] = {"/": ROOT_INODE}
        self._inode_to_path: dict[int, str] = {ROOT_INODE: "/"}
        self._next = ROOT_INODE + 1

    def lookup(self, path: str) -> int:
        with self._lock:
            ino = self._path_to_inode.get(path)
            if ino is None:
                ino = self._next
                self._next += 1
                self._path_to_inode[path] = ino
                self._inode_to_path[ino] = path
            return ino

    def path_of(self, inode: int) -> str | None:
        with self._lock:
            return self._inode_to_path.get(inode)

    def move(self, old_path: str, new_path: str) -> None:
        with self._lock:
            ino = self._path_to_inode.pop(old_path, None)
            if ino is None:
                return
            # a rename target that already had an inode gets orphaned
            stale = self._path_to_inode.pop(new_path, None)
            if stale is not None:
                self._inode_to_path.pop(stale, None)
            self._path_to_inode[new_path] = ino
            self._inode_to_path[ino] = new_path
            # move children of a renamed directory
            prefix = old_path.rstrip("/") + "/"
            for p in [p for p in self._path_to_inode if p.startswith(prefix)]:
                child_ino = self._path_to_inode.pop(p)
                np = new_path.rstrip("/") + "/" + p[len(prefix):]
                self._path_to_inode[np] = child_ino
                self._inode_to_path[child_ino] = np

    def forget(self, path: str) -> None:
        with self._lock:
            ino = self._path_to_inode.pop(path, None)
            if ino is not None and ino != ROOT_INODE:
                self._inode_to_path.pop(ino, None)
