"""FUSE mount: filer-backed filesystem.

Counterpart of `seaweedfs_tpu/mount/` (reference: weed/mount/ —
weedfs.go WFS struct, inode_to_path.go, filehandle.go,
dirty_pages_chunked.go, meta_cache/).  The VFS core (WFS) is
kernel-independent and fully testable; the thin FUSE binding uses the
`fuse` (fusepy) package when present, else the ctypes libfuse2 binding
in `fuse_ll.py`.  Nothing here loads torch: the mount has no device.
"""

from seaweedfs_tpu_torch.mount.weedfs import WFS  # noqa: F401
