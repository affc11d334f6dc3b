"""Minimal ctypes binding to libfuse 2.9 — a fusepy-compatible surface
(`FUSE`, `Operations`, `FuseOSError`) so `weedfs.mount()` can attach the
WFS to a real kernel mount without the fusepy package.  Counterpart of
`seaweedfs_tpu/mount/fuse_ll.py`, the same binding.

Reference: the Go build mounts via hanwen/go-fuse (weed/mount/weedfs.go:12-26);
this is the same role — a thin libfuse high-level-API shim.  Only the
operations WFS implements are wired; the `fuse_operations` struct is
truncated after `utimens` and the true size passed to `fuse_main_real`,
which copies min(op_size, sizeof) — fields past the truncation behave as
NULL (kernel default/ENOSYS), and the fragile trailing bitfield+ioctl tail
of the 2.9 layout never needs to be described.

The mount runs single-threaded (`-s`): every callback enters Python, so
multi-threaded dispatch would only add GIL contention.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import errno as errno_mod
import os

c_char_p = ctypes.c_char_p
c_int = ctypes.c_int
c_uint = ctypes.c_uint
c_void_p = ctypes.c_void_p
c_size_t = ctypes.c_size_t
c_off_t = ctypes.c_longlong
c_mode_t = ctypes.c_uint
c_dev_t = ctypes.c_ulonglong
c_uid_t = ctypes.c_uint
c_gid_t = ctypes.c_uint


class Timespec(ctypes.Structure):
    _fields_ = [("tv_sec", ctypes.c_long), ("tv_nsec", ctypes.c_long)]


class Stat(ctypes.Structure):
    # x86_64 glibc struct stat layout
    _fields_ = [
        ("st_dev", c_dev_t),
        ("st_ino", ctypes.c_ulong),
        ("st_nlink", ctypes.c_ulong),
        ("st_mode", c_mode_t),
        ("st_uid", c_uid_t),
        ("st_gid", c_gid_t),
        ("__pad0", ctypes.c_int),
        ("st_rdev", c_dev_t),
        ("st_size", c_off_t),
        ("st_blksize", ctypes.c_long),
        ("st_blocks", ctypes.c_long),
        ("st_atim", Timespec),
        ("st_mtim", Timespec),
        ("st_ctim", Timespec),
        ("__reserved", ctypes.c_long * 3),
    ]


class FuseFileInfo(ctypes.Structure):
    # libfuse 2.9 struct fuse_file_info
    _fields_ = [
        ("flags", c_int),
        ("fh_old", ctypes.c_ulong),
        ("writepage", c_int),
        ("bits", c_uint),  # direct_io/keep_cache/... bitfield
        ("fh", ctypes.c_uint64),
        ("lock_owner", ctypes.c_uint64),
    ]


_fi_p = ctypes.POINTER(FuseFileInfo)
_stat_p = ctypes.POINTER(Stat)

fill_dir_t = ctypes.CFUNCTYPE(c_int, c_void_p, c_char_p, _stat_p, c_off_t)

# NOTE: every BUFFER parameter is c_void_p, never c_char_p — ctypes converts
# c_char_p callback arguments into (NUL-truncated) Python bytes COPIES, so a
# memmove into one would write into a temporary and binary payloads would
# truncate at the first zero byte.
_OP_PROTOS = [
    ("getattr", (c_char_p, _stat_p)),
    ("readlink", (c_char_p, c_void_p, c_size_t)),
    ("getdir", (c_void_p, c_void_p, c_void_p)),  # deprecated, NULL
    ("mknod", (c_char_p, c_mode_t, c_dev_t)),
    ("mkdir", (c_char_p, c_mode_t)),
    ("unlink", (c_char_p,)),
    ("rmdir", (c_char_p,)),
    ("symlink", (c_char_p, c_char_p)),
    ("rename", (c_char_p, c_char_p)),
    ("link", (c_char_p, c_char_p)),
    ("chmod", (c_char_p, c_mode_t)),
    ("chown", (c_char_p, c_uid_t, c_gid_t)),
    ("truncate", (c_char_p, c_off_t)),
    ("utime", (c_char_p, c_void_p)),
    ("open", (c_char_p, _fi_p)),
    ("read", (c_char_p, c_void_p, c_size_t, c_off_t, _fi_p)),
    ("write", (c_char_p, c_void_p, c_size_t, c_off_t, _fi_p)),
    ("statfs", (c_char_p, c_void_p)),
    ("flush", (c_char_p, _fi_p)),
    ("release", (c_char_p, _fi_p)),
    ("fsync", (c_char_p, c_int, _fi_p)),
    ("setxattr", (c_char_p, c_char_p, c_void_p, c_size_t, c_int)),
    ("getxattr", (c_char_p, c_char_p, c_void_p, c_size_t)),
    ("listxattr", (c_char_p, c_void_p, c_size_t)),
    ("removexattr", (c_char_p, c_char_p)),
    ("opendir", (c_char_p, _fi_p)),
    ("readdir", (c_char_p, c_void_p, fill_dir_t, c_off_t, _fi_p)),
    ("releasedir", (c_char_p, _fi_p)),
    ("fsyncdir", (c_char_p, c_int, _fi_p)),
    ("init", None),     # void *(*)(struct fuse_conn_info *), NULL
    ("destroy", None),  # void (*)(void *), NULL
    ("access", (c_char_p, c_int)),
    ("create", (c_char_p, c_mode_t, _fi_p)),
    ("ftruncate", (c_char_p, c_off_t, _fi_p)),
    ("fgetattr", (c_char_p, _stat_p, _fi_p)),
    ("lock", (c_char_p, _fi_p, c_int, c_void_p)),
    ("utimens", (c_char_p, ctypes.POINTER(Timespec * 2))),
]

_PROTO_TYPES = {
    name: (ctypes.CFUNCTYPE(c_int, *args) if args else c_void_p)
    for name, args in _OP_PROTOS
}


class FuseOperations(ctypes.Structure):
    _fields_ = [(name, _PROTO_TYPES[name]) for name, _ in _OP_PROTOS]


class FuseOSError(OSError):
    def __init__(self, errno_: int):
        super().__init__(errno_, os.strerror(errno_))


class Operations:
    """fusepy-compatible base: any op not overridden raises ENOSYS (the
    FUSE shim only wires ops the subclass actually defines, so unwired
    ones fall back to the kernel default)."""

    def __call__(self, op, *args):
        if not hasattr(self, op):
            raise FuseOSError(errno_mod.ENOSYS)
        return getattr(self, op)(*args)


def _errno_of(exc: BaseException) -> int:
    e = getattr(exc, "errno", None)
    return e if isinstance(e, int) and e > 0 else errno_mod.EIO


class FUSE:
    """Mount `operations` at `mountpoint` via fuse_main_real (blocks while
    mounted, like fusepy with foreground=True).  Unmount externally with
    `fusermount -u` (or unmount())."""

    def __init__(self, operations, mountpoint: str, foreground: bool = True,
                 nothreads: bool = True, **options):
        import platform
        if platform.machine() != "x86_64":
            # Stat/FuseFileInfo above are the x86_64 glibc layouts; on
            # another arch the offsets differ and every getattr would feed
            # the kernel garbage — fail loudly instead
            raise RuntimeError(
                "mount/fuse_ll.py only supports x86_64 (struct layouts); "
                "install the 'fusepy' package for this architecture")
        path = ctypes.util.find_library("fuse") or "libfuse.so.2"
        lib = ctypes.CDLL(path)
        lib.fuse_main_real.argtypes = [
            c_int, ctypes.POINTER(c_char_p), ctypes.POINTER(FuseOperations),
            c_size_t, c_void_p]
        self.operations = operations
        ops = FuseOperations()
        self._keep = []  # CFUNCTYPE objects must outlive the mount

        def wire(name, impl):
            cb = _PROTO_TYPES[name](impl)
            self._keep.append(cb)
            setattr(ops, name, cb)

        def guard(fn):
            def call(*args):
                try:
                    r = fn(*args)
                    return 0 if r is None else r
                except OSError as e:
                    return -_errno_of(e)
                except Exception:
                    import logging
                    logging.getLogger("fuse_ll").exception(
                        "unhandled error in fuse op")
                    return -errno_mod.EIO
            return call

        o = operations

        if hasattr(o, "getattr"):
            def _getattr(p, st):
                d = o.getattr(p.decode())
                self._fill_stat(st.contents, d)
            wire("getattr", guard(_getattr))
            wire("fgetattr", guard(
                lambda p, st, fi: _getattr(p, st)))

        if hasattr(o, "readlink"):
            def _readlink(p, buf, size):
                tgt = o.readlink(p.decode()).encode()[: size - 1]
                ctypes.memmove(buf, tgt + b"\0", len(tgt) + 1)
            wire("readlink", guard(_readlink))

        if hasattr(o, "mkdir"):
            wire("mkdir", guard(lambda p, mode: o.mkdir(p.decode(), mode)))
        if hasattr(o, "unlink"):
            wire("unlink", guard(lambda p: o.unlink(p.decode())))
        if hasattr(o, "rmdir"):
            wire("rmdir", guard(lambda p: o.rmdir(p.decode())))
        if hasattr(o, "symlink"):
            wire("symlink", guard(
                lambda target, source: o.symlink(source.decode(),
                                                 target.decode())))
        if hasattr(o, "rename"):
            wire("rename", guard(
                lambda old, new: o.rename(old.decode(), new.decode())))
        if hasattr(o, "link"):
            wire("link", guard(
                lambda target, source: o.link(source.decode(),
                                              target.decode())))
        if hasattr(o, "chmod"):
            wire("chmod", guard(lambda p, mode: o.chmod(p.decode(), mode)))
        if hasattr(o, "chown"):
            wire("chown", guard(
                lambda p, uid, gid: o.chown(p.decode(), uid, gid)))
        if hasattr(o, "truncate"):
            wire("truncate", guard(
                lambda p, length: o.truncate(p.decode(), length)))
            wire("ftruncate", guard(
                lambda p, length, fi: o.truncate(p.decode(), length,
                                                 fi.contents.fh)))

        if hasattr(o, "open"):
            def _open(p, fi):
                fi.contents.fh = o.open(p.decode(), fi.contents.flags)
            wire("open", guard(_open))
        if hasattr(o, "create"):
            def _create(p, mode, fi):
                fi.contents.fh = o.create(p.decode(), mode)
            wire("create", guard(_create))

        if hasattr(o, "read"):
            def _read(p, buf, size, off, fi):
                data = o.read(p.decode(), size, off, fi.contents.fh)
                n = min(len(data), size)
                ctypes.memmove(buf, data, n)
                return n
            wire("read", guard(_read))

        if hasattr(o, "write"):
            def _write(p, buf, size, off, fi):
                data = ctypes.string_at(buf, size)
                return o.write(p.decode(), data, off, fi.contents.fh)
            wire("write", guard(_write))

        if hasattr(o, "flush"):
            wire("flush", guard(
                lambda p, fi: o.flush(p.decode(), fi.contents.fh)))
        if hasattr(o, "release"):
            wire("release", guard(
                lambda p, fi: o.release(p.decode(), fi.contents.fh)))
        if hasattr(o, "fsync"):
            wire("fsync", guard(
                lambda p, ds, fi: o.fsync(p.decode(), ds, fi.contents.fh)))

        if hasattr(o, "readdir"):
            def _readdir(p, buf, filler, off, fi):
                for name in o.readdir(p.decode(), fi.contents.fh):
                    if filler(buf, name.encode(), None, 0) != 0:
                        break
            wire("readdir", guard(_readdir))

        if hasattr(o, "getxattr"):
            def _getxattr(p, name, buf, size):
                val = o.getxattr(p.decode(), name.decode())
                if size == 0:
                    return len(val)
                if len(val) > size:
                    return -errno_mod.ERANGE
                ctypes.memmove(buf, val, len(val))
                return len(val)
            wire("getxattr", guard(_getxattr))

        if hasattr(o, "listxattr"):
            def _listxattr(p, buf, size):
                names = b"".join(n.encode() + b"\0"
                                 for n in o.listxattr(p.decode()))
                if size == 0:
                    return len(names)
                if len(names) > size:
                    return -errno_mod.ERANGE
                ctypes.memmove(buf, names, len(names))
                return len(names)
            wire("listxattr", guard(_listxattr))

        if hasattr(o, "setxattr"):
            wire("setxattr", guard(
                lambda p, name, val, size, flags: o.setxattr(
                    p.decode(), name.decode(),
                    ctypes.string_at(val, size), flags)))
        if hasattr(o, "removexattr"):
            wire("removexattr", guard(
                lambda p, name: o.removexattr(p.decode(), name.decode())))

        if hasattr(o, "utimens"):
            def _utimens(p, ts):
                times = None
                if ts:
                    a, m = ts.contents[0], ts.contents[1]
                    times = (a.tv_sec + a.tv_nsec / 1e9,
                             m.tv_sec + m.tv_nsec / 1e9)
                o.utimens(p.decode(), times)
            wire("utimens", guard(_utimens))

        argv = [b"weedtpu-mount", mountpoint.encode()]
        if foreground:
            argv.append(b"-f")
        argv.append(b"-s")  # single-threaded (see module docstring)
        opt = ",".join(f"{k}" if v is True else f"{k}={v}"
                       for k, v in options.items())
        if opt:
            argv += [b"-o", opt.encode()]
        arr = (c_char_p * len(argv))(*argv)
        rc = lib.fuse_main_real(len(argv), arr, ctypes.byref(ops),
                                ctypes.sizeof(ops), None)
        if rc != 0:
            raise RuntimeError(f"fuse_main_real exited with {rc}")

    @staticmethod
    def _fill_stat(st: Stat, d: dict) -> None:
        ctypes.memset(ctypes.byref(st), 0, ctypes.sizeof(st))
        st.st_mode = d.get("st_mode", 0)
        st.st_nlink = d.get("st_nlink", 1)
        st.st_size = d.get("st_size", 0)
        st.st_uid = d.get("st_uid", os.getuid())
        st.st_gid = d.get("st_gid", os.getgid())
        st.st_blksize = 4096
        st.st_blocks = (st.st_size + 511) // 512
        for src, dst in (("st_atime", "st_atim"), ("st_mtime", "st_mtim"),
                         ("st_ctime", "st_ctim")):
            t = float(d.get(src, 0.0))
            spec = getattr(st, dst)
            spec.tv_sec = int(t)
            spec.tv_nsec = int((t - int(t)) * 1e9)


def unmount(mountpoint: str) -> None:
    import subprocess
    subprocess.run(["fusermount", "-u", mountpoint], check=False)
