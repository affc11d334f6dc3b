"""The port's mount (`mount/weedfs.py`, `make_fuse_ops`, `fuse_ll.py`)
held to the reference's:

- the five `tests/test_gateways.py::TestMountVFS` and four
  `TestMountAttrSurface` twins over a port stack (the port's master,
  one port volume server with `device="cpu"`, the port's `FilerServer`),
  each keeping its twin's name and body;
- the twin of `tests/test_mount_fuse.py::test_full_surface`, every
  fusepy-facing adapter method of `make_fuse_ops` driven by its raw fuse
  name and signature, and of `test_kernel_mount_e2e`, which skips where
  the reference's does, with the same reason;
- **mounts cross**: one script of VFS operations through a port `WFS`
  over the reference's filer, a reference `WFS` over the port's filer,
  and each package's `WFS` over its own, gives the same bytes, attrs
  and xattrs;
- pins of the two repairs local to one node, beside the reference's
  behaviour: `WFS.close` ends the subscribe thread at once, and
  `start_admin_socket` returns a handle whose `close` (and `WFS.close`)
  stops the accept thread and removes the socket file.
"""

from __future__ import annotations

import ctypes.util
import errno
import os
import shutil
import socket
import stat as stat_mod
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

from tests.test_torch_webdav import DavStack, stack  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestMountVFS:
    def test_wfs_roundtrip(self, stack):  # noqa: F811
        from seaweedfs_tpu_torch.mount.weedfs import WFS, FsError
        c, filer, _ = stack
        wfs = WFS(filer.url, subscribe=False)
        try:
            wfs.mkdir("/mnt-test")
            assert "mnt-test" in wfs.readdir("/")
            fh = wfs.create("/mnt-test/f.txt")
            assert wfs.write(fh, b"hello ", 0) == 6
            assert wfs.write(fh, b"world", 6) == 5
            wfs.flush(fh)
            wfs.release(fh)
            attr = wfs.getattr("/mnt-test/f.txt")
            assert attr["st_size"] == 11
            fh2 = wfs.open("/mnt-test/f.txt")
            assert wfs.read(fh2, 11, 0) == b"hello world"
            assert wfs.read(fh2, 5, 6) == b"world"
            wfs.release(fh2)
            # rename + inode stability
            ino = wfs.inodes.lookup("/mnt-test/f.txt")
            wfs.rename("/mnt-test/f.txt", "/mnt-test/g.txt")
            assert wfs.inodes.lookup("/mnt-test/g.txt") == ino
            assert wfs.read(wfs.open("/mnt-test/g.txt"), 11, 0) == b"hello world"
            # truncate
            wfs.truncate("/mnt-test/g.txt", 5)
            assert wfs.getattr("/mnt-test/g.txt")["st_size"] == 5
            wfs.unlink("/mnt-test/g.txt")
            with pytest.raises(FsError):
                wfs.getattr("/mnt-test/g.txt")
            wfs.rmdir("/mnt-test")
        finally:
            wfs.close()

    def test_wfs_overwrite_in_place(self, stack):  # noqa: F811
        from seaweedfs_tpu_torch.mount.weedfs import WFS
        c, filer, _ = stack
        wfs = WFS(filer.url, subscribe=False)
        try:
            fh = wfs.create("/ow.bin")
            wfs.write(fh, b"AAAAAAAAAA", 0)
            wfs.release(fh)
            fh = wfs.open("/ow.bin")
            wfs.write(fh, b"BB", 4)  # partial overwrite pulls base content
            wfs.release(fh)
            assert wfs.read(wfs.open("/ow.bin"), 10, 0) == b"AAAABBAAAA"
        finally:
            wfs.close()

    def test_meta_cache_subscribe_invalidation(self, stack):  # noqa: F811
        from seaweedfs_tpu_torch.mount.weedfs import WFS
        c, filer, _ = stack
        wfs = WFS(filer.url, subscribe=True)
        try:
            fh = wfs.create("/mc.txt")
            wfs.write(fh, b"v1", 0)
            wfs.release(fh)
            assert wfs.getattr("/mc.txt")["st_size"] == 2
            # external writer updates the file behind the mount's back
            urllib.request.urlopen(urllib.request.Request(
                f"http://{filer.url}/mc.txt", data=b"longer-v2",
                method="PUT"), timeout=15)
            deadline = time.time() + 10
            while time.time() < deadline:
                if wfs.getattr("/mc.txt")["st_size"] == 9:
                    break
                time.sleep(0.2)
            assert wfs.getattr("/mc.txt")["st_size"] == 9
        finally:
            wfs.close()

    def test_wfs_sparse_and_append_patterns(self, stack):  # noqa: F811
        """Chunked dirty pages: sparse writes leave zero-filled gaps,
        appends extend, page-budget writeback keeps RAM bounded
        (reference: dirty_pages_chunked.go / page_writer)."""
        from seaweedfs_tpu_torch.mount import weedfs as wmod
        from seaweedfs_tpu_torch.mount.weedfs import WFS
        c, filer, _ = stack
        wfs = WFS(filer.url, subscribe=False)
        old_page, old_max = wmod.PAGE_SIZE, wmod.MAX_DIRTY_PAGES
        wmod.PAGE_SIZE, wmod.MAX_DIRTY_PAGES = 1024, 4  # tiny for the test
        try:
            # sparse: write at 0 and far beyond, gap must read as zeros
            fh = wfs.create("/sparse.bin")
            wfs.write(fh, b"head", 0)
            wfs.write(fh, b"tail", 5000)
            wfs.flush(fh)
            wfs.release(fh)
            assert wfs.getattr("/sparse.bin")["st_size"] == 5004
            fh = wfs.open("/sparse.bin")
            got = wfs.read(fh, 5004, 0)
            assert got[:4] == b"head"
            assert got[5000:] == b"tail"
            assert got[4:5000] == b"\0" * 4996
            wfs.release(fh)

            # streaming append far beyond the page budget: dirty pages are
            # written back mid-stream, never more than MAX_DIRTY_PAGES held
            fh = wfs.create("/big.bin")
            blob = bytes(range(256)) * 4  # 1KB
            n_pages = 40  # 40KB through a 4-page budget
            for i in range(n_pages):
                wfs.write(fh, blob, i * len(blob))
                h = wfs.handle(fh)
                assert len(h._pages) <= wmod.MAX_DIRTY_PAGES + 1
            wfs.flush(fh)
            wfs.release(fh)
            fh = wfs.open("/big.bin")
            back = wfs.read(fh, n_pages * len(blob), 0)
            assert back == blob * n_pages
            wfs.release(fh)

            # read-your-writes before flush + handle truncate
            fh = wfs.open("/big.bin")
            wfs.write(fh, b"XYZ", 10)
            assert wfs.read(fh, 3, 10) == b"XYZ"  # dirty overlay
            wfs.truncate("/big.bin", 100, fh)
            wfs.flush(fh)
            wfs.release(fh)
            assert wfs.getattr("/big.bin")["st_size"] == 100
            assert wfs.read(wfs.open("/big.bin"), 3, 10) == b"XYZ"
        finally:
            wmod.PAGE_SIZE, wmod.MAX_DIRTY_PAGES = old_page, old_max
            wfs.close()

    def test_filer_ranged_patch_and_truncate_http(self, stack):  # noqa: F811
        """The filer-side primitives directly: PUT ?offset= patches a span
        as chunks; POST ?truncate= is a metadata-only resize."""
        c, filer, _ = stack
        base = f"http://{filer.url}/patch.bin"
        urllib.request.urlopen(urllib.request.Request(
            base, data=b"0123456789", method="PUT"), timeout=15)
        urllib.request.urlopen(urllib.request.Request(
            base + "?offset=3", data=b"ABC", method="PUT"), timeout=15)
        with urllib.request.urlopen(base, timeout=15) as r:
            assert r.read() == b"012ABC6789"
        # extend past the end through a hole
        urllib.request.urlopen(urllib.request.Request(
            base + "?offset=12", data=b"ZZ", method="PUT"), timeout=15)
        with urllib.request.urlopen(base, timeout=15) as r:
            assert r.read() == b"012ABC6789\0\0ZZ"
        # shrink
        urllib.request.urlopen(urllib.request.Request(
            base + "?truncate=4", data=b"", method="POST"), timeout=15)
        with urllib.request.urlopen(base, timeout=15) as r:
            assert r.read() == b"012A"
        # grow (zero-filled tail)
        urllib.request.urlopen(urllib.request.Request(
            base + "?truncate=8", data=b"", method="POST"), timeout=15)
        with urllib.request.urlopen(base, timeout=15) as r:
            assert r.read() == b"012A\0\0\0\0"


class TestMountAttrSurface:
    """Symlink / xattr / chmod-chown-utimens / hardlink through the mount
    (reference: weedfs_symlink.go, weedfs_xattr.go, weedfs_attr.go,
    weedfs_link.go)."""

    def test_symlink_roundtrip(self, stack):  # noqa: F811
        from seaweedfs_tpu_torch.mount.weedfs import WFS, FsError
        c, filer, _ = stack
        wfs = WFS(filer.url, subscribe=False)
        try:
            fh = wfs.create("/sl-target.txt")
            wfs.write(fh, b"payload", 0)
            wfs.release(fh)
            wfs.symlink("/sl-target.txt", "/sl-link")
            assert wfs.readlink("/sl-link") == "/sl-target.txt"
            attr = wfs.getattr("/sl-link")
            assert stat_mod.S_ISLNK(attr["st_mode"])
            assert attr["st_size"] == len("/sl-target.txt")
            # not a symlink -> EINVAL
            with pytest.raises(FsError):
                wfs.readlink("/sl-target.txt")
            wfs.unlink("/sl-link")
            assert wfs.getattr("/sl-target.txt")["st_size"] == 7
        finally:
            wfs.close()

    def test_xattr_roundtrip(self, stack):  # noqa: F811
        from seaweedfs_tpu_torch.mount.weedfs import WFS, FsError
        c, filer, _ = stack
        wfs = WFS(filer.url, subscribe=False)
        try:
            fh = wfs.create("/xa.txt")
            wfs.write(fh, b"x", 0)
            wfs.release(fh)
            wfs.setxattr("/xa.txt", "user.color", b"blue")
            wfs.setxattr("/xa.txt", "user.blob", bytes(range(256)))
            assert wfs.getxattr("/xa.txt", "user.color") == b"blue"
            assert wfs.getxattr("/xa.txt", "user.blob") == bytes(range(256))
            assert wfs.listxattr("/xa.txt") == ["user.blob", "user.color"]
            wfs.removexattr("/xa.txt", "user.color")
            assert wfs.listxattr("/xa.txt") == ["user.blob"]
            with pytest.raises(FsError):
                wfs.getxattr("/xa.txt", "user.color")
            with pytest.raises(FsError):
                wfs.removexattr("/xa.txt", "user.color")
            # content untouched by xattr churn
            assert wfs.read(wfs.open("/xa.txt"), 1, 0) == b"x"
        finally:
            wfs.close()

    def test_chmod_chown_utimens_persist(self, stack):  # noqa: F811
        from seaweedfs_tpu_torch.mount.weedfs import WFS
        c, filer, _ = stack
        wfs = WFS(filer.url, subscribe=False)
        try:
            fh = wfs.create("/perm.txt")
            wfs.write(fh, b"z", 0)
            wfs.release(fh)
            wfs.utimens("/perm.txt", (1700000000.0, 1700000001.5))
            wfs.chmod("/perm.txt", 0o640)
            wfs.chown("/perm.txt", 1234, 5678)
            attr = wfs.getattr("/perm.txt")
            assert attr["st_mode"] & 0o7777 == 0o640
            assert attr["st_uid"] == 1234 and attr["st_gid"] == 5678
            # POSIX: chmod/chown must not disturb an explicit mtime
            assert abs(attr["st_mtime"] - 1700000001.5) < 1e-6
            # a fresh WFS (no warm cache) sees the same persisted attrs
            wfs2 = WFS(filer.url, subscribe=False)
            try:
                attr2 = wfs2.getattr("/perm.txt")
                assert attr2["st_mode"] & 0o7777 == 0o640
                assert attr2["st_uid"] == 1234
            finally:
                wfs2.close()
        finally:
            wfs.close()

    def test_hardlink_through_mount(self, stack):  # noqa: F811
        from seaweedfs_tpu_torch.mount.weedfs import WFS, FsError
        c, filer, _ = stack
        wfs = WFS(filer.url, subscribe=False)
        try:
            fh = wfs.create("/hlm-a.txt")
            wfs.write(fh, b"shared-bytes", 0)
            wfs.release(fh)
            wfs.link("/hlm-a.txt", "/hlm-b.txt")
            assert wfs.getattr("/hlm-a.txt")["st_nlink"] == 2
            assert wfs.getattr("/hlm-b.txt")["st_nlink"] == 2
            assert wfs.read(wfs.open("/hlm-b.txt"), 12, 0) == b"shared-bytes"
            with pytest.raises(FsError):
                wfs.link("/hlm-a.txt", "/hlm-b.txt")  # EEXIST
            wfs.unlink("/hlm-a.txt")
            assert wfs.read(wfs.open("/hlm-b.txt"), 12, 0) == b"shared-bytes"
            assert wfs.getattr("/hlm-b.txt")["st_nlink"] == 1
            wfs.unlink("/hlm-b.txt")
        finally:
            wfs.close()


# ---- the fusepy-facing binding layer (tests/test_mount_fuse.py) --------------

class _StubOps:
    """Stand-in for fusepy's Operations base."""


class _StubFuseOSError(OSError):
    def __init__(self, errno_):
        super().__init__(errno_, os.strerror(errno_))


@pytest.fixture()
def fuse_ops(stack):  # noqa: F811
    from seaweedfs_tpu_torch.mount.weedfs import WFS, make_fuse_ops
    _, filer, _ = stack
    wfs = WFS(filer.url, subscribe=False)
    ops = make_fuse_ops(wfs, _StubOps, _StubFuseOSError)
    yield ops
    wfs.close()


class TestFuseOpsRaw:
    """Every fusepy-facing adapter method executed with its raw fuse
    signature at least once."""

    def test_full_surface(self, fuse_ops):
        o = fuse_ops
        # directory + attr surface
        o.mkdir("/fuseraw", 0o755)
        st = o.getattr("/fuseraw")
        assert st["st_mode"] & 0o40000, "directory mode bit"
        with pytest.raises(OSError) as ei:
            o.getattr("/fuseraw/missing")
        assert ei.value.errno == errno.ENOENT
        # create/write/flush/release with fh plumbing and byte offsets
        fh = o.create("/fuseraw/f.txt", 0o644)
        assert o.write("/fuseraw/f.txt", b"hello ", 0, fh) == 6
        assert o.write("/fuseraw/f.txt", b"world", 6, fh) == 5
        o.flush("/fuseraw/f.txt", fh)
        o.release("/fuseraw/f.txt", fh)
        # open/read at offsets
        fh2 = o.open("/fuseraw/f.txt", os.O_RDONLY)
        assert o.read("/fuseraw/f.txt", 5, 6, fh2) == b"world"
        assert o.read("/fuseraw/f.txt", 100, 0, fh2) == b"hello world"
        o.release("/fuseraw/f.txt", fh2)
        assert o.getattr("/fuseraw/f.txt")["st_size"] == 11
        # readdir includes . and .. exactly once
        names = o.readdir("/fuseraw", 0)
        assert {".", "..", "f.txt"} <= set(names)
        assert names.count(".") == 1 and names.count("..") == 1
        # truncate (path and fh variants)
        o.truncate("/fuseraw/f.txt", 5)
        assert o.getattr("/fuseraw/f.txt")["st_size"] == 5
        # rename
        o.rename("/fuseraw/f.txt", "/fuseraw/g.txt")
        assert "g.txt" in o.readdir("/fuseraw", 0)
        # hard link (fusepy arg order: link(new, existing))
        o.link("/fuseraw/h.txt", "/fuseraw/g.txt")
        assert o.getattr("/fuseraw/h.txt")["st_size"] == 5
        assert o.getattr("/fuseraw/g.txt")["st_nlink"] == 2
        # symlink + readlink (fusepy arg order: symlink(new, target))
        o.symlink("/fuseraw/sl.txt", "g.txt")
        assert o.readlink("/fuseraw/sl.txt") == "g.txt"
        # chmod / chown / utimens
        o.chmod("/fuseraw/g.txt", 0o600)
        assert o.getattr("/fuseraw/g.txt")["st_mode"] & 0o777 == 0o600
        o.chown("/fuseraw/g.txt", os.getuid(), os.getgid())
        o.utimens("/fuseraw/g.txt", (1000000000.5, 1000000001.5))
        assert int(o.getattr("/fuseraw/g.txt")["st_mtime"]) == 1000000001
        # xattrs
        o.setxattr("/fuseraw/g.txt", "user.tag", b"v1", 0)
        assert o.getxattr("/fuseraw/g.txt", "user.tag") == b"v1"
        assert "user.tag" in o.listxattr("/fuseraw/g.txt")
        o.removexattr("/fuseraw/g.txt", "user.tag")
        with pytest.raises(OSError) as ei:
            o.getxattr("/fuseraw/g.txt", "user.tag")
        assert ei.value.errno in (errno.ENODATA, errno.ENOENT)
        # unlink / rmdir errno contracts
        with pytest.raises(OSError) as ei:
            o.rmdir("/fuseraw")  # not empty
        assert ei.value.errno == errno.ENOTEMPTY
        for name in ("g.txt", "h.txt", "sl.txt"):
            o.unlink(f"/fuseraw/{name}")
        o.rmdir("/fuseraw")
        with pytest.raises(OSError) as ei:
            o.getattr("/fuseraw")
        assert ei.value.errno == errno.ENOENT


def _fuse_available() -> bool:
    if not os.path.exists("/dev/fuse"):
        return False
    if not os.access("/dev/fuse", os.R_OK | os.W_OK):
        return False
    if shutil.which("fusermount") is None:
        return False
    return bool(ctypes.util.find_library("fuse"))


@pytest.mark.skipif(not _fuse_available(),
                    reason="kernel FUSE not available "
                           "(/dev/fuse, fusermount, libfuse.so.2)")
def test_kernel_mount_e2e(stack, tmp_path):  # noqa: F811
    """Real kernel mount through mount/fuse_ll.py in a subprocess, driven
    with plain os/file syscalls (the reference's e2e-mount.yml role)."""
    _, filer, _ = stack
    mnt = tmp_path / "mnt"
    mnt.mkdir()
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "mount",
         "-filer", filer.url, "-dir", str(mnt)],
        cwd=REPO, stderr=subprocess.PIPE)
    try:
        deadline = time.time() + 30
        while time.time() < deadline and not os.path.ismount(mnt):
            if proc.poll() is not None:
                pytest.fail("mount process died: "
                            f"{proc.stderr.read().decode()[-2000:]}")
            time.sleep(0.2)
        assert os.path.ismount(mnt), "mount never appeared"

        d = mnt / "kern"
        try:
            d.mkdir()
        except OSError as e:
            if e.errno == errno.ENOSYS:
                # the mount registered but this kernel's FUSE layer can't
                # service operations (containerised hosts)
                pytest.skip("kernel FUSE ops not implemented on this host")
            raise
        (d / "a.txt").write_bytes(b"kernel-sees-this")
        assert (d / "a.txt").read_bytes() == b"kernel-sees-this"
        assert (d / "a.txt").stat().st_size == 16
        # partial read through the page cache path
        with open(d / "a.txt", "rb") as f:
            f.seek(7)
            assert f.read(4) == b"sees"
        os.rename(d / "a.txt", d / "b.txt")
        assert sorted(os.listdir(d)) == ["b.txt"]
        with open(d / "b.txt", "ab") as f:
            f.write(b"!")
        assert (d / "b.txt").read_bytes() == b"kernel-sees-this!"
        os.unlink(d / "b.txt")
        os.rmdir(d)
        assert os.listdir(mnt) is not None
        # the write really landed in the filer, not a local cache
        with urllib.request.urlopen(
                f"http://{filer.url}/?limit=100", timeout=10) as r:
            r.read()
    finally:
        subprocess.run(["fusermount", "-u", str(mnt)], check=False)
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()


# ---- mounts cross ------------------------------------------------------------

@pytest.fixture(scope="module")
def filers(tmp_path_factory):
    """A reference stack and a port stack, each with its own filer."""
    out = {p: DavStack(tmp_path_factory.mktemp(f"mnt-{p}"), p,
                       chunk_size=4096)
           for p in ("reference", "port")}
    yield {p: s.filer.url for p, s in out.items()}
    for s in out.values():
        s.stop()


def _wfs_module(package):
    if package == "port":
        from seaweedfs_tpu_torch.mount import weedfs
    else:
        from seaweedfs_tpu.mount import weedfs
    return weedfs


def _drive(mod, filer_url: str, top: str) -> dict:
    """One script of VFS operations under `top` (offset writes across
    4 KiB chunks, a sparse file, appends through a tiny dirty-page
    budget, an overwrite in place, a truncate, a rename, a symlink, a
    hard link, xattrs and attrs), then what the mount sees of it, paths
    relative to `top`: bytes, attrs (times but an explicit utimens
    masked, as the filer stamps them) and xattrs."""
    wfs = mod.WFS(filer_url, subscribe=False)
    old = mod.PAGE_SIZE, mod.MAX_DIRTY_PAGES
    mod.PAGE_SIZE, mod.MAX_DIRTY_PAGES = 1024, 4
    try:
        wfs.mkdir(top)
        wfs.mkdir(f"{top}/d")
        fh = wfs.create(f"{top}/f.bin")
        wfs.write(fh, b"hello ", 0)
        wfs.write(fh, bytes(range(256)) * 40, 6)
        wfs.release(fh)
        fh = wfs.create(f"{top}/sparse.bin")
        wfs.write(fh, b"head", 0)
        wfs.write(fh, b"tail", 9000)
        wfs.release(fh)
        fh = wfs.create(f"{top}/d/app.bin")
        for i in range(12):
            wfs.write(fh, bytes([i]) * 1000, i * 1000)
        wfs.release(fh)
        fh = wfs.open(f"{top}/f.bin")
        wfs.write(fh, b"OVER", 5000)
        wfs.release(fh)
        wfs.truncate(f"{top}/f.bin", 7000)
        wfs.rename(f"{top}/sparse.bin", f"{top}/d/sparse2.bin")
        wfs.symlink("f.bin", f"{top}/sl")
        wfs.link(f"{top}/f.bin", f"{top}/hl")
        wfs.setxattr(f"{top}/f.bin", "user.color", b"blue")
        wfs.setxattr(f"{top}/f.bin", "user.blob", bytes(range(256)))
        wfs.chmod(f"{top}/d/app.bin", 0o640)
        wfs.chown(f"{top}/d/app.bin", 1234, 5678)
        wfs.utimens(f"{top}/d/app.bin", (1700000000.0, 1700000001.5))
        view = {}
        stack_ = [top]
        while stack_:
            d = stack_.pop()
            for name in wfs.readdir(d):
                if name in (".", ".."):
                    continue
                p = f"{d}/{name}"
                a = wfs.getattr(p)
                a.pop("st_ctime")
                if p != f"{top}/d/app.bin":
                    a.pop("st_mtime")
                rel = p[len(top):]
                view[rel] = {"attr": a}
                if stat_mod.S_ISDIR(a["st_mode"]):
                    stack_.append(p)
                elif stat_mod.S_ISLNK(a["st_mode"]):
                    view[rel]["target"] = wfs.readlink(p)
                else:
                    fh = wfs.open(p)
                    view[rel]["data"] = wfs.read(fh, a["st_size"] + 10, 0)
                    wfs.release(fh)
                    view[rel]["xattrs"] = {n: wfs.getxattr(p, n)
                                           for n in wfs.listxattr(p)}
        return view
    finally:
        mod.PAGE_SIZE, mod.MAX_DIRTY_PAGES = old
        wfs.close()


def test_mounts_cross_between_packages(filers):
    views = {(w, f): _drive(_wfs_module(w), filers[f], f"/x-{w}")
             for w in ("reference", "port")
             for f in ("reference", "port")}
    want = views[("reference", "reference")]
    assert sorted(want) == ["/d", "/d/app.bin", "/d/sparse2.bin", "/f.bin",
                            "/hl", "/sl"]
    assert want["/f.bin"]["data"][:6] == b"hello "
    assert want["/f.bin"]["data"][5000:5004] == b"OVER"
    assert len(want["/f.bin"]["data"]) == 7000
    assert want["/hl"]["attr"]["st_nlink"] == 2
    assert want["/f.bin"]["xattrs"] == {"user.blob": bytes(range(256)),
                                        "user.color": b"blue"}
    assert want["/d/app.bin"]["attr"]["st_uid"] == 1234
    for key, view in views.items():
        assert view == want, key


# ---- repairs local to one node ------------------------------------------------

def _subscribed(filer, n: int) -> None:
    deadline = time.time() + 10
    while len(filer._subscribers) < n:
        assert time.time() < deadline, "the mount never subscribed"
        time.sleep(0.02)


def test_close_ends_the_subscribe_thread_at_once(stack):  # noqa: F811
    """The port's `WFS.close` cuts the live feed and joins its thread;
    the reference's only sets a flag, and its thread reads on until the
    next event under its prefix (or the feed's keepalive)."""
    from seaweedfs_tpu.mount import weedfs as ref_weedfs
    from seaweedfs_tpu_torch.mount.weedfs import WFS
    c, filer, _ = stack
    n0 = len(filer._subscribers)
    wfs = WFS(filer.url, root="/close-pin", subscribe=True)
    _subscribed(filer, n0 + 1)
    t0 = time.perf_counter()
    wfs.close()
    assert time.perf_counter() - t0 < 2.0
    assert not wfs._sub_thread.is_alive()

    ref = ref_weedfs.WFS(filer.url, root="/close-pin", subscribe=True)
    _subscribed(filer, n0 + 1)
    ref.close()
    assert ref._sub_thread.is_alive()
    # an event under its prefix lets the reference's thread see the flag
    urllib.request.urlopen(urllib.request.Request(
        f"http://{filer.url}/close-pin/wake.txt", data=b"w",
        method="PUT"), timeout=15)
    ref._sub_thread.join(10)
    assert not ref._sub_thread.is_alive()


def _admin_threads() -> int:
    return sum(1 for th in threading.enumerate()
               if th.name == "mount-admin" and th.is_alive())


def test_admin_socket_stops_with_its_mount(tmp_path):
    """The port's `start_admin_socket` returns a handle; `WFS.close`
    closes it: the accept thread ends and the socket file goes.  The
    reference's returns nothing and keeps both for the process's life
    (its file is removed here by hand)."""
    from seaweedfs_tpu.mount import weedfs as ref_weedfs
    from seaweedfs_tpu_torch.mount import weedfs

    mnt = str(tmp_path / "port-mnt")
    wfs = weedfs.WFS("127.0.0.1:1", subscribe=False)
    before = _admin_threads()
    admin = weedfs.start_admin_socket(wfs, mnt)
    assert admin.path == weedfs.admin_socket_path(mnt) == \
        ref_weedfs.admin_socket_path(mnt)
    assert os.path.exists(admin.path) and _admin_threads() == before + 1
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.connect(admin.path)
        s.sendall(b'{"quota": 4096}')
        s.shutdown(socket.SHUT_WR)
        assert s.recv(65536) == b'{"ok": true, "root": "", "quota": 4096}'
    wfs.close()
    assert not admin.thread.is_alive()
    assert not os.path.exists(admin.path)
    assert _admin_threads() == before
    admin.close()  # a second close is a no-op

    ref_mnt = str(tmp_path / "ref-mnt")
    ref = ref_weedfs.WFS("127.0.0.1:1", subscribe=False)
    assert ref_weedfs.start_admin_socket(ref, ref_mnt) is None
    ref.close()
    path = ref_weedfs.admin_socket_path(ref_mnt)
    assert os.path.exists(path) and _admin_threads() == before + 1
    os.unlink(path)
