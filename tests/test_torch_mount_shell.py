"""The port shell's `mount.configure` held to the reference's:

- the twin of `tests/test_shell_commands.py::test_mount_configure` over a
  port stack (the port's master, one port volume server with
  `device="cpu"`, the port's `FilerServer`, the port shell's
  `CommandEnv`), keeping its name and body;
- both packages' shells against either package's admin socket: the same
  exchanges print the same lines and set the same quota.
"""

from __future__ import annotations

import io
import os
from unittest import mock

import pytest

from seaweedfs_tpu_torch.shell.commands import CommandEnv, run_command
from tests.test_torch_master_cluster import Cluster, free_port

QUIET_ENV = {"WEEDTPU_SCRUB_MBPS": "0", "WEEDTPU_REPAIR_INTERVAL": "0"}


def shell(env, script: str) -> str:
    out = io.StringIO()
    for line in script.split(";"):
        line = line.strip()
        if line:
            run_command(env, line, out)
    return out.getvalue()


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    from seaweedfs_tpu_torch.server.filer_server import FilerServer

    tmp = tmp_path_factory.mktemp("mshell")
    with mock.patch.dict(os.environ, QUIET_ENV):
        c = Cluster(tmp, n_volume_servers=1).start()
        c.wait_heartbeats()
        filer = FilerServer(c.master.url, port=free_port(),
                            data_dir=str(tmp / "f"))
        c.submit(filer.start())
    yield c, filer, CommandEnv(c.master.url)
    c.submit(filer.stop())
    c.stop()


class TestFilerShellCommands:
    def test_mount_configure(self, stack, tmp_path):
        """mount.configure drives a live WFS through its admin socket;
        the quota rejects writes with EDQUOT
        (reference: command_mount_configure.go)."""
        from seaweedfs_tpu_torch.mount.weedfs import (WFS, FsError,
                                                      start_admin_socket)
        c, filer, env = stack
        mnt = str(tmp_path / "fakemount")
        wfs = WFS(filer.url, subscribe=False)
        start_admin_socket(wfs, mnt)
        out = shell(env, f"mount.configure -dir {mnt}")
        assert "quota=unlimited" in out
        out = shell(env, f"mount.configure -dir {mnt} -quotaMB 0.001")
        assert "quota=0MB" in out or "quota" in out
        assert wfs.quota_bytes == 1048  # 0.001 MB
        fh = wfs.create("/q.bin")
        with pytest.raises(FsError) as ei:
            wfs.write(fh, b"z" * 4096, 0)
        assert ei.value.errno == 122  # EDQUOT
        # clearing the quota unblocks writes
        shell(env, f"mount.configure -dir {mnt} -quotaMB 0")
        assert wfs.write(fh, b"z" * 4096, 0) == 4096
        wfs.release(fh)
        wfs.close()
        # errno contract for a dead socket
        with pytest.raises(RuntimeError):
            shell(env, f"mount.configure -dir {tmp_path}/nonexistent")


def _package(name):
    if name == "port":
        from seaweedfs_tpu_torch.mount import weedfs
        from seaweedfs_tpu_torch.shell import commands
    else:
        from seaweedfs_tpu.mount import weedfs
        from seaweedfs_tpu.shell import commands
    return weedfs, commands


@pytest.mark.parametrize("shell_pkg", ["reference", "port"])
@pytest.mark.parametrize("mount_pkg", ["reference", "port"])
def test_shells_configure_either_mount_alike(tmp_path, shell_pkg,
                                             mount_pkg):
    """Each package's shell drives each package's admin socket: the
    lines printed, with the mountpoint masked, are the reference shell's
    over the reference mount, and the quota lands on the mount."""
    weedfs, _ = _package(mount_pkg)
    mnt = str(tmp_path / f"{shell_pkg}-{mount_pkg}")
    wfs = weedfs.WFS("127.0.0.1:1", root="/mounted", subscribe=False)
    weedfs.start_admin_socket(wfs, mnt)
    try:
        lines = []
        quotas = []
        for args in ("", " -quotaMB 2", " -quotaMB 1.5", "",
                     " -quotaMB 0"):
            _, commands = _package(shell_pkg)
            out = io.StringIO()
            commands.run_command(commands.CommandEnv("127.0.0.1:1"),
                                 f"mount.configure -dir {mnt}{args}", out)
            lines.append(out.getvalue().replace(mnt, "<mnt>"))
            quotas.append(wfs.quota_bytes)
        assert lines == [
            "mount at <mnt>: root=/mounted quota=unlimited\n",
            "mount at <mnt>: root=/mounted quota=2MB\n",
            "mount at <mnt>: root=/mounted quota=2MB\n",
            "mount at <mnt>: root=/mounted quota=2MB\n",
            "mount at <mnt>: root=/mounted quota=unlimited\n"]
        assert quotas == [0, 2 << 20, 3 << 19, 3 << 19, 0]
        _, commands = _package(shell_pkg)
        with pytest.raises(RuntimeError, match="no responding mount"):
            commands.run_command(commands.CommandEnv("127.0.0.1:1"),
                                 f"mount.configure -dir {mnt}-gone",
                                 io.StringIO())
        with pytest.raises(RuntimeError, match="-dir"):
            commands.run_command(commands.CommandEnv("127.0.0.1:1"),
                                 "mount.configure", io.StringIO())
    finally:
        wfs.close()
        if mount_pkg == "reference":  # its socket outlives its mount
            os.unlink(weedfs.admin_socket_path(mnt))
