"""The port CLI's offline and bootstrap subcommands held to the
reference's:

- twins of `tests/test_shell_commands.py::test_cli_compact` and of
  `tests/test_replication.py::test_cli_fix_and_export`, `::test_cli_backup`
  (over a port cluster) and `::test_cli_scaffold`, each keeping its
  twin's name and body;
- `certs`, `version` and `autocomplete` print what the reference's print
  (the certificate directory masked; `autocomplete` lists the port's own
  subcommands, each one the reference has);
- **volumes cross**: on a volume written by either package, `fix` by
  each package rebuilds the same `.idx` bytes, `export` writes the same
  tar members and data, and `compact` leaves byte-equal `.dat` and
  `.idx` files.
"""

from __future__ import annotations

import os
import re
import shutil
import tarfile
import time

import pytest

from seaweedfs_tpu.__main__ import main as ref_cli
from seaweedfs_tpu_torch.__main__ import main as cli
from tests.test_torch_master_cluster import Cluster

T0 = 1_700_000_000_000_000_000


@pytest.fixture(scope="module", autouse=True)
def _log_handlers_outside_capsys():
    """Each package's CLI installs its root log handler once, on the
    stream `sys.stderr` is at the time: here, before any test's capsys
    swaps in a capture that closes when the test ends (later log records
    would then fail on the closed stream)."""
    from seaweedfs_tpu.utils import weedlog as ref_weedlog
    from seaweedfs_tpu_torch.utils import weedlog
    ref_weedlog.setup()
    weedlog.setup()


def test_cli_compact(tmp_path):
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.volume import Volume
    v = Volume(str(tmp_path), "", 9)
    for i in range(1, 6):
        v.append_needle(Needle(id=i, cookie=i, data=b"z" * 2000))
    for i in range(1, 5):
        v.delete_needle(i, i)
    v.close()
    before = os.path.getsize(tmp_path / "9.dat")
    assert cli(["compact", "-dir", str(tmp_path), "-volumeId", "9"]) == 0
    after = os.path.getsize(tmp_path / "9.dat")
    assert after < before
    v2 = Volume(str(tmp_path), "", 9)
    assert v2.read_needle(5).data == b"z" * 2000
    v2.close()


def test_cli_fix_and_export(tmp_path):
    """weed fix rebuilds .idx from .dat; weed export produces a tar
    (reference: command/fix.go, command/export.go)."""
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.volume import Volume

    d = str(tmp_path)
    v = Volume(d, "", 7)
    v.append_needle(Needle(id=1, cookie=11, data=b"aaa", name=b"a.txt"))
    v.append_needle(Needle(id=2, cookie=22, data=b"bbb", name=b"b.txt"))
    v.delete_needle(1, 11)
    v.close()

    idx = os.path.join(d, "7.idx")
    os.remove(idx)
    assert cli(["fix", "-dir", d, "-volumeId", "7"]) == 0
    assert os.path.exists(idx)
    v2 = Volume(d, "", 7)
    assert not v2.has_needle(1)
    assert v2.read_needle(2).data == b"bbb"
    v2.close()

    out = str(tmp_path / "vol7.tar")
    assert cli(["export", "-dir", d, "-volumeId", "7", "-o", out]) == 0
    with tarfile.open(out) as tar:
        names = tar.getnames()
        assert any("b.txt" in n for n in names)
        assert not any("a.txt" in n for n in names)


def test_cli_backup(tmp_path):
    from seaweedfs_tpu_torch.client import WeedClient

    c = Cluster(tmp_path, n_volume_servers=1).start()
    c.wait_heartbeats()
    try:
        client = WeedClient(c.master.url)
        fid = client.upload(b"backup me", name="b.bin")
        vid = int(fid.split(",")[0])
        vs_url = c.volume_servers[0].url
        dest = str(tmp_path / "bk")
        assert cli(["backup", "-server", vs_url, "-volumeId", str(vid),
                    "-dir", dest]) == 0
        assert os.path.getsize(os.path.join(dest, f"{vid}.dat")) > 0
        assert os.path.getsize(os.path.join(dest, f"{vid}.idx")) > 0
        # incremental: a second needle appends only the .dat's new tail
        size0 = os.path.getsize(os.path.join(dest, f"{vid}.dat"))
        client.upload(b"and me", name="c.bin")
        assert cli(["backup", "-server", vs_url, "-volumeId", str(vid),
                    "-dir", dest]) == 0
        assert os.path.getsize(os.path.join(dest, f"{vid}.dat")) > size0
        src = c.volume_servers[0].store.get_volume(vid)
        src.flush()
        with open(os.path.join(src.dir, f"{vid}.dat"), "rb") as f:
            assert open(os.path.join(dest, f"{vid}.dat"), "rb").read() \
                == f.read()
        client.close()
    finally:
        c.stop()


def test_cli_scaffold(capsys):
    assert cli(["scaffold", "-config", "security"]) == 0
    assert "[jwt.signing]" in capsys.readouterr().out


# ---- the bootstrap tools against the reference's -------------------------------

@pytest.mark.parametrize("config", ["filer", "security", "master",
                                    "replication", "notification", "shell"])
def test_scaffold_prints_the_reference_templates(capsys, config):
    assert ref_cli(["scaffold", "-config", config]) == 0
    ref = capsys.readouterr().out
    assert cli(["scaffold", "-config", config]) == 0
    assert capsys.readouterr().out == ref


def test_version_prints_the_reference_fields(capsys):
    assert ref_cli(["version"]) == 0
    ref = capsys.readouterr().out
    assert cli(["version"]) == 0
    out = capsys.readouterr().out
    assert re.fullmatch(r"weedtpu 0\.1\.0 \(python [0-9.]+, native=yes"
                        r"(, gfni)?, pb=(yes|no)\)\n", out), out
    assert out == ref


def test_autocomplete_lists_the_ports_subcommands(capsys):
    from seaweedfs_tpu_torch import __main__ as port_main
    assert ref_cli(["autocomplete"]) == 0
    ref = capsys.readouterr().out
    assert cli(["autocomplete"]) == 0
    out = capsys.readouterr().out
    words = re.compile(r'compgen -W "([^"]*)"')
    ours = words.search(out).group(1).split()
    theirs = words.search(ref).group(1).split()
    assert words.sub('compgen -W "*"', out) == \
        words.sub('compgen -W "*"', ref)
    assert ours == sorted(ours) and set(ours) <= set(theirs)
    assert {"webdav", "ftp", "mount", "fuse", "fix", "compact", "export",
            "backup", "scaffold", "version", "autocomplete", "certs",
            "server", "filer", "s3", "iam"} <= set(ours)
    # the list is the parser's own: every subcommand there parses
    for name in ours:
        with pytest.raises(SystemExit) as ei:
            port_main.main([name, "--help"])
        assert ei.value.code == 0
    capsys.readouterr()


def test_certs_prints_the_reference_table(tmp_path, capsys):
    tables = []
    for name, fn in (("ref", ref_cli), ("port", cli)):
        d = str(tmp_path / name)
        assert fn(["certs", "-dir", d, "-hosts", "localhost,127.0.0.1"]) \
            == 0
        tables.append(capsys.readouterr().out.replace(d, "<dir>"))
        assert sorted(os.listdir(d)) == sorted(
            os.listdir(tmp_path / "ref"))
    assert tables[0] == tables[1]
    assert tables[1].startswith("[tls]\n")


# ---- volumes cross ----------------------------------------------------------------

def _package(name):
    if name == "port":
        from seaweedfs_tpu_torch.storage.needle import Needle
        from seaweedfs_tpu_torch.storage.volume import Volume
        return Volume, Needle, cli
    from seaweedfs_tpu.storage.needle import Needle
    from seaweedfs_tpu.storage.volume import Volume
    return Volume, Needle, ref_cli


def _write_volume(package, d: str, monkeypatch) -> None:
    """Volume 5 of collection "c" with overwrites, deletes and names:
    every needle stamped T0 + id, tombstones at the pinned clock."""
    monkeypatch.setattr(time, "time_ns", lambda: T0 - 1)
    Volume, Needle, _ = _package(package)
    v = Volume(d, "c", 5)
    for i in range(1, 41):
        v.append_needle(Needle(id=i, cookie=1000 + i,
                               data=bytes([i]) * (37 * i),
                               name=f"n{i}.bin".encode() if i % 3 else b"",
                               last_modified=1_700_000_000 + i,
                               append_at_ns=T0 + i))
    for i in range(5, 41, 7):
        v.delete_needle(i, 1000 + i)
    for i in (2, 9):
        v.append_needle(Needle(id=i, cookie=1000 + i, data=b"again" * i,
                               name=b"again.bin", append_at_ns=T0 + 100 + i))
    v.close()


def _tar_members(path: str) -> list:
    with tarfile.open(path) as tar:
        return [(m.name, m.size, m.mtime, m.mode,
                 tar.extractfile(m).read()) for m in tar.getmembers()]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_offline_tools_cross_volumes(tmp_path, monkeypatch, writer):
    src = tmp_path / "src"
    src.mkdir()
    _write_volume(writer, str(src), monkeypatch)
    results = {}
    for tool in ("reference", "port"):
        d = tmp_path / tool
        shutil.copytree(src, d)
        _, _, run = _package(tool)
        os.remove(d / "c_5.idx")
        assert run(["fix", "-dir", str(d), "-volumeId", "5",
                    "-collection", "c"]) == 0
        fixed = (d / "c_5.idx").read_bytes()
        out = str(tmp_path / f"{tool}.tar")
        assert run(["export", "-dir", str(d), "-volumeId", "5",
                    "-collection", "c", "-o", out]) == 0
        assert run(["compact", "-dir", str(d), "-volumeId", "5",
                    "-collection", "c"]) == 0
        results[tool] = {"idx": fixed, "tar": _tar_members(out),
                         "tar_bytes": open(out, "rb").read(),
                         "dat": (d / "c_5.dat").read_bytes(),
                         "compacted_idx": (d / "c_5.idx").read_bytes()}
    ref, port = results["reference"], results["port"]
    # 40 written, 6 deleted, 2 overwritten: 34 live, the rebuilt index
    # one 16-byte entry each
    assert len(ref["idx"]) == 34 * 16
    assert len(ref["tar"]) == 34
    assert sum(1 for m in ref["tar"] if m[0].endswith("again.bin")) == 2
    for key in ("idx", "tar", "tar_bytes", "dat", "compacted_idx"):
        assert port[key] == ref[key], key
    assert len(ref["dat"]) < os.path.getsize(src / "c_5.dat")
