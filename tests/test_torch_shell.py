"""The port's admin shell (`seaweedfs_tpu_torch/shell/`) and its CLI
held against the reference's, on port clusters (the port's master and
port volume servers with `device="cpu"`, in process).

- Hypothesis equalities of the pure helpers: `parse_flags`,
  `parse_duration`, `balanced_ec_distribution`; the topology-snapshot
  selection of `ec.encode` with `time.time` patched alike for both.
- Twins of tests/test_shell_commands.py's volume, EC and cluster tests,
  driven by the port's shell and `WeedClient`.
- The read-only commands print, on one cluster, what the reference's
  shell prints, but for masked fields that move between two calls:
  `registry_series` (the process's metric series, which either shell's
  calls add to), `tokens` (token buckets refill with the wall clock),
  and the timestamps `modified_at`, `last_scrub`, `last_eval` and
  `last_ts`.
- Twin volumes (the same `.dat` and `.idx` under two ids on one
  cluster): `ec.encode` of one by each shell gives the same placement
  and the same shard and `.ecx` bytes; each shell rebuilds the volume
  the other encoded, with the same shard bytes and the same repair-class
  bytes booked by the volume servers; each decodes it back to the same
  `.dat` and `.idx`.
- The CLI's `shell`, `upload`, `download`, `benchmark` and
  `master.follower` as subprocesses against CLI `master` and
  `volume -device cpu`: neither jax nor torch is loaded in the
  client-side processes.

The kept differences (ROADMAP §3): `help` and the unknown-command error
list only the ported commands, and a malformed WEEDTPU_CODEC_LRC or
_MSR makes `ec.codecs` raise where the reference falls back.
"""

import io
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from seaweedfs_tpu.ops import codecs as ref_codecs
from seaweedfs_tpu.shell import commands as ref_commands

from seaweedfs_tpu_torch.client import WeedClient
from seaweedfs_tpu_torch.ops import codec_tags
from seaweedfs_tpu_torch.shell import commands
from seaweedfs_tpu_torch.shell.commands import CommandEnv, run_command
from seaweedfs_tpu_torch.stats import metrics
from tests.test_torch_master_cluster import Cluster, free_port, start_cli

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _quiet_cluster(monkeypatch):
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "0")
    # the master's repair loop would rebuild the shards a flow deletes
    monkeypatch.setenv("WEEDTPU_REPAIR_INTERVAL", "0")


@pytest.fixture()
def cluster3(tmp_path):
    c = Cluster(tmp_path, n_volume_servers=3).start()
    c.wait_heartbeats()
    yield c
    c.stop()


def shell(env, line) -> str:
    buf = io.StringIO()
    run_command(env, line, buf)
    return buf.getvalue()


def wait_for(pred, timeout=6.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.1)
    return False


def _post(url: str, path: str, body: dict) -> dict:
    req = urllib.request.Request(
        f"http://{url}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        raw = r.read()
    return json.loads(raw) if raw else {}


# ---- the pure helpers ----------------------------------------------------

_TOKENS = st.lists(st.text(alphabet="-=abxyz01 .", min_size=0, max_size=6),
                   max_size=8)


@settings(max_examples=200, deadline=None)
@given(_TOKENS)
def test_parse_flags_equals_the_reference(args):
    assert commands.parse_flags(args) == ref_commands.parse_flags(args)


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:  # the exception's type is the outcome
        return ("raises", type(e))


@settings(max_examples=300, deadline=None)
@given(st.one_of(
    st.text(alphabet="0123456789.smhdx -e+", max_size=8),
    st.builds(lambda v, u: f"{v}{u}",
              st.floats(allow_nan=False, allow_infinity=False, width=32),
              st.sampled_from(["", "s", "m", "h", "d"]))))
def test_parse_duration_equals_the_reference(s):
    got = _outcome(commands.parse_duration, s)
    want = _outcome(ref_commands.parse_duration, s)
    assert got == want


@settings(max_examples=200, deadline=None)
@given(st.lists(st.sampled_from([f"127.0.0.1:{p}" for p in range(8080, 8092)]),
                min_size=1, max_size=8, unique=True),
       st.data(), st.integers(1, 20))
def test_balanced_ec_distribution_equals_the_reference(nodes, data, n):
    racks = {nd: data.draw(st.sampled_from(["dc1/r1", "dc1/r2", "dc2/r1"]))
             for nd in nodes if data.draw(st.booleans())}
    got = commands.balanced_ec_distribution(nodes, racks, n_shards=n)
    assert got == ref_commands.balanced_ec_distribution(nodes, racks,
                                                        n_shards=n)
    assert sorted(s for ss in got.values() for s in ss) == list(range(n))


def test_balanced_ec_distribution_rack_aware():
    """Shard spread minimizes per-rack loss (twin of the reference's
    test of the same name)."""
    nodes = [f"n{i}" for i in range(6)]
    racks = {"n0": "r1", "n1": "r1", "n2": "r2", "n3": "r2",
             "n4": "r3", "n5": "r3"}
    alloc = commands.balanced_ec_distribution(nodes, racks)
    assert sum(len(s) for s in alloc.values()) == 14
    per_rack = {}
    for n, shards in alloc.items():
        per_rack[racks[n]] = per_rack.get(racks[n], 0) + len(shards)
    assert sorted(per_rack.values()) == [4, 5, 5], per_rack
    assert all(len(s) <= 3 for s in alloc.values()), alloc
    alloc = commands.balanced_ec_distribution(["a", "b", "c"])
    assert sorted(len(s) for s in alloc.values()) == [4, 5, 5]
    racks = {"a": "r1", "b": "r1", "c": "r1", "d": "r2"}
    alloc = commands.balanced_ec_distribution(["a", "b", "c", "d"], racks)
    assert len(alloc["d"]) == 7


def test_collect_volume_ids_for_ec_encode_snapshot(monkeypatch):
    """One topology snapshot, `time.time` patched alike for both
    packages (each reads the wall clock for "written too recently")."""
    now = 1_700_000_000.0
    monkeypatch.setattr(time, "time", lambda: now)
    topo = {
        "volume_size_limit": 100,
        "nodes": {
            "vs1": {"volume_infos": [
                {"id": 1, "collection": "", "size": 96,
                 "modified_at": now - 7200},
                {"id": 2, "collection": "", "size": 99,
                 "modified_at": now - 10},
                {"id": 3, "collection": "", "size": 50,
                 "modified_at": now - 7200},
                {"id": 4, "collection": "pics", "size": 99,
                 "modified_at": now - 7200},
                {"id": 6, "collection": "", "size": 100,
                 "modified_at": now - 3600},
            ]},
            "vs2": {"volume_infos": [
                {"id": 1, "collection": "", "size": 96,
                 "modified_at": now - 7200},
                {"id": 5, "collection": "", "size": 97,
                 "modified_at": now - 7200},
            ]},
        },
    }
    cases = [("", 95, 3600, [1, 5]), ("pics", 95, 3600, [4]),
             ("", 95, 0, [1, 2, 5, 6]), ("", 0, 3599, [1, 3, 5, 6]),
             ("", 100, 0, [])]
    for col, full, quiet, want in cases:
        got = commands.collect_volume_ids_for_ec_encode(topo, col, full,
                                                        quiet)
        assert got == want == ref_commands.collect_volume_ids_for_ec_encode(
            topo, col, full, quiet), (col, full, quiet)


def test_help_and_unknown_command_list_the_ported_commands():
    """The port registers every command of the reference's (95, the four
    `mq.*` with them), and `help` and the unknown-command error list
    them."""
    left_out = set(ref_commands.COMMANDS) - set(commands.COMMANDS)
    assert set(commands.COMMANDS) == set(ref_commands.COMMANDS)
    assert len(commands.COMMANDS) == 95
    assert "mount.configure" in commands.COMMANDS
    assert {n for n in ref_commands.COMMANDS
            if n.startswith(("fs.", "s3.", "remote.", "volume.tier.",
                             "cluster."))} <= set(commands.COMMANDS)
    assert left_out == set()
    assert sorted(n for n in commands.COMMANDS if n.startswith("mq.")) == [
        "mq.balance", "mq.topic.configure", "mq.topic.desc",
        "mq.topic.list"]
    assert sorted(n for n in commands.COMMANDS if n.startswith("s3.")) == [
        "s3.bucket.create", "s3.bucket.delete", "s3.bucket.list",
        "s3.bucket.quota", "s3.bucket.quota.check", "s3.circuitbreaker",
        "s3.clean.uploads", "s3.configure"]
    env = CommandEnv("127.0.0.1:1")
    listed = [line.split()[0] for line in shell(env, "help").splitlines()]
    assert listed == sorted(commands.COMMANDS)
    with pytest.raises(RuntimeError) as ei:
        run_command(env, "mq.topic.lists", io.StringIO())
    assert ", ".join(sorted(commands.COMMANDS)) in str(ei.value)
    with pytest.raises(RuntimeError) as ref_ei:
        ref_commands.run_command(ref_commands.CommandEnv("127.0.0.1:1"),
                                 "mq.topic.lists", io.StringIO())
    assert str(ei.value) == str(ref_ei.value)
    # `help <name>` prints the same doc as the reference's
    for name in ("ec.encode", "maintenance.status", "volume.balance",
                 "s3.configure", "s3.circuitbreaker", "s3.bucket.quota",
                 "mount.configure", "cluster.geo", "volume.tier.move",
                 "volume.tier.upload", "volume.tier.download",
                 "remote.mount", "remote.cache", "remote.meta.sync",
                 "remote.uncache", "remote.configure", "remote.unmount",
                 "remote.mount.buckets", "mq.balance", "mq.topic.list",
                 "mq.topic.configure", "mq.topic.desc"):
        ref = io.StringIO()
        ref_commands.run_command(ref_commands.CommandEnv("127.0.0.1:1"),
                                 f"help {name}", ref)
        assert shell(env, f"help {name}") == ref.getvalue()


def test_codec_knob_raises_through_ec_codecs(monkeypatch):
    """`ec.codecs` lists `codec_tags.registered()`: a malformed
    WEEDTPU_CODEC_LRC raises there (the reference falls back), before
    the master is asked."""
    monkeypatch.setenv("WEEDTPU_CODEC_LRC", "10,2")
    with pytest.raises(ValueError, match="WEEDTPU_CODEC_LRC"):
        run_command(CommandEnv("127.0.0.1:1"), "ec.codecs", io.StringIO())
    assert [s.tag for s in ref_codecs.registered()] == \
        ["rs_10_4", "lrc_10_2_2", "msr_9_16"]
    monkeypatch.setenv("WEEDTPU_CODEC_LRC", "12,2,2")
    assert [s.describe() for s in codec_tags.registered()] == \
        [s.describe() for s in ref_codecs.registered()]


# ---- twins of tests/test_shell_commands.py ---------------------------------

def test_volume_balance_moves_volumes(cluster3):
    c = cluster3
    client = WeedClient(c.master.url)
    for i in range(6):
        client.upload(b"x" * 1000, name=f"f{i}")
        c.submit(c.master._grow("", "000", "", 1))
    env = CommandEnv(c.master.url)
    env.acquire_lock()
    out = shell(env, "volume.balance")  # dry run
    assert "planned" in out or "nothing to do" in out
    out = shell(env, "volume.balance -apply")
    assert "volume.balance:" in out

    def balanced():
        topo = env.topology()
        counts = [len(n["volumes"]) for n in topo["nodes"].values()]
        return counts and max(counts) - min(counts) <= 1
    assert wait_for(balanced)


def test_fix_replication_restores_copy(cluster3):
    c = cluster3
    client = WeedClient(c.master.url)
    fid = client.upload(b"replicate me", name="r.txt")
    vid = int(fid.split(",")[0])
    env = CommandEnv(c.master.url)
    env.acquire_lock()
    locs = env.volume_locations(vid)
    other = [vs.url for vs in c.volume_servers if vs.url not in locs]
    env.vs_post(other[0], "/admin/volume/copy",
                {"volume": vid, "source": locs[0]})
    assert wait_for(lambda: len(env.volume_locations(vid)) == 2)
    out = shell(env, "volume.fix.replication")
    assert "over-replicated" in out and "planned" in out
    out = shell(env, "volume.fix.replication -apply")
    assert "over-replicated" in out
    assert wait_for(lambda: len(env.volume_locations(vid)) == 1)
    assert client.download(fid) == b"replicate me"


def test_check_disk_detects_divergence(cluster3):
    c = cluster3
    client = WeedClient(c.master.url)
    fid = client.upload(b"abc", name="a.txt")
    vid = int(fid.split(",")[0])
    env = CommandEnv(c.master.url)
    env.acquire_lock()
    locs = env.volume_locations(vid)
    other = [vs.url for vs in c.volume_servers if vs.url not in locs]
    env.vs_post(other[0], "/admin/volume/copy",
                {"volume": vid, "source": locs[0]})
    assert wait_for(lambda: len(env.volume_locations(vid)) == 2)
    out = shell(env, "volume.check.disk")
    assert "0 divergent" in out
    client.upload_to(locs[0], f"{vid},000000ffdeadbeef?type=replicate",
                     b"extra")
    out = shell(env, "volume.check.disk")
    assert "differ" in out


def test_vacuum_all(cluster3):
    c = cluster3
    client = WeedClient(c.master.url)
    fids = [client.upload(b"y" * 10000, name=f"v{i}") for i in range(10)]
    for fid in fids[:9]:
        client.delete(fid)
    env = CommandEnv(c.master.url)
    env.acquire_lock()
    out = shell(env, "volume.vacuum.all -garbageThreshold 0.1")
    assert "vacuumed" in out
    assert client.download(fids[9]) == b"y" * 10000
    assert shell(env, "volume.vacuum.disable") == \
        "automatic vacuum disabled\n"
    assert shell(env, "volume.vacuum.enable") == "automatic vacuum enabled\n"


def test_volume_move_mount_unmount(cluster3):
    c = cluster3
    client = WeedClient(c.master.url)
    fid = client.upload(b"movable", name="m.bin")
    vid = int(fid.split(",")[0])
    env = CommandEnv(c.master.url)
    env.acquire_lock()
    src = env.volume_locations(vid)[0]
    dst = next(vs.url for vs in c.volume_servers if vs.url != src)
    out = shell(env, f"volume.move -volumeId {vid} -target {dst}")
    assert "moved" in out
    assert wait_for(lambda: env.volume_locations(vid) == [dst])
    assert client.download(fid) == b"movable"
    shell(env, f"volume.unmount -volumeId {vid} -node {dst}")
    assert wait_for(lambda: env.volume_locations(vid) == [])
    shell(env, f"volume.mount -volumeId {vid} -node {dst}")
    assert wait_for(lambda: env.volume_locations(vid) == [dst])
    client._vid_cache.clear()
    assert client.download(fid) == b"movable"


def test_cluster_ps_leader_and_check(cluster3):
    """The twin of the reference's `cluster.ps` check (its test starts a
    filer; a registered member stands in for one here)."""
    c = cluster3
    env = CommandEnv(c.master.url)
    assert shell(env, "cluster.ps") == "no registered cluster processes\n"
    assert shell(env, "cluster.leader") == f"{c.master.url}\n"
    out = shell(env, "cluster.check")
    for vs in c.volume_servers:
        assert f"volume {vs.url:24s} ok" in out
    _post(c.master.url, "/cluster/register",
          {"type": "filer", "address": "127.0.0.1:18888"})
    assert wait_for(lambda: bool(
        env.master_get("/cluster/status").get("Members", {}).get("filer")))
    assert "filer 127.0.0.1:18888" in shell(env, "cluster.ps")


def test_incremental_volume_copy(cluster3):
    c = cluster3
    client = WeedClient(c.master.url)
    fid1 = client.upload(b"first " * 100, name="a.bin")
    vid = int(fid1.split(",")[0])
    env = CommandEnv(c.master.url)
    env.acquire_lock()
    locs = env.volume_locations(vid)
    dst = next(vs.url for vs in c.volume_servers if vs.url not in locs)
    out = shell(env, f"volume.copy -volumeId {vid} -target {dst}")
    assert f"copied volume {vid}: {locs[0]} -> {dst}" in out
    assert wait_for(lambda: len(env.volume_locations(vid)) == 2)
    client.upload_to(locs[0], f"{vid},000000aadeadbeef?type=replicate",
                     b"tail-data")
    r = env.vs_post(dst, "/admin/volume/copy",
                    {"volume": vid, "source": locs[0]})
    assert r.get("incremental") and r.get("appended_bytes", 0) > 0
    got = urllib.request.urlopen(
        f"http://{dst}/{vid},000000aadeadbeef", timeout=15).read()
    assert got == b"tail-data"
    r2 = env.vs_post(dst, "/admin/volume/copy",
                     {"volume": vid, "source": locs[0]})
    assert r2.get("appended_bytes") == 0


def test_volume_grow_command(cluster3):
    env = CommandEnv(cluster3.master.url)
    env.acquire_lock()
    out = shell(env, "volume.grow -count 2")
    assert "grew 2 volume(s)" in out
    topo = env.topology()
    assert sum(len(n["volumes"]) for n in topo["nodes"].values()) >= 2
    assert shell(env, "collection.list").startswith("collection (default)")


def test_ec_encode_auto_selection(tmp_path):
    """Without -volumeId, ec.encode scans the topology and encodes the
    quiet+full volumes itself (2 of 3 here)."""
    c = Cluster(tmp_path, n_volume_servers=1,
                volume_size_limit=256 * 1024).start()
    c.wait_heartbeats()
    try:
        client = WeedClient(c.master.url)
        urllib.request.urlopen(urllib.request.Request(
            f"http://{c.master.url}/vol/grow?count=3", data=b"",
            method="POST"), timeout=15).read()
        by_vid = {}
        for i in range(64):
            a = client.assign()
            by_vid.setdefault(int(a["fid"].split(",")[0]), a)
            if len(by_vid) >= 3:
                break
        assert len(by_vid) >= 3
        vids = sorted(by_vid)[:3]
        full, empty = vids[:2], vids[2:]
        for vid in full:
            a = by_vid[vid]
            client.upload_to(a["url"], a["fid"], b"x" * 200 * 1024,
                             jwt=a.get("auth", ""))
        time.sleep(1.0)
        env = CommandEnv(c.master.url)
        shell(env, "lock")
        out = shell(env, "ec.encode -quietFor 0s -fullPercent 50")
        shell(env, "unlock")
        assert re.search(r"^\d+ volume\(s\) ≥50.0% full and quiet for 0s: ",
                         out)
        for vid in full:
            assert f"ec.encode {vid} done" in out
        for vid in empty:
            assert f"ec.encode {vid} done" not in out
        for vid in full:
            assert client.download(by_vid[vid]["fid"]) == b"x" * 200 * 1024
    finally:
        c.stop()


def test_volume_delete_empty(cluster3):
    c = cluster3
    client = WeedClient(c.master.url)
    fid = client.upload(b"live-data", name="keep.bin")
    live_vid = int(fid.split(",")[0])
    urllib.request.urlopen(urllib.request.Request(
        f"http://{c.master.url}/vol/grow?count=2", data=b"",
        method="POST"), timeout=15).read()
    time.sleep(1.0)
    env = CommandEnv(c.master.url)
    shell(env, "lock")
    out = shell(env, "volume.delete.empty -quietFor 0s")
    assert "would delete" in out
    before = {v["id"] for n in env.topology()["nodes"].values()
              for v in n["volume_infos"]}
    out = shell(env, "volume.deleteEmpty")
    assert "volume.deleteEmpty:" in out and "planned" in out
    shell(env, "volume.delete.empty -quietFor 0s -force")
    shell(env, "unlock")
    assert wait_for(lambda: {
        v["id"] for n in env.topology()["nodes"].values()
        for v in n["volume_infos"]} == {live_vid})
    assert live_vid in before and len(before) > 1
    assert client.download(fid) == b"live-data"


def test_volume_server_evacuate_and_leave(cluster3):
    c = cluster3
    client = WeedClient(c.master.url)
    fids = [client.upload(f"payload-{i}".encode()) for i in range(4)]
    env = CommandEnv(c.master.url)
    ec_fid = client.upload(b"ec-payload", collection="ecdata")
    ec_vid = int(ec_fid.split(",")[0])
    shell(env, "lock")
    shell(env, f"ec.encode -volumeId {ec_vid} -collection ecdata")
    shell(env, "unlock")
    topo = env.topology()
    victim = max(topo["nodes"],
                 key=lambda nid: len(topo["nodes"][nid]["volumes"]))
    held = set(topo["nodes"][victim]["volumes"])
    assert held
    shell(env, "lock")
    out = shell(env, f"volume.server.evacuate -node {victim}")
    assert "evacuated" in out
    topo = env.topology()
    assert topo["nodes"][victim]["volumes"] == []
    assert not any(topo["nodes"][victim].get("ec_shards", {}).values())
    assert client.download(ec_fid) == b"ec-payload"
    for i, fid in enumerate(fids):
        assert client.download(fid) == f"payload-{i}".encode()
    shell(env, f"volume.server.leave -node {victim}")
    shell(env, "unlock")
    c.master.node_timeout = 1.5
    assert wait_for(lambda: victim not in env.topology()["nodes"],
                    timeout=15)


def test_collection_delete_and_volume_mark_delete(cluster3):
    c = cluster3
    client = WeedClient(c.master.url)
    gone = client.upload(b"doomed", collection="tmpcol")
    kept = client.upload(b"kept")
    env = CommandEnv(c.master.url)
    shell(env, "lock")
    vid = int(kept.split(",")[0])
    out = shell(env, f"volume.mark -volumeId {vid}")
    assert f"marked {vid} readonly=True" in out
    shell(env, f"volume.mark -volumeId {vid} -writable true")
    out = shell(env, "collection.delete -collection tmpcol")
    assert out.startswith("collection.delete 'tmpcol': ")
    assert not out.startswith("collection.delete 'tmpcol': 0 ")
    gvid = int(gone.split(",")[0])
    assert wait_for(lambda: env.volume_locations(gvid) == [])
    out = shell(env, "volume.configure.replication -volumeId "
                     f"{vid} -replication 000")
    assert f"volume {vid} on " in out
    shell(env, "unlock")
    assert client.download(kept) == b"kept"


# ---- read-only output: the port's shell prints the reference's ------------

_MASKED_KEYS = {"tokens", "modified_at", "last_scrub", "last_eval", "last_ts"}


def _mask(text: str) -> str:
    """Masks what moves between two calls (the module docstring names
    the fields)."""
    text = re.sub(r"registry_series=\d+", "registry_series=*", text)
    text = re.sub(r"tokens=[0-9.e+]+", "tokens=*", text)
    lines = []
    for line in text.splitlines():
        try:
            doc = json.loads(line)
        except ValueError:
            lines.append(line)
            continue
        lines.append(json.dumps(_mask_doc(doc), sort_keys=True))
    return "\n".join(lines)


def _mask_doc(doc):
    if isinstance(doc, dict):
        return {k: "*" if k in _MASKED_KEYS else _mask_doc(v)
                for k, v in doc.items()}
    if isinstance(doc, list):
        return [_mask_doc(v) for v in doc]
    return doc


READ_ONLY = ["volume.list", "cluster.status", "cluster.ps",
             "collection.list", "cluster.leader", "cluster.check",
             "cluster.raft.ps", "ec.codecs", "ec.codecs -json",
             "maintenance.status", "maintenance.status -json",
             "cluster.autopilot", "cluster.autopilot -json",
             "chaos.status", "chaos.status -json", "cluster.slo",
             "cluster.alerts", "cluster.loops", "cluster.interference",
             "cluster.heat", "cluster.perf", "cluster.canary",
             "cluster.trace", "ec.progress -volumeId 1"]


def test_read_only_commands_print_what_the_reference_prints(cluster3):
    c = cluster3
    client = WeedClient(c.master.url)
    fids = [client.upload(b"r" * 3000, collection=col)
            for col in ("", "", "pics") for _ in range(8)]
    vid = int(fids[0].split(",")[0])
    time.sleep(0.7)
    env = CommandEnv(c.master.url)
    shell(env, "lock")
    shell(env, f"ec.encode -volumeId {vid}")
    shell(env, "unlock")
    time.sleep(0.7)
    for line in READ_ONLY:
        ref = io.StringIO()
        ref_rc = ref_commands.run_command(
            ref_commands.CommandEnv(c.master.url), line, ref)
        port = io.StringIO()
        rc = run_command(CommandEnv(c.master.url), line, port)
        assert rc == ref_rc == 0, line
        assert port.getvalue(), line
        assert _mask(port.getvalue()) == _mask(ref.getvalue()), line
    st_ = json.loads(shell(env, "maintenance.status -json"))
    assert st_["volumes"][str(vid)]["kind"] == "ec"
    assert st_["volumes"][str(vid)]["state"] == "healthy"


def test_volume_fsck_equals_the_reference_with_a_port_filer(cluster3):
    """`volume.fsck` lists a filer's tree first: the port's
    `FilerServer`, with an empty tree, registered with the port's
    master."""
    from seaweedfs_tpu_torch.server.filer_server import FilerServer
    c = cluster3
    client = WeedClient(c.master.url)
    for _ in range(6):
        client.upload(b"f" * 2000)
    filer = FilerServer(c.master.url, "127.0.0.1", free_port())
    c.submit(filer.start())
    try:
        env = CommandEnv(c.master.url)
        assert wait_for(lambda: bool(
            env.master_get("/cluster/status").get("Members", {})
            .get("filer")))
        outs = []
        for mod in (ref_commands, commands):
            env = mod.CommandEnv(c.master.url)
            for line in ("volume.fsck", "volume.fsck -json"):
                buf = io.StringIO()
                mod.run_command(env, "lock", buf)
                rc = mod.run_command(env, line, buf)
                mod.run_command(env, "unlock", buf)
                outs.append((rc, _mask(buf.getvalue())))
        assert outs[:2] == outs[2:]
        assert outs[3][0] == 0 and '"ok": true' in outs[3][1]
    finally:
        c.submit(filer.stop())


# ---- EC by both shells on twin volumes ------------------------------------

def _shard_files(c, vid):
    """{node url: {suffix: bytes}} of every `.ecNN` and `.ecx` of `vid`."""
    got = {}
    for vs in c.volume_servers:
        d = pathlib.Path(vs.store.locations[0].directory)
        files = {p.name.split(".", 1)[1]: p.read_bytes()
                 for p in d.glob(f"{vid}.ec*")}
        if files:
            got[vs.url] = files
    return got


def _dat_files(c, vid):
    got = {}
    for vs in c.volume_servers:
        d = pathlib.Path(vs.store.locations[0].directory)
        for ext in ("dat", "idx"):
            p = d / f"{vid}.{ext}"
            if p.exists():
                got[(vs.url, ext)] = p.read_bytes()
    return got


def _repair_bytes() -> dict:
    """Repair-class bytes by (direction, peer role) in the process's
    ledger, which the master and the volume servers share in process."""
    out = {}
    for labels, child in metrics.NET_BYTES._pairs():
        ld = dict(labels)
        if ld.get("class") == "repair":
            out[(ld["direction"], ld["peer_role"])] = child.value
    return out


def _servers_repair_bytes(before: dict, after: dict) -> dict:
    """What a rebuild books between the volume servers and toward the
    shell.  Two kinds of bytes carry the cluster's state and not the
    shell's traffic, so they are left out: the master's answers to the
    shell (`sent` to `shell` at the master: /maintenance/status and the
    topology), and the heartbeat that an admin handler sends under the
    request's class (`sent` to `master`, which one process also books as
    as many bytes `recv` from `volume` at the master)."""
    d = {k: after[k] - before.get(k, 0) for k in after}
    beats = d.get(("sent", "master"), 0)
    return {"volume_recv": d.get(("recv", "volume"), 0) - beats,
            "volume_sent": d.get(("sent", "volume"), 0),
            "shell_recv": d.get(("recv", "shell"), 0),
            "master_recv": d.get(("recv", "master"), 0)}


def test_twin_volumes_encode_rebuild_decode_by_both_shells(cluster3):
    """Volumes 41 and 42 hold the same `.dat` and `.idx`.  The reference's
    shell encodes 41 and the port's 42: the same placement and the same
    shard and `.ecx` bytes.  The same two shards are lost from each; the
    port's shell rebuilds 41 and the reference's 42: the same shard bytes
    and the same repair-class bytes in the port volume servers' netflow
    ledger.  The port's shell decodes 41 and the reference's 42: the
    same `.dat` and `.idx` bytes, and every needle reads back through
    both clients."""
    from seaweedfs_tpu.client import WeedClient as RefClient
    c = cluster3
    src = c.volume_servers[0]
    _post(src.url, "/admin/assign_volume", {"volume": 41})
    rng = np.random.default_rng(41)
    needles = {}
    for i in range(40):
        data = rng.integers(0, 256, int(rng.integers(200, 30_000)),
                            dtype=np.uint8).tobytes()
        key = f"{0x4100 + i:x}{0x1234abcd:08x}"
        req = urllib.request.Request(f"http://{src.url}/41,{key}",
                                     data=data, method="PUT")
        urllib.request.urlopen(req, timeout=30).close()
        needles[key] = data
    _post(src.url, "/admin/volume/unmount", {"volume": 41})
    d = pathlib.Path(src.store.locations[0].directory)
    for ext in ("dat", "idx"):
        shutil.copyfile(d / f"41.{ext}", d / f"42.{ext}")
    _post(src.url, "/admin/volume/mount", {"volume": 41})
    _post(src.url, "/admin/volume/mount", {"volume": 42})
    time.sleep(0.7)
    ref_env = ref_commands.CommandEnv(c.master.url)
    env = CommandEnv(c.master.url)
    sink = io.StringIO()
    ref_run = ref_commands.run_command

    def locked(e, run, line):
        # the admin lock is exclusive: each shell takes it in turn
        run(e, "lock", sink)
        try:
            run(e, line, sink)
        finally:
            run(e, "unlock", sink)

    locked(ref_env, ref_run, "ec.encode -volumeId 41")
    locked(env, run_command, "ec.encode -volumeId 42")
    time.sleep(0.7)
    placement = {v: {s: sorted(urls) for s, urls in
                     env.ec_shard_locations(v).items()} for v in (41, 42)}
    assert placement[41] == placement[42]
    assert sorted(placement[41]) == list(range(14))
    a, b = _shard_files(c, 41), _shard_files(c, 42)
    assert a == b and sum(len(f) for f in a.values()) >= 15
    lost = [0, 3]
    booked = {}
    for vid, e, run in ((41, env, run_command), (42, ref_env, ref_run)):
        for s in lost:
            for url in placement[vid][s]:
                _post(url, "/admin/ec/delete_shards",
                      {"volume": vid, "shards": [s]})
        time.sleep(0.7)
        assert not set(lost) & set(env.ec_shard_locations(vid))
        before = _repair_bytes()
        locked(e, run, "ec.rebuild")
        booked[vid] = _servers_repair_bytes(before, _repair_bytes())
        time.sleep(0.7)
        assert sorted(env.ec_shard_locations(vid)) == list(range(14))
    rebuilt = [{u: {k: v for k, v in f.items() if k in ("ec00", "ec03")}
                for u, f in _shard_files(c, vid).items()} for vid in (41, 42)]
    assert rebuilt[0] == rebuilt[1]
    assert sum(len(f) for f in rebuilt[0].values()) == 2
    # the survivors copied to the rebuilder, shard by shard
    counts = {}
    for s, urls in placement[41].items():
        if s not in lost:
            for u in urls:
                counts[u] = counts.get(u, 0) + 1
    rebuilder = max(counts, key=counts.get)
    shard_size = len(next(v for k, v in sorted(a[rebuilder].items())
                          if re.fullmatch(r"ec\d\d", k)))
    borrowed = sum(1 for s, urls in placement[41].items()
                   if s not in lost and rebuilder not in urls)
    assert booked[41] == booked[42]
    assert booked[41]["volume_recv"] == borrowed * shard_size > 0
    for key, data in list(needles.items())[:6]:
        for vid in (41, 42):
            got = urllib.request.urlopen(
                f"http://{src.url}/{vid},{key}", timeout=30).read()
            assert got == data
    locked(env, run_command, "ec.decode -volumeId 41")
    locked(ref_env, ref_run, "ec.decode -volumeId 42")
    time.sleep(0.7)
    dats = [_dat_files(c, vid) for vid in (41, 42)]
    assert dats[0] == dats[1] and len(dats[0]) == 2
    port, ref = WeedClient(c.master.url), RefClient(c.master.url)
    for key, data in needles.items():
        assert port.download(f"41,{key}") == data
        assert ref.download(f"42,{key}") == data
    port.close()
    ref.close()


# ---- the CLI as subprocesses ------------------------------------------------

CLIENT_CHILD = r"""
import json, sys
from seaweedfs_tpu_torch.__main__ import main
rc = main(sys.argv[1:])
print(json.dumps({"rc": rc, "jax": "jax" in sys.modules,
                  "torch": "torch" in sys.modules,
                  "reference": sorted(m for m in sys.modules
                                      if m.split(".")[0] ==
                                      "seaweedfs_tpu")}))
"""

# as tests/test_torch_master_cluster.py's CLI_CHILD: a `main` that raises
# (a port already bound, say) ends the child, its traceback in the log
SERVER_CHILD = r"""
import json, os, sys, threading, traceback
from seaweedfs_tpu_torch.__main__ import main
def serve():
    try:
        main(sys.argv[1:])
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(3)
threading.Thread(target=serve, daemon=True).start()
sys.stdin.readline()  # the test's word to report and leave
print(json.dumps({"jax": "jax" in sys.modules,
                  "torch": "torch" in sys.modules}), flush=True)
import os
os._exit(0)
"""


def _child_env() -> dict:
    # no background loop of the child master may tick between two reads
    # of its state (the aggregator's first scrape moved the loops
    # headline of `maintenance.status` between them)
    env = dict(os.environ, PYTHONPATH=str(REPO), WEEDTPU_SCRUB_MBPS="0",
               WEEDTPU_REPAIR_INTERVAL="0", WEEDTPU_CANARY_INTERVAL="0",
               WEEDTPU_AGG_INTERVAL="0")
    env.pop("WEEDTPU_EC_CODEC", None)
    return env


def _client(*argv, check=True):
    """One client-side CLI run: (stdout without the report line, the
    report)."""
    r = subprocess.run([sys.executable, "-c", CLIENT_CHILD, *argv],
                       cwd=str(REPO), env=_child_env(), capture_output=True,
                       text=True, timeout=180)
    if not check:
        return r
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.splitlines()
    return "\n".join(lines[:-1]) + "\n", json.loads(lines[-1])


def test_cli_shell_upload_download_benchmark_and_follower(tmp_path):
    """`shell -c`, `upload`, `download`, `benchmark -n 64` and
    `master.follower` of the port's CLI against a CLI `master` and a
    `volume -device cpu`: each client-side process exits 0 and loads
    neither jax, torch nor the reference package; `shell -c` prints
    what the port's shell prints in process, and a failing command ends
    it with a non-zero code.  The servers' ports come from `cli_ports`,
    and a child whose port was taken before it bound starts again on
    fresh ones (`start_cli`)."""
    def argvs(ports):
        mport, vport, _ = ports
        return [["master", "-port", str(mport), "-mdir",
                 str(tmp_path / "m")],
                ["volume", "-dir", str(tmp_path / "d"), "-port", str(vport),
                 "-mserver", f"127.0.0.1:{mport}", "-device", "cpu"]]

    def nodes(ports):
        with urllib.request.urlopen(
                f"http://127.0.0.1:{ports[0]}/dir/status", timeout=2) as r:
            return json.loads(r.read())["Topology"]["nodes"]
    (tmp_path / "d").mkdir()
    procs = []
    try:
        procs, (mport, vport, fport), got = start_cli(
            tmp_path, argvs, 3, nodes, child=SERVER_CHILD, env=_child_env())
        master = f"127.0.0.1:{mport}"
        assert list(got) == [f"127.0.0.1:{vport}"]
        clean = {"rc": 0, "jax": False, "torch": False, "reference": []}

        files = []
        for i in range(3):
            p = tmp_path / f"up{i}.bin"
            p.write_bytes(bytes([i]) * (1000 + 777 * i))
            files.append(p)
        out, report = _client("upload", "-master", master,
                              *map(str, files))
        assert report == clean
        uploaded = json.loads(out)
        assert [u["fileName"] for u in uploaded] == [p.name for p in files]
        dl = tmp_path / "dl"
        dl.mkdir()
        out, report = _client("download", "-master", master, "-dir",
                              str(dl), *[u["fid"] for u in uploaded])
        assert report == clean
        for u, p in zip(uploaded, files):
            assert (dl / u["fid"].replace(",", "_")).read_bytes() == \
                p.read_bytes()
            assert f"{u['fid']} -> " in out

        out, report = _client("shell", "-master", master, "-c",
                              "volume.list; ec.codecs -json; "
                              "maintenance.status -json")
        assert report == clean
        want = io.StringIO()
        env = CommandEnv(master)
        for line in ("volume.list", "ec.codecs -json",
                     "maintenance.status -json"):
            run_command(env, line, want)
        assert _mask(out) == _mask(want.getvalue())

        out, report = _client("benchmark", "-master", master, "-n", "64",
                              "-size", "512", "-c", "4")
        assert report == clean
        assert re.search(r"^write: [0-9.]+ req/s", out, re.M)
        assert re.search(r"^read: +[0-9.]+ req/s", out, re.M)

        r = _client("shell", "-master", master, "-c",
                    "volume.vacuum -volumeId 1", check=False)
        assert r.returncode != 0 and "requires `lock`" in r.stderr

        follower = subprocess.Popen(
            [sys.executable, "-c", SERVER_CHILD, "master.follower",
             "-masters", master, "-port", str(fport)], cwd=str(REPO),
            env=_child_env(), stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
        procs.append(follower)
        via = WeedClient(f"127.0.0.1:{fport}")
        deadline = time.time() + 60
        while True:
            try:
                fid = via.upload(b"through the follower")
                break
            except (RuntimeError, OSError):
                assert time.time() < deadline
                time.sleep(0.2)
        assert via.download(fid) == b"through the follower"
        via.close()
        out, _ = follower.communicate(b"report\n", timeout=60)
        assert json.loads(out.decode().strip().splitlines()[-1]) == \
            {"jax": False, "torch": False}
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)


def test_rebuild_and_decode_a_volume_in_a_collection_unlike_the_reference(
        cluster3):
    """ROADMAP fault 3.9: the reference's `ec.rebuild` copies survivors
    without naming the volume's collection, so the rebuilder asks its
    peers for files they do not have and the command fails; its
    `ec.decode` needs `-collection`.  The port's copies name the
    collection from the topology's `ec_collections`, and its decode
    defaults to it; for a volume in the default collection both send the
    reference's bodies."""
    c = cluster3
    client = WeedClient(c.master.url)
    rng = np.random.default_rng(39)
    blobs = {}
    for i in range(12):
        data = rng.bytes(int(rng.integers(500, 20_000)))
        blobs[client.upload(data, collection="c39")] = data
    vids = sorted({int(f.split(",")[0]) for f in blobs})
    time.sleep(0.7)
    env = CommandEnv(c.master.url)
    shell(env, "lock")
    for vid in vids:
        shell(env, f"ec.encode -volumeId {vid} -collection c39")
    shell(env, "unlock")
    time.sleep(0.7)
    vid = vids[0]
    for url in env.ec_shard_locations(vid)[1]:
        _post(url, "/admin/ec/delete_shards", {"volume": vid, "shards": [1]})
    time.sleep(0.7)
    assert 1 not in env.ec_shard_locations(vid)
    ref_env = ref_commands.CommandEnv(c.master.url)
    ref_commands.run_command(ref_env, "lock", io.StringIO())
    try:
        with pytest.raises(RuntimeError, match="/admin/ec/copy"):
            ref_commands.run_command(ref_env, "ec.rebuild", io.StringIO())
    finally:
        ref_commands.run_command(ref_env, "unlock", io.StringIO())
    shell(env, "lock")
    out = shell(env, "ec.rebuild")
    assert f"volume {vid}: rebuilt [1] on " in out
    time.sleep(0.7)
    assert sorted(env.ec_shard_locations(vid)) == list(range(14))
    for v in vids:
        assert f"ec.decode {v} -> normal volume on " in \
            shell(env, f"ec.decode -volumeId {v}")
    shell(env, "unlock")
    time.sleep(0.7)
    client._vid_cache.clear()
    for fid, data in blobs.items():
        assert client.download(fid) == data
    infos = [vi for n in env.topology()["nodes"].values()
             for vi in n["volume_infos"] if vi["id"] in vids]
    assert sorted(vi["id"] for vi in infos) == vids
    assert {vi["collection"] for vi in infos} == {"c39"}
