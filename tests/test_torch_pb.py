"""The port's protobuf wire layer held to the reference's.

The port carries the schema as data (`pb._SCHEMA`, a serialized
`FileDescriptorProto`) and never runs `protoc`; these tests hold that
descriptor equal to what `protoc` makes of the reference's
`weedtpu.proto`, and the heartbeat bytes of both packages equal for the
same store.
"""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

from seaweedfs_tpu import pb as ref_pb
from seaweedfs_tpu.storage import needle as ref_ndl
from seaweedfs_tpu.storage.store import Store as RefStore
from seaweedfs_tpu.storage.volume import Volume as RefVolume

from seaweedfs_tpu_torch import pb
from seaweedfs_tpu_torch.storage.ec import ec_files
from seaweedfs_tpu_torch.storage.store import Store

REPO = pathlib.Path(__file__).resolve().parent.parent
PROTO = REPO / "seaweedfs_tpu" / "pb" / "weedtpu.proto"

pytestmark = pytest.mark.skipif(not ref_pb.available(),
                                reason="the reference's protoc/protobuf "
                                       "is unavailable")


def _protoc_schema(tmp_path) -> bytes:
    """The serialized descriptor `protoc --python_out` embeds in
    weedtpu_pb2.py for the reference's proto."""
    protoc = shutil.which("protoc")
    if protoc is None:
        pytest.skip("protoc is not installed: nothing to compare with")
    subprocess.run([protoc, f"--python_out={tmp_path}",
                    f"--proto_path={PROTO.parent}", PROTO.name],
                   check=True, capture_output=True)
    tree = ast.parse((tmp_path / "weedtpu_pb2.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and \
                getattr(node.func, "attr", "") == "AddSerializedFile":
            return ast.literal_eval(node.args[0])
    raise AssertionError("no AddSerializedFile in protoc's output")


def test_descriptor_equals_protoc_of_reference_proto(tmp_path):
    from google.protobuf import descriptor_pb2
    want = _protoc_schema(tmp_path)
    assert pb._SCHEMA == want
    got = descriptor_pb2.FileDescriptorProto.FromString(pb._SCHEMA)
    assert got == descriptor_pb2.FileDescriptorProto.FromString(want)
    assert [m.name for m in got.message_type][:3] == [
        "VolumeInformationMessage", "VolumeEcShardInformationMessage",
        "Heartbeat"]


def test_pb_loads_without_protoc_and_writes_nothing(tmp_path):
    """With no protoc on PATH the port still frames heartbeats, and its
    package directory is unchanged."""
    pkg = REPO / "seaweedfs_tpu_torch" / "pb"
    before = sorted(p.name for p in pkg.iterdir() if p.name != "__pycache__")
    code = ("from seaweedfs_tpu_torch import pb\n"
            "assert pb.available()\n"
            "b = {'id': 'n', 'volumes': [{'id': 1}], 'ec_shards': []}\n"
            "assert pb.heartbeat_from_bytes(pb.heartbeat_to_bytes(b))"
            "['volumes'][0]['id'] == 1\n"
            "import shutil, sys\n"
            "assert shutil.which('protoc') is None\n"
            "print('ok', 'jax' in sys.modules)\n")
    env = dict(os.environ, PATH=str(tmp_path), PYTHONPATH=str(REPO),
               PYTHONDONTWRITEBYTECODE="1")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["ok", "False"]
    after = sorted(p.name for p in pkg.iterdir() if p.name != "__pycache__")
    assert after == before == ["__init__.py"]


BEATS = [
    {"id": "127.0.0.1:8080", "url": "127.0.0.1:8080",
     "public_url": "example:8080", "data_center": "dc1", "rack": "r2",
     "max_volume_count": 48, "max_file_key": 12345,
     "volumes": [
         {"id": 3, "size": 1 << 30, "collection": "hot",
          "file_count": 42, "delete_count": 2, "deleted_bytes": 999,
          "read_only": True, "replica_placement": "010", "ttl": "3d",
          "modified_at": 1700000000, "version": 3}],
     "ec_shards": [{"id": 7, "collection": "", "shard_ids": [0, 3, 13]},
                   {"id": 8, "collection": "c", "shard_ids": [1],
                    "shard_size": 4096, "codec": "lrc_10_2_2"}]},
    {"id": "x", "url": "x", "volumes": [], "ec_shards": []},
    {"volumes": [{"id": 1}], "ec_shards": [{"id": 2}]},
]


@pytest.mark.parametrize("beat", BEATS, ids=["full", "empty", "sparse"])
def test_heartbeat_bytes_and_dicts_equal_reference(beat):
    raw = pb.heartbeat_to_bytes(beat)
    assert raw == ref_pb.heartbeat_to_bytes(beat)
    got = pb.heartbeat_from_bytes(raw)
    assert got == ref_pb.heartbeat_from_bytes(raw)
    # shard_size is always emitted, as the reference does
    assert all("shard_size" in e for e in got["ec_shards"])


def _node_dir(d: pathlib.Path) -> None:
    """Two volumes (one in a collection, one read-only after deletes) and
    an EC shard set missing two shards, written by the reference."""
    rng = np.random.default_rng(11)
    for col, vid in (("", 1), ("pics", 2)):
        v = RefVolume(str(d), col, vid, replica_placement="001")
        for k in range(1, 9):
            v.append_needle(ref_ndl.Needle(
                cookie=int(rng.integers(1 << 31)), id=k,
                data=rng.bytes(int(rng.integers(100, 5000))),
                append_at_ns=1_700_000_000_000_000_000 + k))
        v.delete_needle(2)
        v.close()
    v = RefVolume(str(d), "", 5)
    for k in range(1, 30):
        v.append_needle(ref_ndl.Needle(
            cookie=7, id=k, data=rng.bytes(3000),
            append_at_ns=1_700_000_000_000_000_000 + k))
    v.close()
    base = str(d / "5")
    ec_files.write_ec_files(base, device="cpu")
    ec_files.write_sorted_ecx(base + ".idx")
    for ext in (".dat", ".idx", ".ec04", ".ec11"):
        os.remove(base + ext)


def test_store_heartbeats_equal_reference_bytes(tmp_path, monkeypatch):
    """Both packages' `Store.collect_heartbeat` over copies of one
    directory frame to the same protobuf bytes."""
    src = tmp_path / "src"
    src.mkdir()
    _node_dir(src)
    shutil.copytree(src, tmp_path / "ref")
    shutil.copytree(src, tmp_path / "port")
    with monkeypatch.context() as mp:
        mp.setenv("WEEDTPU_EC_CODEC", "numpy")
        ref = RefStore([str(tmp_path / "ref")], 8, "pub:1")
        ref_beat = ref.collect_heartbeat()
    port = Store([str(tmp_path / "port")], 8, "pub:1", device="cpu")
    beat = port.collect_heartbeat()
    try:
        ident = {"id": "n:1", "url": "n:1", "public_url": "pub:1",
                 "data_center": "dc", "rack": "r"}
        ref_beat.update(ident)
        beat.update(ident)
        assert beat == ref_beat
        assert [e["shard_ids"] for e in beat["ec_shards"]] == \
            [[i for i in range(14) if i not in (4, 11)]]
        raw = pb.heartbeat_to_bytes(beat)
        assert raw == ref_pb.heartbeat_to_bytes(ref_beat)
        assert pb.heartbeat_from_bytes(raw) == \
            ref_pb.heartbeat_from_bytes(raw)
    finally:
        ref.close()
        port.close()


def test_messages_are_the_ports_own():
    """The port's classes live in a descriptor pool of its own, beside
    the reference's generated module in the same process."""
    m = pb.messages()
    hb = m.Heartbeat(id="a")
    assert type(hb) is not ref_pb.messages().Heartbeat
    assert hb.SerializeToString() == \
        ref_pb.messages().Heartbeat(id="a").SerializeToString()
