"""Protobuf wire layer: binary framing of the heartbeat.

Counterpart of `seaweedfs_tpu/pb/__init__.py` (reference: weed/pb/
master.proto).  The schema is the reference's `weedtpu.proto`, carried
here as data: `_SCHEMA` is its serialized `FileDescriptorProto`, byte for
byte what `protoc --python_out` embeds in `weedtpu_pb2.py`, loaded into a
descriptor pool of the port's own.  So the port never runs `protoc` and
writes nothing into its package, and the reference's generated module
and this one coexist in one process.  `available()` is False only where
`google.protobuf` cannot be imported; the servers then frame heartbeats
as JSON, as the reference's do.

`heartbeat_to_bytes` and `heartbeat_from_bytes` are the reference's, so
a port node's beat is byte-equal to a reference node's for the same
dict; `heartbeat_from_bytes` always emits `shard_size`, as the
reference's does.
"""

from __future__ import annotations

import threading
import types

CONTENT_TYPE = "application/x-protobuf"

# serialized FileDescriptorProto of weedtpu.proto (package weedtpu):
# VolumeInformationMessage, VolumeEcShardInformationMessage, Heartbeat,
# HeartbeatResponse, AssignRequest/Response, LookupVolumeRequest,
# Location, LookupVolumeResponse
_SCHEMA = (
    b'\n\rweedtpu.proto\x12\x07weedtpu"\xf6\x01\n\x18VolumeInformationMes'
    b'sage\x12\n\n\x02id\x18\x01 \x01(\r\x12\x0c\n\x04size\x18\x02 \x01('
    b'\x04\x12\x12\n\ncollection\x18\x03 \x01(\t\x12\x12\n\nfile_count'
    b'\x18\x04 \x01(\x04\x12\x14\n\x0cdelete_count\x18\x05 \x01(\x04\x12'
    b'\x1a\n\x12deleted_byte_count\x18\x06 \x01(\x04\x12\x11\n\tread_only'
    b'\x18\x07 \x01(\x08\x12\x19\n\x11replica_placement\x18\x08 \x01(\t'
    b'\x12\x0b\n\x03ttl\x18\t \x01(\t\x12\x1a\n\x12modified_at_second\x18'
    b'\n \x01(\x03\x12\x0f\n\x07version\x18\x0b \x01(\r"t\n\x1fVolumeEcSh'
    b'ardInformationMessage\x12\n\n\x02id\x18\x01 \x01(\r\x12\x12\n\ncoll'
    b'ection\x18\x02 \x01(\t\x12\x0e\n\x06shards\x18\x03 \x03(\r\x12\x12'
    b'\n\nshard_size\x18\x04 \x01(\x04\x12\r\n\x05codec\x18\x05 \x01(\t"'
    b'\xfc\x01\n\tHeartbeat\x12\n\n\x02id\x18\x01 \x01(\t\x12\x0b\n\x03ur'
    b'l\x18\x02 \x01(\t\x12\x12\n\npublic_url\x18\x03 \x01(\t\x12\x13\n'
    b'\x0bdata_center\x18\x04 \x01(\t\x12\x0c\n\x04rack\x18\x05 \x01(\t'
    b'\x12\x18\n\x10max_volume_count\x18\x06 \x01(\r\x12\x14\n\x0cmax_fil'
    b'e_key\x18\x07 \x01(\x04\x122\n\x07volumes\x18\x08 \x03(\x0b2!.weedt'
    b'pu.VolumeInformationMessage\x12;\n\tec_shards\x18\t \x03(\x0b2(.wee'
    b'dtpu.VolumeEcShardInformationMessage">\n\x11HeartbeatResponse\x12'
    b'\x19\n\x11volume_size_limit\x18\x01 \x01(\x04\x12\x0e\n\x06leader'
    b'\x18\x02 \x01(\t"i\n\rAssignRequest\x12\r\n\x05count\x18\x01 \x01('
    b'\x04\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x13\n\x0breplication'
    b'\x18\x03 \x01(\t\x12\x0b\n\x03ttl\x18\x04 \x01(\t\x12\x13\n\x0bdata'
    b'_center\x18\x05 \x01(\t"i\n\x0eAssignResponse\x12\x0b\n\x03fid\x18'
    b'\x01 \x01(\t\x12\x0b\n\x03url\x18\x02 \x01(\t\x12\x12\n\npublic_url'
    b'\x18\x03 \x01(\t\x12\r\n\x05count\x18\x04 \x01(\x04\x12\r\n\x05erro'
    b'r\x18\x05 \x01(\t\x12\x0b\n\x03jwt\x18\x06 \x01(\t")\n\x13LookupVol'
    b'umeRequest\x12\x12\n\nvolume_ids\x18\x01 \x03(\t"+\n\x08Location'
    b'\x12\x0b\n\x03url\x18\x01 \x01(\t\x12\x12\n\npublic_url\x18\x02 '
    b'\x01(\t"\xbf\x01\n\x14LookupVolumeResponse\x12K\n\x13volume_id_loca'
    b'tions\x18\x01 \x03(\x0b2..weedtpu.LookupVolumeResponse.VolumeIdLoca'
    b'tion\x1aZ\n\x10VolumeIdLocation\x12\x11\n\tvolume_id\x18\x01 \x01('
    b'\t\x12$\n\tlocations\x18\x02 \x03(\x0b2\x11.weedtpu.Location\x12\r'
    b'\n\x05error\x18\x03 \x01(\tb\x06proto3'
)

_lock = threading.Lock()
_mod = None


def _load():
    """The message classes as attributes (`.Heartbeat`, as on the
    reference's generated module), built once from `_SCHEMA`; None when
    `google.protobuf` cannot be imported."""
    global _mod
    with _lock:
        if _mod is None:
            try:
                from google.protobuf import descriptor_pb2, descriptor_pool
                from google.protobuf import message_factory
            except ImportError:
                return None
            pool = descriptor_pool.DescriptorPool()
            pool.Add(descriptor_pb2.FileDescriptorProto.FromString(_SCHEMA))
            # the heartbeat is the one message a port server frames;
            # the master's messages come with it (ROADMAP 1.18a)
            _mod = types.SimpleNamespace(
                Heartbeat=message_factory.GetMessageClass(
                    pool.FindMessageTypeByName("weedtpu.Heartbeat")))
        return _mod


def available() -> bool:
    return _load() is not None


def messages():
    """The message classes; raises if unavailable."""
    mod = _load()
    if mod is None:
        raise RuntimeError("protobuf wire layer unavailable: "
                           "google.protobuf cannot be imported")
    return mod


# -- Heartbeat dict <-> message bridging (the JSON shapes stay the
# source of truth; protobuf is an alternate framing of the same data) --

def heartbeat_to_bytes(beat: dict) -> bytes:
    m = messages()
    hb = m.Heartbeat(
        id=beat.get("id", ""), url=beat.get("url", ""),
        public_url=beat.get("public_url", ""),
        data_center=beat.get("data_center", ""),
        rack=beat.get("rack", ""),
        max_volume_count=int(beat.get("max_volume_count", 0)),
        max_file_key=int(beat.get("max_file_key", 0)))
    for v in beat.get("volumes", []):
        hb.volumes.add(
            id=int(v.get("id", 0)), size=int(v.get("size", 0)),
            collection=v.get("collection", "") or "",
            file_count=int(v.get("file_count", 0)),
            delete_count=int(v.get("delete_count", 0)),
            deleted_byte_count=int(v.get("deleted_bytes", 0)),
            read_only=bool(v.get("read_only", False)),
            replica_placement=str(v.get("replica_placement", "000")),
            ttl=str(v.get("ttl", "") or ""),
            modified_at_second=int(v.get("modified_at", 0)),
            version=int(v.get("version", 0)))
    for e in beat.get("ec_shards", []):
        hb.ec_shards.add(id=int(e.get("id", 0)),
                         collection=e.get("collection", "") or "",
                         shards=[int(s) for s in e.get("shard_ids", [])],
                         shard_size=int(e.get("shard_size", 0)),
                         codec=e.get("codec", "") or "")
    return hb.SerializeToString()


def heartbeat_from_bytes(raw: bytes) -> dict:
    m = messages()
    hb = m.Heartbeat()
    hb.ParseFromString(raw)
    return {
        "id": hb.id, "url": hb.url, "public_url": hb.public_url,
        "data_center": hb.data_center, "rack": hb.rack,
        "max_volume_count": hb.max_volume_count,
        "max_file_key": hb.max_file_key,
        "volumes": [{
            # proto3 zero-default: a 0 version means "unset" — omit it so
            # the consumer's CURRENT_VERSION default applies, matching a
            # JSON beat that never carried the key
            **({"version": v.version} if v.version else {}),
            "id": v.id, "size": v.size, "collection": v.collection,
            "file_count": v.file_count, "delete_count": v.delete_count,
            "deleted_bytes": v.deleted_byte_count,
            "read_only": v.read_only,
            "replica_placement": v.replica_placement,
            "ttl": v.ttl, "modified_at": v.modified_at_second,
        } for v in hb.volumes],
        "ec_shards": [{
            # empty codec = a pre-codec-family node: consumers default rs
            **({"codec": e.codec} if e.codec else {}),
            "id": e.id, "collection": e.collection,
            "shard_ids": list(e.shards),
            "shard_size": e.shard_size,
        } for e in hb.ec_shards],
    }
