"""Filer entry model: directory entries with attributes + chunk lists.

Counterpart of `seaweedfs_tpu/filer/entry.py`, whole: the same JSON
codec, so a store written by either package reads in the other.

Capability parity with the reference's entry model (weed/filer/entry.go,
entry_codec.go): an Entry is a path plus attributes plus an ordered list of
FileChunk refs into the blob store; directories are entries with no chunks
and the dir mode bit. The reference serialises with protobuf
(filer_pb.Entry); here the store codec is canonical JSON — same fields,
human-debuggable, and the store SPI stays codec-agnostic.
"""

from __future__ import annotations

import json
import stat
import time
from dataclasses import dataclass, field


def join_path(directory: str, name: str) -> str:
    if directory.endswith("/"):
        return directory + name
    return f"{directory}/{name}"


def split_path(full_path: str) -> tuple[str, str]:
    """/a/b/c -> ("/a/b", "c"); "/" -> ("/", "")."""
    full_path = full_path.rstrip("/") or "/"
    if full_path == "/":
        return "/", ""
    d, _, n = full_path.rpartition("/")
    return d or "/", n


@dataclass
class FileChunk:
    """One blob-store chunk of a file (reference: filer_pb.FileChunk used by
    weed/filer/filechunks.go). `mtime` is the modified-at nanosecond stamp
    that decides overwrite precedence between overlapping chunks."""

    fid: str
    offset: int          # logical byte offset inside the file
    size: int            # chunk length in bytes
    mtime: int = 0       # ns; later wins on overlap
    etag: str = ""
    cipher_key: bytes = b""
    is_compressed: bool = False
    is_chunk_manifest: bool = False

    def to_dict(self) -> dict:
        d = {"fid": self.fid, "offset": self.offset, "size": self.size,
             "mtime": self.mtime}
        if self.etag:
            d["etag"] = self.etag
        if self.cipher_key:
            d["cipher_key"] = self.cipher_key.hex()
        if self.is_compressed:
            d["is_compressed"] = True
        if self.is_chunk_manifest:
            d["is_chunk_manifest"] = True
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "FileChunk":
        return cls(fid=d["fid"], offset=d["offset"], size=d["size"],
                   mtime=d.get("mtime", 0), etag=d.get("etag", ""),
                   cipher_key=bytes.fromhex(d["cipher_key"]) if d.get("cipher_key") else b"",
                   is_compressed=d.get("is_compressed", False),
                   is_chunk_manifest=d.get("is_chunk_manifest", False))


@dataclass
class Attr:
    """Entry attributes (reference: weed/filer/entry.go Attr)."""

    mtime: float = 0.0
    crtime: float = 0.0
    mode: int = 0o660
    uid: int = 0
    gid: int = 0
    mime: str = ""
    ttl_sec: int = 0
    user_name: str = ""
    group_names: list[str] = field(default_factory=list)
    symlink_target: str = ""
    md5: str = ""
    file_size: int = 0
    rdev: int = 0
    inode: int = 0

    @property
    def is_directory(self) -> bool:
        return stat.S_ISDIR(self.mode)


@dataclass
class Entry:
    full_path: str
    attr: Attr = field(default_factory=Attr)
    chunks: list[FileChunk] = field(default_factory=list)
    extended: dict[str, str] = field(default_factory=dict)
    hard_link_id: str = ""
    hard_link_counter: int = 0
    remote_mtime: float = 0.0  # remote-storage mapping stamp
    quota: int = 0

    @property
    def directory(self) -> str:
        return split_path(self.full_path)[0]

    @property
    def name(self) -> str:
        return split_path(self.full_path)[1]

    @property
    def is_directory(self) -> bool:
        return self.attr.is_directory

    def size(self) -> int:
        """Logical file size: max attr.file_size and chunk extents
        (reference: entry.go Size())."""
        end = max((c.offset + c.size for c in self.chunks), default=0)
        return max(self.attr.file_size, end)

    # -- codec ---------------------------------------------------------

    def to_dict(self) -> dict:
        a = self.attr
        d = {
            "full_path": self.full_path,
            "attr": {
                "mtime": a.mtime, "crtime": a.crtime, "mode": a.mode,
                "uid": a.uid, "gid": a.gid, "mime": a.mime,
                "ttl_sec": a.ttl_sec, "user_name": a.user_name,
                "group_names": a.group_names,
                "symlink_target": a.symlink_target, "md5": a.md5,
                "file_size": a.file_size, "rdev": a.rdev, "inode": a.inode,
            },
            "chunks": [c.to_dict() for c in self.chunks],
        }
        if self.extended:
            d["extended"] = self.extended
        if self.hard_link_id:
            d["hard_link_id"] = self.hard_link_id
            d["hard_link_counter"] = self.hard_link_counter
        if self.remote_mtime:
            d["remote_mtime"] = self.remote_mtime
        if self.quota:
            d["quota"] = self.quota
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Entry":
        a = d.get("attr", {})
        return cls(
            full_path=d["full_path"],
            attr=Attr(mtime=a.get("mtime", 0.0), crtime=a.get("crtime", 0.0),
                      mode=a.get("mode", 0o660), uid=a.get("uid", 0),
                      gid=a.get("gid", 0), mime=a.get("mime", ""),
                      ttl_sec=a.get("ttl_sec", 0),
                      user_name=a.get("user_name", ""),
                      group_names=list(a.get("group_names", [])),
                      symlink_target=a.get("symlink_target", ""),
                      md5=a.get("md5", ""), file_size=a.get("file_size", 0),
                      rdev=a.get("rdev", 0), inode=a.get("inode", 0)),
            chunks=[FileChunk.from_dict(c) for c in d.get("chunks", [])],
            extended=dict(d.get("extended", {})),
            hard_link_id=d.get("hard_link_id", ""),
            hard_link_counter=d.get("hard_link_counter", 0),
            remote_mtime=d.get("remote_mtime", 0.0),
            quota=d.get("quota", 0))

    def encode(self) -> bytes:
        return json.dumps(self.to_dict(), separators=(",", ":")).encode()

    @classmethod
    def decode(cls, blob: bytes) -> "Entry":
        return cls.from_dict(json.loads(blob))


def new_directory_entry(full_path: str, mode: int = 0o770,
                        uid: int = 0, gid: int = 0) -> Entry:
    now = time.time()
    return Entry(full_path=full_path,
                 attr=Attr(mtime=now, crtime=now,
                           mode=stat.S_IFDIR | (mode & 0o7777),
                           uid=uid, gid=gid))


def parent_directories(full_path: str) -> list[str]:
    """All ancestor dirs of /a/b/c -> ["/", "/a", "/a/b"] (root first)."""
    directory = split_path(full_path)[0]
    if directory == "/":
        return ["/"]
    parts = directory.strip("/").split("/")
    out = ["/"]
    for i in range(len(parts)):
        out.append("/" + "/".join(parts[: i + 1]))
    return out


def ttl_expired(entry: Entry, now: float | None = None) -> bool:
    if entry.attr.ttl_sec <= 0:
        return False
    return (now or time.time()) > entry.attr.crtime + entry.attr.ttl_sec


def etag_of(entry: Entry) -> str:
    """ETag: md5 when known, else a chunk-derived tag
    (reference: filer/filechunks.go ETagEntry)."""
    if entry.attr.md5:
        return entry.attr.md5
    if not entry.chunks:
        return ""
    if len(entry.chunks) == 1:
        return entry.chunks[0].etag
    import hashlib
    h = hashlib.md5()
    for c in entry.chunks:
        h.update(c.etag.encode() or c.fid.encode())
    return f"{h.hexdigest()}-{len(entry.chunks)}"
