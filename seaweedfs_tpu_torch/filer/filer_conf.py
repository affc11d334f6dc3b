"""Counterpart of `seaweedfs_tpu/filer/filer_conf.py`, whole.

Per-path-prefix storage rules (reference: weed/filer/filer_conf.go,
stored at /etc/seaweedfs/filer.conf inside the filer itself). A rule binds
a path prefix to collection / replication / ttl / fsync / disk settings;
the longest matching prefix wins."""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field

CONF_KEY = b"filer.conf"
CONF_PATH = "/etc/seaweedfs/filer.conf"


@dataclass
class PathConf:
    location_prefix: str = "/"
    collection: str = ""
    replication: str = ""
    ttl: str = ""
    fsync: bool = False
    disk_type: str = ""
    read_only: bool = False
    max_file_name_length: int = 0


@dataclass
class FilerConf:
    rules: list[PathConf] = field(default_factory=list)

    def match(self, path: str) -> PathConf:
        best = PathConf()
        best_len = -1
        for r in self.rules:
            if path.startswith(r.location_prefix) and \
                    len(r.location_prefix) > best_len:
                best, best_len = r, len(r.location_prefix)
        return best

    def upsert(self, rule: PathConf) -> None:
        self.rules = [r for r in self.rules
                      if r.location_prefix != rule.location_prefix]
        self.rules.append(rule)
        self.rules.sort(key=lambda r: r.location_prefix)

    def delete_prefix(self, prefix: str) -> None:
        self.rules = [r for r in self.rules if r.location_prefix != prefix]

    def to_json(self) -> str:
        return json.dumps({"locations": [asdict(r) for r in self.rules]},
                          indent=2)

    @classmethod
    def from_json(cls, raw: str | bytes) -> "FilerConf":
        if not raw:
            return cls()
        d = json.loads(raw)
        return cls(rules=[PathConf(**{k: v for k, v in r.items()
                                      if k in PathConf.__dataclass_fields__})
                          for r in d.get("locations", [])])


def load_filer_conf(store) -> FilerConf:
    from seaweedfs_tpu_torch.filer.filerstore import NotFound
    try:
        return FilerConf.from_json(store.kv_get(CONF_KEY))
    except NotFound:
        return FilerConf()


def save_filer_conf(store, conf: FilerConf) -> None:
    store.kv_put(CONF_KEY, conf.to_json().encode())
