"""Filer metadata layer: entries, chunking, stores, event log.

Counterpart of `seaweedfs_tpu/filer/`, without its server (1.20b).  No
module here has a device or loads torch: the filer's chunks live on the
volume servers, and a read of a lost shard reaches the card through the
volume server's degraded read.
"""

from seaweedfs_tpu_torch.filer.entry import Attr, Entry, FileChunk  # noqa: F401
from seaweedfs_tpu_torch.filer.filer import Filer, MetaEvent  # noqa: F401
from seaweedfs_tpu_torch.filer.filerstore import (  # noqa: F401
    FilerStore, MemoryStore, NotFound, make_store)
from seaweedfs_tpu_torch.filer.abstract_sql import (  # noqa: F401
    AbstractSqlStore, MysqlStore, PostgresStore, SqliteStore)
# extra drivers register themselves in STORES on import (the analogue of
# the reference's blank-import registration, weed/command/imports.go)
from seaweedfs_tpu_torch.filer import stores_extra  # noqa: F401,E402
