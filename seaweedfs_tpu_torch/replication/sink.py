"""Replication sinks: apply a stream of filer meta events to a target.

Counterpart of `seaweedfs_tpu/replication/sink.py` (reference:
weed/replication/sink/replication_sink.go, CreateEntry / UpdateEntry /
DeleteEntry and IsIncremental, and the sinks under
weed/replication/sink/), whole: `FilerSink` (another filer over its HTTP
API, stamping the sync's signature header and booking cross-region bytes
into the WAN ledger), `LocalSink` (a directory tree), `CloudSink` (an
object store through a `remote_storage` client, incremental or not) and
the `s3`/`gcs`/`azure`/`b2` kinds over it, `make_sink`, the `Replicator`
that routes one meta event to a sink, and `retry`, the sinks' budgeted
retry over `resilience.retry_call`.  The headers, object keys and bytes a
sink writes are the reference's.  No torch is loaded.
"""

from __future__ import annotations

import logging
import os
import time
import urllib.parse
import urllib.request
from seaweedfs_tpu_torch.security.tls import scheme as _tls_scheme

log = logging.getLogger("replication.sink")


class HTTPStatusError(OSError):
    """An HTTP error status from a PooledHTTP call (which never raises
    on statuses itself).  Carries ``.code`` like urllib's HTTPError so
    the shared retry giveup can treat both the same."""

    def __init__(self, code: int, url: str):
        super().__init__(f"HTTP {code} from {url}")
        self.code = code
        self.url = url


def retry(fn, attempts: int = 4, base_delay: float = 0.5,
          retriable=(urllib.error.URLError, ConnectionError, OSError)):
    """Budgeted jittered retry for sink IO (reference: util.Retry wraps
    every sink write) — without it one transient 500 during filer.sync
    drops the event permanently.  Rides the unified resilience layer:
    decorrelated-jitter delays, and every retry spends a token from the
    process-wide budget so a down replication target can't storm.
    Client errors (HTTP < 500 — urllib HTTPError or our own
    HTTPStatusError) won't heal by retrying and raise immediately."""
    from seaweedfs_tpu_torch.utils import resilience

    def giveup(e: BaseException) -> bool:
        return getattr(e, "code", 500) < 500

    def wrapped():
        try:
            return fn()
        except retriable as e:
            log.warning("sink call failed (%s); may retry", e)
            raise

    return resilience.retry_call(
        wrapped, attempts=attempts, base=base_delay, cap=30.0,
        cls="replication",
        retry_on=(retriable if isinstance(retriable, tuple)
                  else (retriable,)),
        giveup=giveup)


def entry_is_directory(entry: dict) -> bool:
    """Entry dicts carry directoriness in attr.mode (S_IFDIR), matching
    Entry.to_dict / Attr.is_directory."""
    import stat
    if "is_directory" in entry:
        return bool(entry["is_directory"])
    return stat.S_ISDIR((entry.get("attr") or {}).get("mode", 0))


class ReplicationSink:
    """create/update/delete against a replication target."""

    name = "abstract"

    def create_entry(self, path: str, entry: dict, data: bytes | None) -> None:
        raise NotImplementedError

    def update_entry(self, path: str, entry: dict, data: bytes | None) -> None:
        self.create_entry(path, entry, data)

    def delete_entry(self, path: str, is_directory: bool) -> None:
        raise NotImplementedError

    def is_incremental(self) -> bool:
        """Incremental sinks only append dated copies, never delete
        (reference: IsIncremental + -filer.backup)."""
        return False


class FilerSink(ReplicationSink):
    """Replicate into another filer over its HTTP API, stamping the
    configured signature for sync-loop prevention.  Writes ride a
    PooledHTTP (deadline clamps, breakers, netflow/trace headers) —
    raw urllib kept replication bytes invisible to the byte ledger —
    and, when a remote region is named, run inside ``netflow.wan()``
    so the WAN ledger books every cross-region byte."""

    name = "filer"

    def __init__(self, filer_url: str, path_prefix: str = "/",
                 signature: int = 0, timeout: float = 60.0,
                 http=None, region: str = "", retries: int = 4):
        self.filer_url = filer_url
        self.prefix = path_prefix.rstrip("/")
        self.signature = signature
        self.timeout = timeout
        # sink-level retry attempts.  The sync pump passes 1: its _apply
        # loop already does budgeted retries AND re-replays from the
        # offset, and stacking the two layers multiplies worst-case
        # stall detection from seconds into minutes.  Standalone users
        # (filer.backup, cloud sinks) keep the default — this is their
        # only retry layer.
        self.retries = retries
        # the REMOTE region this sink writes toward ("" = same region)
        self.region = region
        if http is None:
            from seaweedfs_tpu_torch.utils.http import PooledHTTP
            http = PooledHTTP(timeout=timeout, role="replicator")
        self.http = http
        # transient, set per-event by the Replicator: the event's existing
        # signature chain, forwarded so ring topologies terminate
        self.event_signatures: list[int] = []

    def _headers(self) -> dict:
        sigs = [s for s in self.event_signatures if s]
        if self.signature:
            sigs.append(self.signature)
        return {"X-Weed-Signatures": ",".join(map(str, sigs))} if sigs else {}

    def _url(self, path: str) -> str:
        return f"{_tls_scheme()}://{self.filer_url}{urllib.parse.quote(self.prefix + path)}"

    def _request(self, url: str, method: str, body: bytes | None,
                 headers: dict, ok_statuses=()) -> None:
        from seaweedfs_tpu_torch.stats import netflow as _netflow
        if self.region:
            with _netflow.wan(self.region):
                status, _, _ = self.http.request(
                    url, method, body, headers, timeout=self.timeout)
        else:
            status, _, _ = self.http.request(
                url, method, body, headers, timeout=self.timeout)
        if status >= 400 and status not in ok_statuses:
            raise HTTPStatusError(status, url)

    def create_entry(self, path: str, entry: dict, data: bytes | None) -> None:
        if entry_is_directory(entry):
            url = self._url(path.rstrip("/") + "/")
            headers = self._headers()
            body: bytes = b""
        else:
            url = self._url(path)
            headers = self._headers()
            attr = entry.get("attr") or {}
            if attr.get("mime"):
                headers["Content-Type"] = attr["mime"]
            for k, v in (entry.get("extended") or {}).items():
                headers[f"Seaweed-{k}"] = v
            body = data or b""
        retry(lambda: self._request(url, "POST", body, headers),
              attempts=self.retries)

    def delete_entry(self, path: str, is_directory: bool) -> None:
        url = self._url(path) + "?recursive=true"
        # 404 tolerated: the entry may never have replicated
        retry(lambda: self._request(url, "DELETE", None, self._headers(),
                                    ok_statuses=(404,)),
              attempts=self.retries)


class LocalSink(ReplicationSink):
    """Replicate into a local directory (reference:
    weed/replication/sink/localsink)."""

    name = "local"

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def _p(self, path: str) -> str:
        return os.path.join(self.dir, path.lstrip("/"))

    def create_entry(self, path: str, entry: dict, data: bytes | None) -> None:
        p = self._p(path)
        if entry_is_directory(entry):
            os.makedirs(p, exist_ok=True)
            return
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "wb") as f:
            f.write(data or b"")

    def delete_entry(self, path: str, is_directory: bool) -> None:
        p = self._p(path)
        try:
            if is_directory:
                import shutil
                shutil.rmtree(p, ignore_errors=True)
            else:
                os.remove(p)
        except FileNotFoundError:
            pass


class CloudSink(ReplicationSink):
    """Replicate into an object store through a RemoteStorageClient wire
    client (reference: weed/replication/sink/{s3sink/s3_sink.go:30-70,
    gcssink,azuresink,b2sink}).  Object stores have no directories, so
    directory events are no-ops; incremental mode prefixes keys with the
    event date and never deletes (the reference's IsIncremental backup
    behavior)."""

    name = "cloud"

    def __init__(self, remote, key_prefix: str = "",
                 incremental: bool = False):
        self.remote = remote
        self.key_prefix = key_prefix.strip("/")
        self.incremental = incremental

    def _key(self, path: str) -> str:
        key = path.lstrip("/")
        if self.incremental:
            key = time.strftime("%Y-%m-%d") + "/" + key
        if self.key_prefix:
            key = self.key_prefix + "/" + key
        return key

    def is_incremental(self) -> bool:
        return self.incremental

    def create_entry(self, path: str, entry: dict, data: bytes | None) -> None:
        if entry_is_directory(entry):
            return
        retry(lambda: self.remote.write_file(self._key(path), data or b""))

    def delete_entry(self, path: str, is_directory: bool) -> None:
        if is_directory:
            # delete every object under the prefix (S3 has no rmdir);
            # skip directory placeholder entries some remotes yield —
            # delete_file on them would error and abort the fan-out
            prefix = self._key(path).rstrip("/") + "/"
            for ent in list(self.remote.traverse(prefix)):
                if ent.is_directory:
                    continue
                retry(lambda k=ent.key: self.remote.delete_file(k))
            return
        retry(lambda: self.remote.delete_file(self._key(path)))


def _cloud_sink_factory(kind: str):
    """Sink kinds s3/gcs/azure/b2 construct the matching wire client from
    seaweedfs_tpu_torch.remote_storage (b2 rides B2's S3-compatible endpoint, so
    it shares the SigV4 client the way the reference's b2sink shares the
    blazer API shape)."""
    def make(key_prefix: str = "", incremental=False, **remote_opts):
        from seaweedfs_tpu_torch import remote_storage
        remote_kind = "s3" if kind == "b2" else kind
        remote = remote_storage.make_remote(remote_kind, **remote_opts)
        # sink specs arrive as strings from the CLI ("incremental=false")
        if isinstance(incremental, str):
            incremental = incremental.lower() in ("true", "1", "yes")
        sink = CloudSink(remote, key_prefix=key_prefix,
                         incremental=incremental)
        sink.name = kind
        return sink
    return make


SINKS = {"filer": FilerSink, "local": LocalSink,
         "s3": _cloud_sink_factory("s3"), "gcs": _cloud_sink_factory("gcs"),
         "azure": _cloud_sink_factory("azure"),
         "b2": _cloud_sink_factory("b2")}


def make_sink(kind: str, **options) -> ReplicationSink:
    try:
        return SINKS[kind](**options)
    except KeyError:
        raise ValueError(f"unknown sink {kind!r} (have {sorted(SINKS)})")


class Replicator:
    """Routes one meta event to a sink (reference:
    weed/replication/replicator.go Replicate)."""

    def __init__(self, sink: ReplicationSink,
                 read_file: "callable[[str], bytes]",
                 prefix: str = "/"):
        self.sink = sink
        self.read_file = read_file
        self.prefix = prefix if prefix.endswith("/") else prefix + "/"

    def _in_scope(self, path: str) -> bool:
        return path.startswith(self.prefix) or path == self.prefix.rstrip("/")

    def replicate(self, event: dict) -> bool:
        """Apply one subscribe-stream event dict.  Returns True if the
        event resulted in a sink action."""
        # forward the event's signature chain (loop prevention must be
        # transitive across multi-filer rings)
        if hasattr(self.sink, "event_signatures"):
            self.sink.event_signatures = list(event.get("signatures") or [])
        old, new = event.get("old_entry"), event.get("new_entry")
        old_path = old.get("full_path") if old else None
        new_path = new.get("full_path") if new else None
        if new is not None:
            if not self._in_scope(new_path):
                # rename OUT of the synced subtree: drop the sink's copy of
                # the old path, or it diverges forever
                if old is not None and self._in_scope(old_path) and \
                        not self.sink.is_incremental():
                    self.sink.delete_entry(old_path, entry_is_directory(old))
                    return True
                return False
            data = None
            if not entry_is_directory(new):
                data = self.read_file(new_path)
            if old is not None and old_path != new_path and \
                    self._in_scope(old_path) and not self.sink.is_incremental():
                self.sink.delete_entry(old_path, entry_is_directory(old))
            if old is None:
                self.sink.create_entry(new_path, new, data)
            else:
                self.sink.update_entry(new_path, new, data)
            return True
        if old is not None and self._in_scope(old_path) and \
                not self.sink.is_incremental():
            self.sink.delete_entry(old_path, entry_is_directory(old))
            return True
        return False
