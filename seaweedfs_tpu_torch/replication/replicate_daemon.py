"""Queue-driven replicate daemon (filer.replicate).

Counterpart of `seaweedfs_tpu/replication/replicate_daemon.py`
(reference: `weed filer.replicate`, weed/command/filer_replicate.go:23-80),
whole: consume filer meta events from a notification queue and apply
each to a `ReplicationSink`, resuming from a persisted offset after a
restart, in the same `SyncOffsetStore` file format the sync pump uses.
Sources mirror weed/replication/sub/notifications.go's input registry:
`LogFileSource` tails the `LogQueue`'s JSONL file (either package's: the
lines are the same bytes), its offset the byte position after the last
applied line; `MemorySource` reads a `MemoryQueue`.  `read_file_via_filer`
fetches a file's content through the source filer.

`ReplicateDaemon.stop` joins the thread `run_in_thread` started (the
reference's sets the flag and returns).  No torch is loaded.
"""

from __future__ import annotations

import json
import logging
import threading

from seaweedfs_tpu_torch.replication.filer_sync import SyncOffsetStore
from seaweedfs_tpu_torch.replication.sink import Replicator, ReplicationSink

log = logging.getLogger("replication.replicate")


class NotificationSource:
    """Input side of the replicate daemon: yields (next_offset, event)."""

    name = "abstract"

    def receive(self, since: int, stop: threading.Event):
        raise NotImplementedError


class LogFileSource(NotificationSource):
    """Tail the notification LogQueue's JSONL file; the resume offset is
    the byte position after the last applied line, so a restarted daemon
    re-reads nothing and skips nothing (partial trailing lines — a writer
    mid-append — are left for the next poll)."""

    name = "log"

    def __init__(self, path: str, poll_interval: float = 0.2):
        self.path = path
        self.poll_interval = poll_interval

    def receive(self, since: int, stop: threading.Event):
        pos = since
        while not stop.is_set():
            try:
                f = open(self.path, "rb")
            except FileNotFoundError:
                if stop.wait(self.poll_interval):
                    return
                continue
            with f:
                f.seek(pos)
                while not stop.is_set():
                    line = f.readline()
                    if not line:
                        break
                    if not line.endswith(b"\n"):
                        break  # torn tail: re-read after the writer flushes
                    pos = f.tell()
                    s = line.strip()
                    if not s:
                        continue
                    try:
                        yield pos, json.loads(s)
                    except ValueError:
                        log.warning("skipping malformed event line at %d",
                                    pos)
            if stop.wait(self.poll_interval):
                return


class MemorySource(NotificationSource):
    """Consume a notification.MemoryQueue; the offset is the count of
    messages consumed from the queue since process start.  The queue's
    deque is bounded, so eviction is tracked via the queue's total send
    count — consuming resumes at (total - len(deque)) at worst, and a
    gap (evicted-before-read messages) is logged rather than silently
    skipped."""

    name = "memory"

    def __init__(self, queue, poll_interval: float = 0.05):
        self.queue = queue
        self.poll_interval = poll_interval

    def receive(self, since: int, stop: threading.Event):
        seen = since
        import contextlib
        # snapshot (sent, messages) under the queue's lock when it has
        # one: this used to snapshot the deque BEFORE reading sent, so a
        # send() racing between the two reads inflated `first` and an
        # event was skipped (or yielded under the wrong offset) without
        # any eviction having occurred.  The sent-before-snapshot order
        # alone is not enough either — append and the sent increment are
        # two bytecodes, and catching the gap after an eviction
        # mis-offsets msgs[0].
        lock = getattr(self.queue, "lock", None) or contextlib.nullcontext()
        while not stop.is_set():
            with lock:
                total = getattr(self.queue, "sent", None)
                msgs = list(self.queue.messages)
            if total is None:
                total = len(msgs)
            first = max(0, total - len(msgs))  # absolute index of msgs[0]
            if seen < first:
                log.warning("memory queue evicted %d unread events",
                            first - seen)
                seen = first
            while seen < total:
                _, message = msgs[seen - first]
                seen += 1
                yield seen, message
            if stop.wait(self.poll_interval):
                return


class ReplicateDaemon:
    """Pump source -> sink with offset persistence and per-event retry
    already inside the sink layer (sink.retry)."""

    def __init__(self, source: NotificationSource, sink: ReplicationSink,
                 read_file, prefix: str = "/",
                 offset_path: str | None = None,
                 offset_key: str | None = None):
        self.source = source
        self.replicator = Replicator(sink, read_file, prefix=prefix)
        self.offsets = SyncOffsetStore(offset_path)
        self.key = offset_key or f"replicate:{source.name}:{sink.name}"
        self.stop_event = threading.Event()
        self.applied = 0
        self._thread: threading.Thread | None = None

    def run(self) -> None:
        since = self.offsets.get(self.key)
        for offset, event in self.source.receive(since, self.stop_event):
            try:
                if self.replicator.replicate(event):
                    self.applied += 1
            except Exception:
                # the sink layer already retried with backoff; a still-
                # failing event must not wedge the stream forever — log
                # loudly and move the offset past it (the reference's
                # processEventFn error likewise skips after logging)
                log.exception("replicate failed for event at offset %s",
                              offset)
            self.offsets.put(self.key, offset)
        self.offsets.flush()

    def run_in_thread(self) -> threading.Thread:
        t = threading.Thread(target=self.run, name="filer-replicate",
                             daemon=True)
        t.start()
        self._thread = t
        return t

    def stop(self) -> None:
        self.stop_event.set()
        if self._thread is not None and \
                self._thread is not threading.current_thread():
            self._thread.join(30)


def read_file_via_filer(filer_url: str, timeout: float = 60.0):
    """File-content reader for sinks: fetch the path from the filer HTTP
    API (same shape SyncDirection._read_source_file uses)."""
    import urllib.parse
    import urllib.request
    from seaweedfs_tpu_torch.security.tls import scheme as _tls_scheme

    def read(path: str) -> bytes:
        url = f"{_tls_scheme()}://{filer_url}{urllib.parse.quote(path)}"
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.read()
    return read
