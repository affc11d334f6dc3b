"""filer.sync: continuous (optionally bidirectional) filer to filer
replication over the meta-event subscribe stream, with persisted resume
offsets, signature-based loop prevention and the geo-replication
observatory's lag plane.

Counterpart of `seaweedfs_tpu/replication/filer_sync.py` (reference:
weed/command/filer_sync.go doSubscribeFilerMetaChanges,
weed/replication/track_sync_offset.go), whole.  The direction src->dst
stamps every write with sig(src) (the `X-Weed-Signatures` header) and
skips any event already stamped sig(dst), so a write that came from the
other direction does not echo back.  The offsets file is the reference's
JSON (`{"src=>dst": ts_ns}`), so a pump of either package resumes from
the other's.  `filer_signature` is also what the filer server's peer
aggregator stamps on the events it relays.

Observatory (``WEEDTPU_GEO_OBS=0`` turns it off, read per event):
lag (now minus the last applied or confirmed source event's ts; live
keepalives confirm), backlog (source meta-log events newer than the
resume offset, polled from the source's ``/__meta__/digest`` on connect,
on stream errors and at most every ``WEEDTPU_SYNC_BACKLOG_INTERVAL``
seconds while streaming), stalled (no progress for
``WEEDTPU_SYNC_STALL_AFTER`` seconds while the stream errors), a sampled
``sync.apply`` root span per applied event, and the WAN ledger (sink
writes inside ``netflow.wan(remote_region)``).  Reconnects pace on a
decorrelated-jitter `Backoff` (``WEEDTPU_SYNC_BACKOFF_BASE``, ``_CAP``)
and spend class=replication retry-budget tokens.

Kept apart from the reference on purpose (each pinned by a test):
- every knob above is read when a `SyncDirection` is built too, and a
  malformed one raises ValueError there, before any thread starts; the
  reference raises only inside its pump thread, which then dies, or
  reads anything but "0" as on;
- `FilerSync.stop` (and `SyncDirection.abort`) cuts each pump's live
  `/__meta__/subscribe` stream, so the threads end at once; the
  reference's wait in their read until the source's next keepalive or
  event, up to its 5 s join.

No torch is loaded: the pump reads files through the source filer, whose
volume servers run the kernels (a degraded read of a chunk on a lost
data shard launches K1 there).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import urllib.parse
import urllib.request
import zlib

from seaweedfs_tpu_torch.replication.sink import FilerSink, Replicator
from seaweedfs_tpu_torch.security.tls import scheme as _tls_scheme
from seaweedfs_tpu_torch.stats import netflow as _netflow
from seaweedfs_tpu_torch.stats import trace as _trace
from seaweedfs_tpu_torch.utils import resilience as _res
from seaweedfs_tpu_torch.utils.http import PooledHTTP, shutdown_response

MAX_APPLY_RETRIES = 5

log = logging.getLogger("filer.sync")


def geo_obs_enabled() -> bool:
    """Observatory switch, read per event (a bench can flip it between
    interleaved reps to price the lag plane itself); a value other than
    0 or 1 raises ValueError."""
    return _res.env_switch("WEEDTPU_GEO_OBS")


def _sync_backoff() -> "_res.Backoff":
    return _res.Backoff(
        base=_res._env_float("WEEDTPU_SYNC_BACKOFF_BASE", 0.5),
        cap=_res._env_float("WEEDTPU_SYNC_BACKOFF_CAP", 15.0))


def stall_after_s() -> float:
    return _res._env_float("WEEDTPU_SYNC_STALL_AFTER", 30.0)


def backlog_interval_s() -> float:
    return _res._env_float("WEEDTPU_SYNC_BACKLOG_INTERVAL", 5.0)


def filer_signature(filer_url: str) -> int:
    return zlib.crc32(filer_url.encode()) & 0x7FFFFFFF or 1


class SyncOffsetStore:
    """Resume offsets persisted to a local JSON file
    (reference: replication/track_sync_offset.go persists in the filer)."""

    def __init__(self, path: str | None):
        self.path = path
        self._data: dict[str, int] = {}
        self._lock = threading.Lock()  # both sync directions share one store
        self._last_flush = 0.0
        if path and os.path.exists(path):
            try:
                with open(path) as f:
                    self._data = {k: int(v) for k, v in json.load(f).items()}
            except (OSError, ValueError):
                self._data = {}

    FLUSH_INTERVAL = 2.0  # seconds between on-disk offset snapshots

    def get(self, key: str) -> int:
        with self._lock:
            return self._data.get(key, 0)

    def put(self, key: str, ts_ns: int) -> None:
        """Update in memory; snapshot to disk at most every FLUSH_INTERVAL
        (events are idempotent, so a crash replays at most a couple of
        seconds — the reference also persists offsets periodically)."""
        import time as _time
        with self._lock:
            self._data[key] = ts_ns
            now = _time.monotonic()
            if self.path and now - self._last_flush >= self.FLUSH_INTERVAL:
                self._flush_locked()
                self._last_flush = now

    def flush(self) -> None:
        with self._lock:
            if self.path:
                self._flush_locked()

    def _flush_locked(self) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._data, f)
        os.replace(tmp, self.path)


class SyncDirection:
    """One src→dst pump."""

    def __init__(self, src: str, dst: str, prefix: str = "/",
                 offsets: SyncOffsetStore | None = None,
                 timeout: float = 60.0, sink=None,
                 region: str = "", remote_region: str = ""):
        """`sink` defaults to a FilerSink on `dst`; pass any
        ReplicationSink (e.g. LocalSink for filer.backup) to replicate
        into something other than a peer filer.  `region` names the
        pump's home region (it runs beside its SOURCE filer) and
        `remote_region` the sink's, for the WAN ledger and region
        faults; both default to "" — single-region pumps pay nothing."""
        self.src, self.dst = src, dst
        self.prefix = prefix
        self.offsets = offsets or SyncOffsetStore(None)
        self.key = f"{src}=>{dst}"
        # metric/trace label: region pair when known ("a->b"), else the
        # netloc pair — region names keep the label space bounded
        self.direction = (f"{region}->{remote_region}"
                          if region and remote_region else self.key)
        self.src_sig = filer_signature(src)
        self.dst_sig = filer_signature(dst)
        self.timeout = timeout
        self.region = region
        self.remote_region = remote_region
        # one pool for source reads, backlog polls, AND sink writes:
        # replication bytes ride the netflow ledger, breakers, and
        # deadline clamps like every other caller's
        self.http = PooledHTTP(timeout=timeout, role="replicator",
                               region=region)
        if sink is None:
            # retries=1: _apply owns the (budgeted, offset-replaying)
            # retry loop — a second layer inside the sink would multiply
            # worst-case stall detection into minutes
            sink = FilerSink(dst, signature=self.src_sig, timeout=timeout,
                             http=self.http, region=remote_region,
                             retries=1)
        self.replicator = Replicator(sink, self._read_source_file, prefix)
        self.applied = 0
        self.skipped = 0
        self.errors = 0
        self.backlog = 0
        self.stalled = False
        # progress clock: the timestamp replication is known caught up
        # to (applied event ts, or "now" on a live keepalive).  Lag is
        # now minus this.
        self.last_progress = time.time()
        self.last_trace_id = ""
        # every knob is read now, so a malformed one raises here and not
        # in the pump's thread
        geo_obs_enabled()
        stall_after_s()
        backlog_interval_s()
        self._backoff = _sync_backoff()
        self._last_backlog_poll = 0.0
        self._stop: threading.Event | None = None
        # the live subscribe stream, which abort() cuts
        self._resp = None
        self._resp_lock = threading.Lock()

    # -- observatory ------------------------------------------------------

    def _gauges(self):
        from seaweedfs_tpu_torch.stats import metrics as _metrics
        return _metrics

    def lag_s(self, now: float | None = None) -> float:
        return max(0.0, (now or time.time()) - self.last_progress)

    def _note_progress(self, event_ts_ns: int | None = None) -> None:
        """An event applied/skipped (confirmed up to its ts), or a live
        keepalive (confirmed up to now)."""
        now = time.time()
        self.last_progress = now if event_ts_ns is None \
            else min(now, event_ts_ns / 1e9)
        self._backoff.reset()
        if not geo_obs_enabled():
            return
        m = self._gauges()
        m.REPLICATION_LAG.labels(self.direction).set(self.lag_s(now))
        if self.stalled:
            self.stalled = False
            m.REPLICATION_STALLED.labels(self.direction).set(0)

    def _note_error(self) -> None:
        """A stream/apply error: refresh the lag gauge from the frozen
        progress clock and raise the stalled flag once the stall window
        has passed with no progress."""
        self.errors += 1
        if not geo_obs_enabled():
            return
        m = self._gauges()
        m.REPLICATION_ERRORS.labels(self.direction).inc()
        lag = self.lag_s()
        m.REPLICATION_LAG.labels(self.direction).set(lag)
        if lag > stall_after_s():
            self.stalled = True
            m.REPLICATION_STALLED.labels(self.direction).set(1)

    def _poll_backlog(self, force: bool = False) -> None:
        """Refresh backlog depth (source meta-log head minus our resume
        offset) from the source's digest endpoint — cheap head read, no
        tree walk.  Best effort: a dead source keeps the last value."""
        if not geo_obs_enabled():
            return
        now = time.monotonic()
        if not force and now - self._last_backlog_poll < \
                backlog_interval_s():
            return
        self._last_backlog_poll = now
        url = (f"{_tls_scheme()}://{self.src}/__meta__/digest?"
               + urllib.parse.urlencode({
                   "prefix": self.prefix, "digest": "0",
                   "since": str(self.offsets.get(self.key))}))
        try:
            status, _, body = self.http.request(url, timeout=self.timeout)
            if status != 200:
                return
            self.backlog = int(json.loads(body).get("backlog_events", 0))
            self._gauges().REPLICATION_BACKLOG.labels(self.direction).set(
                self.backlog)
        except (OSError, ValueError):
            pass

    def status(self) -> dict:
        return {"src": self.src, "dst": self.dst, "prefix": self.prefix,
                "region": self.region, "remote_region": self.remote_region,
                "applied": self.applied, "skipped": self.skipped,
                "errors": self.errors, "backlog": self.backlog,
                "direction": self.direction,
                "lag_s": round(self.lag_s(), 3), "stalled": self.stalled,
                "offset_ts_ns": self.offsets.get(self.key),
                "last_trace_id": self.last_trace_id}

    # -- pump -------------------------------------------------------------

    def _read_source_file(self, path: str) -> bytes:
        from seaweedfs_tpu_torch.replication.sink import HTTPStatusError
        url = f"{_tls_scheme()}://{self.src}{urllib.parse.quote(path)}"
        status, _, body = self.http.request(url, timeout=self.timeout)
        if status == 404:
            # the file was deleted/renamed after this event was logged;
            # a later event supersedes it — skip, don't stall the stream
            raise FileNotFoundError(path)
        if status >= 400:
            raise HTTPStatusError(status, url)
        return body

    def abort(self) -> None:
        """Cut the live subscribe stream, if one is open: a `run` whose
        `stop` is set then returns at once instead of at the source's
        next keepalive."""
        with self._resp_lock:
            resp = self._resp
        if resp is not None:
            shutdown_response(resp)

    def run(self, stop: threading.Event, live: bool = True) -> None:
        """Pump events until `stop` is set (or the replay drains when
        live=False)."""
        self._stop = stop
        while not stop.is_set():
            since = self.offsets.get(self.key)
            url = (f"{_tls_scheme()}://{self.src}/__meta__/subscribe?"
                   + urllib.parse.urlencode({
                       "since": str(since),
                       "prefix": self.prefix,
                       "live": "true" if live else "false"}))
            try:
                self._poll_backlog(force=True)
                with urllib.request.urlopen(url, timeout=self.timeout) as r:
                    with self._resp_lock:
                        self._resp = r
                    if stop.is_set():
                        return
                    for raw in r:
                        if stop.is_set():
                            return
                        line = raw.strip()
                        if not line:
                            # keepalive: the stream is live and drained —
                            # replication is caught up as of now
                            self._note_progress()
                            self._poll_backlog()
                            continue
                        ev = json.loads(line)
                        if not self._apply(ev, stop):
                            # event still failing after retries: reconnect
                            # from the last good offset rather than skip it
                            raise ConnectionError("replicate failed; "
                                                  "will retry from offset")
                if not live or stop.is_set():
                    return
            except (urllib.error.URLError, ConnectionError, OSError,
                    json.JSONDecodeError, TimeoutError) as e:
                if stop.is_set():
                    return
                if not live:
                    raise
                self._note_error()
                self._poll_backlog(force=True)
                delay = self._backoff.next()
                if not _res.spend_retry("replication"):
                    # budget exhausted: park at the cap — the damper
                    # working, not a bug (see utils/resilience.py)
                    delay = max(delay, self._backoff.cap)
                log.warning("%s: stream error, reconnecting in %.1fs: %s",
                            self.key, delay, e)
                stop.wait(delay)
            finally:
                with self._resp_lock:
                    self._resp = None

    def _replicate_observed(self, ev: dict) -> bool:
        """One replicate pass under the observatory: class=replication
        netflow, a fresh sampled root span both regions' servers will
        parent to, and WAN booking on the sink side (the sink enters
        ``wan(remote_region)`` itself — the source read is local)."""
        if not geo_obs_enabled():
            with _netflow.flow("replication"):
                return self.replicator.replicate(ev)
        t = _trace.new_root(sampled=True)
        tok = _trace._current.set(t)
        try:
            path = (ev.get("new_entry") or ev.get("old_entry")
                    or {}).get("full_path", "")
            with _netflow.flow("replication"), \
                    _trace.span("sync.apply", server="replicator",
                                direction=self.direction, path=path,
                                region=self.region):
                return self.replicator.replicate(ev)
        finally:
            _trace._current.reset(tok)
            self.last_trace_id = t.trace_id

    def _apply(self, ev: dict, stop: threading.Event | None = None) -> bool:
        """Apply one event; the offset advances ONLY on success so a
        transient sink failure re-replays instead of silently dropping
        (events are idempotent overwrites)."""
        stop = stop or self._stop
        if self.dst_sig in (ev.get("signatures") or []):
            self.skipped += 1  # originated on dst; don't echo back
            if geo_obs_enabled():
                self._gauges().REPLICATION_SKIPPED.labels(self.direction).inc()
            self._note_progress(ev["ts_ns"])
            self.offsets.put(self.key, ev["ts_ns"])
            return True
        path = (ev.get("new_entry") or ev.get("old_entry")
                or {}).get("full_path")

        def giveup(e: BaseException) -> bool:
            # deleted-at-source is handled by the caller, and client
            # errors (HTTP < 500) won't heal by retrying
            return isinstance(e, FileNotFoundError) or \
                getattr(e, "code", 500) < 500

        try:
            did = _res.retry_call(
                lambda: self._replicate_observed(ev),
                attempts=MAX_APPLY_RETRIES, base=self._backoff.base,
                cap=10.0, cls="replication", retry_on=(Exception,),
                giveup=giveup,
                sleep=(stop.wait if stop is not None else time.sleep))
        except FileNotFoundError:
            # source content gone; a later event will converge the sink
            self.skipped += 1
            if geo_obs_enabled():
                self._gauges().REPLICATION_SKIPPED.labels(self.direction).inc()
            self._note_progress(ev["ts_ns"])
            self.offsets.put(self.key, ev["ts_ns"])
            return True
        except Exception as e:
            log.warning("%s: replicate %s failed after %d tries: %s",
                        self.key, path, MAX_APPLY_RETRIES, e)
            self._note_error()
            return False
        if did:
            self.applied += 1
            if geo_obs_enabled():
                self._gauges().REPLICATION_APPLIED.labels(self.direction).inc()
        self._note_progress(ev["ts_ns"])
        self.offsets.put(self.key, ev["ts_ns"])
        return True


class FilerSync:
    """Bidirectional filer.sync (reference: weed filer.sync -a -b).

    With region names attached (the GeoCluster harness does), each
    direction labels its WAN bytes and the divergence auditor
    (stats/canary.DivergenceAuditor) rides along, proving both filers'
    subtree digests converge."""

    def __init__(self, filer_a: str, filer_b: str, prefix: str = "/",
                 offset_path: str | None = None, one_way: bool = False,
                 region_a: str = "", region_b: str = ""):
        offsets = SyncOffsetStore(offset_path)
        self.a2b = SyncDirection(filer_a, filer_b, prefix, offsets,
                                 region=region_a, remote_region=region_b)
        self.b2a = None if one_way else SyncDirection(
            filer_b, filer_a, prefix, offsets,
            region=region_b, remote_region=region_a)
        self.stop_event = threading.Event()
        self._threads: list[threading.Thread] = []
        self.auditor = None
        if not one_way:
            from seaweedfs_tpu_torch.stats.canary import DivergenceAuditor
            self.auditor = DivergenceAuditor(filer_a, filer_b, prefix,
                                             region_a=region_a,
                                             region_b=region_b)

    def start(self) -> None:
        for d in self.directions():
            th = threading.Thread(target=d.run, args=(self.stop_event,),
                                  daemon=True, name=f"sync-{d.key}")
            th.start()
            self._threads.append(th)
        if self.auditor is not None:
            self.auditor.start()

    def directions(self) -> list[SyncDirection]:
        return [d for d in (self.a2b, self.b2a) if d is not None]

    def status(self) -> dict:
        out = {"directions": {d.key: d.status()
                              for d in self.directions()}}
        if self.auditor is not None:
            out["audit"] = self.auditor.status()
        return out

    def stop(self) -> None:
        self.stop_event.set()
        for d in self.directions():
            d.abort()
        if self.auditor is not None:
            self.auditor.stop()
        for th in self._threads:
            th.join(5)
        for d in self.directions():
            d.http.close()
        self.a2b.offsets.flush()  # both directions share the store

    def run_forever(self) -> None:
        self.start()
        try:
            while True:
                self.stop_event.wait(3600)
        except KeyboardInterrupt:
            self.stop()
