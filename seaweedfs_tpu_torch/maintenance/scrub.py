"""Scrub: find silent corruption before a client does.

Counterpart of `seaweedfs_tpu/maintenance/scrub.py`.  One `Scrubber` runs
on each volume server.  A pass streams every store volume and every EC
volume of its Store at a bounded rate (WEEDTPU_SCRUB_MBPS):

- store volumes: each live needle is re-read and its CRC32-C (the port's
  host library, csrc/crc32c.cc) recomputed against the stored checksum,
  and the record's id checked against the index entry that routed there;
- EC volumes: parity verification is a batched GF(2^8) product.  Each
  window stacks the k data-shard stripes into one [k, W] matrix,
  recomputes parity through the dispatch seam the encoder uses
  (`dispatch.parity_mismatch`, one apply of the kernel K1 on the card per
  window, one launch per row block of the parity matrix) on the volume's
  own codec, and compares it with the stored parity shards.  A mismatch
  is localised to the single corrupt shard by a per-candidate
  consistency test on the mismatching byte columns (RS and LRC decode
  column by column, so only those columns are re-derived, with the numpy
  reference code of the volume's own code).  MSR couples the bytes of
  each alpha block, so its windows are alpha multiples and its
  mismatches are found but not localised.

Corrupt EC ranges are quarantined on the owning EcVolume (reads of the
range reconstruct from the other shards), and each pass's verdicts go to
`report(summary)`, which the volume server posts to the master's repair
planner.  Every byte read counts in ``weedtpu_scrub_bytes_total{kind}``,
every corruption in ``weedtpu_scrub_corruptions_total{kind}``; a pass is
a `scrub.pass` span under a sampled root, each window's parity check a
`scrub.syndrome` span.

Knobs, under the reference's names and defaults; a malformed value
raises ValueError where the reference falls back: WEEDTPU_SCRUB_MBPS
(8; 0 disables the volume server's scrubber), WEEDTPU_SCRUB_INTERVAL
(300 s between passes), WEEDTPU_SCRUB_WINDOW (1 MiB), WEEDTPU_SCRUB_REMOTE
(1: windows missing local shards fetch them through the server's shard
reader; 0 or unset: only locally assembled windows are checked).
"""

from __future__ import annotations

import logging
import os
import threading
import time

import numpy as np

from seaweedfs_tpu_torch.ops import dispatch, gf
from seaweedfs_tpu_torch.stats import metrics, netflow, trace
from seaweedfs_tpu_torch.storage import needle as ndl
from seaweedfs_tpu_torch.storage import types as t

log = logging.getLogger("scrub")

DEFAULT_MBPS = 8.0          # WEEDTPU_SCRUB_MBPS: sustained scrub rate
DEFAULT_INTERVAL = 300.0    # WEEDTPU_SCRUB_INTERVAL: seconds between passes
DEFAULT_WINDOW = 1024 * 1024  # WEEDTPU_SCRUB_WINDOW: syndrome window bytes
# columns fed to the corrupt-shard localiser: RS is column-independent, so
# a handful of mismatching columns identify the shard as well as all of them
LOCALIZE_COLS = 1024


def env_mbps() -> float:
    """WEEDTPU_SCRUB_MBPS: a number >= 0 (0 disables scrubbing)."""
    raw = os.environ.get("WEEDTPU_SCRUB_MBPS", "").strip()
    if not raw:
        return DEFAULT_MBPS
    try:
        val = float(raw)
    except ValueError:
        val = -1.0
    if not val >= 0:
        raise ValueError(f"WEEDTPU_SCRUB_MBPS={raw!r}: want a number >= 0")
    return val


def _env_interval() -> float:
    raw = os.environ.get("WEEDTPU_SCRUB_INTERVAL", "").strip()
    if not raw:
        return DEFAULT_INTERVAL
    try:
        val = float(raw)
    except ValueError:
        val = 0.0
    if not val > 0:
        raise ValueError(f"WEEDTPU_SCRUB_INTERVAL={raw!r}: want seconds > 0")
    return val


def _env_window() -> int | None:
    """WEEDTPU_SCRUB_WINDOW; None when unset (DEFAULT_WINDOW at scan
    time)."""
    raw = os.environ.get("WEEDTPU_SCRUB_WINDOW", "").strip()
    if not raw:
        return None
    try:
        val = int(raw)
    except ValueError:
        val = 0
    if val < 1:
        raise ValueError(f"WEEDTPU_SCRUB_WINDOW={raw!r}: want bytes >= 1")
    return val


def _env_remote() -> bool:
    raw = os.environ.get("WEEDTPU_SCRUB_REMOTE", "").strip()
    if raw not in ("", "0", "1"):
        raise ValueError(f"WEEDTPU_SCRUB_REMOTE={raw!r}: want 0 or 1")
    return raw == "1"


class RateLimiter:
    """Byte-budget throttle: sustained `bytes_per_s` with a small burst
    allowance, so per-needle accounting does not turn into thousands of
    sub-millisecond sleeps."""

    def __init__(self, bytes_per_s: float, burst_s: float = 0.25):
        self.rate = float(bytes_per_s)
        self.burst = burst_s
        self._next = time.monotonic()

    def set_rate(self, bytes_per_s: float) -> None:
        """Retarget the rate live (a float store, atomic under the GIL;
        the scrub thread reads it per chunk, so a push lands mid-pass)."""
        self.rate = float(bytes_per_s)

    def throttle(self, nbytes: int) -> None:
        # read the rate once: set_rate flips it from another thread, and
        # the zero check must guard the value divided by
        rate = self.rate
        if rate <= 0 or nbytes <= 0:
            return
        now = time.monotonic()
        # credit at most `burst` seconds of idle time, then advance the
        # schedule by this chunk's time at the target rate
        self._next = max(self._next, now - self.burst) + nbytes / rate
        delay = self._next - now
        if delay > 0:
            time.sleep(delay)


def localize_corrupt_shard(cols: np.ndarray, code) -> int | None:
    """Identify the single corrupt shard from the stored bytes at the
    mismatching byte columns.

    `cols` is [n, C] for the volume's code (any alpha = 1 code with
    `reconstruct_numpy` and `parity_matrix`: RS, LRC).  For each candidate
    shard, reconstruct it from the other n-1 and test whether the stripe
    becomes consistent (all m parity rows match a recompute from the data
    rows).  With one corrupt shard exactly one candidate passes.  Returns
    None when zero or several pass: more than one shard is corrupt in this
    window."""
    passing: list[int] = []
    for cand in range(code.n):
        others = {i: cols[i] for i in range(code.n) if i != cand}
        rows = dict(others)
        rows[cand] = code.reconstruct_numpy(others, wanted=[cand])[cand]
        data = np.stack([rows[i] for i in range(code.k)])
        parity = gf.gf_matmul(code.parity_matrix, data)
        if all(np.array_equal(parity[r], rows[code.k + r])
               for r in range(code.m)):
            passing.append(cand)
            if len(passing) > 1:
                return None
    return passing[0] if len(passing) == 1 else None


def syndrome_scan(ev, stats: dict | None = None, *,
                  window: int | None = None,
                  limiter: RateLimiter | None = None, shard_reader=None,
                  stop: threading.Event | None = None) -> list[dict]:
    """Walk an EcVolume's shard files window by window and verify parity.

    Each window reads the same [off, off+W) slice (W = `window`, else
    DEFAULT_WINDOW, cut to an alpha multiple for MSR) of every readable
    shard, a shard missing locally through `shard_reader(sid, off, n)`
    where one is given, recomputes parity from the k data rows in one
    dispatch on the volume's codec, and compares it with the stored
    parity rows.  Windows where a data shard (or every parity shard) is
    unreadable are skipped and counted.  `limiter` paces the bytes read;
    a set `stop` ends the walk at the next window.

    Returns corrupt-range dicts {shard, offset, size, columns}; shard is -1
    when the corruption could not be localised to one shard (localising
    needs all n rows and an alpha = 1 code)."""
    codec = ev.codec
    spec = ev.spec
    window = window or DEFAULT_WINDOW
    if spec.alpha > 1:
        window = max(spec.alpha, window - window % spec.alpha)
    k, m = spec.k, spec.m
    out: list[dict] = []
    for off in range(0, ev.shard_size, window):
        if stop is not None and stop.is_set():
            break
        n = min(window, ev.shard_size - off)
        rows: dict[int, np.ndarray] = {}
        for sid in range(spec.n):
            data = ev._read_local(sid, off, n)
            if (data is None or len(data) != n) and shard_reader is not None:
                data = shard_reader(sid, off, n)
            if data is not None and len(data) == n:
                rows[sid] = np.frombuffer(data, dtype=np.uint8)
        got = sum(r.nbytes for r in rows.values())
        if stats is not None:
            stats["bytes"] = stats.get("bytes", 0) + got
        metrics.SCRUB_BYTES.labels("ec").inc(got)
        parity_have = {s - k: rows[s] for s in range(k, k + m) if s in rows}
        if any(i not in rows for i in range(k)) or not parity_have:
            if stats is not None:
                stats["windows_skipped"] = stats.get("windows_skipped", 0) + 1
            if limiter is not None:
                limiter.throttle(got)
            continue
        batch = np.stack([rows[i] for i in range(k)])
        with trace.span("scrub.syndrome", offset=off, bytes=batch.nbytes):
            masks = dispatch.parity_mismatch(codec, batch, parity_have)
        if stats is not None:
            stats["windows"] = stats.get("windows", 0) + 1
        if limiter is not None:
            limiter.throttle(got)
        mism = np.zeros(n, dtype=bool)
        for mask in masks.values():
            mism |= mask
        bad_cols = np.nonzero(mism)[0]
        if bad_cols.size == 0:
            continue
        shard = -1
        if len(rows) == spec.n and spec.alpha == 1:
            sel = bad_cols[:LOCALIZE_COLS]
            loc = localize_corrupt_shard(
                np.stack([rows[i][sel] for i in range(spec.n)]),
                code=codec.code)
            if loc is not None:
                shard = loc
        out.append({"shard": shard, "offset": off, "size": n,
                    "columns": int(bad_cols.size)})
    return out


class Scrubber:
    """Rate-limited background scrub loop over one Store.

    `report(summary)` is called on the scrub thread after each background
    pass; the volume server posts it to the master's
    /maintenance/scrub_report.  `shard_reader_factory(vid)` supplies a
    remote shard reader for windows missing local shards when
    WEEDTPU_SCRUB_REMOTE=1.  The knobs are read once, here (the
    reference reads WEEDTPU_SCRUB_REMOTE at each pass); the interval and
    the window come from them alone.  The EC windows run on each
    EcVolume's own codec, built on the store's device."""

    def __init__(self, store, *, mbps: float | None = None,
                 report=None, shard_reader_factory=None):
        self.store = store
        self.mbps = mbps if mbps is not None else env_mbps()
        self.interval = _env_interval()
        self.window = _env_window()
        self.remote = _env_remote()
        self.report = report
        self.shard_reader_factory = shard_reader_factory
        # this node's configured rate: the governor's pushes scale it
        # (apply_governed_scale), never raise it to another node's
        self.configured_mbps = self.mbps
        self.last_scrub = 0.0
        self.last_summary: dict = {}
        self._stop = threading.Event()
        self._mu = threading.Lock()  # one pass at a time
        self._thread: threading.Thread | None = None
        # the pass in flight keeps its limiter here, so a retune lands
        # mid-pass
        self._limiter: RateLimiter | None = None
        # an operator's {"mbps": 0} sticks until the operator resumes:
        # the governor's re-pushes never un-pause a node
        self.operator_paused = False

    def set_mbps(self, mbps: float, governed: bool = False) -> float:
        """Retune the sustained rate (/admin/scrub_rate), for the pass in
        flight and every later one.  0 pauses: later passes skip and the
        one in flight stops at its next volume; the live limiter keeps
        its rate, since a zero-rate limiter means unthrottled.  A
        `governed` push (the interference governor's) is a no-op while
        an operator pause holds and never flips it; an operator's call
        sets it on 0 and releases it above.  Returns the rate in
        effect."""
        mbps = max(0.0, float(mbps))
        if governed:
            if self.operator_paused:
                return self.mbps
        else:
            self.operator_paused = mbps <= 0
            self.configured_mbps = mbps
        self.mbps = mbps
        lim = self._limiter
        if lim is not None and self.mbps > 0:
            lim.set_rate(self.mbps * 1e6)
        return self.mbps

    def apply_governed_scale(self, scale: float) -> float:
        """The governor's form: this node's configured rate times the
        fleet's backoff fraction, clamped to [0, 1]."""
        scale = max(0.0, min(1.0, float(scale)))
        return self.set_mbps(self.configured_mbps * scale, governed=True)

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "Scrubber":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run,
                                            name="scrubber", daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout)

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                summary = self.scrub_once()
            except Exception:
                log.warning("scrub pass failed", exc_info=True)
                continue
            if self.report is not None:
                try:
                    self.report(summary)
                except Exception:
                    log.warning("scrub report failed", exc_info=True)

    # -- one pass ------------------------------------------------------

    def scrub_once(self) -> dict:
        """One pass over every mounted volume; returns the summary that
        also goes upstream: {ts, bytes, volumes: {vid: verdict}}."""
        if self.mbps <= 0:
            return {"ts": time.time(), "bytes": 0, "volumes": {},
                    "paused": True}
        # remote shard bytes the pass pulls book as class scrub: the
        # reader factory captures the class on this thread
        with self._mu, netflow.flow("scrub"), \
                trace.span("scrub.pass", parent=trace.new_root()) \
                as pass_span:
            limiter = RateLimiter(self.mbps * 1e6)
            self._limiter = limiter
            vols: dict[str, dict] = {}
            total = 0
            for loc in self.store.locations:
                for vid, v in list(loc.volumes.items()):
                    if self._stop.is_set() or self.mbps <= 0:
                        break
                    if v.backend_kind == "remote":
                        continue  # a remote tier's reads cost money
                    try:
                        res = self._scrub_volume(vid, v, limiter)
                    except Exception as e:
                        res = {"kind": "normal", "error": str(e)}
                    vols[str(vid)] = res
                    total += res.get("bytes", 0)
                for vid, ev in list(loc.ec_volumes.items()):
                    if self._stop.is_set() or self.mbps <= 0:
                        break
                    try:
                        res = self._scrub_ec(vid, ev, limiter)
                    except Exception as e:
                        res = {"kind": "ec", "error": str(e)}
                    vols[str(vid)] = res
                    total += res.get("bytes", 0)
            pass_span.set(volumes=len(vols), bytes=total)
            self._limiter = None
            summary = {"ts": time.time(), "bytes": total, "volumes": vols}
            self.last_scrub = summary["ts"]
            self.last_summary = summary
            return summary

    def _scrub_volume(self, vid: int, v, limiter: RateLimiter) -> dict:
        res: dict = {"kind": "normal", "needles": 0, "bytes": 0,
                     "crc_mismatches": 0, "corrupt": []}
        for nid, (off, size) in list(v.nm.items()):
            if self._stop.is_set():
                break
            if not t.size_is_valid(size):
                continue
            try:
                n = v._read_at(off, size, verify_checksum=False)
                c = ndl.crc32c(n.data)
                ok = n.id == nid and \
                    n.checksum in (c, ndl.crc_legacy_value(c))
            except (ValueError, EOFError, OSError):
                ok = False
            nbytes = t.actual_size(size, v.version)
            res["needles"] += 1
            res["bytes"] += nbytes
            metrics.SCRUB_BYTES.labels("volume").inc(nbytes)
            if not ok:
                res["crc_mismatches"] += 1
                res["corrupt"].append({"needle": f"{nid:x}"})
                metrics.SCRUB_CORRUPTIONS.labels("needle").inc()
                log.warning("scrub: volume %d needle %x failed CRC "
                            "verification", vid, nid)
            limiter.throttle(nbytes)
        res["last_scrub"] = time.time()
        return res

    def _scrub_ec(self, vid: int, ev, limiter: RateLimiter) -> dict:
        res: dict = {"kind": "ec", "windows": 0, "windows_skipped": 0,
                     "bytes": 0}
        reader = None
        if self.shard_reader_factory is not None and self.remote:
            reader = self.shard_reader_factory(vid)
        corrupt = syndrome_scan(ev, res, window=self.window,
                                limiter=limiter, shard_reader=reader,
                                stop=self._stop)
        for c in corrupt:
            metrics.SCRUB_CORRUPTIONS.labels("ec_shard").inc()
            if c["shard"] >= 0:
                # reads of the range reconstruct from the other shards
                # until the repair planner rebuilds the shard
                ev.quarantine_range(c["shard"], c["offset"], c["size"])
            log.warning("scrub: ec volume %d parity mismatch at "
                        "[%d, +%d) -> shard %s", vid, c["offset"],
                        c["size"], c["shard"] if c["shard"] >= 0
                        else "unlocalized")
        res["corrupt"] = corrupt
        res["quarantined"] = ev.quarantine_snapshot()
        res["last_scrub"] = time.time()
        return res
