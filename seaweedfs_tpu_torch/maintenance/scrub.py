"""Syndrome scrub of EC volumes: find silent corruption before a client does.

Counterpart of the EC half of `seaweedfs_tpu/maintenance/scrub.py`.
Parity verification is a batched GF(2^8) product: each scrub window stacks
the k data-shard stripes into one [k, W] matrix, recomputes parity through
the same dispatch seam the encoder uses (`dispatch.parity_mismatch`, one
apply of the kernel K1 on the card per window, one launch per row block of
the parity matrix), and compares it with the stored parity shards.  A
mismatch is localised to the single corrupt shard by a per-candidate
consistency test on the mismatching byte columns (RS and LRC decode column
by column, so only those columns are re-derived, with the numpy reference
code of the volume's own code).  MSR couples the bytes of each alpha
block, so its windows are alpha multiples and its mismatches are found
but not localised.

Every window's bytes read go to ``weedtpu_scrub_bytes_total{kind="ec"}``
and its parity check is a `scrub.syndrome` span under a sampled trace.
The background Scrubber with its rate limiter, remote shard reader, pass
span and corruption counters needs a Store and comes with the serving
top (ROADMAP 1.15).
"""

from __future__ import annotations

import numpy as np

from seaweedfs_tpu_torch.ops import dispatch, gf
from seaweedfs_tpu_torch.stats import metrics, trace

DEFAULT_WINDOW = 1024 * 1024  # syndrome window, bytes of each shard
# columns fed to the corrupt-shard localiser: RS is column-independent, so
# a handful of mismatching columns identify the shard as well as all of them
LOCALIZE_COLS = 1024


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


def syndrome_scan(ev, stats: dict | None = None) -> list[dict]:
    """Walk an EcVolume's shard files window by window and verify parity.

    Each window reads the same [off, off+W) slice (W = DEFAULT_WINDOW,
    cut to an alpha multiple for MSR) of every readable shard, recomputes
    parity from the k data rows in one dispatch on the volume's codec, and
    compares it with the stored parity rows.  Windows where a data shard
    (or every parity shard) is unreadable are skipped and counted.

    Returns corrupt-range dicts {shard, offset, size, columns}; shard is -1
    when the corruption could not be localised to one shard (localising
    needs all n rows and an alpha = 1 code)."""
    codec = ev.codec
    spec = ev.spec
    window = DEFAULT_WINDOW
    if spec.alpha > 1:
        window = max(spec.alpha, window - window % spec.alpha)
    k, m = spec.k, spec.m
    out: list[dict] = []
    for off in range(0, ev.shard_size, window):
        n = min(window, ev.shard_size - off)
        rows: dict[int, np.ndarray] = {}
        for sid in range(spec.n):
            data = ev._read_local(sid, off, n)
            if data is not None:
                rows[sid] = np.frombuffer(data, dtype=np.uint8)
        got = sum(r.nbytes for r in rows.values())
        if stats is not None:
            stats["bytes"] = stats.get("bytes", 0) + got
        metrics.SCRUB_BYTES.labels("ec").inc(got)
        parity_have = {s - k: rows[s] for s in range(k, k + m) if s in rows}
        if any(i not in rows for i in range(k)) or not parity_have:
            if stats is not None:
                stats["windows_skipped"] = stats.get("windows_skipped", 0) + 1
            continue
        batch = np.stack([rows[i] for i in range(k)])
        with trace.span("scrub.syndrome", offset=off, bytes=batch.nbytes):
            masks = dispatch.parity_mismatch(codec, batch, parity_have)
        if stats is not None:
            stats["windows"] = stats.get("windows", 0) + 1
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
