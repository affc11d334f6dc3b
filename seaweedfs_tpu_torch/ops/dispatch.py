"""Backend dispatch seam between the EC data path and the codec.

Counterpart of `seaweedfs_tpu/ops/dispatch.py`.  The storage layer needs
three things from a codec: dispatch a parity encode, materialise the result
on the host, and reconstruct missing rows.  On the card a dispatch is
asynchronous:

- H2D copies are `non_blocking` from pinned host buffers, on the calling
  thread's current stream, and the kernel is enqueued behind them;
- `dispatch_parity` ([k, B], kernel K1) and `dispatch_parity_batch`
  ([U, k, B], K2) return a `Pending` (the un-synced output tensor and a
  CUDA event recorded after the kernel);
- `materialize` is the sync point: it waits on that event, then copies the
  result D2H into pinned memory and hands back numpy;
- `reconstruct_batch` (rebuild) and `apply_matrix` (a repair helper's
  partial product, ops/regen.py) go through the same steps and return
  host bytes.

Every batch lands on the card in a buffer whose rows start 16 bytes
apart (`rows.device_empty`), the layout the kernel reads in place, so the
kernel wrapper never has to stage a copy of it (it does so only for a
view it cannot read in place, and counts each in `gf_cuda.STAGED`).

Synchronising on the event rather than on a stream matters because the
encode pipeline dispatches on one thread and drains on another, and each
thread has its own current stream.  On the CPU the codec computes eagerly
and the same calls return at once.

`COUNTERS` accumulates h2d / device / d2h seconds and bytes per process.
h2d seconds are the host's enqueue time; device seconds are the wait on
the event, which covers the copy and the kernel.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from seaweedfs_tpu_torch.ops.rows import device_empty, padded_width


class Counters:
    """Thread-safe running totals of the dispatch seam."""

    KEYS = ("calls", "h2d_s", "h2d_bytes", "device_s", "d2h_s", "d2h_bytes")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._v: dict[str, float] = dict.fromkeys(self.KEYS, 0)

    def reset(self) -> None:
        with self._lock:
            self._v = dict.fromkeys(self.KEYS, 0)

    def add(self, **kw) -> None:
        with self._lock:
            for key, v in kw.items():
                self._v[key] += v

    def snapshot(self) -> dict[str, float]:
        with self._lock:
            return dict(self._v)


COUNTERS = Counters()


def host_empty(shape, device: torch.device) -> torch.Tensor:
    """A uint8 host buffer for `device`'s transfers: pinned (page-locked)
    when the device is a card, so H2D/D2H copies run asynchronously at
    full link rate; plain memory on the CPU."""
    return torch.empty(shape, dtype=torch.uint8,
                       pin_memory=device.type == "cuda")


def _as_tensor(batch) -> torch.Tensor:
    return torch.from_numpy(batch) if isinstance(batch, np.ndarray) \
        else batch


@dataclass
class Pending:
    """An enqueued device result: the output tensor and the event recorded
    after the kernel that produces it."""
    tensor: torch.Tensor
    event: torch.cuda.Event


def _h2d(host: torch.Tensor, device: torch.device,
         staging: torch.Tensor | None) -> torch.Tensor:
    """Enqueue the copy of a [..., B] host batch ([k, B], or a [U, k, B]
    unit batch) to the card, row by row into `staging` ([..., >= B] from
    `device_empty`; a new one when None), so the kernel reads a [..., :B]
    view of the wider buffer."""
    if staging is None:
        staging = device_empty(tuple(host.shape), device)
    n = host.shape[-1]
    dst = staging[..., :n]
    for d, h in zip(dst.view(-1, n), host.view(-1, n)):
        d.copy_(h, non_blocking=True)
    return dst


def _dispatch(codec, apply, batch, staging: torch.Tensor | None):
    """Run `apply` (a codec method) on a host batch: eagerly on the CPU;
    on the card behind an enqueued H2D into `staging`, returning a
    `Pending`."""
    host = _as_tensor(batch)
    if codec.device.type == "cpu":
        COUNTERS.add(calls=1)
        return apply(host)
    t0 = time.perf_counter()
    dev = _h2d(host, codec.device, staging)
    t1 = time.perf_counter()
    out = apply(dev)
    ev = torch.cuda.Event()
    ev.record()
    COUNTERS.add(calls=1, h2d_s=t1 - t0, h2d_bytes=host.numel())
    return Pending(out, ev)


def dispatch_parity(codec, batch, staging: torch.Tensor | None = None):
    """Dispatch [k, B] -> [m, B] parity.  On the card the result comes back
    un-synced (a `Pending`); on the CPU it is computed eagerly."""
    return _dispatch(codec, codec.encode_parity, batch, staging)


def materialize(parity) -> np.ndarray:
    """Sync point of a dispatch: host results pass through; a `Pending`
    waits on its event and copies D2H into pinned memory."""
    if isinstance(parity, np.ndarray):
        return parity
    if isinstance(parity, torch.Tensor):
        return parity.numpy()
    t0 = time.perf_counter()
    parity.event.synchronize()
    t1 = time.perf_counter()
    host = host_empty(tuple(parity.tensor.shape), parity.tensor.device)
    host.copy_(parity.tensor)
    COUNTERS.add(device_s=t1 - t0, d2h_s=time.perf_counter() - t1,
                 d2h_bytes=host.numel())
    return host.numpy()


def dispatch_parity_batch(codec, units, staging: torch.Tensor | None = None):
    """Dispatch a [U, k, B] unit batch -> [U, m, B] parity in one kernel
    launch (K2), the fleet conversion's seam (ops/fleet_convert.py).

    On the card the pinned host batch is copied into `staging` (a
    `device_empty((U, k, B))` slot buffer, or a new one when None), whose
    unit and row strides are multiples of 16, so the kernel reads it in
    place; the result comes back un-synced as a `Pending`, and
    `materialize` is its sync point.  On the CPU it is computed eagerly."""
    return _dispatch(codec, codec.encode_parity_batch, units, staging)


def reconstruct_batch(codec, shards: dict[int, np.ndarray],
                      wanted: list[int]) -> dict[int, np.ndarray]:
    """Rebuild `wanted` shard rows from >= k survivor rows (host bytes in
    and out) in one kernel launch.  The survivors the decode reads are
    packed into one padded host stack, copied to the card in one transfer
    and read there in place."""
    if not wanted:
        return {}
    basis, mat = codec.decoder(tuple(sorted(shards)), tuple(wanted))
    n = len(shards[basis[0]])
    host = host_empty((len(basis), padded_width(n)), codec.device)
    hn = host.numpy()
    for r, i in enumerate(basis):
        hn[r, :n] = shards[i]
    COUNTERS.add(calls=1)
    if codec.device.type == "cpu":
        out = mat(host[:, :n])
        return {w: out[r].numpy() for r, w in enumerate(wanted)}
    t0 = time.perf_counter()
    dev = host.to(codec.device, non_blocking=True)[:, :n]
    t1 = time.perf_counter()
    out = mat(dev)
    ev = torch.cuda.Event()
    ev.record()
    t2 = time.perf_counter()
    ev.synchronize()
    t3 = time.perf_counter()
    back = host_empty((len(wanted), n), codec.device)
    back.copy_(out)
    COUNTERS.add(h2d_s=t1 - t0, h2d_bytes=host.numel(), device_s=t3 - t2,
                 d2h_s=time.perf_counter() - t3, d2h_bytes=back.numel())
    bn = back.numpy()
    return {w: bn[r] for r, w in enumerate(wanted)}


# matrix applies for the reduced-read repair plane (ops/regen.py): the
# coefficient matrices are tiny ([1, j] slices of a decode matrix) but
# arbitrary, so each one's apply (its kernel tables) is built once through
# the codec's factory and cached; a repair plan reuses the same few
# windows for a whole shard.  The key is the codec's factory and the
# matrix: a card codec (`CudaGFMatrix`, which copies its tables to each
# card at first use) and the native host codec (`NativeGFMatrix`) in one
# process must not share an apply.  The lock covers the check-build-store:
# execute_plan applies from its fetch pool's threads and the caller's at
# once.
_APPLY_CACHE: dict = {}
_APPLY_CACHE_MAX = 64
_APPLY_LOCK = threading.Lock()


def apply_matrix(codec, C: np.ndarray, stack: np.ndarray) -> np.ndarray:
    """out[r, n] = C[r, j] @ stack[j, n] over GF(2^8), host bytes in and
    out: the partial-sum apply of the reduced-read repair path.

    The [j, n] stack is packed into a pinned host buffer, copied to the
    card into rows 16 bytes apart (`rows.device_empty`, which the kernel
    reads in place), applied by K1, and brought back after the dispatch's
    event, on whichever thread calls.  On the CPU the codec's own apply
    computes it: the plain version, or the native host codec's."""
    C = np.ascontiguousarray(C, dtype=np.uint8)
    key = (codec._factory, C.shape, C.tobytes())
    with _APPLY_LOCK:
        mat = _APPLY_CACHE.get(key)
        if mat is None:
            if len(_APPLY_CACHE) >= _APPLY_CACHE_MAX:
                _APPLY_CACHE.clear()
            mat = _APPLY_CACHE[key] = codec._factory(C)
    host = host_empty(stack.shape, codec.device)
    host.numpy()[...] = stack
    return materialize(_dispatch(codec, mat, host, None))


def parity_mismatch(codec, data: np.ndarray,
                    parity_rows: dict[int, np.ndarray]
                    ) -> dict[int, np.ndarray]:
    """Scrub seam: recompute the parity of a [k, B] data-stripe window
    through the same dispatch the encoder uses and compare it with the
    stored parity bytes.  Returns a boolean mismatch mask per supplied
    parity row (row index is parity-relative: 0..m-1)."""
    expect = materialize(dispatch_parity(codec, data))
    return {r: np.not_equal(expect[r],
                            np.frombuffer(stored, dtype=np.uint8)
                            if isinstance(stored, (bytes, bytearray))
                            else stored)
            for r, stored in parity_rows.items()}
