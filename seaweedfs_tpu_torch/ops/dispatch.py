"""Backend dispatch seam between the EC data path and the codec.

Counterpart of `seaweedfs_tpu/ops/dispatch.py`.  The storage layer needs
three things from a codec: dispatch a parity encode, materialise the result
on the host, and reconstruct missing rows.  On the card a dispatch is
asynchronous:

- H2D copies are `non_blocking` from pinned host buffers, on the calling
  thread's current stream, and the kernel is enqueued behind them;
- `dispatch_parity` ([k, B], kernel K1) and `dispatch_parity_batch`
  ([U, k, B], K2) return a `Pending` (the un-synced output tensor, the
  kernel row it is booked in, and a CUDA event recorded after the
  kernel);
- `materialize` is the sync point: it waits on that event, then copies the
  result D2H into pinned memory and hands back numpy;
- `reconstruct_batch` (rebuild) and `apply_matrix` (a repair helper's
  partial product, ops/regen.py) go through the same steps and return
  host bytes.

A mesh codec (parallel/mesh.py: `ShardedRSEncoder`, `FleetUnitEncoder`)
copies each position's slice to that position itself, and its results
are `ShardedArray`s, one block per position, each with its own event:
`materialize` gathers them, and `unit_parity_shards` yields each block
as its event completes (the fleet's streaming drain).  A mesh's repair
partials (`apply_matrix`) run on its first position.

Every batch lands on the card in a buffer whose rows start 16 bytes
apart (`rows.device_empty`), the layout the kernel reads in place, so the
kernel wrapper never has to stage a copy of it (it does so only for a
view it cannot read in place, and counts each in `gf_cuda.STAGED`).

Synchronising on the event rather than on a stream matters because the
encode pipeline dispatches on one thread and drains on another, and each
thread has its own current stream.  On the CPU the codec computes eagerly
and the same calls return at once (the plain version's result still
comes back as a `Pending`, with no event, so that it carries its row).

Every call feeds the kernel profile (`stats.profile.KERNELS`) and, under
a sampled trace, records the reference's spans (`codec.dispatch_parity`,
`codec.dispatch_parity_batch`, `codec.d2h`, `codec.apply_matrix`,
`codec.reconstruct`).  A row is `<kernel>[host]` for the native host
codec, which computes inside the call (its wall time), and
`<kernel>[device]` otherwise: the card, or its plain version when the
caller named the CPU, as the reference books its JAX codecs on any
backend.  Its calls, bytes, h2d_bytes and d2h_bytes are the reference's:
payload bytes, counted where the reference counts them.  On the card
`wall_s` is the host's enqueue of the apply, `device_s` the wait on the
dispatch's event (whatever of the copy and the kernel is still running
when the host gets there) and `d2h_s` the copy back.  No `h2d_s` is
booked there: the copy is asynchronous, and no host clock around its
enqueue measures it.  Neither the wait nor the enqueue is a device
interval, so the roofline (stats/profile.py) reads neither; the card's
copy and kernel times come from a `torch.profiler` trace
(`utils/grace.torch_profile`).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from seaweedfs_tpu_torch.ops.rows import device_empty, padded_width
from seaweedfs_tpu_torch.stats import trace
from seaweedfs_tpu_torch.stats.profile import KERNELS


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
    """A dispatched result not yet on the host: the output tensor, the
    `KERNELS` row its sync point is booked in, and on the card the event
    recorded after the kernel that produces it (None for the plain
    version's CPU tensor, which is already computed)."""
    tensor: torch.Tensor
    kernel: str
    event: torch.cuda.Event | None = None


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


def _backend(codec) -> str:
    """"host" for the native host codec (and an MSR file codec over it),
    "device" for the card's codec on any device."""
    return "host" if getattr(codec, "host_backend", False) else "device"


def _enqueue(codec, apply, host: torch.Tensor,
             staging: torch.Tensor | None, kernel: str):
    """Run `apply` (a codec method or matrix apply) on a host tensor and
    book it in `kernel`'s row: the native codec computes eagerly and its
    result comes back as numpy; the plain version on the CPU returns a
    `Pending` with no event; on the card the apply is enqueued behind an
    H2D into `staging` and a `Pending` comes back."""
    nbytes = host.numel()
    if _backend(codec) == "host":
        with KERNELS.timed(kernel, nbytes=nbytes):
            return apply(host).numpy()
    if codec.device.type == "cpu":
        t0 = time.perf_counter()
        out = apply(host)
        KERNELS.record(kernel, "device", wall_s=time.perf_counter() - t0,
                       h2d_bytes=nbytes, nbytes=nbytes)
        return Pending(out, kernel)
    dev = _h2d(host, codec.device, staging)
    t0 = time.perf_counter()
    out = apply(dev)
    ev = torch.cuda.Event()
    ev.record()
    KERNELS.record(kernel, "device", wall_s=time.perf_counter() - t0,
                   h2d_bytes=nbytes, nbytes=nbytes)
    return Pending(out, kernel, ev)


def _to_host(tensor: torch.Tensor, event, kernel: str) -> np.ndarray:
    """A device result's host bytes, booking its device wait and its D2H
    (calls=0) in `kernel`'s row: a card tensor waits on its event and is
    copied into pinned memory; a CPU tensor is viewed as numpy."""
    if event is None:
        out = tensor.numpy()
        KERNELS.record(kernel, "device", calls=0, d2h_bytes=out.nbytes)
        return out
    t0 = time.perf_counter()
    event.synchronize()
    t1 = time.perf_counter()
    host = host_empty(tuple(tensor.shape), tensor.device)
    host.copy_(tensor)
    KERNELS.record(kernel, "device", calls=0, device_s=t1 - t0,
                   d2h_s=time.perf_counter() - t1, d2h_bytes=host.numel())
    return host.numpy()


def _fetch(result) -> np.ndarray:
    """The host bytes of an `_enqueue` result or a mesh's `ShardedArray`,
    its device wait and D2H booked in the result's row; the native
    codec's numpy passes through."""
    if isinstance(result, np.ndarray):
        return result
    if isinstance(result, Pending):
        return _to_host(result.tensor, result.event, result.kernel)
    blocks = [(s.index, _to_host(s.data, s.event, result.kernel))
              for s in result.shards]
    if len(blocks) == 1 and blocks[0][1].shape == tuple(result.shape):
        return blocks[0][1]
    out = np.zeros(result.shape, dtype=np.uint8)
    for index, block in blocks:
        out[index] = block
    return out


def _is_mesh(codec) -> bool:
    """A mesh codec (parallel/mesh.py) places its own input."""
    return hasattr(codec, "mesh")


def dispatch_parity(codec, batch, staging: torch.Tensor | None = None):
    """Dispatch [k, B] -> [m, B] parity (`encode_parity`).  On the card
    the result comes back un-synced (a `Pending`); on the CPU it is
    computed eagerly."""
    host = _as_tensor(batch)
    with trace.span("codec.dispatch_parity", backend=_backend(codec),
                    bytes=host.numel()):
        if _is_mesh(codec):
            return _enqueue_mesh(codec.encode_parity, host, "encode_parity")
        return _enqueue(codec, codec.encode_parity, host, staging,
                        "encode_parity")


def _enqueue_mesh(apply, host: torch.Tensor, kernel: str, h2d: bool = True):
    """Run a mesh codec's `apply` on host data (it copies each position's
    slice itself) and book it in `kernel`'s row; returns its
    `ShardedArray`.  `h2d` False: a `place` booked the copy already."""
    nbytes = host.numel()
    t0 = time.perf_counter()
    out = apply(host)
    out.kernel = kernel
    KERNELS.record(kernel, "device", wall_s=time.perf_counter() - t0,
                   h2d_bytes=nbytes if h2d else 0, nbytes=nbytes)
    return out


def materialize(parity) -> np.ndarray:
    """Sync point of a dispatch, its device wait and D2H booked in the row
    of the kernel that dispatched it: host results pass through; a
    `Pending` waits on its event and is copied D2H into pinned memory; a
    mesh's `ShardedArray` so, block by block, gathered."""
    if isinstance(parity, np.ndarray):
        return parity
    nbytes = parity.tensor.numel() if isinstance(parity, Pending) \
        else parity.nbytes
    with trace.span("codec.d2h", bytes=nbytes):
        return _fetch(parity)


def dispatch_parity_batch(codec, units, staging=None, placed=None):
    """Dispatch a [U, k, B] unit batch -> [U, m, B] parity (K2,
    `fleet_encode`), the fleet conversion's seam (ops/fleet_convert.py).

    A codec with `place` (a mesh's `FleetUnitEncoder`) copies each
    position's units to it: `placed` is a batch it placed already, else
    it places `units` here, into `staging` (its `empty_slot`) when given;
    either way `place` books the H2D, exactly once.  One K2 launch per
    position holding units.

    Otherwise, on the card, the pinned host batch is copied into `staging`
    (a `device_empty((U, k, B))` slot buffer, or a new one when None),
    whose unit and row strides are multiples of 16, so the kernel reads
    it in place, in one launch.  Results come back un-synced (a `Pending`
    or a `ShardedArray`); `materialize` and `unit_parity_shards` are
    their sync points.  On the CPU they are computed eagerly."""
    host = _as_tensor(units)
    with trace.span("codec.dispatch_parity_batch", backend=_backend(codec),
                    bytes=host.numel()):
        place = getattr(codec, "place", None)
        if place is not None:
            if placed is None:
                placed = place(host, staging)
            return _enqueue_mesh(lambda _: codec.encode_parity_batch(placed),
                                 host, "fleet_encode", h2d=False)
        if placed is not None:
            raise TypeError(f"placed= needs a codec with place(), not "
                            f"{type(codec).__name__}")
        return _enqueue(codec, codec.encode_parity_batch, host, staging,
                        "fleet_encode")


def unit_parity_shards(parity, kernel: str = "fleet_encode"):
    """Streaming sync point of a batched dispatch: yield (u_start,
    u_stop, ndarray) per position's block, each as its event completes,
    its device wait and D2H booked in `kernel`'s row, so the drain hands
    a block's shards to the writers while later blocks still copy.  A
    `Pending` or a host result yields one block."""
    if isinstance(parity, np.ndarray):
        yield 0, parity.shape[0], parity
        return
    sharded = not isinstance(parity, Pending)
    nbytes = parity.nbytes if sharded else parity.tensor.numel()
    with trace.span("codec.d2h", bytes=nbytes, streamed=True):
        if not sharded:
            out = _to_host(parity.tensor, parity.event, kernel)
            yield 0, out.shape[0], out
            return
        for s in parity.shards:
            yield s.index[0].start, s.index[0].stop, \
                _to_host(s.data, s.event, kernel)


def reconstruct_batch(codec, shards: dict[int, np.ndarray],
                      wanted: list[int]) -> dict[int, np.ndarray]:
    """Rebuild `wanted` shard rows from >= k survivor rows (host bytes in
    and out) in one apply (`reconstruct`).  The survivors the decode reads
    are packed into one padded host stack, copied to the card in one
    transfer and read there in place."""
    if not wanted:
        return {}
    nbytes = sum(v.nbytes for v in shards.values())
    backend = _backend(codec)
    with trace.span("codec.reconstruct", backend=backend, bytes=nbytes,
                    wanted=len(wanted)):
        t0 = time.perf_counter()
        basis, mat = codec.decoder(tuple(sorted(shards)), tuple(wanted))
        n = len(shards[basis[0]])
        host = host_empty((len(basis), padded_width(n)), codec.device)
        hn = host.numpy()
        for r, i in enumerate(basis):
            hn[r, :n] = shards[i]
        if _is_mesh(codec):
            t1 = time.perf_counter()
            rows = codec.reconstruct({i: host[r, :n]
                                      for r, i in enumerate(basis)},
                                     list(wanted))
            KERNELS.record("reconstruct", "device",
                           wall_s=time.perf_counter() - t1,
                           h2d_bytes=nbytes, nbytes=nbytes)
            return {w: _fetch(rows[w]) for w in wanted}
        if codec.device.type == "cpu":
            out = mat(host[:, :n]).numpy()
            if backend == "host":
                KERNELS.record("reconstruct", "host", nbytes=nbytes,
                               wall_s=time.perf_counter() - t0)
            else:
                KERNELS.record("reconstruct", "device", nbytes=nbytes,
                               wall_s=time.perf_counter() - t0,
                               h2d_bytes=nbytes, d2h_bytes=out.nbytes)
            return {w: out[r] for r, w in enumerate(wanted)}
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
        KERNELS.record("reconstruct", "device", wall_s=t2 - t1,
                       h2d_bytes=nbytes,
                       device_s=t3 - t2, d2h_s=time.perf_counter() - t3,
                       d2h_bytes=back.numel(), nbytes=nbytes)
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
    out: the partial-sum apply of the reduced-read repair path
    (`repair_partial`).

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
    with trace.span("codec.apply_matrix", backend=_backend(codec),
                    bytes=stack.nbytes):
        host = host_empty(stack.shape, codec.device)
        host.numpy()[...] = stack
        return _fetch(_enqueue(codec, mat, host, None, "repair_partial"))


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
