"""Device-mesh parallel erasure coding, driven by one process.

Counterpart of `seaweedfs_tpu/parallel/mesh.py`.  SeaweedFS scales EC by
spreading the shard files of each volume across volume servers
(weed/shell/command_ec_encode.go spreadEcShards); the mesh has three
axes for it:

- **column parallelism**: the byte columns of one stripe [k, n] split
  over positions; parity is column-local, so encode needs no exchange;
- **unit parallelism** (the fleet's shape): a batch of independent
  [k, B] units, interleaved from many volumes by the conversion pipeline
  (ops/fleet_convert.py), splits over positions on the unit axis;
- **volume/shard placement**: a batch of volumes [V, k, n] splits over
  positions on V; after the local encode one all_to_all moves shard
  group g of every volume to the positions of group g, the shard-spread
  step of ec.encode.

The reference builds and drives its mesh inside one process (one
controller over `shard_map`), and every caller of it (the mesh EC codec,
the fleet's unit encoder, the dry run) runs where there may be one card.
So the port's mesh is a grid of `torch.device`s held by one process, not
a `torch.distributed` group, which needs a process per card:

- each position's apply is `CudaGFMatrix`: the kernel on a card (K1 for
  a [k, n] column block, K2 for a [U, k, n] unit block), launched on that
  card's current stream; the plain version on a CPU position;
- each position's input is copied into a buffer of its own
  (`rows.device_empty`), rows 16 bytes apart, so the kernel reads it in
  place whatever the slice's width;
- the all_to_all is copies between positions: peer copies between
  cards, same-card copies otherwise, each ordered after the kernel that
  made its source by an event;
- a position may name a device another position names: the CPU tests
  build 8 positions on "cpu", as the reference's tests build 8 virtual
  CPU devices, and a host with one card runs several positions on it.

Column work (`encode`, `encode_parity`, `reconstruct`) runs on the
positions of the column axis alone (index 0 on every other axis): the
reference repeats it on every replica of the other axes, to the same
bytes.  Results are `ShardedArray`s: each position's block, its place in
the whole and the event recorded after the work that made it, in mesh
order (the counterpart of a jax array's `addressable_shards`).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from seaweedfs_tpu_torch.ops import codec_base
from seaweedfs_tpu_torch.ops.dispatch import _h2d
from seaweedfs_tpu_torch.ops.gf_cuda import CudaGFMatrix, resolve_device
from seaweedfs_tpu_torch.ops.rows import device_empty
from seaweedfs_tpu_torch.stats.profile import KERNELS


class Mesh:
    """An n-dimensional grid of devices with named axes.  `shape[axis]`
    is the axis' size, as on a `jax.sharding.Mesh`."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of {devices.ndim} dimensions, axes "
                             f"{axis_names}")
        kinds = {d.type for d in devices.flat}
        if len(kinds) != 1:
            raise ValueError(f"a mesh is all cards or all CPU, got "
                             f"{sorted(kinds)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    def positions(self, along: str | None = None) -> list:
        """(coordinate, device) of every position in mesh order; with
        `along`, only those at index 0 on every other axis, in the order
        of that axis."""
        keep = None if along is None else self.axis_names.index(along)
        return [(c, self.devices[c]) for c in np.ndindex(self.devices.shape)
                if keep is None or all(i == 0 for a, i in enumerate(c)
                                       if a != keep)]


def _device(d) -> torch.device:
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def mesh_devices(devices=None) -> list[torch.device]:
    """The positions `devices` names: None, every card (raises without
    one); one device, one position; a sequence, its devices in order."""
    if devices is None:
        resolve_device(None)  # raises without a card
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if isinstance(devices, (str, torch.device)):
        devices = [devices]
    return [_device(d) for d in devices]


def make_mesh(n_devices: int | None = None,
              axis_names: tuple[str, ...] = ("data",),
              shape: tuple[int, ...] | None = None,
              devices=None) -> Mesh:
    """A mesh over the first n_devices positions of `devices` (see
    `mesh_devices`; default all of them, or prod(shape) when a shape is
    given).  Raises when fewer positions are there."""
    devs = mesh_devices(devices)
    if n_devices is None and shape is not None:
        n_devices = int(np.prod(shape))
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(f"a mesh of {n_devices} positions, "
                             f"{len(devs)} given")
        devs = devs[:n_devices]
    if shape is None:
        shape = (len(devs),) + (1,) * (len(axis_names) - 1)
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), axis_names)


@dataclass
class Shard:
    """One position's block of a sharded result: its mesh coordinate,
    its place in the whole (a tuple of slices), the tensor on the
    position's device, and on a card the event recorded after the work
    that made it."""
    position: tuple
    index: tuple
    data: torch.Tensor
    event: torch.cuda.Event | None = None


@dataclass
class ShardedArray:
    """A uint8 array of `shape` held as blocks on the mesh's positions
    (`shards`, in mesh order).  `kernel` is the `KERNELS` row its sync
    point is booked in; `keep` holds intermediates that copies still
    read."""
    shape: tuple
    shards: list[Shard]
    kernel: str | None = None
    keep: list = field(default_factory=list, repr=False)

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape))

    def __getitem__(self, i: int) -> "ShardedArray":
        """Row i of an array whose first dimension is not split."""
        return ShardedArray(self.shape[1:], [
            Shard(s.position, s.index[1:], s.data[i], s.event)
            for s in self.shards], self.kernel, self.keep)

    def numpy(self) -> np.ndarray:
        """The whole on the host, each block after its event."""
        out = np.zeros(self.shape, dtype=np.uint8)
        for s in self.shards:
            if s.event is not None:
                s.event.synchronize()
            out[s.index] = s.data.cpu().numpy()
        return out

    def __array__(self, dtype=None, copy=None):
        out = self.numpy()
        return out if dtype is None else out.astype(dtype)


def _record(dev: torch.device) -> torch.cuda.Event | None:
    """An event after the work enqueued so far on `dev`'s current stream
    (None on the CPU, where the work is done)."""
    if dev.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(dev))
    return ev


def _host(arr) -> torch.Tensor:
    """A host array as a CPU tensor (numpy is viewed, not copied)."""
    if isinstance(arr, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.uint8))
    if arr.device.type != "cpu":
        raise ValueError(f"want host data or a ShardedArray, got a tensor "
                         f"on {arr.device}")
    return arr


def _split(n: int, parts: int) -> list[tuple[int, int]]:
    """[a, b) of each of `parts` column slices of n: n padded up to a
    multiple of `parts` and cut evenly (a slice past n is empty)."""
    w = -(-n // parts)
    return [(min(p * w, n), min((p + 1) * w, n)) for p in range(parts)]


def shard_columns(mesh: Mesh, arr, axis: str = "data") -> ShardedArray:
    """Place [rows, n] host data with columns split over `axis`: one
    `device_empty` buffer per position of the axis, column slice p on
    position p."""
    host = _host(arr)
    rows, n = host.shape
    cols = mesh.positions(axis)
    shards = []
    for (coord, dev), (a, b) in zip(cols, _split(n, len(cols))):
        if a < b:
            buf = _h2d(host[:, a:b], dev, device_empty((rows, b - a), dev))
            shards.append(Shard(coord, (slice(None), slice(a, b)), buf))
    return ShardedArray((rows, n), shards)


def _book_h2d(nbytes: int, kernel: str) -> None:
    """Book a place()'s H2D in the kernel profile, bytes only, as the
    port books every card transfer (no host clock measures an
    asynchronous copy)."""
    KERNELS.record(kernel, "device", calls=0, h2d_bytes=nbytes)


class ShardedRSEncoder:
    """RS(k, m) encode and rebuild over a mesh.

    `col_axis` splits byte columns; the optional `vol_axis` splits a
    leading volume dimension for `encode_batch_place`.  The survivor
    basis and the decode matrices come from the one-device codec shell
    (`RSCodecBase`), cached per pattern; `_factory` is the matrix apply a
    repair partial (`dispatch.apply_matrix`) builds, on `device`, the
    mesh's first position."""

    def __init__(self, code, mesh: Mesh, col_axis: str = "data",
                 vol_axis: str | None = None):
        self.code = code
        self.k, self.m, self.n_shards = code.k, code.m, code.n
        self.mesh = mesh
        self.col_axis = col_axis
        self.vol_axis = vol_axis
        self.device = mesh.devices.flat[0]
        self._shell = codec_base.RSCodecBase(code, CudaGFMatrix)
        self._factory = CudaGFMatrix
        self._parity = self._shell._parity
        self.basis = self._shell.basis
        self.decoder = self._shell.decoder
        self._cols = mesh.positions(col_axis)
        self._placement_groups: int | None = None
        if vol_axis is not None:
            D = mesh.shape[vol_axis]
            self._placement_groups = -(-self.n_shards // D) * D

    def _column_blocks(self, data) -> list:
        """(coordinate, device, (a, b), [rows, b - a] block) of each
        column position holding columns: the blocks of a ShardedArray
        this mesh split, or host data copied in."""
        if not isinstance(data, ShardedArray):
            data = shard_columns(self.mesh, data, self.col_axis)
        return [(s.position, s.data.device, (s.index[-1].start,
                                             s.index[-1].stop), s.data)
                for s in data.shards]

    # -- column-parallel single volume ---------------------------------

    def encode(self, data) -> ShardedArray:
        """[k, n] -> [k + m, n], columns split over `col_axis`."""
        k, n = self.k, data.shape[-1]
        shards = []
        for coord, dev, (a, b), x in self._column_blocks(data):
            out = device_empty((self.n_shards, b - a), dev)
            out[:k].copy_(x)
            out[k:].copy_(self._parity(out[:k]))
            shards.append(Shard(coord, (slice(None), slice(a, b)), out,
                                _record(dev)))
        return ShardedArray((self.n_shards, n), shards)

    def encode_parity(self, data) -> ShardedArray:
        """[k, n] -> [m, n] parity, columns split over `col_axis`; n is
        padded up to a multiple of the axis' size (the padding computes
        nothing: a position past n holds no block)."""
        n = data.shape[-1]
        shards = [Shard(coord, (slice(None), slice(a, b)), self._parity(x),
                        _record(dev))
                  for coord, dev, (a, b), x in self._column_blocks(data)]
        return ShardedArray((self.m, n), shards)

    def place_columns(self, arr) -> ShardedArray:
        """Copy [k, n] host data to the column positions, each its own
        slice: the layout `encode` and `encode_parity` read, so they copy
        nothing more.  Books the H2D once."""
        out = shard_columns(self.mesh, arr, self.col_axis)
        _book_h2d(out.nbytes, "encode_parity")
        return out

    def reconstruct(self, shards: dict, wanted: list[int] | None = None
                    ) -> dict[int, ShardedArray]:
        """Column-parallel rebuild of missing shards from >= k survivor
        rows on the host; columns padded as `encode_parity` pads them."""
        present = tuple(sorted(shards))
        if wanted is None:
            wanted = [i for i in range(self.n_shards) if i not in shards]
        if not wanted:
            return {}
        basis, mat = self.decoder(present, tuple(wanted))
        rows = [_host(shards[i]) for i in basis]
        n = rows[0].shape[-1]
        out = []
        for (coord, dev), (a, b) in zip(self._cols,
                                        _split(n, len(self._cols))):
            if a == b:
                continue
            stack = device_empty((len(basis), b - a), dev)
            for r, row in enumerate(rows):
                stack[r].copy_(row[a:b], non_blocking=True)
            out.append(Shard(coord, (slice(None), slice(a, b)), mat(stack),
                             _record(dev)))
        whole = ShardedArray((len(wanted), n), out, "reconstruct")
        return {w: whole[r] for r, w in enumerate(wanted)}

    # -- batched volumes + shard placement ------------------------------

    def placement_groups(self) -> int:
        """Shard rows padded so every position of `vol_axis` gets an
        equal group."""
        if self._placement_groups is None:
            raise ValueError("construct with vol_axis= for placement")
        return self._placement_groups

    def encode_batch_place(self, volumes) -> ShardedArray:
        """[V, k, n] -> [V, S, n], S = `placement_groups()`: position
        (v, c) ends up holding shard rows [v*S/D, (v+1)*S/D) of EVERY
        volume, in column slice c (ec.encode's spreadEcShards as one
        exchange between positions).  Each position encodes its V/D
        volumes in one K2 launch; rows past the code's n are zero.  A
        one-position volume axis keeps [V, k + m, n] where it was made."""
        if self.vol_axis is None:
            raise ValueError("construct with vol_axis= for batching")
        host = _host(volumes)
        V, k, n = host.shape
        D, C = self.mesh.shape[self.vol_axis], self.mesh.shape[self.col_axis]
        if V % D or n % C:
            raise ValueError(f"[{V}, {k}, {n}] does not split evenly over "
                             f"{D} x {C} positions")
        vi = self.mesh.axis_names.index(self.vol_axis)
        ci = self.mesh.axis_names.index(self.col_axis)
        Vl, nl = V // D, n // C
        S = self.n_shards if D == 1 else self._placement_groups
        local = {}
        for coord, dev in self.mesh.positions():
            v, c = coord[vi], coord[ci]
            buf = device_empty((Vl, S, nl), dev)
            for u in range(Vl):
                _h2d(host[v * Vl + u, :, c * nl:(c + 1) * nl], dev,
                     buf[u, :k])
            buf[:, k:self.n_shards].copy_(self._parity.apply_batch(
                buf[:, :k]))
            buf[:, self.n_shards:].zero_()
            local[coord] = (buf, _record(dev))
        cols = (slice(None),)
        if D == 1:
            shards = [Shard(coord, cols + (slice(0, S),
                                           slice(coord[ci] * nl,
                                                 (coord[ci] + 1) * nl)),
                            buf, ev)
                      for coord, (buf, ev) in local.items()]
            return ShardedArray((V, S, n), shards)
        G = S // D
        shards = []
        for coord, dev in self.mesh.positions():
            v, c = coord[vi], coord[ci]
            out = device_empty((V, G, nl), dev)
            for src in range(D):
                at = list(coord)
                at[vi] = src
                sbuf, sev = local[tuple(at)]
                if sev is not None:
                    torch.cuda.current_stream(dev).wait_event(sev)
                out[src * Vl:(src + 1) * Vl].copy_(
                    sbuf[:, v * G:(v + 1) * G], non_blocking=True)
            shards.append(Shard(coord, cols + (slice(v * G, (v + 1) * G),
                                               slice(c * nl, (c + 1) * nl)),
                                out, _record(dev)))
        return ShardedArray((V, S, n), shards, keep=list(local.values()))


class FleetUnitEncoder:
    """Unit-parallel fleet encode, the mesh shape of the multi-volume
    conversion pipeline (ops/fleet_convert.py).

    A batch of U independent [k, B] units splits over the positions of
    `unit_axis` in contiguous blocks; each position encodes its block in
    one K2 launch (parity is unit-local: no exchange).  `place` copies
    each block into the position's own buffer (a pooled slot from
    `empty_slot`, or a new one), `encode_parity_batch` launches, and
    `unit_shards` yields each position's parity as its event completes,
    so the drain streams shards to the writers as they come off each
    position."""

    def __init__(self, code, mesh: Mesh | None = None,
                 unit_axis: str = "unit"):
        if mesh is None:
            mesh = make_mesh(axis_names=(unit_axis,))
        self.code = code
        self.k, self.m = code.k, code.m
        self.mesh = mesh
        self.unit_axis = unit_axis
        self.n_devices = mesh.shape[unit_axis]
        self.device = mesh.devices.flat[0]
        self._parity = CudaGFMatrix(code.parity_matrix)
        self._units = mesh.positions(unit_axis)

    def unit_slots(self, min_units: int) -> int:
        """Round a desired in-flight unit count up to an even split over
        the positions."""
        D = self.n_devices
        return max(D, -(-min_units // D) * D)

    def empty_slot(self, units: int, width: int) -> list[torch.Tensor]:
        """One [units / D, k, width] `device_empty` buffer per position:
        the device half of a pooled slot for `place`."""
        per = units // self.n_devices
        return [device_empty((per, self.k, width), dev)
                for _, dev in self._units]

    def place(self, host_units, staging: list | None = None
              ) -> ShardedArray:
        """Copy a [U, k, B] host batch to the positions, unit block p on
        position p, and book the H2D once.  Without `staging` U must split
        evenly; with it (an `empty_slot`) each position takes up to its
        buffer's units, so a ragged batch leaves the last positions
        empty: they launch nothing."""
        host = _host(host_units)
        U, k, B = host.shape
        if staging is None:
            if U % self.n_devices:
                raise ValueError(f"{U} units do not split over "
                                 f"{self.n_devices} positions")
            per = U // self.n_devices
        else:
            per = staging[0].shape[0]
            if U > per * self.n_devices:
                raise ValueError(f"{U} units, slot of {per} x "
                                 f"{self.n_devices}")
        shards = []
        for p, (coord, dev) in enumerate(self._units):
            a, b = p * per, min((p + 1) * per, U)
            if a >= b:
                break
            dst = device_empty((b - a, k, B), dev) if staging is None \
                else staging[p][:b - a, :, :B]
            shards.append(Shard(coord, (slice(a, b),),
                                _h2d(host[a:b], dev, dst)))
        _book_h2d(host.numel(), "fleet_encode")
        return ShardedArray((U, k, B), shards)

    def encode_parity_batch(self, units: ShardedArray) -> ShardedArray:
        """Placed [U, k, B] -> [U, m, B] parity, split as its input: one
        K2 launch per position holding units."""
        U, _, B = units.shape
        shards = [Shard(s.position, s.index, self._parity.apply_batch(s.data),
                        _record(s.data.device)) for s in units.shards]
        return ShardedArray((U, self.m, B), shards, "fleet_encode")

    def unit_shards(self, parity):
        """Yield (u_start, u_stop, ndarray) per position's block, in unit
        order, each once its event has completed; host data yields one
        block."""
        if not isinstance(parity, ShardedArray):
            arr = np.asarray(parity)
            yield 0, arr.shape[0], arr
            return
        for s in parity.shards:
            if s.event is not None:
                s.event.synchronize()
            yield s.index[0].start, s.index[0].stop, s.data.cpu().numpy()

