"""GF(2^8) matrix apply on the card: the CUDA kernel, its plain PyTorch
version, and the RS codec over them.

Counterpart of `seaweedfs_tpu/ops/pallas_gf.py`.  `CudaGFMatrix` applies a
fixed [m, k] GF(2^8) matrix C to [k, n] (`__call__`) or [U, k, n]
(`apply_batch`) uint8 tensors:

- a CUDA tensor goes to the hand-written kernel in `csrc/gf_matmul.cu`
  (nibble-split lookup tables built here on the host, `nibble_tables`,
  looked up four bytes at a time with PRMT), launched on PyTorch's
  current stream without synchronising;
- a CPU tensor goes to `gf_apply_plain`, the bit-sliced algorithm of
  `gfmat_jax.bitsliced_apply_body`: unpack bit planes, one float32 matrix
  product against the [8m, 8k] 0/1 lift of C (exact: every sum is at most
  8k < 2^11), keep the parity bit, repack.  It runs on one intra-op
  thread (`one_intra_op_thread`): a server's request threads are its
  parallelism, and an OpenMP team of one thread per core in every call
  oversubscribes the host's cores (ROADMAP fault 3.16).

C may have any shape a GF(2^8) code gives it (k + m <= 256).  The kernel
takes at most 16 output rows per launch, so the wrapper cuts C into row
blocks of up to 16 rows, one launch each (a [72, 72] MSR(9,16) apply is
five launches).

The two are different algorithms, so agreement between them is evidence.
There is no fallback between them: a tensor on any other device raises,
and a kernel that fails to build or launch raises.  The kernel reads rows
that start on 16-byte boundaries in place (ops/rows.py buffers, which
ops/dispatch.py stages every host batch into); any other CUDA view of any
width is first copied once into such a buffer, as `PallasGFMatrix` pads.

Every launch takes a tile, the counterpart of the Pallas kernel's
byte-column tile: the byte columns one block covers per step, a multiple
of 2048 (csrc/gf_matmul.cu); `DEFAULT_TILE`, one chunk per thread per
step, is the launch the kernel had before it took a tile.
`resolved_tile` picks it as the reference does: the argument, else
WEEDTPU_EC_TILE (raising where it is not a positive integer; the
reference falls back), else the pin whose fingerprint is this card's
(`chip_fingerprint`: the card's name, capability and count), else the
default.  `micro_sweep` times every candidate of `SWEEP_TILES` at the
main path's [10, 1 MiB] dispatch on the card; `save_tile_pin` writes
its winner (to WEEDTPU_TILE_PIN, default ~/.weedtpu_tile_pin.json) and
`load_tile_pin` reads it back, at one `stat` a lookup in steady state.
The tile-drift sentinel (stats/pipeline.py) re-runs the sweep against
the pin.  The plain version has no tile and ignores it.

`LAUNCHES` counts the kernel's launches by name ("gf_apply" for the
[k, n] apply, K1; "gf_apply_batch" for the [U, k, n] one, K2), one per
row block, raised only where a launch succeeds: a run reads it to show
its path went through the kernel.  `STAGED` counts, by the same names,
the inputs the wrapper had to copy before launching: a run reads it to
show its path handed the kernel rows it reads in place.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time

import numpy as np
import torch

from seaweedfs_tpu_torch.ops import codec_base, gf
from seaweedfs_tpu_torch.ops.rows import ALIGN, device_empty, padded_width

ROW_BLOCK = 16  # output rows per launch (csrc/gf_matmul.cu kMaxM)
MAX_UNITS = 65535  # units per launch: the grid's y dimension
TILE_UNIT = 2048  # byte columns of one step of a block: 128 threads x 16 B
MAX_TILE = 1 << 20  # csrc/gf_matmul.cu kMaxTile
DEFAULT_TILE = TILE_UNIT  # one chunk per thread per step
# the candidates micro_sweep times; DEFAULT_TILE is always one of them
SWEEP_TILES = (2048, 4096, 8192, 16384, 32768)
SWEEP_N = 1 << 20  # byte columns of the sweep: the encode's [10, 1 MiB]
# the card's sleep before a candidate's timed launches (~10 ms at 2 GHz):
# the host enqueues them meanwhile, so the events time the kernel and not
# the host's launch rate, which is below the kernel's at [10, 1 MiB]
SWEEP_SLEEP_CYCLES = 20_000_000
# the fingerprint of the plain version: it never equals a card's, nor the
# reference's "cpu:cpu:1", so no measured pin applies to it
CPU_FINGERPRINT = "cpu:plain:1"

LAUNCHES = {"gf_apply": 0, "gf_apply_batch": 0}
STAGED = {"gf_apply": 0, "gf_apply_batch": 0}
_launch_lock = threading.Lock()


def reset_launches() -> None:
    """Zero `LAUNCHES` and `STAGED`."""
    with _launch_lock:
        for counts in (LAUNCHES, STAGED):
            for name in counts:
                counts[name] = 0


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU.  Raises when the card is asked for and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless the caller "
            "passes device='cpu'")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


# -- launch tile and its pin ---------------------------------------------

def check_tile(tile) -> int:
    """`tile` if the kernel can take it: a multiple of TILE_UNIT from
    TILE_UNIT to MAX_TILE.  Raises ValueError otherwise."""
    if isinstance(tile, bool) or not isinstance(tile, (int, np.integer)) \
            or not TILE_UNIT <= tile <= MAX_TILE or tile % TILE_UNIT:
        raise ValueError(f"launch tile {tile!r}: want a multiple of "
                         f"{TILE_UNIT} from {TILE_UNIT} to {MAX_TILE}")
    return int(tile)


def resolved_tile(tile: int | None = None, device=None) -> int:
    """The tile a launch on `device` (None: the card) uses: `tile` if
    given, else WEEDTPU_EC_TILE, else the pin (`load_tile_pin`) when its
    fingerprint is `chip_fingerprint(device)`, else DEFAULT_TILE.  A
    WEEDTPU_EC_TILE that is not a positive integer raises ValueError
    (the reference falls back to the pin).  Whether the kernel can take
    the tile is `check_tile`'s question, asked before any launch."""
    if tile is not None:
        return tile
    env = os.environ.get("WEEDTPU_EC_TILE")
    if env:
        try:
            t = int(env)
        except ValueError:
            t = 0
        if t <= 0:
            raise ValueError(f"WEEDTPU_EC_TILE={env!r} is not a positive "
                             f"integer")
        return t
    pin = load_tile_pin()
    if pin and pin.get("fingerprint") == chip_fingerprint(device):
        return int(pin["tile"])
    return DEFAULT_TILE


_fingerprints: dict = {}


def chip_fingerprint(device=None) -> str:
    """What a tile measurement is a property of: ``cuda:<name> sm_<cc>:
    <cards>`` for a card (None: the current one), CPU_FINGERPRINT for the
    CPU.  Memoised per card, and taken only for a device asked for: the
    CPU's creates no CUDA context."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        _fingerprints["cpu"] = CPU_FINGERPRINT
        return CPU_FINGERPRINT
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    fp = _fingerprints.get(idx)
    if fp is None:
        major, minor = torch.cuda.get_device_capability(idx)
        fp = _fingerprints[idx] = (
            f"cuda:{torch.cuda.get_device_name(idx)} sm_{major}{minor}:"
            f"{torch.cuda.device_count()}")
    return fp


def known_fingerprints() -> set:
    """The fingerprints this process has taken so far; asking takes none
    (profile.ceilings reads it where it must not touch the card)."""
    return set(_fingerprints.values())


def pin_path(path: str | None = None) -> str:
    """`path`, else WEEDTPU_TILE_PIN, else ~/.weedtpu_tile_pin.json."""
    return path or os.environ.get("WEEDTPU_TILE_PIN") or \
        os.path.join(os.path.expanduser("~"), ".weedtpu_tile_pin.json")


def save_tile_pin(tile: int, gbps: float, sweep: dict | None = None,
                  path: str | None = None, device=None) -> str:
    """Write the sweep's winner, with `device`'s fingerprint (None: the
    card) and the sweep table, atomically (a temporary file renamed), in
    the reference's format; returns the path written."""
    p = pin_path(path)
    rec = {"tile": int(tile), "gbps": round(float(gbps), 3),
           "fingerprint": chip_fingerprint(device), "ts": time.time()}
    if sweep:
        rec["sweep"] = {str(k): v for k, v in sweep.items()}
    tmp = p + ".tmp"
    with open(tmp, "w") as f:
        json.dump(rec, f)
    os.replace(tmp, p)
    return p


_pin_cache: dict[str, tuple[tuple, dict | None]] = {}


def load_tile_pin(path: str | None = None) -> dict | None:
    """The pin at `pin_path(path)`, or None.  Cached by the file's (mtime,
    size, inode), so a lookup costs one `stat` until the file changes; a
    file that does not parse, or holds no tile, is cached as None.  Hands
    out a copy."""
    p = pin_path(path)
    try:
        st = os.stat(p)
    except OSError:
        _pin_cache.pop(p, None)
        return None
    key = (st.st_mtime_ns, st.st_size, st.st_ino)
    hit = _pin_cache.get(p)
    if hit is not None and hit[0] == key:
        return dict(hit[1]) if hit[1] is not None else None
    try:
        with open(p) as f:
            rec = json.load(f)
    except OSError:
        return None  # gone between the stat and the open: not cached
    except ValueError:
        rec = None
    rec = rec if isinstance(rec, dict) and rec.get("tile") else None
    _pin_cache[p] = (key, rec)
    return dict(rec) if rec is not None else None


def micro_sweep(k: int = 10, m: int = 4, n: int | None = None,
                iters: int = 3, ensure_tile: int | None = None,
                device=None) -> dict[int, float]:
    """{tile: GB/s} of RS(k, m)'s parity apply (K1) on the card at every
    SWEEP_TILES candidate and `ensure_tile` (the pin a sentinel watches),
    over [k, n] bytes from a fixed seed: n defaults to SWEEP_N, or the
    largest candidate if that is larger, and is moved to a multiple of
    `ensure_tile` as the reference moves it.  Each candidate is launched
    once to warm up, then `iters` times between two CUDA events on the
    current stream, enqueued while the card sleeps (SWEEP_SLEEP_CYCLES),
    so back to back and with the input warm in L2; GB/s is k * n over the
    mean seconds.  So a sweep launches K1 (1 + iters) times per
    candidate.  Raises on the CPU (the
    plain version has no tile), on a tile the kernel cannot take, and on
    a launch that fails: no candidate is skipped."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"micro_sweep times the kernel's launch tile on a "
                         f"card; the plain version on {dev} has none")
    from seaweedfs_tpu_torch.models import rs
    tiles = sorted(set(SWEEP_TILES) |
                   ({int(ensure_tile)} if ensure_tile else set()))
    if n is None:
        n = max(SWEEP_N, max(SWEEP_TILES))
        if ensure_tile:
            t = int(ensure_tile)
            if t > n:
                n = t
            elif n % t:
                n = (n // t) * t
    mats = [CudaGFMatrix(rs.get_code(k, m).parity_matrix, tile=t)
            for t in tiles]
    data = device_empty((k, n), dev)
    data.copy_(torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (k, n), dtype=np.uint8)))
    out: dict[int, float] = {}
    with torch.cuda.device(dev):
        for t, mat in zip(tiles, mats):
            mat(data)  # the tables' copy and the first launch
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SWEEP_SLEEP_CYCLES)
            start.record()
            for _ in range(iters):
                mat(data)
            end.record()
            end.synchronize()
            out[t] = k * n / 1e9 / (start.elapsed_time(end) / 1e3 / iters)
    return out


# -- plain version -------------------------------------------------------

@contextlib.contextmanager
def one_intra_op_thread():
    """Run the block's CPU ops on the calling thread alone, then give the
    thread back the intra-op thread count it had.  Under a loaded host a
    team of one thread per core waits at every op's barrier for threads
    the scheduler parked: a [2, 10] @ [10, 50 000] plain product took
    219 ms on the team against 14 ms on one thread (ROADMAP fault 3.16)."""
    n = torch.get_num_threads()
    if n == 1:
        yield
        return
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def gf_apply_plain(bitmat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[..., k, n] uint8 -> [..., m, n]: the product over GF(2^8) by the
    bit-sliced algorithm.  `bitmat` is the [8m, 8k] 0/1 lift of C
    (`gf.gf_matrix_to_bitmatrix`): row 8i+r makes bit r of output i,
    column 8j+s reads bit s of input j."""
    if x.dtype != torch.uint8:
        raise TypeError(f"want uint8, got {x.dtype}")
    # exact whatever torch.backends.cuda.matmul.allow_tf32 says: 0 and 1
    # are exact in TF32 and every sum, at most 8k < 2^11, is exact in
    # float32
    *lead, k, n = x.shape
    m = bitmat.shape[0] // 8
    shifts = torch.arange(8, dtype=torch.uint8, device=x.device)
    bits = (x.unsqueeze(-2) >> shifts[:, None]) & 1  # [..., k, 8, n]
    bits = bits.reshape(*lead, 8 * k, n).to(torch.float32)
    acc = torch.matmul(bitmat.to(device=x.device, dtype=torch.float32), bits)
    ybits = (acc.to(torch.int32) & 1).reshape(*lead, m, 8, n)
    weights = (torch.ones(8, dtype=torch.int32, device=x.device)
               << torch.arange(8, dtype=torch.int32, device=x.device))
    return (ybits * weights[:, None]).sum(dim=-2).to(torch.uint8)


# -- kernel wrapper ------------------------------------------------------

def nibble_tables(C: np.ndarray) -> np.ndarray:
    """The kernel's lookup tables for the [m, k] matrix C: [m, k, 32]
    uint8, for each coefficient c first lo[x] = c*x, then hi[x] =
    c*(x << 4), x < 16, so that c*b = lo[b & 15] ^ hi[b >> 4]."""
    mul = gf.GF_MUL_TABLE[np.asarray(C, dtype=np.uint8)]  # [m, k, 256]
    x = np.arange(16)
    return np.ascontiguousarray(
        np.concatenate([mul[..., x], mul[..., x << 4]], axis=-1),
        dtype=np.uint8)


def _in_place(x: torch.Tensor) -> bool:
    """Whether the kernel can read [U, k, n] `x` where it lies: unit-stride
    rows on a 16-byte aligned base, row and unit strides too."""
    U, k, _ = x.shape
    return x.stride(2) == 1 and x.data_ptr() % ALIGN == 0 and \
        (k == 1 or x.stride(1) % ALIGN == 0) and \
        (U == 1 or x.stride(0) % ALIGN == 0)


def gf_apply_cuda(tables: torch.Tensor, x: torch.Tensor,
                  name: str = "gf_apply",
                  tile: int = DEFAULT_TILE) -> torch.Tensor:
    """Launch the kernel on [U, k, n] uint8 `x` with the [m, k, 32]
    `nibble_tables` of the matrix, both on the same card, at launch tile
    `tile` (`check_tile`).  Returns
    [U, m, n] (a view of a 16-byte-padded buffer), enqueued on the current
    stream.  C is applied in row blocks of up to ROW_BLOCK rows, one
    launch each, and each launch that succeeds adds one to
    `LAUNCHES[name]`.

    Strided rows and units on 16-byte boundaries are read in place; any
    other view is copied once into a padded buffer first, which adds one
    to `STAGED[name]`.  Raises on another device or dtype, on shapes the
    kernel does not take, and when a launch fails.  An empty `x` launches
    nothing and counts nothing."""
    from seaweedfs_tpu_torch import _build
    if not x.is_cuda or x.device != tables.device:
        raise ValueError(f"kernel wants x and tables on one card, got "
                         f"{x.device} / {tables.device}")
    if x.dtype != torch.uint8 or tables.dtype != torch.uint8:
        raise TypeError("kernel wants uint8 tensors")
    if x.dim() != 3:
        raise ValueError(f"kernel wants [U, k, n], got {tuple(x.shape)}")
    U, k, n = x.shape
    m, kc, width = tables.shape
    if kc != k or width != 32 or not tables.is_contiguous():
        raise ValueError(f"tables {tuple(tables.shape)} do not fit k={k}")
    _check_shape(m, k)
    check_tile(tile)
    if U > MAX_UNITS:
        raise ValueError(f"kernel takes at most {MAX_UNITS} units, got {U}")
    out = device_empty((U, m, n), x.device)
    if n == 0 or U == 0:
        return out
    if not _in_place(x):
        staged = device_empty((U, k, n), x.device)
        staged.copy_(x)
        x = staged
        with _launch_lock:
            STAGED[name] += 1
    # the default tile's kernels keep the untiled loop (csrc/gf_matmul.cu)
    lib = _build.load("gf_matmul" if tile == DEFAULT_TILE
                      else "gf_matmul_tiled")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for r0 in range(0, m, ROW_BLOCK):
            rows = min(ROW_BLOCK, m - r0)
            err = lib.gf_apply_u8(tables[r0].data_ptr(), rows, k,
                                  x.data_ptr(), x.stride(0), x.stride(1),
                                  out[:, r0].data_ptr(), out.stride(0),
                                  out.stride(1), n, U, tile, stream)
            if err != 0:
                raise RuntimeError(f"gf_apply_u8 launch failed: "
                                   f"cudaError {err}")
            with _launch_lock:
                LAUNCHES[name] += 1
    return out


def _check_shape(m: int, k: int) -> None:
    """The shapes a GF(2^8) code can give a matrix: k + m <= 256."""
    if m < 1 or k < 1 or k + m > 256:
        raise ValueError(f"matrix [{m}, {k}]: want m, k >= 1 and "
                         f"k + m <= 256, as a GF(2^8) code allows")


class CudaGFMatrix:
    """A fixed GF(2^8) matrix, applied by the kernel to CUDA tensors and
    by the plain version to CPU tensors.  The kernel's lookup tables are
    built once, here, and copied to each card at first use.  Every launch
    takes `tile` (`check_tile`, raising here on one the kernel cannot
    take); None resolves it per card at the first launch there
    (`resolved_tile`) and keeps it.  The plain version ignores it."""

    def __init__(self, C: np.ndarray, tile: int | None = None):
        self.C = np.ascontiguousarray(C, dtype=np.uint8)
        self.m, self.k = self.C.shape
        _check_shape(self.m, self.k)
        self.tile = None if tile is None else check_tile(tile)
        self._tiles: dict[torch.device, int] = {}
        self.bitmat = torch.from_numpy(
            gf.gf_matrix_to_bitmatrix(self.C)).to(torch.float32)
        self.tables = nibble_tables(self.C)
        self._on_device: dict[torch.device, torch.Tensor] = {}

    def tables_on(self, device: torch.device) -> torch.Tensor:
        """`tables` on `device`, copied there at first use."""
        t = self._on_device.get(device)
        if t is None:
            t = self._on_device[device] = torch.from_numpy(
                self.tables).to(device)
        return t

    def tile_on(self, device: torch.device) -> int:
        """The launch tile on `device`: the constructor's, else the one
        `resolved_tile` gave at the first launch there."""
        if self.tile is not None:
            return self.tile
        t = self._tiles.get(device)
        if t is None:
            t = self._tiles[device] = check_tile(resolved_tile(None, device))
        return t

    def _apply(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """[U, k, n] on the tensor's own device."""
        if x.shape[-2] != self.k:
            raise ValueError(f"want {self.k} input rows, got {x.shape[-2]}")
        if x.device.type == "cpu":
            with one_intra_op_thread():
                return gf_apply_plain(self.bitmat, x)
        if x.device.type != "cuda":
            raise ValueError(f"unsupported device {x.device}")
        return gf_apply_cuda(self.tables_on(x.device), x, name,
                             self.tile_on(x.device))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """[k, n] uint8 -> [m, n]."""
        return self._apply(x.unsqueeze(0), "gf_apply")[0]

    def apply_batch(self, x: torch.Tensor) -> torch.Tensor:
        """[U, k, n] unit batch -> [U, m, n] in one launch."""
        return self._apply(x, "gf_apply_batch")


class CudaRSCodec(codec_base.RSCodecBase):
    """RS codec on one device: `RSCodecBase` over `CudaGFMatrix` applies.
    `device` is where the dispatch seam (ops/dispatch.py) puts the data:
    the card runs the kernel, the CPU the plain version.  `tile` is
    resolved for that device here (`resolved_tile`) and every apply of
    the codec launches at it."""

    def __init__(self, code, device=None, tile: int | None = None):
        self.device = resolve_device(device)
        self.tile = check_tile(resolved_tile(tile, self.device))
        super().__init__(code, functools.partial(CudaGFMatrix,
                                                 tile=self.tile))


@functools.lru_cache(maxsize=16)
def _get_codec_cached(k: int, m: int, construction: str,
                      device: torch.device, tile: int) -> CudaRSCodec:
    from seaweedfs_tpu_torch.models import rs
    return CudaRSCodec(rs.get_code(k, m, construction), device, tile)


def get_codec(k: int, m: int, construction: str = "vandermonde",
              device=None, tile: int | None = None) -> CudaRSCodec:
    """RS(k, m) codec on `device` (None: the card; raises without one)
    at `resolved_tile(tile, device)`, which is part of the cache key: a
    pin written after a first call reaches the calls after it."""
    dev = resolve_device(device)
    return _get_codec_cached(k, m, construction, dev,
                             resolved_tile(tile, dev))
