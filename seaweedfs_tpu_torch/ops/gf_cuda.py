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
  8k < 2^11), keep the parity bit, repack.

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

`LAUNCHES` counts the kernel's launches by name ("gf_apply" for the
[k, n] apply, K1; "gf_apply_batch" for the [U, k, n] one, K2), one per
row block, raised only where a launch succeeds: a run reads it to show
its path went through the kernel.  `STAGED` counts, by the same names,
the inputs the wrapper had to copy before launching: a run reads it to
show its path handed the kernel rows it reads in place.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from seaweedfs_tpu_torch.ops import codec_base, gf
from seaweedfs_tpu_torch.ops.rows import ALIGN, device_empty, padded_width

ROW_BLOCK = 16  # output rows per launch (csrc/gf_matmul.cu kMaxM)
MAX_UNITS = 65535  # units per launch: the grid's y dimension

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


# -- plain version -------------------------------------------------------

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
                  name: str = "gf_apply") -> torch.Tensor:
    """Launch the kernel on [U, k, n] uint8 `x` with the [m, k, 32]
    `nibble_tables` of the matrix, both on the same card.  Returns
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
    lib = _build.load("gf_matmul")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for r0 in range(0, m, ROW_BLOCK):
            rows = min(ROW_BLOCK, m - r0)
            err = lib.gf_apply_u8(tables[r0].data_ptr(), rows, k,
                                  x.data_ptr(), x.stride(0), x.stride(1),
                                  out[:, r0].data_ptr(), out.stride(0),
                                  out.stride(1), n, U, stream)
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
    built once, here, and copied to each card at first use."""

    def __init__(self, C: np.ndarray):
        self.C = np.ascontiguousarray(C, dtype=np.uint8)
        self.m, self.k = self.C.shape
        _check_shape(self.m, self.k)
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

    def _apply(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """[U, k, n] on the tensor's own device."""
        if x.shape[-2] != self.k:
            raise ValueError(f"want {self.k} input rows, got {x.shape[-2]}")
        if x.device.type == "cpu":
            return gf_apply_plain(self.bitmat, x)
        if x.device.type != "cuda":
            raise ValueError(f"unsupported device {x.device}")
        return gf_apply_cuda(self.tables_on(x.device), x, name)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """[k, n] uint8 -> [m, n]."""
        return self._apply(x.unsqueeze(0), "gf_apply")[0]

    def apply_batch(self, x: torch.Tensor) -> torch.Tensor:
        """[U, k, n] unit batch -> [U, m, n] in one launch."""
        return self._apply(x, "gf_apply_batch")


class CudaRSCodec(codec_base.RSCodecBase):
    """RS codec on one device: `RSCodecBase` over `CudaGFMatrix` applies.
    `device` is where the dispatch seam (ops/dispatch.py) puts the data:
    the card runs the kernel, the CPU the plain version."""

    def __init__(self, code, device=None):
        super().__init__(code, CudaGFMatrix)
        self.device = resolve_device(device)


@functools.lru_cache(maxsize=16)
def _get_codec_cached(k: int, m: int, construction: str,
                      device: torch.device) -> CudaRSCodec:
    from seaweedfs_tpu_torch.models import rs
    return CudaRSCodec(rs.get_code(k, m, construction), device)


def get_codec(k: int, m: int, construction: str = "vandermonde",
              device=None) -> CudaRSCodec:
    """RS(k, m) codec on `device` (None: the card; raises without one)."""
    return _get_codec_cached(k, m, construction, resolve_device(device))
