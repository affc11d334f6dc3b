"""The host CPU codec over the native GF(2^8) library (native.py).

Counterpart of `seaweedfs_tpu/ops/native_codec.py`: the role
klauspost/reedsolomon's SIMD assembly plays in the reference's encoder.
It runs only where the caller names it (`WEEDTPU_EC_CODEC=native`, or
`codecs.make_codec(tag, kind="native")`); nothing falls back to it.

`NativeGFMatrix` applies a fixed [m, k] GF(2^8) matrix to CPU uint8
tensors by row address (`native.gf_matmul_ptrs`), so rows 16 bytes apart
(`rows.device_empty`), the survivors' padded stack and MSR's
de-interleaved sub-rows are all read where they lie.  `NativeRSCodec` is
the `RSCodecBase` shell over it on the CPU: the dispatch seam computes
eagerly there, and the storage layer's zero-copy host paths
(`ec_files._host_parity_unit`, the host-serial rebuild) take its code's
matrices straight to the library.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from seaweedfs_tpu_torch import native
from seaweedfs_tpu_torch.ops import codec_base
from seaweedfs_tpu_torch.ops.rows import device_empty

_CPU = torch.device("cpu")


class NativeGFMatrix:
    """A fixed GF(2^8) matrix applied on the host by the native library.
    Takes CPU uint8 [k, n] (`__call__`) or [U, k, n] (`apply_batch`, one
    call per unit) whose rows have unit stride; returns the product in a
    `device_empty` buffer on the CPU."""

    def __init__(self, C: np.ndarray):
        self.C = np.ascontiguousarray(C, dtype=np.uint8)
        self.m, self.k = self.C.shape

    def _into(self, x: torch.Tensor, out: torch.Tensor) -> None:
        if x.device.type != "cpu":
            raise ValueError(f"the native codec takes CPU tensors, got "
                             f"{x.device}")
        if x.shape[-2] != self.k:
            raise ValueError(f"want {self.k} input rows, got {x.shape[-2]}")
        native.gf_matmul_ptrs(self.C, x.unbind(0), out.unbind(0),
                              x.shape[-1])

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """[k, n] uint8 -> [m, n]."""
        out = device_empty((self.m, x.shape[-1]), _CPU)
        self._into(x, out)
        return out

    def apply_batch(self, x: torch.Tensor) -> torch.Tensor:
        """[U, k, n] -> [U, m, n], unit by unit, as the reference's host
        codecs run a batch."""
        out = device_empty((x.shape[0], self.m, x.shape[-1]), _CPU)
        for u in range(x.shape[0]):
            self._into(x[u], out[u])
        return out


class NativeRSCodec(codec_base.RSCodecBase):
    """RS or LRC codec on the host CPU: `RSCodecBase` over
    `NativeGFMatrix` applies, with the shell's cached `basis` and
    `decoder`."""

    host_backend = True

    def __init__(self, code):
        super().__init__(code, NativeGFMatrix)
        self.device = _CPU


@functools.lru_cache(maxsize=16)
def get_codec(k: int, m: int,
              construction: str = "vandermonde") -> NativeRSCodec:
    """The native RS(k, m) codec."""
    from seaweedfs_tpu_torch.models import rs
    return NativeRSCodec(rs.get_code(k, m, construction))
