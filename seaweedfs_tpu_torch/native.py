"""ctypes bindings for the port's host GF(2^8) codec (csrc/gf_native.cc)
and its chunk cipher (csrc/aes_gcm.cc).

Counterpart of the GF and AES-GCM parts of `seaweedfs_tpu/native.py`.
The module loads no torch: a CPU tensor handed to the codec means torch
is already loaded, so the filer and the cipher import it without torch.

The codec's library is the split-nibble AVX2 scheme of
klauspost/reedsolomon plus a GFNI/AVX-512 affine path, built with g++ at
first use (`_build.load("gf_native")`, which also builds its tables once,
under the load lock); the cipher's is AES-256-GCM, AES-NI where CPUID
finds it (`_build.load("aes_gcm")`).

There is no graceful degradation: a library that does not build raises
RuntimeError with the compiler's output, and forcing the GFNI kernel on a
CPU without it raises instead of running another kernel.  Under
GF_IMPL_AUTO the library picks GFNI where CPUID finds it and AVX2
otherwise; `gf_impl()` says which, so under auto it also says whether
the CPU has GFNI.

Rows are numpy arrays or CPU uint8 tensors, passed by address: each row
must have unit stride and at least n bytes (views into an mmap'd file at
any offset are fine).
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np

GF_IMPL_AUTO, GF_IMPL_AVX2, GF_IMPL_SCALAR, GF_IMPL_GFNI = 0, 1, 2, 3
IMPL_NAMES = {GF_IMPL_AVX2: "avx2", GF_IMPL_SCALAR: "scalar",
              GF_IMPL_GFNI: "gfni"}

_PTR = ctypes.c_void_p


def _lib(name: str = "gf_native") -> ctypes.CDLL:
    from seaweedfs_tpu_torch import _build
    return _build.load(name)


def gf_impl() -> int:
    """The kernel a matmul runs now: GF_IMPL_AVX2, _SCALAR or _GFNI."""
    return int(_lib().wn_gf_impl())


def set_gf_impl(impl: int) -> None:
    """Force a kernel (GF_IMPL_*) for the whole process, or GF_IMPL_AUTO
    for the best the CPU has.  Forcing GFNI on a CPU without GFNI and
    AVX-512BW raises ValueError and leaves the choice at auto."""
    if impl not in (GF_IMPL_AUTO, *IMPL_NAMES):
        raise ValueError(f"unknown GF impl {impl}")
    lib = _lib()
    lib.wn_gf_set_impl(int(impl))
    if impl == GF_IMPL_GFNI and lib.wn_gf_impl() != GF_IMPL_GFNI:
        lib.wn_gf_set_impl(GF_IMPL_AUTO)
        raise ValueError("GF_IMPL_GFNI forced on a CPU without GFNI and "
                         "AVX-512BW")


def _row_ptr(row, n: int, writable: bool) -> int:
    """The address of a row of >= n bytes with unit stride."""
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(row, torch.Tensor):
        if row.device.type != "cpu" or row.dtype != torch.uint8:
            raise ValueError(f"want CPU uint8 rows, got {row.device} "
                             f"{row.dtype}")
        if row.dim() != 1 or (row.numel() > 1 and row.stride(0) != 1):
            raise ValueError("want 1-D rows of unit stride")
        if row.numel() < n:
            raise ValueError(f"row of {row.numel()} B, need {n}")
        return row.data_ptr()
    if not isinstance(row, np.ndarray) or row.dtype != np.uint8 or \
            row.ndim != 1 or (row.size > 1 and row.strides[0] != 1):
        raise ValueError("want 1-D uint8 numpy rows of unit stride")
    if row.size < n:
        raise ValueError(f"row of {row.size} B, need {n}")
    if writable and not row.flags.writeable:
        raise ValueError("output row is read-only")
    return row.ctypes.data


def gf_matmul_ptrs(mat: np.ndarray, in_rows, out_rows, n: int) -> None:
    """out_rows[r][:n] = XOR_j mat[r, j] * in_rows[j][:n] over GF(2^8).

    The rows may lie anywhere (straight off an mmap'd .dat, or the rows
    of a padded buffer), so an encode or rebuild stages no copy.  Each
    in_rows[j] and out_rows[r] is a 1-D uint8 numpy array or CPU tensor
    of unit stride with >= n bytes; outputs must not overlap inputs."""
    mat = np.ascontiguousarray(mat, dtype=np.uint8)
    if mat.ndim != 2:
        raise ValueError(f"want a [rows, k] matrix, got {mat.shape}")
    rows, k = mat.shape
    if len(in_rows) != k or len(out_rows) != rows:
        raise ValueError(f"matrix {mat.shape} against {len(in_rows)} input "
                         f"and {len(out_rows)} output rows")
    if n < 0:
        raise ValueError(f"n = {n}")
    if rows == 0 or n == 0:
        return
    ins = (_PTR * k)(*[_row_ptr(r, n, False) for r in in_rows])
    outs = (_PTR * rows)(*[_row_ptr(r, n, True) for r in out_rows])
    # in_rows / out_rows hold the buffers alive across the call
    _lib().wn_gf_matmul_ptrs(mat.ctypes.data, rows, k, ins, outs, n)


# -- the chunk cipher: AES-256-GCM with a 12-byte nonce -------------------

def _bytes_ptr(b: bytes) -> int:
    return ctypes.cast(ctypes.c_char_p(b), _PTR).value or 0


def aes256_gcm_seal(key: bytes, nonce: bytes, plaintext: bytes,
                    aad: bytes = b"") -> bytes:
    """ciphertext || tag, the layout of Go's gcm.Seal that the reference
    stores for a sealed chunk (weed/util/cipher.go)."""
    if len(key) != 32 or len(nonce) != 12:
        raise ValueError(f"want a 32-byte key and a 12-byte nonce, got "
                         f"{len(key)} and {len(nonce)}")
    key, nonce, plaintext, aad = (bytes(key), bytes(nonce),
                                  bytes(plaintext), bytes(aad))
    out = ctypes.create_string_buffer(len(plaintext) + 16)
    base = ctypes.addressof(out)
    _lib("aes_gcm").wn_aes256_gcm_seal(
        _bytes_ptr(key), _bytes_ptr(nonce), _bytes_ptr(aad), len(aad),
        _bytes_ptr(plaintext), base, len(plaintext), base + len(plaintext))
    return out.raw


def aes256_gcm_open(key: bytes, nonce: bytes, sealed: bytes,
                    aad: bytes = b"") -> bytes:
    """The plaintext of ciphertext || tag; ValueError when the tag does
    not authenticate it."""
    if len(key) != 32 or len(nonce) != 12 or len(sealed) < 16:
        raise ValueError(f"want a 32-byte key, a 12-byte nonce and >= 16 "
                         f"sealed bytes, got {len(key)}, {len(nonce)} and "
                         f"{len(sealed)}")
    key, nonce, sealed, aad = (bytes(key), bytes(nonce), bytes(sealed),
                               bytes(aad))
    n = len(sealed) - 16
    out = ctypes.create_string_buffer(max(n, 1))
    rc = _lib("aes_gcm").wn_aes256_gcm_open(
        _bytes_ptr(key), _bytes_ptr(nonce), _bytes_ptr(aad), len(aad),
        _bytes_ptr(sealed), ctypes.addressof(out), n,
        _bytes_ptr(sealed) + n)
    if rc != 0:
        raise ValueError("cipher: message authentication failed")
    return out.raw[:n]
