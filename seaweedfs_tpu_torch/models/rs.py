"""Reed-Solomon code constructions ("model families" of the EC data plane).

Builds systematic [k+m, k] generator matrices over GF(2^8) and the derived
decode/rebuild matrices. Two constructions:

- "vandermonde": Vandermonde matrix rows r^c normalised by the inverse of its
  top kxk square so the first k rows are the identity. This reproduces the
  construction used by the reference's reedsolomon dependency (reference:
  weed/storage/erasure_coding/ec_encoder.go:77 — klauspost/reedsolomon
  `buildMatrix`), so parity bytes are bit-identical and shard files
  interoperate.
- "cauchy": Cauchy matrix 1/(x_i + y_j) under the identity; any square
  submatrix is invertible by construction, and matrices exist for any
  k + m <= 256.

The default RS(10,4) with 1GB/1MB striping mirrors the reference's
erasure_coding constants (weed/storage/erasure_coding/ec_encoder.go:17-23).
"""

from __future__ import annotations

import functools

import numpy as np

from seaweedfs_tpu_torch.ops import gf

# Reference parity: weed/storage/erasure_coding/ec_encoder.go:17-23
DATA_SHARDS = 10
PARITY_SHARDS = 4
TOTAL_SHARDS = DATA_SHARDS + PARITY_SHARDS


def vandermonde(rows: int, cols: int) -> np.ndarray:
    """vm[r, c] = r**c in GF(2^8) (with 0**0 == 1)."""
    out = np.zeros((rows, cols), dtype=np.uint8)
    for r in range(rows):
        for c in range(cols):
            out[r, c] = gf.gf_pow(r, c)
    return out


def systematic_vandermonde_matrix(k: int, m: int) -> np.ndarray:
    """[k+m, k] systematic generator: vm @ inv(vm[:k]). Top k rows == I."""
    if k + m > 256:
        raise ValueError(f"RS({k},{m}): k+m must be <= 256 in GF(2^8)")
    vm = vandermonde(k + m, k)
    top_inv = gf.gf_mat_inv(vm[:k])
    mat = gf.gf_matmul(vm, top_inv)
    assert np.array_equal(mat[:k], np.eye(k, dtype=np.uint8))
    return mat


def cauchy_matrix(k: int, m: int) -> np.ndarray:
    """[k+m, k] systematic generator with a Cauchy parity block.

    Parity row i, col j = 1 / (x_i + y_j) with x_i = k + i, y_j = j; all
    x_i, y_j distinct so every square submatrix is invertible.
    """
    if k + m > 256:
        raise ValueError(f"RS({k},{m}): k+m must be <= 256 in GF(2^8)")
    mat = np.zeros((k + m, k), dtype=np.uint8)
    mat[:k] = np.eye(k, dtype=np.uint8)
    for i in range(m):
        for j in range(k):
            mat[k + i, j] = gf.gf_inv((k + i) ^ j)
    return mat


class RSCode:
    """A systematic RS(k, m) code over GF(2^8).

    Holds the generator matrix and derives decode/rebuild matrices for any
    pattern of surviving shards. All heavy byte-crunching lives in
    ops.gf_cuda; this class is pure metadata + the slow numpy reference
    codec used by tests.
    """

    def __init__(self, k: int = DATA_SHARDS, m: int = PARITY_SHARDS,
                 construction: str = "vandermonde",
                 matrix: np.ndarray | None = None):
        if k < 1 or m < 0:
            raise ValueError(f"bad RS({k},{m})")
        # k+m <= 256 is validated by the matrix constructors below
        self.k = k
        self.m = m
        self.n = k + m
        self.construction = construction
        if matrix is not None:
            self.matrix = np.array(matrix, dtype=np.uint8)
            if self.matrix.shape != (k + m, k) or not np.array_equal(
                    self.matrix[:k], np.eye(k, dtype=np.uint8)):
                raise ValueError(
                    f"RS({k},{m}): want a systematic [{k + m}, {k}] matrix")
        elif construction == "vandermonde":
            self.matrix = systematic_vandermonde_matrix(k, m)
        elif construction == "cauchy":
            self.matrix = cauchy_matrix(k, m)
        else:
            raise ValueError(f"unknown construction {construction!r}")
        self.parity_matrix = self.matrix[k:]

    # ---- matrices -------------------------------------------------------

    def decode_matrix(self, available: list[int], wanted: list[int]) -> np.ndarray:
        """Matrix reconstructing shards `wanted` from shards `available`.

        `available` must contain at least k shard indices (data or parity);
        the first k are used. Returns [len(wanted), k] over GF(2^8) so that
        wanted_shards = M @ available_shards[:k].

        Mirrors the reference's degraded-read reconstruction
        (weed/storage/store_ec.go:339-393 enc.ReconstructData) and shard
        rebuild (weed/storage/erasure_coding/ec_encoder.go:237-291).
        """
        if len(available) < self.k:
            raise ValueError(
                f"need >= {self.k} shards to reconstruct, have {len(available)}")
        rows = sorted(available)[: self.k]
        sub = self.matrix[rows]  # [k, k]
        inv = gf.gf_mat_inv(sub)  # data = inv @ shards[rows]
        want = self.matrix[list(wanted)]  # [w, k]
        return gf.gf_matmul(want, inv)

    # ---- slow reference codec (numpy) -----------------------------------

    def reconstruct_numpy(self, shards: dict[int, np.ndarray],
                          wanted: list[int]) -> dict[int, np.ndarray]:
        """Rebuild the `wanted` shards from any >= k present ones (numpy
        path; the scrubber's localiser decodes a few byte columns with
        it)."""
        present = sorted(shards)
        M = self.decode_matrix(present, wanted)
        stack = np.stack([shards[r] for r in present[: self.k]], axis=0)
        out = gf.gf_matmul(M, stack)
        return {w: out[i] for i, w in enumerate(wanted)}


@functools.lru_cache(maxsize=32)
def get_code(k: int = DATA_SHARDS, m: int = PARITY_SHARDS,
             construction: str = "vandermonde") -> RSCode:
    return RSCode(k, m, construction)


def from_reference(matrix: np.ndarray, k: int, m: int) -> RSCode:
    """An RSCode over a generator matrix handed over as a numpy array (the
    reference package's `RSCode.matrix`), so both packages code with the
    very same matrix."""
    return RSCode(k, m, construction="given", matrix=matrix)
