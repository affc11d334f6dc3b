"""GF(2^8) arithmetic on the host (numpy).

The slow-but-correct reference implementation of the Galois field used by the
Reed-Solomon codec, plus the matrix machinery (inversion, sub-matrix selection)
needed to build decode matrices. The CUDA codec (`ops.gf_cuda`) and its
plain PyTorch version are tested against this module.

Field: GF(2^8) with the primitive polynomial x^8+x^4+x^3+x^2+1 (0x11D) and
generator 2 — the same field as the reference's reedsolomon dependency
(reference: weed/storage/erasure_coding/ec_encoder.go:77 uses
klauspost/reedsolomon, which inherits Backblaze's 0x11D tables), so shard
bytes are drop-in compatible.
"""

from __future__ import annotations

import numpy as np

POLY = 0x11D  # x^8 + x^4 + x^3 + x^2 + 1
FIELD = 256
ORDER = 255  # multiplicative group order


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(512, dtype=np.uint8)  # doubled to skip the mod in mul
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(ORDER):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    for i in range(ORDER, 512):
        exp[i] = exp[i - ORDER]
    log[0] = -1  # sentinel; callers must special-case 0
    return exp, log


GF_EXP, GF_LOG = _build_tables()

def _build_mul_table() -> np.ndarray:
    """Dense 256x256 multiplication table: handy for vectorised host-side
    encode and for building bit-matrices."""
    mul = np.zeros((256, 256), dtype=np.uint8)
    nz = np.arange(1, 256)
    mul[1:, 1:] = GF_EXP[(GF_LOG[nz][:, None] + GF_LOG[nz][None, :]) % ORDER]
    return mul


GF_MUL_TABLE = _build_mul_table()


def gf_mul(a: int, b: int) -> int:
    return int(GF_MUL_TABLE[a, b])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("0 has no inverse in GF(2^8)")
    return int(GF_EXP[(ORDER - GF_LOG[a]) % ORDER])


def gf_pow(a: int, n: int) -> int:
    """a**n in GF(2^8). By convention 0**0 == 1 (matches the reference's
    Vandermonde construction)."""
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(GF_EXP[(GF_LOG[a] * n) % ORDER])


def gf_matmul(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """Matrix product over GF(2^8). A: [m,k] uint8, B: [k,n] uint8 -> [m,n].

    Slow reference path — used for building matrices and for property tests,
    not the data plane.
    """
    A = np.asarray(A, dtype=np.uint8)
    B = np.asarray(B, dtype=np.uint8)
    m, k = A.shape
    k2, n = B.shape
    assert k == k2, (A.shape, B.shape)
    out = np.zeros((m, n), dtype=np.uint8)
    for j in range(k):
        # out ^= A[:, j] * B[j, :]
        out ^= GF_MUL_TABLE[A[:, j][:, None], B[j][None, :]]
    return out


def gf_mat_inv(A: np.ndarray) -> np.ndarray:
    """Invert a square matrix over GF(2^8) by Gauss-Jordan elimination.

    Raises ValueError if the matrix is singular.
    """
    A = np.asarray(A, dtype=np.uint8)
    n = A.shape[0]
    assert A.shape == (n, n)
    aug = np.concatenate([A.copy(), np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        # pivot
        pivot = -1
        for r in range(col, n):
            if aug[r, col] != 0:
                pivot = r
                break
        if pivot < 0:
            raise ValueError("singular matrix over GF(2^8)")
        if pivot != col:
            aug[[col, pivot]] = aug[[pivot, col]]
        # scale pivot row to 1
        inv = gf_inv(int(aug[col, col]))
        aug[col] = GF_MUL_TABLE[inv][aug[col]]
        # eliminate other rows
        for r in range(n):
            if r != col and aug[r, col] != 0:
                aug[r] ^= GF_MUL_TABLE[int(aug[r, col])][aug[col]]
    return aug[:, n:].copy()


def gf_rref(A: np.ndarray) -> tuple[np.ndarray, list[int]]:
    """Reduced row-echelon form over GF(2^8) -> (R, pivot_columns).

    Non-destructive; the pivot column list doubles as the rank."""
    R = np.array(A, dtype=np.uint8, copy=True)
    rows, cols = R.shape
    pivots: list[int] = []
    r = 0
    for c in range(cols):
        if r >= rows:
            break
        pivot = -1
        for i in range(r, rows):
            if R[i, c] != 0:
                pivot = i
                break
        if pivot < 0:
            continue
        if pivot != r:
            R[[r, pivot]] = R[[pivot, r]]
        R[r] = GF_MUL_TABLE[gf_inv(int(R[r, c]))][R[r]]
        for i in range(rows):
            if i != r and R[i, c] != 0:
                R[i] ^= GF_MUL_TABLE[int(R[i, c])][R[r]]
        pivots.append(c)
        r += 1
    return R, pivots


def gf_solve(A: np.ndarray, B: np.ndarray) -> np.ndarray | None:
    """Solve A @ X = B over GF(2^8) for X; None when inconsistent.

    A: [r, c], B: [r, w] -> X: [c, w].  Under-determined systems return
    the particular solution with every free variable zero: the codec
    layer uses this to express wanted shard rows as combinations of an
    arbitrary (possibly non-square, possibly redundant) survivor row set,
    which a plain matrix inverse cannot do for a non-MDS code like LRC."""
    A = np.asarray(A, dtype=np.uint8)
    B = np.asarray(B, dtype=np.uint8)
    r, c = A.shape
    assert B.shape[0] == r, (A.shape, B.shape)
    R, pivots = gf_rref(np.concatenate([A, B], axis=1))
    # a pivot landing in the B block means B has a row outside A's span
    if any(p >= c for p in pivots):
        return None
    X = np.zeros((c, B.shape[1]), dtype=np.uint8)
    for row, p in enumerate(pivots):
        X[p] = R[row, c:]
    return X


def gf_mul_bitmatrix(c: int) -> np.ndarray:
    """The GF(2) 8x8 bit-matrix of 'multiply by constant c'.

    GF(2^8) is an 8-dimensional vector space over GF(2) and multiplication by
    a constant is linear, so y = c*x satisfies bits(y) = M_c @ bits(x) mod 2.
    Column s of M_c is bits(c * 2^s); bit r of a byte b is (b >> r) & 1.

    This is the seed of the plain (bit-sliced) codec: a [m,k] GF(2^8)
    coding matrix expands to a [8m,8k] 0/1 matrix and encode becomes a
    matrix product followed by parity (&1).
    """
    M = np.zeros((8, 8), dtype=np.uint8)
    for s in range(8):
        prod = gf_mul(c, 1 << s)
        for r in range(8):
            M[r, s] = (prod >> r) & 1
    return M


def gf_matrix_to_bitmatrix(C: np.ndarray) -> np.ndarray:
    """Expand a [m,k] GF(2^8) matrix to its [8m,8k] GF(2) bit-matrix.

    Row 8i+r of the result computes bit r of output shard i; column 8j+s
    corresponds to bit s of input shard j.
    """
    C = np.asarray(C, dtype=np.uint8)
    m, k = C.shape
    out = np.zeros((8 * m, 8 * k), dtype=np.uint8)
    for i in range(m):
        for j in range(k):
            out[8 * i : 8 * i + 8, 8 * j : 8 * j + 8] = gf_mul_bitmatrix(int(C[i, j]))
    return out
