"""The card kernel's lookup tables, the one interface between Python and
`csrc/gf_matmul.cu` that a run without a card can reach.

`gf_cuda.nibble_tables` builds, on the host, the [m, k, 32] tables the
wrapper copies to the card.  Here they are held against the JAX package's
GF(2^8) multiply table, and a numpy model of the kernel's word-wide
lookup (PRMT selectors and bit-3 masks, the lookups and their XOR fold,
the byte unshuffle; written out below and not in the package) reads them
in exactly that layout and reproduces `seaweedfs_tpu.ops.gf.gf_matmul`.
"""

import numpy as np
import pytest

from seaweedfs_tpu.ops import gf as ref_gf

from seaweedfs_tpu_torch.ops import gf_cuda

# ---- a numpy model of the kernel's lookup --------------------------------


def prmt(a, b, s):
    """PTX `prmt.b32 d, a, b, s` (default mode) on uint32 arrays: byte n of
    d is byte (s >> 4n) & 7 of the 8 bytes {b:a}; bit 3 of that selector
    nibble replaces the byte by its sign bit, replicated."""
    src = (b.astype(np.uint64) << np.uint64(32)) | a.astype(np.uint64)
    d = np.zeros(np.broadcast(a, b, s).shape, dtype=np.uint64)
    s = np.asarray(s, dtype=np.uint64)
    for n in range(4):
        sel = (s >> np.uint64(4 * n)) & np.uint64(0xF)
        byte = (src >> (np.uint64(8) * (sel & np.uint64(7)))) & np.uint64(0xFF)
        sign = np.where(byte & np.uint64(0x80), np.uint64(0xFF), np.uint64(0))
        byte = np.where(sel & np.uint64(8), sign, byte)
        d |= byte << np.uint64(8 * n)
    return d.astype(np.uint32)


def make_sel(w):
    """`make_sel` of the kernel: (lo, hi, mlo, mhi) of uint32 words w, in
    the byte order (2, 0, 3, 1)."""
    zero = np.zeros_like(w)
    a = w & np.uint32(0x07070707)
    b = w & np.uint32(0x70707070)
    return ((a >> np.uint32(16)) | (a << np.uint32(4)),
            b | (b >> np.uint32(20)),
            prmt(w << np.uint32(4), zero, 0x9B8A),
            prmt(w, zero, 0x9B8A))


def unshuffle(v):
    return prmt(v, np.zeros_like(v), 0x2031)


def coef_from(lo, hi):
    """`coef_from` of the kernel: lo, hi = the 4 words of each half table;
    returns (t, c8) as the inner loop reads them."""
    zero = np.zeros(1, np.uint32)
    return ((lo[0], lo[1], hi[0], hi[1]),
            (prmt(lo[2:3], zero, 0)[0], prmt(hi[2:3], zero, 0)[0]))


def mac(acc, coef, sel):
    (t, c8), (lo, hi, mlo, mhi) = coef, sel
    return acc ^ prmt(t[0], t[1], lo) ^ prmt(t[2], t[3], hi) ^ \
        (mlo & c8[0]) ^ (mhi & c8[1])


def kernel_model(tables: np.ndarray, x: np.ndarray) -> np.ndarray:
    """[m, k, 32] tables, [k, n] uint8 -> [m, n] as the kernel computes it:
    whole 16-byte chunks a word (4 bytes) at a time, the ragged tail a byte
    at a time from the nibble tables."""
    m, k, _ = tables.shape
    n = x.shape[1]
    words = tables.view("<u4").reshape(m, k, 8)  # lo = 0..3, hi = 4..7
    coef = [[coef_from(words[i, j, :4], words[i, j, 4:]) for j in range(k)]
            for i in range(m)]
    full = (n // 16) * 16
    out = np.zeros((m, n), dtype=np.uint8)
    acc = np.zeros((m, full // 4), dtype=np.uint32)
    for j in range(k):
        sel = make_sel(np.ascontiguousarray(x[j, :full]).view("<u4"))
        for i in range(m):
            acc[i] = mac(acc[i], coef[i][j], sel)
    out[:, :full] = unshuffle(acc).view(np.uint8).reshape(m, full)
    for i in range(m):
        for j in range(k):
            v = x[j, full:]
            out[i, full:] ^= tables[i, j, v & 15] ^ tables[i, j, 16 + (v >> 4)]
    return out


# ---- tests -----------------------------------------------------------------

def test_nibble_tables_multiply_every_byte():
    """lo[c][b & 15] ^ hi[c][b >> 4] == c * b for every c and b."""
    C = np.arange(256, dtype=np.uint8).reshape(16, 16)
    t = gf_cuda.nibble_tables(C).reshape(256, 32)
    b = np.arange(256)
    got = t[:, b & 15] ^ t[:, 16 + (b >> 4)]
    assert np.array_equal(got, ref_gf.GF_MUL_TABLE)
    assert t.dtype == np.uint8 and t.flags.c_contiguous


def test_selectors_cover_every_byte_in_every_lane():
    """The word-wide lookup agrees with the byte table for each of the 256
    byte values in each of the 4 byte lanes of a word."""
    for c in (0x01, 0x8E, 0xFF):
        t = gf_cuda.nibble_tables(np.array([[c]], np.uint8))[0, 0]
        coef = coef_from(t.view("<u4")[:4], t.view("<u4")[4:])
        b = np.arange(256, dtype=np.uint32)
        for lane in range(4):
            w = b << np.uint32(8 * lane)
            got = unshuffle(mac(np.zeros_like(w), coef, make_sel(w))) >> \
                np.uint32(8 * lane) & np.uint32(0xFF)
            assert np.array_equal(got, ref_gf.GF_MUL_TABLE[c].astype(
                np.uint32)), (c, lane)


@pytest.mark.parametrize("m", [1, 4, 16])
@pytest.mark.parametrize("k", [1, 10, 32])
def test_kernel_model_equals_gf_matmul(m, k):
    g = np.random.default_rng(m * 100 + k)
    C = g.integers(0, 256, (m, k), dtype=np.uint8)
    n = 16 * int(g.integers(1, 40)) + int(g.integers(1, 16))  # ragged
    x = g.integers(0, 256, (k, n), dtype=np.uint8)
    mat = gf_cuda.CudaGFMatrix(C)
    assert mat.tables.shape == (m, k, 32)
    assert np.array_equal(kernel_model(mat.tables, x), ref_gf.gf_matmul(C, x))
