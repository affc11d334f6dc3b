"""PM-MSR(k, d): product-matrix minimum-storage regenerating codes.

RS repairs one lost shard by shipping k full shards over the wire.
Regenerating codes (Dimakis et al.; construction from Rashmi, Shah &
Kumar, arXiv:1005.4178 / PAPERS.md 1412.3022) hit the cut-set bound
instead: each of d > k helpers ships a 1/alpha fraction of its shard,
for a total of d/alpha shard-equivalents.  The default PM-MSR(9,16)
has alpha = k-1 = 8, so a repair moves 16/8 = 2 shard-equivalents
instead of 9 — a repair_network_ratio of d/(k*alpha) = 16/72 = 0.222
against the naive k-shard copy, under the 0.334 reduced-read RS floor.

Construction (product-matrix, MSR point, beta = 1)
--------------------------------------------------
alpha = k - 1, d = 2*alpha = 2k - 2, n <= d + 1 nodes.  Node i has an
encoding row psi_i = [phi_i, lambda_i * phi_i] of length d, where
phi_i = [1, x_i, .., x_i^(alpha-1)] is Vandermonde over distinct
x_i = g^i and lambda_i = x_i^alpha (distinct while alpha*i < 255 for
all i).  The message is M = [[S1],[S2]] with S1, S2 symmetric
alpha x alpha — exactly B = alpha*(alpha+1) = k*alpha free symbols —
and node i stores the alpha symbols psi_i @ M.

Repair of node f: every helper j ships the single symbol
stored_j . phi_f (the same phi_f combination for all helpers); the
collected d-vector equals Psi_H @ [S1 phi_f^T; S2 phi_f^T], so the
rebuilder applies R = [I | lambda_f I] @ inv(Psi_H) and, because S1
and S2 are symmetric, R @ received is node f's content transposed.
`ops/regen.plan_msr_repair` ships these partials (`repair_coeff`,
`repair_matrix`).

Byte layout: sub-packetization is BYTE-INTERLEAVED.  Sub-row a of
node i's shard file is the byte set {t*alpha + a}; coupling is purely
local, so reconstructing byte range [o, o+s) of one shard touches only
the survivors' same alpha-aligned range, ragged tails behave exactly
as in RS, and a helper's partial read over sub-range [o, s) is one
contiguous pread of file bytes [o*alpha, (o+s)*alpha).

Two classes:
- PMMSRCode: the inner code over n*alpha "virtual rows", systematised
  so its parity_matrix [k*alpha, k*alpha] drops straight into the
  RSCodecBase / matrix_apply_factory seam (the card's GF(2^8) kernel
  runs it unchanged, in row blocks: ops/gf_cuda.py).
- MSRFileCodec: the file-level wrapper (k files in, n files out) that
  owns the interleave reshapes; what the storage layer sees.

Counterpart of `seaweedfs_tpu/ops/msr.py`; the matrices are the same
array for array.  On the card the interleave reshapes are plain data
movement: each de-interleave is written into a `rows.device_empty`
buffer, whose rows start 16 bytes apart, so the kernel reads it in place
whatever L / alpha is.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from seaweedfs_tpu_torch.ops import codec_base, gf
from seaweedfs_tpu_torch.ops.rows import device_empty

DEFAULT_K = 9
DEFAULT_D = 16
GENERATOR = 2


class PMMSRCode:
    """Inner product-matrix MSR code over virtual rows.

    Virtual row i*alpha + a is sub-row a of node i.  Systematic in the
    first k nodes' rows; `parity_matrix` is [m*alpha, k*alpha].  The
    code is node-MDS (any k whole nodes decode), NOT row-MDS — decoding
    goes through `decode_select`, which picks whole nodes."""

    family = "msr"

    def __init__(self, k: int = DEFAULT_K, d: int = DEFAULT_D,
                 n: int | None = None):
        if d != 2 * (k - 1):
            raise ValueError(f"PM-MSR needs d == 2k-2, got k={k} d={d}")
        self.k_nodes = k
        self.d = d
        self.alpha = k - 1
        self.n_nodes = n if n is not None else d + 2  # 2k-2 helpers + lost + 1
        if self.n_nodes < d + 1:
            raise ValueError(f"need n >= d+1 nodes, got {self.n_nodes}")
        if self.alpha * (self.n_nodes - 1) >= gf.ORDER:
            raise ValueError(f"PM-MSR({k},{d}) lambdas collide in GF(2^8)")
        self.m_nodes = self.n_nodes - k
        a = self.alpha
        # per-node encoding rows psi_i = [phi_i, lambda_i * phi_i]
        self.x = np.array([gf.gf_pow(GENERATOR, i)
                           for i in range(self.n_nodes)], dtype=np.uint8)
        self.phi = np.array(
            [[gf.gf_pow(int(xi), t) for t in range(a)] for xi in self.x],
            dtype=np.uint8)
        self.lam = np.array([gf.gf_pow(int(xi), a) for xi in self.x],
                            dtype=np.uint8)
        assert len(set(int(v) for v in self.lam)) == self.n_nodes
        self.psi = np.concatenate(
            [self.phi, gf.GF_MUL_TABLE[self.lam[:, None], self.phi]], axis=1)
        # E maps the B = k*alpha free symbols (upper triangles of S1, S2)
        # to the n*alpha stored symbols; systematise against the first k
        # nodes to get the generator G with parity block G[k*alpha:].
        B = a * (a + 1)
        tri = {}
        for p in range(a):
            for q in range(p, a):
                tri[(p, q)] = len(tri)
        E = np.zeros((self.n_nodes * a, B), dtype=np.uint8)
        half = B // 2
        for i in range(self.n_nodes):
            for col in range(a):  # stored symbol: phi_i @ S1[:,col] + ...
                for u in range(a):
                    s = tri[(min(u, col), max(u, col))]
                    E[i * a + col, s] ^= int(self.phi[i, u])
                    E[i * a + col, half + s] ^= gf.gf_mul(
                        int(self.lam[i]), int(self.phi[i, u]))
        D = E[: k * a]
        G = gf.gf_matmul(E, gf.gf_mat_inv(D))
        assert np.array_equal(G[: k * a], np.eye(k * a, dtype=np.uint8))
        self.G = G
        self.parity_matrix = np.ascontiguousarray(G[k * a:])
        # RSCodecBase surface: virtual-row dimensions
        self.k = k * a
        self.m = self.m_nodes * a
        self.n = self.n_nodes * a
        self.tag = f"msr_{k}_{d}"

    # ---- node geometry ---------------------------------------------------

    def node_rows(self, i: int) -> list[int]:
        return list(range(i * self.alpha, (i + 1) * self.alpha))

    def whole_nodes(self, rows) -> list[int]:
        """Node ids whose full alpha sub-rows appear in `rows`."""
        have = set(rows)
        return [i for i in range(self.n_nodes)
                if all(r in have for r in self.node_rows(i))]

    # ---- decoding (virtual-row protocol for the codec shells) ------------

    def decode_select(self, available: list[int],
                      wanted: list[int]) -> list[int]:
        """First k whole surviving nodes, as sorted virtual rows.  The
        PM code is node-MDS, so any k whole nodes form a basis."""
        nodes = self.whole_nodes(available)
        if len(nodes) < self.k_nodes:
            raise ValueError(
                f"msr: {len(nodes)} whole nodes available, need "
                f"{self.k_nodes}")
        basis: list[int] = []
        for i in nodes[: self.k_nodes]:
            basis.extend(self.node_rows(i))
        return sorted(basis)

    def decode_matrix(self, available: list[int],
                      wanted: list[int]) -> np.ndarray:
        basis = self.decode_select(list(available), list(wanted))
        inv = gf.gf_mat_inv(self.G[basis])
        return gf.gf_matmul(self.G[list(wanted)], inv)

    # ---- regenerating repair (consumed by ops/regen.py) ------------------

    def repair_coeff(self, lost_node: int) -> np.ndarray:
        """[1, alpha] helper-side combination: every helper ships
        phi_f @ its own sub-rows, one row per alpha stored."""
        return self.phi[lost_node][None, :].copy()

    def repair_matrix(self, lost_node: int,
                      helpers: list[int]) -> np.ndarray:
        """[alpha, d] rebuilder matrix R: node f's sub-rows are
        R @ stacked helper symbols (helpers in the given order)."""
        if len(helpers) != self.d:
            raise ValueError(f"msr repair needs d={self.d} helpers, "
                             f"got {len(helpers)}")
        if lost_node in helpers:
            raise ValueError("lost node cannot help itself")
        inv = gf.gf_mat_inv(self.psi[list(helpers)])  # [d, d] Vandermonde
        a = self.alpha
        eye = np.eye(a, dtype=np.uint8)
        # [I | lambda_f I] @ inv(Psi_H)
        return gf.gf_matmul(
            np.concatenate([eye, eye * self.lam[lost_node]], axis=1), inv)

    def repair_ratio(self) -> float:
        """Repair bytes over the naive k-shard copy: d / (k * alpha)."""
        return self.d / (self.k_nodes * self.alpha)


def split_rows(x: torch.Tensor, alpha: int) -> torch.Tensor:
    """[..., r, L] file rows -> [..., r*alpha, L/alpha] virtual sub-rows,
    written into a `device_empty` buffer on x's device (rows 16 bytes
    apart, which the kernel reads in place).  `x` may be any strided view
    whose last dimension is contiguous."""
    *lead, r, L = x.shape
    if L % alpha:
        raise ValueError(f"MSR rows of {L} B are not {alpha}-aligned")
    S = L // alpha
    out = device_empty((*lead, r * alpha, S), x.device)
    out.unflatten(-2, (r, alpha)).copy_(
        x.unflatten(-1, (S, alpha)).transpose(-1, -2))
    return out


def merge_rows(v: torch.Tensor, alpha: int) -> torch.Tensor:
    """[..., r*alpha, S] virtual sub-rows -> [..., r, S*alpha] file rows,
    in a `device_empty` buffer on v's device."""
    *lead, ra, S = v.shape
    r = ra // alpha
    out = device_empty((*lead, r, S * alpha), v.device)
    out.unflatten(-1, (S, alpha)).copy_(
        v.unflatten(-2, (r, alpha)).transpose(-1, -2))
    return out


class _FileApply:
    """A virtual-row matrix apply seen from the file level: de-interleave
    the [..., k, L] file rows, apply the inner [w*alpha, k*alpha] matrix,
    re-interleave to [..., w, L]."""

    def __init__(self, inner, alpha: int):
        self.inner, self.alpha = inner, alpha

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return merge_rows(self.inner(split_rows(x, self.alpha)), self.alpha)

    def apply_batch(self, x: torch.Tensor) -> torch.Tensor:
        return merge_rows(self.inner.apply_batch(split_rows(x, self.alpha)),
                          self.alpha)


class MSRFileCodec:
    """File-level MSR codec: k shard files in, n out.

    Wraps an inner `RSCodecBase` shell over PMMSRCode's virtual rows and
    owns the byte-interleave reshapes.  Exposes what the dispatch seam
    (ops/dispatch.py) and the storage layer use: `device`,
    `host_backend`, `_factory`,
    `encode_parity`, `encode_parity_batch`, `basis(present, wanted)` and
    `decoder(present, wanted)`."""

    family = "msr"

    def __init__(self, inner):
        self.inner = inner
        self.code = inner.code
        assert isinstance(self.code, PMMSRCode)
        self.k = self.code.k_nodes
        self.m = self.code.m_nodes
        self.n = self.code.n_nodes
        self.alpha = self.code.alpha
        self.device = inner.device
        # over the native host codec the dispatch seam books it as host
        self.host_backend = getattr(inner, "host_backend", False)
        self._factory = inner._factory
        self._parity = _FileApply(inner._parity, self.alpha)

    def encode_parity(self, data: torch.Tensor) -> torch.Tensor:
        """[k, L] data files -> [m, L] parity files (L % alpha == 0)."""
        return self._parity(data)

    def encode_parity_batch(self, units: torch.Tensor) -> torch.Tensor:
        """[U, k, L] -> [U, m, L] through the inner batch apply."""
        return self._parity.apply_batch(units)

    def basis(self, present, wanted) -> tuple:
        """File-level survivor choice: the first k sorted files (the code
        is node-MDS, so any k whole files decode)."""
        avail = sorted(set(present))
        if len(avail) < self.k:
            raise ValueError(f"msr: {len(avail)} survivors, need {self.k}")
        return tuple(avail[: self.k])

    def decoder(self, present: tuple, wanted: tuple):
        """(basis, file-level apply) for a survivor/wanted pattern: the
        apply maps the [k, L] rows of the k files in `basis` to the
        [len(wanted), L] wanted files through the inner shell's cached
        [w*alpha, k*alpha] decode matrix."""
        a = self.alpha
        basis = self.basis(present, wanted)
        rows = tuple(s * a + j for s in basis for j in range(a))
        want = tuple(w * a + j for w in wanted for j in range(a))
        vbasis, mat = self.inner.decoder(rows, want)
        assert vbasis == rows, (vbasis, rows)
        return basis, _FileApply(mat, a)

    # the file-level encode / reconstruct are the shell's, over the
    # file-level encode_parity and decoder above
    encode = codec_base.RSCodecBase.encode
    reconstruct = codec_base.RSCodecBase.reconstruct


@functools.lru_cache(maxsize=8)
def get_code(k: int = DEFAULT_K, d: int = DEFAULT_D) -> PMMSRCode:
    return PMMSRCode(k, d)
