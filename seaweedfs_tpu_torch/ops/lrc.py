"""LRC(k, l, g): locally repairable codes with per-group XOR parities.

The Facebook warehouse study (arXiv:1309.0186) measures what RS costs a
hot cluster: every degraded read of a single lost shard fans in k full
survivor ranges.  An LRC splits the k data shards into l local groups
of r = k/l and gives each group its own local parity (the XOR of its
members), plus g global parities for multi-loss protection — so the
overwhelmingly common single-shard degraded read touches ONE group:
r surviving shards instead of k, and never crosses group boundaries.

Construction
------------
Generator [n, k] over GF(2^8), n = k + l + g:

- rows 0..k-1: identity (systematic);
- rows k..k+l-1: local parities — row k+i is all-ones over group i's
  columns, zero elsewhere (plain XOR, so local repair needs no table
  multiplies at all);
- rows k+l..n-1: global parities — extended-Cauchy rows 1/(x_i + y_j)
  with distinct x_i, y_j.  Together with the all-ones local rows these
  form a generalized Cauchy family (the ones row is the x -> infinity
  limit), which is what makes every information-theoretically
  decodable loss pattern actually decode; the default LRC(10,2,2) has
  distance 4 (any 3 losses decode, verified exhaustively by the tests).

Unlike RS, the code is NOT MDS: "first k sorted survivors" is not a
valid decode basis (two data losses in one group leave its local
parity useless).  Decoding therefore goes through `decode_select`,
which picks a preferred basis by Gaussian elimination — local group
first, then other data rows, locals, globals — and `decode_matrix`,
whose columns follow that basis.  The codec shell (ops/codec_base.py)
consumes exactly this pair, so the card's GF(2^8) kernel runs LRC
unchanged: it is just another fixed GF(2^8) matrix.

Counterpart of `seaweedfs_tpu/ops/lrc.py`; the matrices are the same
array for array.
"""

from __future__ import annotations

import functools

import numpy as np

from seaweedfs_tpu_torch.ops import gf

DEFAULT_K = 10
DEFAULT_L = 2  # local groups
DEFAULT_G = 2  # global parities


class LRCCode:
    """A systematic LRC(k, l, g) code over GF(2^8).

    k data shards in l groups of r = k/l, one XOR local parity per
    group, g extended-Cauchy global parities.  Pure metadata + numpy
    reference codec, same contract as models/rs.RSCode plus the local
    -repair hooks (`group_of`, `repair_support`, `decode_select`)."""

    family = "lrc"

    def __init__(self, k: int = DEFAULT_K, l: int = DEFAULT_L,  # noqa: E741
                 g: int = DEFAULT_G):
        if k < 2 or l < 1 or g < 0 or k % l != 0:
            raise ValueError(f"bad LRC({k},{l},{g}): need k % l == 0")
        self.k = k
        self.l = l  # noqa: E741
        self.g = g
        self.r = k // l  # group width (data shards per local group)
        self.m = l + g
        self.n = k + self.m
        if self.n + g > 256:
            raise ValueError(f"LRC({k},{l},{g}) does not fit GF(2^8)")
        mat = np.zeros((self.n, k), dtype=np.uint8)
        mat[:k] = np.eye(k, dtype=np.uint8)
        for gi in range(l):
            mat[k + gi, gi * self.r:(gi + 1) * self.r] = 1
        # extended-Cauchy global rows: x_i = n + i keeps x disjoint from
        # y_j = j for every shard count that fits the field
        for i in range(g):
            for j in range(k):
                mat[k + l + i, j] = gf.gf_inv((self.n + i) ^ j)
        self.matrix = mat
        self.parity_matrix = mat[k:]
        self.tag = f"lrc_{k}_{l}_{g}"

    # ---- group geometry --------------------------------------------------

    def group_of(self, sid: int) -> int | None:
        """Local group of a shard id; None for global parities."""
        if sid < self.k:
            return sid // self.r
        if sid < self.k + self.l:
            return sid - self.k
        return None

    def group_members(self, gi: int) -> tuple[int, ...]:
        """Data shards of group gi plus its local parity shard."""
        return tuple(range(gi * self.r, (gi + 1) * self.r)) + (self.k + gi,)

    def repair_support(self, lost: int,
                       available: list[int]) -> list[int] | None:
        """The single-group survivor set repairing `lost`, or None when
        the loss is not locally repairable (global parity, or a second
        loss inside the group).  This is the no-wide-fan-in path: the
        returned set has exactly r shards, all in one group."""
        gi = self.group_of(lost)
        if gi is None:
            return None
        members = set(self.group_members(gi))
        support = sorted((members - {lost}) & set(available))
        if len(support) != self.r:  # a second group member is missing
            return None
        return support

    # ---- decoding --------------------------------------------------------

    def decode_select(self, available: list[int],
                      wanted: list[int]) -> list[int]:
        """Choose the survivor basis feeding `decode_matrix`.

        Preference order: single-group local repair when possible
        (degraded reads touch <= r shards, never both groups), else a
        greedy rank build over data rows first, then local, then global
        parities, pruned to the rows the solve actually uses."""
        avail = sorted(set(available))
        if len(wanted) == 1:
            support = self.repair_support(wanted[0], avail)
            if support is not None:
                return support
        w_rows = self.matrix[list(wanted)]
        # preference: identity rows are free pivots; globals are last
        order = sorted(avail, key=lambda s: (s >= self.k,
                                             s >= self.k + self.l, s))
        chosen: list[int] = []
        rank = 0
        for sid in order:
            cand = chosen + [sid]
            nr = len(gf.gf_rref(self.matrix[cand])[1])
            if nr > rank:
                chosen, rank = cand, nr
            if rank and gf.gf_solve(self.matrix[chosen].T,
                                    w_rows.T) is not None:
                break
        X = gf.gf_solve(self.matrix[chosen].T, w_rows.T)
        if X is None:
            raise ValueError(
                f"lrc: cannot reconstruct {list(wanted)} from "
                f"{avail} (undecodable loss pattern)")
        used = [sid for i, sid in enumerate(chosen) if X[i].any()]
        return sorted(used) if used else chosen[:1]

    def decode_matrix(self, available: list[int],
                      wanted: list[int]) -> np.ndarray:
        """[w, len(basis)] matrix with columns following
        decode_select(available, wanted) in sorted order, so that
        wanted_rows = M @ survivor_rows[basis]."""
        basis = self.decode_select(list(available), list(wanted))
        X = gf.gf_solve(self.matrix[basis].T, self.matrix[list(wanted)].T)
        if X is None:
            raise ValueError(
                f"lrc: basis {basis} cannot express {list(wanted)}")
        return np.ascontiguousarray(X.T, dtype=np.uint8)

    # ---- slow reference codec (numpy, for tests) -------------------------

    def encode_numpy(self, data: np.ndarray) -> np.ndarray:
        data = np.asarray(data, dtype=np.uint8)
        assert data.shape[0] == self.k, data.shape
        parity = gf.gf_matmul(self.parity_matrix, data)
        return np.concatenate([data, parity], axis=0)

    def reconstruct_numpy(self, shards: dict[int, np.ndarray],
                          wanted: list[int] | None = None
                          ) -> dict[int, np.ndarray]:
        present = sorted(shards)
        if wanted is None:
            wanted = [i for i in range(self.n) if i not in shards]
        if not wanted:
            return {}
        basis = self.decode_select(present, list(wanted))
        M = self.decode_matrix(present, list(wanted))
        stack = np.stack([np.asarray(shards[s]) for s in basis], axis=0)
        out = gf.gf_matmul(M, stack)
        return {w: out[i] for i, w in enumerate(wanted)}


@functools.lru_cache(maxsize=16)
def get_code(k: int = DEFAULT_K, l: int = DEFAULT_L,  # noqa: E741
             g: int = DEFAULT_G) -> LRCCode:
    return LRCCode(k, l, g)
