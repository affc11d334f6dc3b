"""Shared codec shell: encode/reconstruct orchestration over a matrix-apply
backend, on torch tensors.

Counterpart of `seaweedfs_tpu/ops/codec_base.py`.  Survivor selection and
decode-matrix caching live here once.  Any code object exposing k/m/n,
`parity_matrix` and `decode_matrix(available, wanted)` plugs in: RS, LRC
(ops/lrc.py) and the MSR inner code (ops/msr.py).  Non-MDS codes also
expose `decode_select(available, wanted)`, which names the survivor basis
the decode matrix's columns follow; without it a decode reads the first k
sorted survivors (MDS).  `RSCodecBase.basis` is the one place a caller
asks which survivors to read, and it caches the answer per pattern.
"""

from __future__ import annotations

import collections
import os
import threading

import torch

from seaweedfs_tpu_torch.ops.rows import device_empty


def decode_cache_cap() -> int:
    """LRU bound for per-(survivors, wanted) decode matrices."""
    try:
        return max(1, int(os.environ.get("WEEDTPU_CODEC_DECODE_CACHE", "64")))
    except ValueError:
        return 64


def select_survivors(code, present, wanted) -> tuple:
    """The survivor basis a decode matrix is built against: the code's
    `decode_select` when it has one, else the MDS default of the first k
    sorted survivors."""
    sel = getattr(code, "decode_select", None)
    if sel is not None:
        return tuple(sel(sorted(present), list(wanted)))
    return tuple(sorted(present)[: code.k])


class RSCodecBase:
    """Encode / reconstruct for one fixed-matrix GF(2^8) code.

    `matrix_apply_factory(C)` returns a callable mapping a [k, n] uint8
    tensor to the [m, n] product by the fixed GF(2^8) matrix C, with
    `apply_batch` for [U, k, n]."""

    def __init__(self, code, matrix_apply_factory):
        self.code = code
        self.k, self.m, self.n = code.k, code.m, code.n
        self._factory = matrix_apply_factory
        self._parity = matrix_apply_factory(code.parity_matrix)
        self._decode_cache: collections.OrderedDict = collections.OrderedDict()
        self._bases: dict = {}
        # degraded reads of one volume decode from several threads at once
        self._lock = threading.Lock()

    def basis(self, present, wanted) -> tuple:
        """The survivors a decode of `wanted` from `present` reads
        (`select_survivors`: one local group for an LRC single loss),
        cached per pattern; the cache is emptied when it passes
        WEEDTPU_CODEC_DECODE_CACHE entries."""
        key = (tuple(sorted(present)), tuple(wanted))
        with self._lock:
            hit = self._bases.get(key)
            if hit is None:
                if len(self._bases) >= decode_cache_cap():
                    self._bases.clear()
                hit = self._bases[key] = select_survivors(self.code, *key)
        return hit

    def decoder(self, present: tuple, wanted: tuple):
        """(basis, matrix apply) for a survivor/wanted pattern: the apply
        maps the rows of the survivors in `basis` (`self.basis`) to the
        [len(wanted), n] wanted rows.  LRU-bounded by
        WEEDTPU_CODEC_DECODE_CACHE."""
        basis = self.basis(present, wanted)
        key = (basis, wanted)
        with self._lock:
            hit = self._decode_cache.get(key)
            if hit is not None:
                self._decode_cache.move_to_end(key)
                return basis, hit
            mat = self._factory(self.code.decode_matrix(list(present),
                                                        list(wanted)))
            self._decode_cache[key] = mat
            while len(self._decode_cache) > decode_cache_cap():
                self._decode_cache.popitem(last=False)
        return basis, mat

    def encode_parity(self, data: torch.Tensor) -> torch.Tensor:
        """[k, n] data -> [m, n] parity (systematic: data shards unchanged)."""
        return self._parity(data)

    def encode_parity_batch(self, units: torch.Tensor) -> torch.Tensor:
        """[U, k, n] unit batch -> [U, m, n] parity in one dispatch."""
        return self._parity.apply_batch(units)

    def encode(self, data: torch.Tensor) -> torch.Tensor:
        """[k, n] data -> [k+m, n] shards, in a buffer whose rows are
        16 bytes apart, so the parity apply reads the data rows in place."""
        out = device_empty((self.n, data.shape[1]), data.device)
        out[: self.k].copy_(data)
        out[self.k:].copy_(self.encode_parity(out[: self.k]))
        return out

    def reconstruct(self, shards: dict[int, torch.Tensor],
                    wanted: list[int] | None = None
                    ) -> dict[int, torch.Tensor]:
        """Rebuild missing shards from sufficient survivors; the decode
        matrix is cached per (basis, wanted) pattern.  The survivors are
        stacked into one [k, n] buffer whose rows are 16 bytes apart, which
        the card's kernel reads in place whatever n is."""
        present = tuple(sorted(shards))
        if wanted is None:
            wanted = [i for i in range(self.n) if i not in shards]
        if not wanted:
            return {}
        basis, mat = self.decoder(present, tuple(wanted))
        first = shards[basis[0]]
        stack = device_empty((len(basis), first.shape[0]), first.device)
        for r, i in enumerate(basis):
            stack[r].copy_(shards[i])
        out = mat(stack)
        return {w: out[i] for i, w in enumerate(wanted)}
