"""Codec registry: the tag grammar, and codec builds for every family.

Counterpart of `seaweedfs_tpu/ops/codecs.py`.  A volume's erasure code is
named by a tag carried in its `.vif`:

    rs_<k>_<m>        Reed-Solomon (MDS), e.g. rs_10_4
    lrc_<k>_<l>_<g>   locally repairable, e.g. lrc_10_2_2
    msr_<k>_<d>       product-matrix regenerating, e.g. msr_9_16

`parse_tag(None)` and any unknown tag resolve to the RS default.
`make_codec` builds every family by the backend kind:

    cuda (or None)   `CudaGFMatrix`: the card's kernel, or its plain
                     version when the caller passes device="cpu"
    native           `NativeGFMatrix`: the host CPU codec (AVX2, or GFNI
                     where CPUID finds it), only when the caller names it
    mesh             RS: `parallel.mesh.ShardedRSEncoder` over the
                     positions `device` names (None: every card; one
                     device; or a sequence of them), memoized per
                     positions; LRC and MSR: the cuda kind's codec on the
                     one device named, as the reference's registry gives
                     them its one-device shell under mesh

RS and LRC are fixed GF(2^8) matrices in the `RSCodecBase` shell; MSR
wraps that shell in its interleaving file codec (ops/msr.py).  Only the
mesh kind takes a sequence of devices.  Any other kind raises, the
reference's auto, tpu, jax, numpy and its alias cpp included: its auto
turns to the CPU codec where there is no accelerator, which is the
fallback the port does not make.

Every `rs_<k>_<m>` tag builds RS(10, 4), k and m from the layout
(`storage/ec/layout.py`), as the reference does (its RS build delegates
to `ec_files._get_codec`, which takes them from the layout): the tag
names the family, and the two packages give the same code for any RS
tag.

Knobs: WEEDTPU_CODEC_DEFAULT (tag or family for newly encoded volumes),
WEEDTPU_CODEC_LRC ("k,l,g" params behind the bare "lrc" family name),
WEEDTPU_CODEC_MSR ("k,d" likewise).  Where the reference falls back to
the default params on a malformed value, the port raises.
"""

from __future__ import annotations

import functools

import torch

from seaweedfs_tpu_torch.ops.codec_tags import (  # noqa: F401
    DEFAULT_TAG, CodecSpec, default_tag, parse_tag, registered)
from seaweedfs_tpu_torch.storage.ec import layout

KINDS = ("mesh", "cuda", "native")


def _check_kind(kind: str | None) -> str:
    """The backend kind a caller named, one of KINDS (None means "cuda");
    raises ValueError on any other value."""
    if kind is None:
        return "cuda"
    if kind in KINDS:
        return kind
    raise ValueError(f"codec kind {kind!r}: the port takes "
                     f"{', '.join(KINDS)} (unset means cuda)")


def make_codec(tag: str | None, device=None, kind: str | None = None):
    """The codec for a tag.  Kind "cuda" (or None): on `device` (None:
    the card; raises without one), RS (RS(10, 4) whatever the tag's k and
    m, as the reference builds it) and LRC as `CudaRSCodec`, MSR as
    `MSRFileCodec` over one.  Kind "native": the host
    codec, `NativeRSCodec` or an `MSRFileCodec` over one, on the CPU;
    `device` must then be None or "cpu".  Kind "mesh": RS as a
    `ShardedRSEncoder` over the positions `device` names, the other
    families as kind "cuda" builds them."""
    spec = parse_tag(tag)
    kind = _check_kind(kind)
    if not isinstance(device, (str, torch.device, type(None))):
        if kind != "mesh":
            raise ValueError(f"codec kind {kind} runs on one device, not "
                             f"{device!r}")
        if spec.family != "rs":
            raise ValueError(f"{spec.tag} runs on one device under mesh, "
                             f"not {device!r}")
    if kind == "mesh":
        if spec.family == "rs":
            from seaweedfs_tpu_torch.parallel import mesh
            return _mesh_codec(layout.DATA_SHARDS, layout.PARITY_SHARDS,
                               tuple(mesh.mesh_devices(device)))
        kind = "cuda"
    if kind == "native":
        if device is not None and torch.device(device).type != "cpu":
            raise ValueError(f"the native codec runs on the CPU, not "
                             f"{device}")
        if spec.family == "rs":
            from seaweedfs_tpu_torch.ops import native_codec
            return native_codec.get_codec(layout.DATA_SHARDS,
                                          layout.PARITY_SHARDS)
        return _build(spec.tag, None, kind, None)
    from seaweedfs_tpu_torch.ops import gf_cuda
    dev = gf_cuda.resolve_device(device)
    if spec.family == "rs":
        return gf_cuda.get_codec(layout.DATA_SHARDS, layout.PARITY_SHARDS,
                                 device=dev)
    return _build(spec.tag, dev, kind, gf_cuda.resolved_tile(None, dev))


@functools.lru_cache(maxsize=8)
def _mesh_codec(k: int, m: int, positions: tuple):
    from seaweedfs_tpu_torch.models import rs
    from seaweedfs_tpu_torch.parallel import mesh
    return mesh.ShardedRSEncoder(rs.get_code(k, m),
                                 mesh.make_mesh(devices=list(positions)))


@functools.lru_cache(maxsize=16)
def _build(tag: str, device, kind: str, tile: int | None):
    """The LRC or MSR codec of `tag`; `tile`, a card codec's launch tile,
    is in the key, so a pin written since reaches the next lookup."""
    from seaweedfs_tpu_torch.ops import gf_cuda, lrc, msr, native_codec
    spec = parse_tag(tag)
    code = lrc.get_code(*spec.params) if spec.family == "lrc" \
        else msr.get_code(*spec.params)
    shell = native_codec.NativeRSCodec(code) if kind == "native" \
        else gf_cuda.CudaRSCodec(code, device, tile)
    return shell if spec.family == "lrc" else msr.MSRFileCodec(shell)
