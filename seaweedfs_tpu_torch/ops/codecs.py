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

import dataclasses
import functools
import os

import torch

from seaweedfs_tpu_torch.storage.ec import layout

DEFAULT_TAG = "rs_10_4"


@dataclasses.dataclass(frozen=True)
class CodecSpec:
    """Identity + geometry of one registered code."""
    tag: str
    family: str       # rs | lrc | msr
    k: int            # data shard files
    m: int            # parity shard files
    n: int            # total shard files
    alpha: int        # sub-packetization (1 for rs/lrc)
    params: tuple     # family params, e.g. (10, 4) / (10, 2, 2) / (9, 16)


def _family_params(var: str, default: str, count: int) -> tuple:
    """The comma-separated ints a bare family name stands for.  A
    malformed value raises: a typo must not quietly pick another code."""
    raw = os.environ.get(var, default)
    try:
        params = tuple(int(v) for v in raw.split(","))
    except ValueError:
        params = ()
    if len(params) != count:
        raise ValueError(
            f"{var}={raw!r}: want {count} comma-separated integers")
    return params


def _spec_rs(k: int, m: int) -> CodecSpec:
    return CodecSpec(tag=f"rs_{k}_{m}", family="rs", k=k, m=m, n=k + m,
                     alpha=1, params=(k, m))


def _spec_lrc(k: int, l: int, g: int) -> CodecSpec:  # noqa: E741
    return CodecSpec(tag=f"lrc_{k}_{l}_{g}", family="lrc", k=k, m=l + g,
                     n=k + l + g, alpha=1, params=(k, l, g))


def _spec_msr(k: int, d: int) -> CodecSpec:
    n = d + 2
    return CodecSpec(tag=f"msr_{k}_{d}", family="msr", k=k, m=n - k, n=n,
                     alpha=k - 1, params=(k, d))


def parse_tag(tag: str | None) -> CodecSpec:
    """Tag string -> CodecSpec.  None, "", bare family names and any
    unparseable/unknown tag degrade to a usable spec: a volume with no
    codec tag is RS.  Only a malformed WEEDTPU_CODEC_LRC / _MSR behind a
    bare family name raises."""
    if not tag:
        return parse_tag(DEFAULT_TAG)
    tag = str(tag).strip().lower()
    if tag == "rs":
        return _spec_rs(10, 4)
    if tag == "lrc":
        return _spec_lrc(*_family_params("WEEDTPU_CODEC_LRC", "10,2,2", 3))
    if tag == "msr":
        return _spec_msr(*_family_params("WEEDTPU_CODEC_MSR", "9,16", 2))
    parts = tag.split("_")
    try:
        if parts[0] == "rs" and len(parts) == 3:
            return _spec_rs(int(parts[1]), int(parts[2]))
        if parts[0] == "lrc" and len(parts) == 4:
            return _spec_lrc(int(parts[1]), int(parts[2]), int(parts[3]))
        if parts[0] == "msr" and len(parts) == 3:
            return _spec_msr(int(parts[1]), int(parts[2]))
    except ValueError:
        pass
    return parse_tag(DEFAULT_TAG)


def default_tag() -> str:
    """The codec newly-encoded volumes get when nothing chose one:
    WEEDTPU_CODEC_DEFAULT accepts a full tag or a bare family name."""
    return parse_tag(os.environ.get("WEEDTPU_CODEC_DEFAULT",
                                    DEFAULT_TAG)).tag


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
        return _build(spec.tag, None, kind)
    from seaweedfs_tpu_torch.ops import gf_cuda
    dev = gf_cuda.resolve_device(device)
    if spec.family == "rs":
        return gf_cuda.get_codec(layout.DATA_SHARDS, layout.PARITY_SHARDS,
                                 device=dev)
    return _build(spec.tag, dev, kind)


@functools.lru_cache(maxsize=8)
def _mesh_codec(k: int, m: int, positions: tuple):
    from seaweedfs_tpu_torch.models import rs
    from seaweedfs_tpu_torch.parallel import mesh
    return mesh.ShardedRSEncoder(rs.get_code(k, m),
                                 mesh.make_mesh(devices=list(positions)))


@functools.lru_cache(maxsize=16)
def _build(tag: str, device, kind: str):
    from seaweedfs_tpu_torch.ops import gf_cuda, lrc, msr, native_codec
    spec = parse_tag(tag)
    code = lrc.get_code(*spec.params) if spec.family == "lrc" \
        else msr.get_code(*spec.params)
    shell = native_codec.NativeRSCodec(code) if kind == "native" \
        else gf_cuda.CudaRSCodec(code, device)
    return shell if spec.family == "lrc" else msr.MSRFileCodec(shell)
