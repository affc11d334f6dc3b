"""Codec tags: the identity and geometry of each registered erasure code.

Split out of `ops/codecs.py` so that the master, which has no device,
reads volumes' codec tags (`/cluster/perf`'s codec mix), and the shell
lists them (`ec.codecs`), without loading torch; `ops/codecs.py`
re-exports every name.  Counterpart of the tag
half of `seaweedfs_tpu/ops/codecs.py`.
"""

from __future__ import annotations

import dataclasses
import os

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

    @property
    def tolerance(self) -> int:
        """Worst-case guaranteed losses: m for MDS codes, the minimum
        distance - 1 for LRC (g + 1 with one local parity per group)."""
        if self.family == "lrc":
            return self.params[2] + 1
        return self.m

    def describe(self) -> dict:
        return {"tag": self.tag, "family": self.family, "k": self.k,
                "m": self.m, "n": self.n, "alpha": self.alpha,
                "tolerance": self.tolerance,
                "params": list(self.params)}


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


def registered() -> list[CodecSpec]:
    """The codec family as configured right now, what `ec.codecs` lists.
    A malformed WEEDTPU_CODEC_LRC or _MSR raises, as in `parse_tag`."""
    return [_spec_rs(10, 4),
            _spec_lrc(*_family_params("WEEDTPU_CODEC_LRC", "10,2,2", 3)),
            _spec_msr(*_family_params("WEEDTPU_CODEC_MSR", "9,16", 2))]
