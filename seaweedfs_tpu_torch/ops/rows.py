"""The row layout the card's GF(2^8) kernel reads in place: rows that start
16 bytes apart, held as the [..., :n] view of a buffer `padded_width(n)`
bytes wide.

The dispatch seam, the codec shell and the kernel wrapper all allocate
rows in this layout; it lives here, importing nothing of the codec, so
each of them can use it without reaching into another layer.
"""

from __future__ import annotations

import torch

ALIGN = 16  # bytes: the kernel's vector width (csrc/gf_matmul.cu)


def padded_width(n: int) -> int:
    """Row width, in bytes, of a buffer whose [:, :n] view the kernel reads
    in place: n rounded up to the kernel's 16-byte vector."""
    return -(-n // ALIGN) * ALIGN


def device_empty(shape, device: torch.device) -> torch.Tensor:
    """An uninitialised uint8 [..., n] tensor on `device`: the [..., :n]
    view of a buffer whose rows are `padded_width(n)` bytes wide."""
    *lead, n = shape
    buf = torch.empty((*lead, padded_width(n)), dtype=torch.uint8,
                      device=device)
    return buf[..., :n]
