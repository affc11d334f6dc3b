"""Image operations on the read path: resize and crop.

Counterpart of `seaweedfs_tpu/images.py` (reference: weed/images/
resizing.go, served as ?width=&height=&mode= on volume reads), cut to
what the volume server calls: `fix_orientation` has no caller in either
package.  PIL does the pixel work and stays optional, as in the
reference: without it, or on an image it cannot read, the bytes come
back unchanged.
"""

from __future__ import annotations

import io

RESIZABLE = ("image/jpeg", "image/png", "image/gif", "image/webp")


def is_image_mime(mime: str) -> bool:
    return (mime or "").lower() in RESIZABLE


def resized(data: bytes, mime: str, width: int = 0, height: int = 0,
            mode: str = "") -> bytes:
    """Resize on read (reference: images/resizing.go Resized):
      mode ''    : preserve ratio within the WxH box
      mode 'fit' : pad to exactly WxH, preserving ratio
      mode 'fill': crop-to-fill exactly WxH."""
    if not (width or height) or not is_image_mime(mime):
        return data
    try:
        from PIL import Image, ImageOps
        img = Image.open(io.BytesIO(data))
        w0, h0 = img.size
        w, h = width or w0, height or h0
        if mode == "fill":
            img = ImageOps.fit(img, (w, h))
        elif mode == "fit":
            img = ImageOps.pad(img, (w, h))
        else:
            img = img.copy()
            img.thumbnail((w, h))
        fmt = {"image/jpeg": "JPEG", "image/png": "PNG", "image/gif": "GIF",
               "image/webp": "WEBP"}[mime.lower()]
        out = io.BytesIO()
        if fmt == "JPEG" and img.mode not in ("RGB", "L"):
            img = img.convert("RGB")
        img.save(out, format=fmt)
        return out.getvalue()
    except Exception:
        return data
