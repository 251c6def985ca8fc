"""Minimal dependency-free PNG writer for the render views.

The reference ships image tooling (tools/gen_image.c renders meter-face
PNGs via cairo); this is the framework's analog for persisting
utils/render images — a complete zlib-deflate RGBA PNG encoder in ~40
lines, no external imaging libraries.  A copy of
``meters_lv2_tpu/utils/png.py``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data)) + tag + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def encode_png(img: np.ndarray) -> bytes:
    """Encode [H, W, 4] uint8 RGBA (or [H, W, 3] RGB / [H, W] gray)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        if (np.issubdtype(img.dtype, np.floating) and img.size
                and float(img.max()) <= 1.0 + 1e-6):
            raise TypeError(
                "float image looks normalized to [0, 1] — scale to "
                "0..255 before encoding (a clip would silently produce "
                "a black PNG)"
            )
        img = np.clip(img, 0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    h, w, c = img.shape
    assert c in (3, 4), img.shape
    color_type = 6 if c == 4 else 2
    # filter byte 0 (None) per scanline
    raw = b"".join(b"\x00" + img[row].tobytes() for row in range(h))
    return (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR",
                 struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(raw, 6))
        + _chunk(b"IEND", b"")
    )


def write_png(path: str, img: np.ndarray) -> None:
    """Write [H, W, 4] uint8 RGBA (or [H, W, 3] RGB / [H, W] gray)."""
    with open(path, "wb") as f:
        f.write(encode_png(img))
