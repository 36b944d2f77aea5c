"""Minimal PNG writer (numpy + zlib): 8-bit RGB or RGBA, no filtering."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def encode_png(img: np.ndarray) -> bytes:
    """[H, W, 3|4] u8 → PNG file bytes."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    assert c in (3, 4), img.shape
    # filter type 0 (None) byte in front of every scanline
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)],
                         axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    color_type = 2 if c == 3 else 6
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def write_png(path, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
