"""A PNG writer on the standard library (zlib), for machines without
OpenCV: `write_png(path, img)` writes what `cv2.imwrite(path, img)` writes
for a uint8 BGR (H, W, 3) or gray (H, W[, 1]) image, pixel for pixel (8-bit
RGB or gray, no interlace)."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)


def write_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 BGR (H, W, 3) or gray (H, W[, 1]) image as an 8-bit PNG."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"write_png takes uint8 images, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    if img.ndim == 2:
        color_type, pixels = 0, img
    elif img.ndim == 3 and img.shape[2] == 3:
        color_type, pixels = 2, img[:, :, ::-1]  # BGR -> the file's RGB
    else:
        raise ValueError(f"write_png takes (H, W), (H, W, 1) or (H, W, 3) images, got {img.shape}")
    h, w = pixels.shape[:2]
    rows = np.ascontiguousarray(pixels).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()  # filter 0 per row
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(raw, 6))
                 + _chunk(b"IEND", b""))
