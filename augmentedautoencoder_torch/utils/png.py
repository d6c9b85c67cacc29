"""PNG I/O for machines without OpenCV.

  * `write_png(path, img)` -- the standard library (zlib): writes what
    `cv2.imwrite(path, img)` writes, pixel for pixel, for a uint8 BGR
    (H, W, 3) or gray (H, W[, 1]) image (8-bit RGB or gray) and for a
    uint16 (H, W) image (16-bit gray, e.g. a depth map); no interlace.
  * `read_png(path, unchanged=False)` -- PIL, imported in the call: equals
    `cv2.imread(path)` (3-channel BGR uint8, EXIF orientation applied) or,
    with `unchanged`, `cv2.imread(path, cv2.IMREAD_UNCHANGED)` (uint8 or
    uint16 gray (H, W), BGR (H, W, 3), BGRA (H, W, 4)).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)


def write_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 BGR (H, W, 3) or gray (H, W[, 1]) image as an 8-bit
    PNG, or a uint16 (H, W[, 1]) image as a 16-bit gray PNG."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"write_png takes uint8 or uint16 images, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    if img.ndim == 2:
        color_type, pixels = 0, img
    elif img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8:
        color_type, pixels = 2, img[:, :, ::-1]  # BGR -> the file's RGB
    else:
        raise ValueError(
            f"write_png takes (H, W), (H, W, 1) or uint8 (H, W, 3) images, got {img.dtype} {img.shape}"
        )
    bit_depth = 16 if img.dtype == np.uint16 else 8
    h, w = pixels.shape[:2]
    if bit_depth == 16:
        pixels = pixels.astype(">u2")  # the file's samples are big-endian
    rows = np.ascontiguousarray(pixels).view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()  # filter 0 per row
    header = struct.pack(">IIBBBBB", w, h, bit_depth, color_type, 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(raw, 6))
                 + _chunk(b"IEND", b""))


def _to_8bit(a: np.ndarray) -> np.ndarray:
    """cv2's depth conversion for IMREAD_COLOR: 16-bit samples >> 8."""
    return (a >> 8).astype(np.uint8) if a.dtype == np.uint16 else a.astype(np.uint8)


def read_png(path: str, unchanged: bool = False) -> np.ndarray:
    """`cv2.imread(path)` or, with `unchanged`, `cv2.imread(path,
    cv2.IMREAD_UNCHANGED)`, through PIL. Raises FileNotFoundError for a
    missing file (where cv2 returns None)."""
    from PIL import Image, ImageOps

    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with Image.open(path) as im:
        if not unchanged:
            im = ImageOps.exif_transpose(im)
        mode = im.mode
        if mode in ("I;16", "I;16B", "I;16L", "I"):
            a = np.asarray(im)
            if a.dtype != np.uint16:
                a = a.astype(np.uint16)
            return a if unchanged else np.repeat(_to_8bit(a)[:, :, None], 3, axis=2)
        if not unchanged:
            return np.ascontiguousarray(np.asarray(im.convert("RGB"))[:, :, ::-1])
        a = np.asarray(im)
    if mode == "L":
        return a.copy()
    if mode == "RGB":
        return np.ascontiguousarray(a[:, :, ::-1])
    if mode == "RGBA":
        return np.ascontiguousarray(a[:, :, [2, 1, 0, 3]])
    raise ValueError(f"read_png: PNG mode {mode!r} of {path} is not read unchanged (L, I;16, RGB, RGBA are)")
