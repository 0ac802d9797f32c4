"""Image IO: the reference's BMP format plus PNG and NPY.

BMP matches save_image (PathTrace.cpp:104-136, PathTrace.cu:74-106):
24-bit, bottom-up row order, BGR byte order, 54-byte header — so outputs
are drop-in comparable with RenderResultGL.bmp / RenderResultCuda.bmp.
PNG is a minimal stdlib-zlib encoder (no external deps).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_bmp(path: str, rgb_u8: np.ndarray) -> None:
    """Write [H, W, 3] u8 RGB (row 0 = top) as bottom-up BGR 24-bit BMP."""
    img = np.asarray(rgb_u8, np.uint8)
    h, w, _ = img.shape
    bgr_bottom_up = img[::-1, :, ::-1]
    # rows padded to 4-byte multiples
    row_bytes = w * 3
    pad = (-row_bytes) % 4
    payload = bytearray()
    for row in bgr_bottom_up:
        payload += row.tobytes() + b"\x00" * pad
    size_image = len(payload)
    with open(path, "wb") as f:
        f.write(b"BM")
        f.write(struct.pack("<IHHI", size_image + 54, 0, 0, 54))
        f.write(struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, size_image,
                            0, 0, 0, 0))
        f.write(payload)


def read_bmp(path: str) -> np.ndarray:
    """Read a 24-bit BMP back to [H, W, 3] u8 RGB (row 0 = top)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:2] == b"BM", "not a BMP"
    off = struct.unpack_from("<I", data, 10)[0]
    w = struct.unpack_from("<i", data, 18)[0]
    h = struct.unpack_from("<i", data, 22)[0]
    bpp = struct.unpack_from("<H", data, 28)[0]
    assert bpp == 24, f"only 24-bit BMP supported, got {bpp}"
    flip = h > 0
    h = abs(h)
    row_bytes = w * 3
    stride = row_bytes + ((-row_bytes) % 4)
    rows = np.frombuffer(data, np.uint8, count=stride * h, offset=off)
    rows = rows.reshape(h, stride)[:, :row_bytes].reshape(h, w, 3)
    img = rows[:, :, ::-1]  # BGR -> RGB
    return img[::-1] if flip else img


def write_png(path: str, rgb_u8: np.ndarray) -> None:
    """Minimal PNG encoder (8-bit RGB, zlib filter 0)."""
    img = np.asarray(rgb_u8, np.uint8)
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def save(path: str, rgb_u8: np.ndarray) -> None:
    """Dispatch on extension (.bmp / .png / .npy)."""
    if path.endswith(".bmp"):
        write_bmp(path, rgb_u8)
    elif path.endswith(".png"):
        write_png(path, rgb_u8)
    elif path.endswith(".npy"):
        np.save(path, rgb_u8)
    else:
        raise ValueError(f"unknown image extension: {path}")
