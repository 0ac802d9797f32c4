"""Radiance .hdr (RGBE) reader/writer and a procedural sky generator.

The reference depends on a missing external ``lib/hdrloader`` to load
``background.hdr`` (PathTrace.cpp:21,1150-1153; PathTrace.cu:16,1648-1674;
CMakeLists.txt:36). This module is the replacement: it reads both flat and
new-RLE scanline encodings, writes flat RGBE, and can synthesize a
deterministic environment (sky gradient + sun disc) so the demo scene is
self-contained without the repo's missing ``background.hdr`` asset.
"""

from __future__ import annotations

import numpy as np


def _rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """[..., 4] uint8 RGBE -> [..., 3] float32 (hdrloader convention)."""
    rgbe = rgbe.astype(np.float32)
    e = rgbe[..., 3]
    scale = np.where(e > 0.0, np.ldexp(np.float32(1.0), (e - 136).astype(np.int32)), 0.0)
    return ((rgbe[..., :3] + 0.5) * scale[..., None]).astype(np.float32)


def _float_to_rgbe(rgb: np.ndarray) -> np.ndarray:
    """[..., 3] float32 -> [..., 4] uint8 RGBE."""
    rgb = np.maximum(np.asarray(rgb, np.float32), 0.0)
    maxv = rgb.max(axis=-1)
    m, e = np.frexp(maxv)  # maxv = m * 2^e, m in [0.5, 1)
    scale = np.where(maxv >= 1e-32, m * 256.0 / np.maximum(maxv, 1e-32), 0.0)
    out = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    out[..., :3] = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    out[..., 3] = np.where(maxv >= 1e-32, e + 128, 0).astype(np.uint8)
    return out


def read_hdr(filepath: str) -> np.ndarray:
    """Read a Radiance .hdr file -> [H, W, 3] float32 (row 0 = top)."""
    with open(filepath, "rb") as fh:
        data = fh.read()
    # ---- header ----
    pos = data.find(b"\n\n")
    if pos < 0:
        raise ValueError("not a Radiance HDR file (no header terminator)")
    header = data[:pos].decode("latin-1")
    if not header.startswith("#?"):
        raise ValueError("not a Radiance HDR file (missing #? magic)")
    body = data[pos + 2:]
    nl = body.find(b"\n")
    dims = body[:nl].decode("latin-1").split()
    # Support the common "-Y H +X W" orientation.
    if len(dims) != 4 or dims[0] != "-Y" or dims[2] != "+X":
        raise ValueError(f"unsupported HDR orientation: {dims}")
    height, width = int(dims[1]), int(dims[3])
    buf = np.frombuffer(body[nl + 1:], np.uint8)

    out = np.zeros((height, width, 4), np.uint8)
    off = 0
    for y in range(height):
        if (
            width >= 8
            and width < 32768
            and off + 4 <= len(buf)
            and buf[off] == 2
            and buf[off + 1] == 2
            and (int(buf[off + 2]) << 8 | int(buf[off + 3])) == width
        ):
            # new-style RLE: four separately-encoded component planes
            off += 4
            for c in range(4):
                x = 0
                while x < width:
                    count = int(buf[off]); off += 1
                    if count > 128:  # run
                        out[y, x : x + count - 128, c] = buf[off]
                        off += 1
                        x += count - 128
                    else:  # literal
                        out[y, x : x + count, c] = buf[off : off + count]
                        off += count
                        x += count
        else:
            # flat scanline (with old-style run markers 1,1,1,shift)
            x = 0
            while x < width:
                px = buf[off : off + 4]
                off += 4
                if px[0] == 1 and px[1] == 1 and px[2] == 1 and x > 0:
                    run = int(px[3])
                    out[y, x : x + run] = out[y, x - 1]
                    x += run
                else:
                    out[y, x] = px
                    x += 1
    return _rgbe_to_float(out)


def write_hdr(filepath: str, img: np.ndarray) -> None:
    """Write [H, W, 3] float32 as a flat (uncompressed) Radiance .hdr."""
    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    rgbe = _float_to_rgbe(img)
    with open(filepath, "wb") as fh:
        fh.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        fh.write(f"-Y {h} +X {w}\n".encode("latin-1"))
        fh.write(rgbe.tobytes())


def procedural_sky(
    height: int = 256, width: int = 512, sun_intensity: float = 40.0
) -> np.ndarray:
    """Deterministic equirect environment: gradient sky + warm sun disc.

    Stands in for the missing background.hdr demo asset. Radiance values
    exceed the integrator's 10.0 clamp near the sun (PathTrace.cu:700) so
    the clamp path is exercised.
    """
    v = (np.arange(height) + 0.5) / height  # 0 top .. 1 bottom
    u = (np.arange(width) + 0.5) / width
    uu, vv = np.meshgrid(u, v)
    # direction from uv (inverse of SampleSphericalMap, PathTrace.cu:686-694)
    phi = (uu - 0.5) * 2.0 * np.pi
    theta = (0.5 - vv) * np.pi  # +pi/2 at top
    y = np.sin(theta)
    x = np.cos(theta) * np.cos(phi)
    z = np.cos(theta) * np.sin(phi)

    t = np.clip(y * 0.5 + 0.5, 0, 1)
    horizon = np.array([0.8, 0.65, 0.5])
    zenith = np.array([0.25, 0.45, 0.85])
    sky = horizon[None, None] * (1 - t[..., None]) + zenith[None, None] * t[..., None]
    ground = np.array([0.18, 0.15, 0.12])
    sky = np.where(y[..., None] < 0, ground[None, None] * (0.3 - 0.25 * t[..., None]), sky)

    sun_dir = np.array([0.45, 0.65, 0.6])
    sun_dir = sun_dir / np.linalg.norm(sun_dir)
    cosang = x * sun_dir[0] + y * sun_dir[1] + z * sun_dir[2]
    disc = np.clip((cosang - 0.995) / 0.005, 0, 1) ** 2
    glow = np.clip(cosang, 0, 1) ** 64
    sun_col = np.array([1.0, 0.85, 0.6])
    img = sky + sun_col[None, None] * (disc[..., None] * sun_intensity + glow[..., None] * 1.5)
    return img.astype(np.float32)
