"""The orbit camera (PathTrace.cpp:209-211, 671-673) and its jittered
primary rays (PathTrace.cu:1430-1435): the eye orbits ``center`` at
radius ``r``; a ray's direction is ``camera_rotate * (ndc_x, ndc_y,
-1.5, 0)``, matrices stored GLM-style as m[col, row]."""

from __future__ import annotations

import math

import numpy as np
import torch

from . import rng
from .vec import V3, normalize

FOCAL_Z = -1.5


def eye(up_deg: float, rotate_deg: float, r: float) -> np.ndarray:
    ra, ua = math.radians(rotate_deg), math.radians(up_deg)
    return r * np.array([-math.sin(ra) * math.cos(ua), math.sin(ua),
                         math.cos(ra) * math.cos(ua)])


def camera_rotate(eye_pt: np.ndarray, center=(0.0, 0.0, 0.0)) -> np.ndarray:
    """inverse(lookAt(eye, center, +Y)) in m[col, row] layout."""
    eye_pt = np.asarray(eye_pt, np.float64)
    f = np.asarray(center, np.float64) - eye_pt
    f = f / np.linalg.norm(f)
    s = np.cross(f, np.array([0.0, 1.0, 0.0]))
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4)
    m[0, 0], m[1, 0], m[2, 0] = s
    m[0, 1], m[1, 1], m[2, 1] = u
    m[0, 2], m[1, 2], m[2, 2] = -f
    m[3, 0], m[3, 1], m[3, 2] = -np.dot(s, eye_pt), -np.dot(u, eye_pt), np.dot(f, eye_pt)
    return np.linalg.inv(m.T).T


def orbit(up_deg: float, rotate_deg: float, r: float):
    """(eye [3], camera_rotate [4, 4]) as float32 NumPy arrays."""
    e = eye(up_deg, rotate_deg, r)
    return e.astype(np.float32), camera_rotate(e).astype(np.float32)


def primary_rays(cam, width: int, height: int, pixel: torch.Tensor, sample: torch.Tensor,
                 seed: int, dtype=torch.float32):
    """CUDA-jittered primary rays ``ndc = -1 + 2/W * (px + u - 0.5)``
    (PathTrace.cu:1430-1431) -> (origins V3, unit dirs V3)."""
    e, m = (torch.tensor(a, device=pixel.device).to(dtype) for a in cam)
    px = (pixel % width).to(dtype)
    py = torch.div(pixel, width, rounding_mode="floor").to(dtype)
    u1 = rng.uniform(pixel, sample, 0, rng.JITTER_X, seed).to(dtype)
    u2 = rng.uniform(pixel, sample, 0, rng.JITTER_Y, seed).to(dtype)
    nx = -1.0 + (2.0 / width) * (px + u1 - 0.5)
    ny = -1.0 + (2.0 / height) * (py + u2 - 0.5)
    nz = torch.full_like(nx, FOCAL_Z)
    d = V3(m[0, 0] * nx + m[1, 0] * ny + m[2, 0] * nz,
           m[0, 1] * nx + m[1, 1] * ny + m[2, 1] * nz,
           m[0, 2] * nx + m[1, 2] * ny + m[2, 2] * nz)
    o = V3(e[0].expand(nx.shape), e[1].expand(nx.shape), e[2].expand(nx.shape))
    return o, normalize(d)
