"""Orbit camera (host NumPy) and jittered primary rays (torch planes).

The camera math is the JAX package's core/camera.py: the eye orbits the
origin while looking at ``eye_center``; a primary ray direction is
``camera_rotate * (ndc_x, ndc_y, FOCAL_Z, 0)`` with matrices stored
GLM-style as ``m[col, row]`` (PathTrace.cu:1430-1435).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import rng
from .vecmath import V3, div, vnormalize, vtransform

FOCAL_Z = -1.5  # film plane depth (fshader_render.fsh:464, PathTrace.cu:1434)


def look_at(eye: np.ndarray, center: np.ndarray, up: np.ndarray) -> np.ndarray:
    """GLM-compatible right-handed lookAt, returned as m[col, row]."""
    eye = np.asarray(eye, np.float64)
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, np.asarray(up, np.float64))
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4)
    m[0, 0], m[1, 0], m[2, 0] = s
    m[0, 1], m[1, 1], m[2, 1] = u
    m[0, 2], m[1, 2], m[2, 2] = -f
    m[3, 0] = -np.dot(s, eye)
    m[3, 1] = -np.dot(u, eye)
    m[3, 2] = np.dot(f, eye)
    return m


def invert(m: np.ndarray) -> np.ndarray:
    """Inverse of a m[col, row]-layout matrix, same layout out."""
    return np.linalg.inv(m.T).T


@dataclasses.dataclass
class FixedCamera:
    """An explicit eye + rotation (what render_args.txt carries)."""

    eye_point: np.ndarray
    rotate: np.ndarray

    @property
    def eye(self) -> np.ndarray:
        return np.asarray(self.eye_point, np.float64)

    @property
    def camera_rotate(self) -> np.ndarray:
        return np.asarray(self.rotate, np.float64)


@dataclasses.dataclass
class OrbitCamera:
    """Orbit-camera state (PathTrace.cpp:209-211, 671-673), degrees."""

    up_angle: float = 0.0
    rotate_angle: float = 0.0
    r: float = 4.0
    eye_center: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float64)
    )

    @property
    def eye(self) -> np.ndarray:
        ra, ua = math.radians(self.rotate_angle), math.radians(self.up_angle)
        return self.r * np.array(
            [-math.sin(ra) * math.cos(ua), math.sin(ua), math.cos(ra) * math.cos(ua)]
        )

    @property
    def camera_rotate(self) -> np.ndarray:
        """inverse(lookAt(eye, eye_center, +Y)) as m[col, row]."""
        return invert(look_at(self.eye, self.eye_center, np.array([0.0, 1.0, 0.0])))

    # the preview's controls (PathTrace.cpp:729-851)
    def orbit(self, d_up: float = 0.0, d_rotate: float = 0.0) -> None:
        self.up_angle += d_up
        self.rotate_angle += d_rotate

    def move_center(self, dx: float = 0.0, dy: float = 0.0) -> None:
        self.eye_center[0] += dx
        self.eye_center[1] += dy

    def dolly(self, dr: float) -> None:
        self.r += dr


def camera_tensors(cam, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(eye [3], camera_rotate [4, 4]) as float32 tensors on ``device``."""
    eye = torch.tensor(np.asarray(cam.eye, np.float32), device=device)
    rot = torch.tensor(np.asarray(cam.camera_rotate, np.float32), device=device)
    return eye, rot


def generate_rays_p(eye: torch.Tensor, camera_rotate: torch.Tensor,
                    width: int, height: int, pixel_id: torch.Tensor,
                    sample_id, seed: int = 0, jitter: str = "cuda"):
    """Jittered primary rays for flat pixel ids -> (origins V3, dirs V3).

    ``jitter='cuda'``: ``ndc = -1 + 2/W * (px + u - 0.5)``
    (PathTrace.cu:1430-1431); ``jitter='gl'``: pixel-center NDC plus
    ``(u - 0.5)/W`` (fshader_render.fsh:463).
    """
    px = (pixel_id % width).to(torch.float32)
    py = torch.div(pixel_id, width, rounding_mode="floor").to(torch.float32)
    u1 = rng.uniform(pixel_id, sample_id, 0, rng.DrawSites.JITTER_X, seed)
    u2 = rng.uniform(pixel_id, sample_id, 0, rng.DrawSites.JITTER_Y, seed)
    if jitter == "cuda":
        ndc_x = -1.0 + (2.0 / width) * (px + u1 - 0.5)
        ndc_y = -1.0 + (2.0 / height) * (py + u2 - 0.5)
    elif jitter == "gl":
        ndc_x = -1.0 + div(2.0 * (px + 0.5), width) + div(u1 - 0.5, width)
        ndc_y = -1.0 + div(2.0 * (py + 0.5), height) + div(u2 - 0.5, height)
    else:
        raise ValueError(f"unknown jitter mode {jitter!r}")
    d = V3(ndc_x, ndc_y, torch.full_like(ndc_x, FOCAL_Z))
    dirs = vnormalize(vtransform(camera_rotate, d, 0.0))
    e = eye.to(torch.float32)
    origins = V3(e[0].expand(px.shape), e[1].expand(px.shape),
                 e[2].expand(px.shape))
    return origins, dirs
