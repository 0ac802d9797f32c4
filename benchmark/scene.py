"""The benchmark's scene maker: the jade demo scene of the reference's
interactive app and offline renderer (PathTrace.cpp:981-1068) as raw
triangles, made the same way on every run.

A frozen copy of the procedural stand-ins the program ships (the
reference repository does not ship ``happyBuddha.obj``, ``light.obj`` or
``box.obj``): a seated-statue blob of displaced spheres on a plinth, made
from a fixed seed (7) with about the requested number of triangles, a
light quad of emission 1000 and a 12 x 0.125 x 12 mirror floor slab, each
normalised to the unit cube and placed by the reference's transforms, and
a procedural 256 x 512 HDR sky. The harness hands these raw arrays to the
program (``benchmark/program.py``) and to the reference
(``benchmark/reference/scene.py``) alike. NumPy only.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

# reflex / refract modes (PathTrace.cu:41-47)
DIFFUSE, MIRROR = 0, 1
NO_REFRACT, SUB_SURFACE, DIR_REFRACT = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class Material:
    """The reference's 7-field material (PathTrace.cpp:38-46)."""

    emissive: tuple = (0.0, 0.0, 0.0)
    brdf: tuple = (0.8, 0.8, 0.8)
    reflex_mode: int = DIFFUSE
    refract_mode: int = NO_REFRACT
    refract_rate: tuple = (0.8, 0.8, 0.8)
    refract_albedo: tuple = (0.8, 0.8, 0.8)
    refract_index: float = 1.0


# PathTrace.cpp:981-989, 1004-1008, 1030-1035
JADE = Material(brdf=(0.02, 0.02, 0.02), reflex_mode=MIRROR, refract_mode=SUB_SURFACE,
                refract_rate=(0.1, 0.1, 0.1), refract_albedo=(0.3, 0.3, 0.3),
                refract_index=2.66)
LIGHT_1000 = Material(emissive=(1000.0, 1000.0, 1000.0), brdf=(0.3, 0.3, 0.3),
                      refract_index=1.1)
MIRROR_FLOOR = Material(brdf=(0.3, 0.3, 0.3), reflex_mode=MIRROR,
                        refract_rate=(0.7, 0.7, 0.7), refract_index=1.1)

# the reference's transforms (PathTrace.cpp:1002, 1010, 1035-1037)
STATUE_TRS = dict(rotate=(-90, 0, 0), translate=(0, -0.52, 0.5), scale=(0.3, 0.3, 0.3))
LIGHT_TRS = dict(rotate=(0, 90, 90), translate=(-0.2, 1.2, 1.0), scale=(1.5, 0.5, 1.5))
FLOOR_TRS = dict(rotate=(0, 0, 0), translate=(0, -0.5625, 0), scale=(12, 0.125, 12))


@dataclasses.dataclass
class RawObject:
    """One object's triangle soup ([T, 3] float32 each) and material."""

    name: str
    p1: np.ndarray
    p2: np.ndarray
    p3: np.ndarray
    norm: np.ndarray
    material: Material


@dataclasses.dataclass
class RawScene:
    objects: list
    env: np.ndarray  # [H, W, 3] float32, row 0 at the top

    @property
    def n_triangles(self) -> int:
        return sum(len(o.p1) for o in self.objects)

    def vertices(self, name: str) -> np.ndarray:
        """The triangle corners of the object ``name`` [3T, 3]."""
        o = next(o for o in self.objects if o.name == name)
        return np.concatenate([o.p1, o.p2, o.p3])


# ---- meshes ------------------------------------------------------------------

def _box():
    v = np.array([[-0.5, -0.5, -0.5], [0.5, -0.5, -0.5], [0.5, 0.5, -0.5], [-0.5, 0.5, -0.5],
                  [-0.5, -0.5, 0.5], [0.5, -0.5, 0.5], [0.5, 0.5, 0.5], [-0.5, 0.5, 0.5]])
    f = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4],
                  [3, 6, 2], [3, 7, 6], [0, 7, 3], [0, 4, 7], [1, 2, 6], [1, 6, 5]])
    return v, f


def _quad():
    v = np.array([[-0.5, -0.5, 0.0], [0.5, -0.5, 0.0], [0.5, 0.5, 0.0], [-0.5, 0.5, 0.0]])
    return v, np.array([[0, 1, 2], [0, 2, 3]])


def _uv_sphere(n_lat, n_lon):
    """The program's UV sphere (a pole, ``n_lat - 1`` rings of ``n_lon``
    vertices, a pole; fans at the poles), built with array operations."""
    theta = np.pi * np.arange(1, n_lat) / n_lat
    phi = 2 * np.pi * np.arange(n_lon) / n_lon
    y = np.repeat(0.5 * np.cos(theta), n_lon)
    rad = np.repeat(0.5 * np.sin(theta), n_lon)
    ring = np.stack([rad * np.tile(np.cos(phi), n_lat - 1), y,
                     rad * np.tile(np.sin(phi), n_lat - 1)], axis=1)
    v = np.concatenate([[(0.0, 0.5, 0.0)], ring, [(0.0, -0.5, 0.0)]]).astype(np.float64)
    j = np.arange(n_lon)
    j2 = (j + 1) % n_lon
    top = np.stack([np.zeros(n_lon, np.int64), 1 + j2, 1 + j], axis=1)
    a = 1 + np.arange(n_lat - 2)[:, None] * n_lon
    b = a + n_lon
    quads = np.stack([np.stack([a + j, a + j2, b + j], axis=-1),
                      np.stack([a + j2, b + j2, b + j], axis=-1)], axis=2).reshape(-1, 3)
    last, a = len(v) - 1, 1 + (n_lat - 2) * n_lon
    bottom = np.stack([np.full(n_lon, last), a + j, a + j2], axis=1)
    return v, np.concatenate([top, quads, bottom]).astype(np.int64)


def _displaced_sphere(n_lat, n_lon, seed, amp):
    v, f = _uv_sphere(n_lat, n_lon)
    rng = np.random.default_rng(seed)
    freqs = rng.uniform(1.5, 6.0, size=(8, 3))
    phases = rng.uniform(0, 2 * np.pi, size=8)
    amps = rng.uniform(0.4, 1.6, size=8) * amp
    p = v * 2.0
    disp = np.zeros(len(v))
    for k in range(8):
        disp += amps[k] * np.sin(p[:, 0] * freqs[k, 0] + p[:, 1] * freqs[k, 1]
                                 + p[:, 2] * freqs[k, 2] + phases[k])
    return v * (1.0 + disp)[:, None], f


def statue(n_triangles: int, seed: int = 7):
    """The seated-statue stand-in: body, head, two shoulders and a plinth
    with about ``n_triangles`` triangles, z-up like happyBuddha.obj."""
    def latlon(frac):
        n_lat = max(6, int(np.sqrt(max(n_triangles, 200) * frac / 0.88 / 4.0)))
        return n_lat, 2 * n_lat

    parts = [
        (_displaced_sphere(*latlon(0.55), seed, 0.06), (0.72, 0.60, 0.52), (0.0, -0.12, 0.0)),
        (_displaced_sphere(*latlon(0.18), seed + 1, 0.04), (0.34, 0.38, 0.34), (0.0, 0.32, 0.02)),
        (_displaced_sphere(*latlon(0.08), seed + 2, 0.05), (0.26, 0.22, 0.26), (-0.33, 0.05, 0.0)),
        (_displaced_sphere(*latlon(0.08), seed + 3, 0.05), (0.26, 0.22, 0.26), (0.33, 0.05, 0.0)),
        (_box(), (0.95, 0.14, 0.72), (0.0, -0.42, 0.0)),
    ]
    vs, fs, off = [], [], 0
    for (v, f), scale, shift in parts:
        vs.append(v * np.asarray(scale)[None, :] + np.asarray(shift)[None, :])
        fs.append(f + off)
        off += len(v)
    v, f = np.concatenate(vs), np.concatenate(fs)
    return np.stack([v[:, 0], -v[:, 2], v[:, 1]], axis=1), f


# ---- placement -----------------------------------------------------------------

def transform_matrix(rotate, translate, scale) -> np.ndarray:
    """translate * Rx * Ry * Rz * scale (PathTrace.cpp:343-359), stored
    GLM-style as m[col, row]."""
    def rot(axis, deg):
        c, s = math.cos(math.radians(deg)), math.sin(math.radians(deg))
        return {0: np.array([[1, 0, 0], [0, c, -s], [0, s, c]]),
                1: np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]),
                2: np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])}[axis]

    m = np.eye(4)
    m[:3, :3] = (rot(0, rotate[0]) @ rot(1, rotate[1]) @ rot(2, rotate[2])
                 * np.asarray(scale, np.float64)[None, :])
    m[:3, 3] = translate
    return m.T.copy()


def place(name: str, v: np.ndarray, f: np.ndarray, material: Material, trs: dict) -> RawObject:
    """Normalise to the unit cube (longest axis 1, centred), transform,
    and take flat face normals normalize(cross(p2-p1, p3-p1))."""
    v = np.asarray(v, np.float64)
    lo, hi = v.min(axis=0), v.max(axis=0)
    v = (v - (hi + lo) / 2.0) / float((hi - lo).max())
    m = transform_matrix(**trs)
    v = np.stack([m[0, c] * v[:, 0] + m[1, c] * v[:, 1] + m[2, c] * v[:, 2] + m[3, c]
                  for c in range(3)], axis=-1)
    p1, p2, p3 = (v[f[:, k]].astype(np.float32) for k in range(3))
    c = np.cross(p2.astype(np.float64) - p1, p3.astype(np.float64) - p1)
    with np.errstate(divide="ignore", invalid="ignore"):
        norm = (c * (1.0 / np.sqrt(np.sum(c * c, axis=-1, keepdims=True)))).astype(np.float32)
    return RawObject(name, p1, p2, p3, norm, material)


def sky(height: int, width: int, sun_intensity: float = 40.0) -> np.ndarray:
    """Equirect sky: a horizon-to-zenith gradient, a dark ground and a
    warm sun disc whose radiance passes the integrator's clamp of 10."""
    v = (np.arange(height) + 0.5) / height
    u = (np.arange(width) + 0.5) / width
    uu, vv = np.meshgrid(u, v)
    phi, theta = (uu - 0.5) * 2.0 * np.pi, (0.5 - vv) * np.pi
    y = np.sin(theta)
    x, z = np.cos(theta) * np.cos(phi), np.cos(theta) * np.sin(phi)
    t = np.clip(y * 0.5 + 0.5, 0, 1)
    horizon, zenith = np.array([0.8, 0.65, 0.5]), np.array([0.25, 0.45, 0.85])
    img = horizon[None, None] * (1 - t[..., None]) + zenith[None, None] * t[..., None]
    ground = np.array([0.18, 0.15, 0.12])
    img = np.where(y[..., None] < 0, ground[None, None] * (0.3 - 0.25 * t[..., None]), img)
    sun = np.array([0.45, 0.65, 0.6])
    sun = sun / np.linalg.norm(sun)
    cosang = x * sun[0] + y * sun[1] + z * sun[2]
    disc = np.clip((cosang - 0.995) / 0.005, 0, 1) ** 2
    glow = np.clip(cosang, 0, 1) ** 64
    img = img + np.array([1.0, 0.85, 0.6])[None, None] * (disc[..., None] * sun_intensity
                                                          + glow[..., None] * 1.5)
    return img.astype(np.float32)


def jade(statue_tris: int, env_shape) -> RawScene:
    """The jade demo scene: statue (jade), light quad, mirror floor, sky."""
    return RawScene(objects=[place("statue", *statue(statue_tris), JADE, STATUE_TRS),
                             place("light", *_quad(), LIGHT_1000, LIGHT_TRS),
                             place("floor", *_box(), MIRROR_FLOOR, FLOOR_TRS)],
                    env=sky(*env_shape))


SCENES = {"jade": jade}


def make(spec: dict) -> RawScene:
    """The scene a configuration's ``scene`` entry names."""
    return SCENES[spec["name"]](spec["statue_tris"], tuple(spec["env_shape"]))
