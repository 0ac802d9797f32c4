"""Wavefront OBJ loader (host NumPy) with reference-compatible semantics.

The JAX package's scene/objloader.py, with its Python parser and, by
default, the native one (accel/native.py): ``v`` and
``f`` records, fan-triangulated faces, optional unit-cube normalization
(with the reference's cross-axis AABB typo behind ``compat_aabb_bug``), a
4x4 model transform in GLM ``m[col, row]`` layout, and flat face normals
``normalize(cross(p2-p1, p3-p1))`` (PathTrace.cu:448).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class MeshData:
    """Triangle soup for one object: [T, 3] float32 arrays."""

    p1: np.ndarray
    p2: np.ndarray
    p3: np.ndarray
    norm: np.ndarray

    @property
    def n_triangles(self) -> int:
        return len(self.p1)


def parse_obj_text(
    text: str, compat_slash_faces: bool = False
) -> tuple[np.ndarray, np.ndarray]:
    """Parse OBJ source -> (vertices [V,3] f64, 0-based faces [F,3] i64)."""
    vertices: list[tuple[float, float, float]] = []
    faces: list[tuple[int, int, int]] = []
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if compat_slash_faces:
            line = line.replace("/", " ")
        parts = line.split()
        tag = parts[0]
        if tag == "v":
            vertices.append((float(parts[1]), float(parts[2]), float(parts[3])))
        elif tag == "f":
            idx = [int(tok.split("/")[0]) for tok in parts[1:]]
            if len(idx) < 3:
                raise ValueError(f"face with <3 vertices: {raw!r}")
            if compat_slash_faces:
                idx = idx[:3]  # the reference reads three ints per face
            for k in range(1, len(idx) - 1):
                tri = (idx[0], idx[k], idx[k + 1])
                faces.append(
                    tuple(v - 1 if v > 0 else len(vertices) + v for v in tri)
                )
    v = np.asarray(vertices, np.float64).reshape(-1, 3)
    f = np.asarray(faces, np.int64).reshape(-1, 3)
    return v, f


def _reference_aabb(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The buggy running AABB of PathTrace.cpp:399-400."""
    maxx = maxy = maxz = -11451419.19
    minx = miny = minz = 11451419.19
    for x, y, z in v:
        maxx = max(maxx, x)
        maxy = max(maxx, y)
        maxz = max(maxx, z)
        minx = min(minx, x)
        miny = min(minx, y)
        minz = min(minx, z)
    return np.array([minx, miny, minz]), np.array([maxx, maxy, maxz])


def normalize_vertices(v: np.ndarray, compat_aabb_bug: bool = False) -> np.ndarray:
    """Center the model and scale its longest AABB axis to 1."""
    if len(v) == 0:
        return v
    lo, hi = _reference_aabb(v) if compat_aabb_bug else (v.min(axis=0), v.max(axis=0))
    max_axis = float((hi - lo).max())
    center = (hi + lo) / 2.0
    return (v - center) / max_axis


def _transform_point(m: np.ndarray, v: np.ndarray) -> np.ndarray:
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return np.stack([m[0, c] * x + m[1, c] * y + m[2, c] * z + m[3, c]
                     for c in range(3)], axis=-1)


def _face_normal(p1: np.ndarray, p2: np.ndarray, p3: np.ndarray) -> np.ndarray:
    c = np.cross(p2 - p1, p3 - p1)
    with np.errstate(divide="ignore", invalid="ignore"):
        return c * (1.0 / np.sqrt(np.sum(c * c, axis=-1, keepdims=True)))


def mesh_from_arrays(
    v: np.ndarray,
    f: np.ndarray,
    transform: np.ndarray | None = None,
    normalize: bool = False,
    compat_aabb_bug: bool = False,
) -> MeshData:
    """Assemble a MeshData: normalize -> transform -> flat normals."""
    v = np.asarray(v, np.float64)
    if normalize:
        v = normalize_vertices(v, compat_aabb_bug)
    if transform is not None:
        v = _transform_point(np.asarray(transform, np.float64), v)
    p1 = v[f[:, 0]].astype(np.float32)
    p2 = v[f[:, 1]].astype(np.float32)
    p3 = v[f[:, 2]].astype(np.float32)
    norm = _face_normal(
        p1.astype(np.float64), p2.astype(np.float64), p3.astype(np.float64)
    ).astype(np.float32)
    return MeshData(p1=p1, p2=p2, p3=p3, norm=norm)


def read_obj(filepath: str, transform: np.ndarray | None = None,
             normalize: bool = False, compat_aabb_bug: bool = False,
             compat_slash_faces: bool = False, backend: str = "auto") -> MeshData:
    """readObj equivalent: file -> transformed flat-shaded triangle soup.

    ``backend='auto'`` takes the native C++ parser (accel/native.py) when
    its library builds and the Python parser otherwise; 'native' and
    'python' force one."""
    if backend not in ("auto", "native", "python"):
        raise ValueError(f"unknown OBJ parser backend {backend!r}")
    parsed = None
    if backend != "python":
        from ..accel import native

        parsed = native.parse_obj(filepath, compat_slash_faces)
        if parsed is None and backend == "native":
            raise RuntimeError("native OBJ parser requested but no C++ compiler (g++) "
                               "is available to build runtime/jade_native.cpp")
    if parsed is None:
        with open(filepath, "r") as fh:
            parsed = parse_obj_text(fh.read(), compat_slash_faces)
    return mesh_from_arrays(*parsed, transform, normalize, compat_aabb_bug)
