"""Model transform composition: translate * rotate(x,y,z) * scale.

Reproduces getTransformMatrix (PathTrace.cpp:343-359): rotations applied
about X then Y then Z in degrees via glm::rotate chaining (which
post-multiplies, so the combined rotation is Rx @ Ry @ Rz), composed as
``model = T @ R @ S``. Matrices are returned in the GLM storage layout
``m[col, row]`` used everywhere in this framework (see core.camera).
"""

from __future__ import annotations

import math

import numpy as np


def _rx(deg: float) -> np.ndarray:
    c, s = math.cos(math.radians(deg)), math.sin(math.radians(deg))
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float64)


def _ry(deg: float) -> np.ndarray:
    c, s = math.cos(math.radians(deg)), math.sin(math.radians(deg))
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)


def _rz(deg: float) -> np.ndarray:
    c, s = math.cos(math.radians(deg)), math.sin(math.radians(deg))
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)


def transform_matrix(rotate=(0.0, 0.0, 0.0), translate=(0.0, 0.0, 0.0),
                     scale=(1.0, 1.0, 1.0)) -> np.ndarray:
    """TRS matrix in m[col, row] layout (PathTrace.cpp:343-359).

    Argument order matches the reference call sites:
    ``getTransformMatrix(rotateCtrl, translateCtrl, scaleCtrl)``.
    """
    r = _rx(rotate[0]) @ _ry(rotate[1]) @ _rz(rotate[2])
    m = np.eye(4)
    m[:3, :3] = r * np.asarray(scale, np.float64)[None, :]
    m[:3, 3] = translate
    # m is row-major math layout; convert to GLM m[col, row] storage.
    return m.T.copy()


def identity() -> np.ndarray:
    return np.eye(4)
