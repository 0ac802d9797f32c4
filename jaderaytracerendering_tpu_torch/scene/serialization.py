"""Scene/camera serialization: render_args.txt compatibility + JSON.

The reference's only cross-program "config system" is render_args.txt
(written by the GL app's F key, generate_arguments PathTrace.cpp:883-918;
consumed by the CUDA renderer's main prologue PathTrace.cu:1486-1525):

    eye.x eye.y eye.z
    cameraRotate 4x4 (glm m[row][col] nesting = our m[col,row] layout)
    obj_cnt
    per object: path, 4x4 transform, emissive(3), brdf(3), reflex_mode,
    refract_mode, refract_rate(3), refract_albedo(3), refract_index,
    normalize flag

This module reads and writes that exact format, plus a structured JSON
equivalent carrying the same fields (preferred for new configs). It is
the JAX package's scene/serialization.py (NumPy only), so either package
reads what the other writes, byte for byte.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List

import numpy as np

from .material import Material


@dataclasses.dataclass
class ObjectSpec:
    path: str
    transform: np.ndarray  # [4,4] m[col,row] layout
    material: Material
    normalize: bool


@dataclasses.dataclass
class SceneSpec:
    eye: np.ndarray            # [3]
    camera_rotate: np.ndarray  # [4,4] m[col,row] layout
    objects: List[ObjectSpec]


def write_render_args(path: str, spec: SceneSpec) -> None:
    """generate_arguments-compatible writer (PathTrace.cpp:883-918)."""
    with open(path, "w") as f:
        f.write(f"{spec.eye[0]} {spec.eye[1]} {spec.eye[2]}\n")
        for row in range(4):
            f.write(" ".join(_fmt(spec.camera_rotate[row, col]) for col in range(4)) + " \n")
        f.write(f"{len(spec.objects)}\n")
        for o in spec.objects:
            m = o.material
            f.write(o.path + "\n")
            for row in range(4):
                f.write(" ".join(_fmt(o.transform[row, col]) for col in range(4)) + " \n")
            f.write(" ".join(_fmt(c) for c in m.emissive) + "\n")
            f.write(" ".join(_fmt(c) for c in m.brdf) + "\n")
            f.write(f"{m.reflex_mode}\n{m.refract_mode}\n")
            f.write(" ".join(_fmt(c) for c in m.refract_rate) + "\n")
            f.write(" ".join(_fmt(c) for c in m.refract_albedo) + "\n")
            f.write(f"{_fmt(m.refract_index)}\n")
            f.write(f"{1 if o.normalize else 0}\n")


def _fmt(x: float) -> str:
    return f"{float(x):g}"


def read_render_args(path: str) -> SceneSpec:
    """CUDA-main-compatible reader (PathTrace.cu:1486-1525).

    Token-stream parsing like ``fin >>`` — whitespace/newline agnostic,
    except object paths which are whole tokens (the reference reads them
    with >> too, so paths cannot contain spaces).
    """
    with open(path) as f:
        toks = f.read().split()
    it = iter(toks)
    nxt = lambda: next(it)
    fl = lambda: float(nxt())
    eye = np.array([fl(), fl(), fl()])
    cam = np.empty((4, 4))
    for row in range(4):
        for col in range(4):
            cam[row, col] = fl()
    n = int(nxt())
    objects = []
    for _ in range(n):
        p = nxt()
        tr = np.empty((4, 4))
        for row in range(4):
            for col in range(4):
                tr[row, col] = fl()
        emissive = (fl(), fl(), fl())
        brdf = (fl(), fl(), fl())
        reflex_mode = int(nxt())
        refract_mode = int(nxt())
        refract_rate = (fl(), fl(), fl())
        refract_albedo = (fl(), fl(), fl())
        refract_index = fl()
        normalize = int(nxt()) != 0
        objects.append(
            ObjectSpec(
                path=p,
                transform=tr,
                material=Material(
                    emissive=emissive, brdf=brdf, reflex_mode=reflex_mode,
                    refract_mode=refract_mode, refract_rate=refract_rate,
                    refract_albedo=refract_albedo, refract_index=refract_index,
                ),
                normalize=normalize,
            )
        )
    return SceneSpec(eye=eye, camera_rotate=cam, objects=objects)


# ---- JSON form -------------------------------------------------------------

def spec_to_json(spec: SceneSpec) -> str:
    return json.dumps(
        {
            "eye": list(map(float, spec.eye)),
            "camera_rotate": np.asarray(spec.camera_rotate).tolist(),
            "objects": [
                {
                    "path": o.path,
                    "transform": np.asarray(o.transform).tolist(),
                    "material": dataclasses.asdict(o.material),
                    "normalize": o.normalize,
                }
                for o in spec.objects
            ],
        },
        indent=2,
    )


def spec_from_json(text: str) -> SceneSpec:
    d = json.loads(text)
    return SceneSpec(
        eye=np.asarray(d["eye"], np.float64),
        camera_rotate=np.asarray(d["camera_rotate"], np.float64),
        objects=[
            ObjectSpec(
                path=o["path"],
                transform=np.asarray(o["transform"], np.float64),
                material=Material(**{
                    k: tuple(v) if isinstance(v, list) else v
                    for k, v in o["material"].items()
                }),
                normalize=o["normalize"],
            )
            for o in d["objects"]
        ],
    )
