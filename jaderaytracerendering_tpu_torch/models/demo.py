"""Demo scenes: the jade-Buddha hero scene and test variants.

Mirrors the hardcoded scene in the reference's main
(PathTrace.cpp:981-1068): a jade model (MIRROR + SUB_SURFACE), one
emissive quad light (emissive 1000), and a 12 x 0.125 x 12 mirror floor
slab. The repo ships no OBJ assets (SURVEY: happyBuddha.obj / light.obj /
box.obj are missing externals), so geometry comes from
scene.procedural stand-ins; the real assets can be substituted via
``obj_paths``. The same scenes as the JAX package's models/demo.py.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..core.camera import OrbitCamera
from ..scene import hdr, material, procedural, serialization, transforms
from ..scene.objloader import mesh_from_arrays, read_obj
from ..scene.scene import SceneObject

# Reference transforms (PathTrace.cpp:1002, 1010, 1035-1037).
BUDDHA_TRANSFORM = dict(rotate=(-90, 0, 0), translate=(0, -0.52, 0.5), scale=(0.3, 0.3, 0.3))
LIGHT_TRANSFORM = dict(rotate=(0, 90, 90), translate=(-0.2, 1.2, 1.0), scale=(1.5, 0.5, 1.5))
FLOOR_TRANSFORM = dict(rotate=(0, 0, 0), translate=(0, -0.5625, 0), scale=(12, 0.125, 12))


@dataclasses.dataclass
class DemoScene:
    objects: List[SceneObject]
    env_map: np.ndarray
    camera: OrbitCamera


def _obj(name, verts_faces, mat, trans_kw, normalize=True) -> SceneObject:
    v, f = verts_faces
    t = transforms.transform_matrix(**trans_kw)
    mesh = mesh_from_arrays(v, f, transform=t, normalize=normalize)
    return SceneObject(mesh=mesh, material=mat, name=name, transform=t,
                       normalize=normalize)


def jade_scene(
    n_buddha_tris: int = 100_000,
    env_shape: tuple[int, int] = (256, 512),
    obj_paths: Optional[dict] = None,
) -> DemoScene:
    """The hero scene: jade statue + light quad + mirror floor.

    ``obj_paths`` may map {'buddha'|'light'|'floor': path} to load real
    OBJ assets in place of the procedural stand-ins.
    """
    def geom(key, fallback):
        if obj_paths and key in obj_paths:
            return None  # loaded below
        return fallback

    objs: List[SceneObject] = []
    specs = [
        ("buddha", lambda: procedural.buddha_standin(n_buddha_tris),
         material.JADE, BUDDHA_TRANSFORM),
        ("light", procedural.quad, material.LIGHT_1000, LIGHT_TRANSFORM),
        ("floor", procedural.box, material.MIRROR_FLOOR, FLOOR_TRANSFORM),
    ]
    for name, gen, mat, trans_kw in specs:
        if obj_paths and name in obj_paths:
            t = transforms.transform_matrix(**trans_kw)
            mesh = read_obj(obj_paths[name], transform=t, normalize=True)
            objs.append(SceneObject(mesh=mesh, material=mat, name=name,
                                    source_path=obj_paths[name], transform=t,
                                    normalize=True))
        else:
            objs.append(_obj(name, gen(), mat, trans_kw))
    env = hdr.procedural_sky(*env_shape)
    return DemoScene(objects=objs, env_map=env, camera=OrbitCamera())


def diffuse_scene(
    n_buddha_tris: int = 5_000, env_shape: tuple[int, int] = (128, 256)
) -> DemoScene:
    """Config-1 scene (BASELINE.md): same geometry, all-diffuse materials.

    Matches the GLSL offline renderer's feature level — the GL encoding
    drops refract fields so fshader_render.fsh only ever shades diffuse
    NEE paths (SURVEY §2.2)."""
    gray = material.Material(brdf=(0.5, 0.5, 0.5))
    floor = material.Material(brdf=(0.3, 0.3, 0.3))
    ds = jade_scene(n_buddha_tris, env_shape)
    ds.objects[0] = dataclasses.replace(ds.objects[0], material=gray)
    ds.objects[2] = dataclasses.replace(ds.objects[2], material=floor)
    return ds


def cornell_scene(env_shape: tuple[int, int] = (16, 32)) -> DemoScene:
    """Cornell box: the reference's commented-out alternate scene family
    (PathTrace.cpp:1026-1063 loads cornell_* parts with red/green/white
    diffuse walls). Rebuilt from procedural quads/boxes: white floor/
    ceiling/back, red left, green right, ceiling area light, short and
    tall boxes. The env map is irrelevant (closed box) but present."""
    white = material.Material(brdf=(0.72, 0.72, 0.72))
    red = material.Material(brdf=(0.72, 0.0, 0.0))
    green = material.Material(brdf=(0.0, 0.72, 0.0))
    light = material.Material(emissive=(40.0, 40.0, 40.0), brdf=(0.3, 0.3, 0.3))

    def wall(name, mat, rotate, translate, scale=(2.0, 2.0, 1.0)):
        return _obj(name, procedural.quad(), mat,
                    dict(rotate=rotate, translate=translate, scale=scale),
                    normalize=False)

    objs = [
        wall("floor", white, (-90, 0, 0), (0, -1, 0)),
        wall("ceiling", white, (90, 0, 0), (0, 1, 0)),
        wall("back", white, (0, 0, 0), (0, 0, -1)),
        wall("left", red, (0, 90, 0), (-1, 0, 0)),
        wall("right", green, (0, -90, 0), (1, 0, 0)),
        wall("light", light, (90, 0, 0), (0, 0.999, 0), scale=(0.6, 0.6, 1.0)),
        _obj("short_box", procedural.box(), white,
             dict(rotate=(0, -17, 0), translate=(0.35, -0.7, 0.35),
                  scale=(0.6, 0.6, 0.6)), normalize=False),
        _obj("tall_box", procedural.box(), white,
             dict(rotate=(0, 18, 0), translate=(-0.35, -0.4, -0.3),
                  scale=(0.6, 1.2, 0.6)), normalize=False),
    ]
    env = hdr.procedural_sky(*env_shape, sun_intensity=0.0)
    cam = OrbitCamera(r=3.6)
    return DemoScene(objects=objs, env_map=env, camera=cam)


def tiny_scene(env_shape: tuple[int, int] = (32, 64)) -> DemoScene:
    """A minimal diffuse scene for fast unit tests: floor + light quad."""
    objs = [
        _obj("floor", procedural.box(), material.Material(brdf=(0.6, 0.6, 0.6)),
             FLOOR_TRANSFORM),
        _obj("light", procedural.quad(), material.LIGHT_1000, LIGHT_TRANSFORM),
    ]
    env = hdr.procedural_sky(*env_shape)
    return DemoScene(objects=objs, env_map=env, camera=OrbitCamera())


def to_spec(ds: DemoScene) -> serialization.SceneSpec:
    """SceneSpec for render_args.txt round-trips (paths may be procedural://)."""
    return serialization.SceneSpec(
        eye=ds.camera.eye,
        camera_rotate=ds.camera.camera_rotate,
        objects=[
            serialization.ObjectSpec(
                path=o.source_path or f"procedural://{o.name}",
                transform=o.transform if o.transform is not None else np.eye(4),
                material=o.material,
                normalize=o.normalize,
            )
            for o in ds.objects
        ],
    )
