"""The benchmark's one door into the system under test, the PyTorch and
CUDA package ``jaderaytracerendering_tpu_torch``: its scene build, its
render and preview entries, its host tone map, its launch counters.
Nothing else in ``benchmark/`` imports the program, and the reference
(``benchmark/reference``) never does."""

from __future__ import annotations

import numpy as np

from jaderaytracerendering_tpu_torch.accel import native
from jaderaytracerendering_tpu_torch.core.camera import OrbitCamera
from jaderaytracerendering_tpu_torch.core.film import Film
from jaderaytracerendering_tpu_torch.integrator import render
from jaderaytracerendering_tpu_torch.ops import kernels
from jaderaytracerendering_tpu_torch.post import tonemap
from jaderaytracerendering_tpu_torch.scene import material, objloader
from jaderaytracerendering_tpu_torch.scene.scene import SceneObject, assemble
from jaderaytracerendering_tpu_torch.utils.config import RenderConfig

__all__ = ["Film", "OrbitCamera", "render", "tonemap", "launches", "reset_launches",
           "load_libraries", "build_scene", "render_config"]


def load_libraries(device) -> None:
    """Load the program's native libraries: the BVH builder's (g++) and,
    on the card, the CUDA kernels' (nvcc); each is built on a checkout's
    first run into the package's ``build/`` directory and loaded from
    there after."""
    native.load_library()
    if device.type == "cuda":
        kernels.library()


def build_scene(raw, device):
    """The program's scene (``scene.assemble``, default BVH builder) from
    the raw triangles of ``benchmark.scene`` -> SceneData on ``device``."""
    objects = [SceneObject(mesh=objloader.MeshData(p1=o.p1, p2=o.p2, p3=o.p3, norm=o.norm),
                           material=material.Material(**vars(o.material)), name=o.name)
               for o in raw.objects]
    return assemble(objects, np.asarray(raw.env, np.float32), device=device)


def render_config(settings: dict) -> RenderConfig:
    """A RenderConfig from the configuration's and traffic's settings
    (names as RenderConfig's fields)."""
    return RenderConfig(**settings)


def launches() -> dict:
    return dict(kernels.LAUNCHES)


def reset_launches() -> None:
    kernels.reset_launches()
