"""Render configuration.

The same ``RenderConfig`` as the JAX package (field names, defaults and
``from_json`` tolerance), so ``configs/*.json`` and archived render args
load in both packages. The knobs that tuned the TPU kernels
(``mega_gather``, ``mega_tile``, ``mega_sweep_tile``, ``mega_chunked``,
``mega_force_stream``, ``mega_stack_segments``, ``mega_redistribute``,
``mega_prologue``, ``spawn_kernel``, ``fused_tail``, ``front_kernel``,
``rays_per_launch``) are accepted and ignored. Every ``traversal`` name
of the JAX package (``TRAVERSALS``) computes the same nearest hit, so the
port walks the BVH for all of them: with the trace kernel on the card, in
plain torch on the CPU. Any other name raises (``check_traversal``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

# the names the JAX package's integrator/render.py::make_nearest accepts
TRAVERSALS = ("sweep", "sweep_vpu", "sweep_mxu", "sweep_fused", "sweep_stream",
              "clusters", "gemm", "bvh", "brute")


def check_traversal(name: str) -> None:
    if name not in TRAVERSALS:
        raise ValueError(f"unknown traversal {name!r}")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 1024                 # PathTrace.cpp:26
    height: int = 1024                # PathTrace.cpp:27
    spp: int = 16
    max_depth: int = 16               # bounce cap; GLSL 16 / CUDA 128
    rr_rate: float = 0.9              # PathTrace.cu:35 (GLSL uses 0.8)
    sss_rate: float = 0.5             # PathTrace.cu:47
    max_refract_bounces: int = 32     # MAX_FULL_REFLEX_TIME, PathTrace.cu:39
    internal_reflect_rate: float = 0.2  # PathTrace.cu:1215
    hdr_clamp: float = 10.0           # PathTrace.cu:700
    emissive_break_eps: float = 1.4e-5  # PathTrace.cu:917
    emissive_skip_eps: float = 1.5e-4   # PathTrace.cu:1005
    seed: int = 0
    jitter: str = "cuda"              # 'cuda' | 'gl' film jitter convention
    tonemap: str = "aces"             # 'aces' | 'reinhard' | 'none'
    spp_batch: int = 4                # samples per scan-engine launch
    rays_per_launch: int = 1 << 14    # ignored
    traversal: str = "sweep"          # a name of TRAVERSALS: the BVH walk (trace kernel on CUDA)
    integrator: str = "full"          # 'full' (NEE) | 'preview' (2 bounces, no NEE)
    preview_bounces: int = 2
    preview_bands: int = 1
    engine: str = "mega"              # 'mega' (CUDA megakernel) | 'pool'
    #                                   (wavefront kernels) | 'scan' (torch)
    mega_spp_batch: int = 64          # ignored (one megakernel call a window's samples)
    mega_gather: str = "auto"         # ignored (TPU)
    mega_redistribute: bool = True    # ignored (TPU)
    mega_prologue: bool = True        # ignored (TPU)
    mega_chunked: str = "auto"        # ignored (TPU)
    mega_stack_segments: bool = False  # ignored (TPU)
    mega_tile: int = 512              # ignored (TPU)
    mega_sweep_tile: int = -1         # ignored (TPU)
    mega_force_stream: bool = False   # ignored (TPU)
    spawn_rounds: int = 1             # pool engine: spawn rounds per iteration
    spawn_kernel: bool = True         # ignored (TPU)
    fused_tail: bool = True           # ignored (TPU)
    front_kernel: bool = True         # ignored (TPU)
    bvh_leaf_size: int = 8            # PathTrace.cpp:1086 / PathTrace.cu:1565
    bvh_stack_size: int = 128         # PathTrace.cu:34; must cover depth + 1
    mesh_shape: Optional[Tuple[int, ...]] = None  # multi-device (tile, spp)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "RenderConfig":
        data = json.loads(text)
        if data.get("mesh_shape") is not None:
            data["mesh_shape"] = tuple(data["mesh_shape"])
        # tolerate fields from older configs so archived args still load
        known = {f.name for f in dataclasses.fields(RenderConfig)}
        return RenderConfig(**{k: v for k, v in data.items() if k in known})

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


# ---- reference-parity presets (the JAX package's, field for field) ----------

def cuda_parity(**kw) -> RenderConfig:
    """PathTrace.cu settings: RR 0.9, depth cap 128, CUDA jitter, ACES."""
    base = dict(rr_rate=0.9, max_depth=128, jitter="cuda", tonemap="aces",
                engine="pool")
    base.update(kw)
    return RenderConfig(**base)


def gl_render_parity(**kw) -> RenderConfig:
    """fshader_render.fsh settings: RR 0.8, depth 16, GL jitter, Reinhard
    pass3. (The GL encoding drops refract fields; pair with a diffuse
    scene for full parity: models.demo.diffuse_scene.)"""
    base = dict(rr_rate=0.8, max_depth=16, jitter="gl", tonemap="reinhard")
    base.update(kw)
    return RenderConfig(**base)


def gl_preview_parity(**kw) -> RenderConfig:
    """fshader_preview.fsh settings: 2-bounce no-NEE progressive preview."""
    base = dict(integrator="preview", preview_bounces=2, jitter="gl",
                tonemap="reinhard", spp=1, spp_batch=1)
    base.update(kw)
    return RenderConfig(**base)
