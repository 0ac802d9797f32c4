"""Shared CLI plumbing: scene loading from render_args.txt, a JSON spec
or a demo name, and config from flags."""

from __future__ import annotations

import dataclasses
import os

from ..core.camera import FixedCamera
from ..models import demo
from ..scene import hdr as hdr_mod, objloader, procedural, serialization
from ..scene.scene import SceneObject
from ..utils.config import RenderConfig
from ..utils.logging import stage  # noqa: F401  (the CLIs' stage lines)


_PROCEDURAL = {
    "procedural://buddha": lambda: procedural.buddha_standin(20_000),
    "procedural://light": procedural.quad,
    "procedural://floor": procedural.box,
    "procedural://box": procedural.box,
    "procedural://quad": procedural.quad,
    "procedural://sphere": procedural.uv_sphere,
}


def load_scene_spec(spec: serialization.SceneSpec, env_path):
    """SceneSpec -> (objects, env_map, camera) — the CUDA main prologue
    equivalent (PathTrace.cu:1486-1532 + HDR load 1647-1691)."""
    objects = []
    for o in spec.objects:
        if o.path in _PROCEDURAL:
            v, f = _PROCEDURAL[o.path]()
            mesh = objloader.mesh_from_arrays(v, f, transform=o.transform,
                                              normalize=o.normalize)
        else:
            mesh = objloader.read_obj(o.path, transform=o.transform, normalize=o.normalize)
        objects.append(SceneObject(mesh=mesh, material=o.material,
                                   name=os.path.basename(o.path), source_path=o.path,
                                   transform=o.transform, normalize=o.normalize))
        stage(f"loaded {o.path}: {mesh.n_triangles} triangles")
    if env_path and os.path.exists(env_path):
        env = hdr_mod.read_hdr(env_path)
        stage(f"HDR environment: {env_path} {env.shape}")
    else:
        env = hdr_mod.procedural_sky(256, 512)
        stage("HDR environment: procedural sky (no background.hdr found)")
    return objects, env, FixedCamera(eye_point=spec.eye, rotate=spec.camera_rotate)


def load_scene(args):
    """Resolve --render-args / --scene-json / --scene (with --tris, --hdr)
    into (objects, env_map, camera)."""
    if args.render_args:
        spec = serialization.read_render_args(args.render_args)
        stage(f"read {args.render_args}: {len(spec.objects)} objects")
        return load_scene_spec(spec, args.hdr)
    if args.scene_json:
        with open(args.scene_json) as f:
            spec = serialization.spec_from_json(f.read())
        return load_scene_spec(spec, args.hdr)
    name, tris = args.scene, args.tris
    if name == "jade":
        ds = demo.jade_scene(n_buddha_tris=tris)
    elif name == "diffuse":
        ds = demo.diffuse_scene(n_buddha_tris=tris)
    elif name == "cornell":
        ds = demo.cornell_scene()
    elif name == "tiny":
        ds = demo.tiny_scene()
    else:
        raise SystemExit(f"unknown scene {name!r}")
    if args.hdr and os.path.exists(args.hdr):
        ds = dataclasses.replace(ds, env_map=hdr_mod.read_hdr(args.hdr))
    return ds.objects, ds.env_map, ds.camera


def config_from_args(args) -> RenderConfig:
    cfg = RenderConfig()
    if args.config:
        with open(args.config) as f:
            cfg = RenderConfig.from_json(f.read())
    kw = {k: getattr(args, k) for k in ("width", "height", "spp", "max_depth", "traversal",
                                         "spp_batch", "rays_per_launch", "seed",
                                         "tonemap", "engine")
          if getattr(args, k) is not None}
    return cfg.replace(**kw) if kw else cfg


def add_common_args(ap) -> None:
    ap.add_argument("--scene", default="jade", help="jade|diffuse|cornell|tiny")
    ap.add_argument("--render-args", dest="render_args",
                    help="render_args.txt written by the preview (its f command)")
    ap.add_argument("--scene-json", dest="scene_json", help="scene spec JSON path")
    ap.add_argument("--hdr", help="background .hdr path")
    ap.add_argument("--tris", type=int, default=20_000,
                    help="procedural statue triangle count")
    ap.add_argument("--config", help="RenderConfig JSON path")
    ap.add_argument("--width", type=int)
    ap.add_argument("--height", type=int)
    ap.add_argument("--spp", type=int)
    ap.add_argument("--max-depth", dest="max_depth", type=int)
    ap.add_argument("--traversal", choices=["sweep", "clusters", "gemm", "bvh", "brute"],
                    help="the JAX CLI's choices; every one walks the BVH here")
    ap.add_argument("--engine", choices=["mega", "scan", "pool"])
    ap.add_argument("--spp-batch", dest="spp_batch", type=int,
                    help="samples per scan-engine batch (and per preview frame with --spp)")
    ap.add_argument("--rays-per-launch", dest="rays_per_launch", type=int,
                    help="accepted for the JAX CLI's command lines; ignored")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--tonemap", choices=["aces", "reinhard", "none"])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the scene and the render live (default cuda)")


def select_device(args):
    """The torch device for --device; CUDA that is missing is an error,
    never a quiet fall back to the CPU."""
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu to render on the CPU)")
    return torch.device(args.device)


def card() -> str:
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]
