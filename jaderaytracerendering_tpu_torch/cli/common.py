"""Shared CLI plumbing: demo scene loading and config from flags."""

from __future__ import annotations

import dataclasses
import logging
import os

from ..models import demo
from ..scene import hdr as hdr_mod
from ..utils.config import RenderConfig

logger = logging.getLogger("jaderaytracerendering_tpu_torch")


def stage(msg: str) -> None:
    """Stage banner (the reference's 'Model load done' style lines)."""
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("[%(name)s] %(levelname)s %(message)s"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
    logger.info(msg)


def load_scene(args):
    """Resolve --scene/--tris/--hdr into (objects, env_map, camera)."""
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
    kw = {k: getattr(args, k) for k in ("width", "height", "spp", "max_depth",
                                         "seed", "tonemap", "engine")
          if getattr(args, k) is not None}
    return cfg.replace(**kw) if kw else cfg


def add_common_args(ap) -> None:
    ap.add_argument("--scene", default="jade", help="jade|diffuse|cornell|tiny")
    ap.add_argument("--hdr", help="background .hdr path")
    ap.add_argument("--tris", type=int, default=20_000,
                    help="procedural statue triangle count")
    ap.add_argument("--config", help="RenderConfig JSON path")
    ap.add_argument("--width", type=int)
    ap.add_argument("--height", type=int)
    ap.add_argument("--spp", type=int)
    ap.add_argument("--max-depth", dest="max_depth", type=int)
    ap.add_argument("--engine", choices=["mega", "scan", "pool"])
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
