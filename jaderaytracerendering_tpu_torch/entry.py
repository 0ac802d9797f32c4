"""Entry points of the port, after the JAX package's ``__graft_entry__.py``.

- ``entry()`` -> (fn, example_args): one scan render step on the tiny
  jade scene, on the card (``device="cpu"`` for the CPU).
- ``dryrun_multichip(n)``: the three engines over an (n/2, 2) mesh of n
  ranks (parallel/sharding.py), each rank a process on this node, on the
  cards (ranks share them over gloo when they outnumber them;
  ``device="cpu"`` for the CPU). Asserts finite films with the right
  sample count.

    python -m jaderaytracerendering_tpu_torch.entry [--device cpu]
    python -m jaderaytracerendering_tpu_torch.entry multichip 4 [--device cpu]

A missing card is an error, never a quiet fall back to the CPU.
"""

from __future__ import annotations

import argparse

import torch


def _tiny_setup(device, n_tris: int = 400, width: int = 8, height: int = 8):
    from .core import camera as camera_mod
    from .models import demo
    from .scene.scene import assemble
    from .utils.config import RenderConfig

    ds = demo.jade_scene(n_buddha_tris=n_tris, env_shape=(16, 32))
    sd = assemble(ds.objects, ds.env_map, device=device)
    cfg = RenderConfig(width=width, height=height, spp=2, spp_batch=2, max_depth=3,
                       traversal="bvh", bvh_stack_size=48)
    eye, rot = camera_mod.camera_tensors(ds.camera, device)
    return ds, sd, cfg, eye, rot


def entry(device: str = "cuda"):
    """(fn, example_args): ``fn(*example_args)`` renders ``spp_batch``
    samples of every pixel -> (radiance sums [P, 3], useful rays [P])."""
    from .integrator.render import render_batch

    _, sd, cfg, eye, rot = _tiny_setup(torch.device(device))
    pixel_ids = torch.arange(cfg.width * cfg.height, dtype=torch.int64, device=sd.device)

    def fn(sd_, eye_, rot_, pixel_ids_):
        return render_batch(sd_, eye_, rot_, pixel_ids_, 0, cfg, cfg.spp_batch)

    return fn, (sd, eye, rot, pixel_ids)


def _dryrun_rank(n_devices: int, device: str) -> dict:
    """One rank of ``dryrun_multichip``: the three engines over the mesh."""
    from .parallel import sharding

    n_spp = 2 if n_devices % 2 == 0 else 1
    mesh = sharding.make_mesh((n_devices // n_spp, n_spp))
    ds, sd, cfg, _, _ = _tiny_setup(sharding.rank_device(device))
    counts = {}
    for engine in ("scan", "pool", "mega"):
        film = sharding.render_film_distributed(
            sd, ds.camera, cfg.replace(engine=engine, spp=2 * n_spp), mesh)
        if not bool(torch.isfinite(film.accum).all()) or film.count != 2 * n_spp:
            raise AssertionError(f"{engine} over the mesh: count {film.count}, finite "
                                 f"{bool(torch.isfinite(film.accum).all())}")
        counts[engine] = film.count
    return {"rank": mesh.rank, "mesh": mesh.shape, "device": str(sd.device),
            "backend": torch.distributed.get_backend(), "counts": counts}


def dryrun_multichip(n_devices: int, device: str = "cuda") -> list:
    """Run the three engines over an (n/2, 2) mesh of ``n_devices`` ranks
    on this node -> each rank's report. Rank r renders on card
    ``r % cards`` (``sharding.rank_device``), so ranks share the cards when
    they outnumber them; ``device="cpu"`` runs them on the CPU."""
    from .parallel import sharding

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: no CUDA device is available "
                           "(pass device='cpu' to run the ranks on the CPU)")
    out = sharding.spawn_local("jaderaytracerendering_tpu_torch.entry:_dryrun_rank",
                               n_devices, (n_devices, device), device=device)
    print(f"dryrun_multichip OK: {n_devices} ranks, mesh {out[0]['mesh']}, "
          f"{out[0]['backend']} on {device}, film counts {out[0]['counts']}")
    return out


def main(argv=None) -> None:
    from .cli import common

    ap = argparse.ArgumentParser(prog="python -m jaderaytracerendering_tpu_torch.entry")
    ap.add_argument("command", nargs="?", choices=["multichip"],
                    help="run dryrun_multichip instead of one render step")
    ap.add_argument("n", nargs="?", type=int, default=2, help="multichip: ranks")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where to render (default cuda)")
    args = ap.parse_args(argv)
    device = common.select_device(args)
    if args.command == "multichip":
        dryrun_multichip(args.n, device.type)
    else:
        fn, ex = entry(device.type)
        rad, rays = fn(*ex)
        print("entry OK:", tuple(rad.shape), float(rad.mean()), float(rays.sum()))


if __name__ == "__main__":
    main()
