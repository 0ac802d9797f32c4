"""Batch renderer CLI — the PathTrace.cu main equivalent.

Renders a scene (a named demo scene, render_args.txt from the preview's
f command, or a JSON spec) at width x height x spp and writes the image
(bottom-up BGR BMP like the reference's RenderResultCuda.bmp, or PNG):

    python -m jaderaytracerendering_tpu_torch.cli.render \
        --scene jade --spp 16 --out out.bmp
    python -m jaderaytracerendering_tpu_torch.cli.render \
        --render-args render_args.txt --spp 256 --out out.bmp

With no flags this is the main path: the jade scene with 20,000 statue
triangles, 1024x1024 at 16 spp, depth 16, through the CUDA megakernel.

``--mesh TILExSPP`` renders over tile x spp ranks (parallel/sharding.py):
started plainly, the CLI spawns the ranks on this node itself; under
``torchrun --nproc-per-node N`` (or ``python -m torch.distributed.run``)
each rank joins the group from the environment. Every rank renders on
its own device (``--device cpu``: the CPU, gloo) and holds the whole
film; rank 0 alone writes the image and ``--save-film``.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import tempfile
import time

from . import common


def _parse_mesh(text: str) -> tuple[int, int]:
    try:
        t, s = (int(x) for x in text.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--mesh {text}: want TILExSPP, e.g. 2x1") from None
    if t < 1 or s < 1:
        raise SystemExit(f"--mesh {text}: both axes must be at least 1")
    return t, s


def _rank_main(argv, film_path: str) -> dict:
    """One spawned rank: the CLI in the rank's process group; rank 0 also
    saves the film for the launching process -> this rank's stats."""
    import torch.distributed as dist

    film, stats = main(argv)
    if dist.get_rank() == 0:
        film.save(film_path)
    return stats


def _spawn(argv, shape, args):
    """Start tile x spp ranks on this node and wait for them -> (rank 0's
    film on the CPU, rank 0's stats with every rank's under ``ranks``)."""
    from ..core.film import Film
    from ..parallel import sharding

    common.select_device(args)  # a missing CUDA device fails here, before any rank starts
    world = shape[0] * shape[1]
    common.stage(f"--mesh {args.mesh}: spawning {world} ranks on this node")
    with tempfile.TemporaryDirectory(prefix="jade-film-") as tmp:
        film_path = os.path.join(tmp, "film.npz")
        try:
            ranks = sharding.spawn_local("jaderaytracerendering_tpu_torch.cli.render:_rank_main",
                                         world, (list(argv), film_path), device=args.device)
        except RuntimeError as e:
            raise SystemExit(f"--mesh {args.mesh}: {e}") from None
        film = Film.load(film_path)
    return film, dict(ranks[0], ranks=ranks)


def main(argv=None):
    """Run the CLI; returns (film, stats) with stats = {'seconds',
    'rays', 'device', 'bvh_builder', 'scene_build_s'} for callers that
    drive it in-process (with ``--mesh``, also 'backend', 'rank',
    'rank_device', 'window_ms' (each rank's tile window), the film's
    all_reduce figures, 'film_sha256' and 'launches'; spawned ranks' stats
    under 'ranks')."""
    import sys

    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(prog="jade-render-torch")
    common.add_common_args(ap)
    ap.add_argument("--out", default="RenderResultCuda.bmp")
    ap.add_argument("--mesh", help="device mesh TILExSPP, e.g. 2x1: film tiles x samples "
                                   "over tile*spp ranks (torch.distributed)")
    ap.add_argument("--save-film", dest="save_film",
                    help="checkpoint the raw film (npz) for resume")
    ap.add_argument("--resume-film", dest="resume_film",
                    help="resume accumulation from a film checkpoint")
    args = ap.parse_args(argv)
    shape = _parse_mesh(args.mesh) if args.mesh else None

    import torch
    import torch.distributed as dist

    if shape and not dist.is_initialized() and "RANK" not in os.environ:
        return _spawn(argv, shape, args)

    from ..core.film import Film
    from ..integrator import render as R
    from ..ops import kernels
    from ..post import image_io, tonemap
    from ..scene.scene import assemble

    device = common.select_device(args)
    mesh = None
    if shape:
        from ..parallel import sharding

        sharding.init_distributed(device=args.device)  # torchrun's environment, or the group
        world = dist.get_world_size()
        if shape[0] * shape[1] != world:
            raise SystemExit(f"--mesh {args.mesh}: {shape[0] * shape[1]} ranks, but the process "
                             f"group has {world}")
        device = sharding.rank_device(args.device)
        mesh = sharding.make_mesh(shape)
    objects, env, cam = common.load_scene(args)
    cfg = common.config_from_args(args)
    t0 = time.perf_counter()
    sd = assemble(objects, env, leaf_size=cfg.bvh_leaf_size, device=device)
    build_s = time.perf_counter() - t0
    common.stage(f"scene: {sd.n_triangles} triangles, {sd.n_nodes} BVH nodes, "
                 f"{sd.n_emit} emissive, BVH depth {sd.bvh_depth}, {sd.bvh_builder} BVH "
                 f"builder, built in {build_s:.3f}s, device {device}")

    film = Film.load(args.resume_film, device) if args.resume_film else None
    stats = {"device": str(device), "bvh_builder": sd.bvh_builder, "scene_build_s": build_s}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        stats["device"] = torch.cuda.get_device_name(device)
    if mesh is not None:  # the ranks start together (an all_reduce as the barrier)
        dist.all_reduce(torch.zeros(1, device=device))
    t0 = time.perf_counter()
    if mesh is None:
        film = R.render_film(sd, cam, cfg, film=film, stats=stats)
    else:
        film = sharding.render_film_distributed(sd, cam, cfg, mesh, film=film, stats=stats)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stats["seconds"] = time.perf_counter() - t0
    samples = cfg.width * cfg.height * cfg.spp
    line = (f"rendered {cfg.width}x{cfg.height} +{cfg.spp}spp (film {film.count}spp) in "
            f"{stats['seconds']:.3f}s: {samples / stats['seconds'] / 1e6:.3f} Msamples/s, "
            f"{stats['rays'] / stats['seconds'] / 1e6:.3f} useful Mrays/s on {stats['device']}")
    if mesh is not None:
        stats["rank"] = dist.get_rank()
        stats["rank_device"] = str(device)
        stats["film_sha256"] = hashlib.sha256(film.accum.cpu().numpy().tobytes()).hexdigest()
        stats["launches"] = dict(kernels.LAUNCHES)
        win = stats["window_ms"]
        line += (f" ({device}); mesh {shape[0]}x{shape[1]} ({stats['backend']}): the whole mesh's "
                 f"samples and rays; rank windows {', '.join(f'{w:.3f}' for w in win)} ms "
                 f"(imbalance {sharding.tile_imbalance_pct(win):.1f}%); all_reduce "
                 f"{stats['allreduce_ms']:.3f} ms in {stats['allreduce_calls']} calls "
                 f"({stats['allreduce_bytes']} bytes); film sha256 {stats['film_sha256'][:16]}")
    common.stage(line)

    if mesh is None or dist.get_rank() == 0:
        if args.save_film:
            film.save(args.save_film)
            common.stage(f"film checkpoint -> {args.save_film}")
        # film row 0 is the bottom row; a CUDA film is finished on the card
        image_io.save(args.out, tonemap.finalize(film.mean(), cfg.tonemap, flip=True))
        common.stage(f"wrote {args.out}")
    return film, stats


if __name__ == "__main__":
    main()
