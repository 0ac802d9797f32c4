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
"""

from __future__ import annotations

import argparse
import time

from . import common


def main(argv=None):
    """Run the CLI; returns (film, stats) with stats = {'seconds',
    'rays', 'device', 'bvh_builder', 'scene_build_s'} for callers that
    drive it in-process."""
    ap = argparse.ArgumentParser(prog="jade-render-torch")
    common.add_common_args(ap)
    ap.add_argument("--out", default="RenderResultCuda.bmp")
    ap.add_argument("--mesh", help="device mesh TILExSPP (multi-device: not ported yet)")
    ap.add_argument("--save-film", dest="save_film",
                    help="checkpoint the raw film (npz) for resume")
    ap.add_argument("--resume-film", dest="resume_film",
                    help="resume accumulation from a film checkpoint")
    args = ap.parse_args(argv)
    if args.mesh:
        raise SystemExit(f"--mesh {args.mesh}: multi-device rendering is not ported yet; "
                         "render on one device without --mesh")
    device = common.select_device(args)

    import torch

    from ..core.film import Film
    from ..integrator import render as R
    from ..post import image_io, tonemap
    from ..scene.scene import assemble

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
    t0 = time.perf_counter()
    film = R.render_film(sd, cam, cfg, film=film, stats=stats)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stats["seconds"] = time.perf_counter() - t0
    samples = cfg.width * cfg.height * cfg.spp
    common.stage(f"rendered {cfg.width}x{cfg.height} +{cfg.spp}spp "
                 f"(film {film.count}spp) in {stats['seconds']:.3f}s: "
                 f"{samples / stats['seconds'] / 1e6:.3f} Msamples/s, "
                 f"{stats['rays'] / stats['seconds'] / 1e6:.3f} useful Mrays/s "
                 f"on {stats['device']}")

    if args.save_film:
        film.save(args.save_film)
        common.stage(f"film checkpoint -> {args.save_film}")
    rad = film.mean().cpu().numpy()[::-1]  # film row 0 is the bottom row
    image_io.save(args.out, tonemap.finalize(rad, cfg.tonemap))
    common.stage(f"wrote {args.out}")
    return film, stats


if __name__ == "__main__":
    main()
