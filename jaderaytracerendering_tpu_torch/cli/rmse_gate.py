"""North-star quality gate: the port's pipeline against its CPU oracle.

BASELINE.md: "RMSE < 1e-3 vs CPU reference at 1024 spp". The JAX
package's tools/rmse_gate.py and tools/rmse_northstar.py in one module:
the jade scene (a statue of ``--tris`` triangles, a 16x32 sky, the camera
at r 2.0; ``--statue`` aims it at the statue, which that view's primary
rays miss at 8x8) rendered at ``--size``^2 and ``--spp`` by the oracle
(cpuref/integrator.py, path by path on the CPU) and by
``integrator.render.render_film`` on ``--device`` (on the card: the
kernels of ``--engine``). Both scene copies are built
from the same objects. Prints one result line and PASS; exits non-zero
when the relative RMSE (over max |oracle|) reaches 1e-3.

    python -m jaderaytracerendering_tpu_torch.cli.rmse_gate                 # pool, 1024 spp
    python -m jaderaytracerendering_tpu_torch.cli.rmse_gate --engine mega
    python -m jaderaytracerendering_tpu_torch.cli.rmse_gate --statue   # SSS and mirror paths
    python -m jaderaytracerendering_tpu_torch.cli.rmse_gate --engine mega \\
        --traversal brute --depth 5 --spp-batch 64   # tools/rmse_northstar.py's setting
    python -m jaderaytracerendering_tpu_torch.cli.rmse_gate --device cpu --size 4 --spp 4

The oracle takes minutes at 8x8 and 1024 spp (65,536 paths); never hand
it a large film.
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from . import common

GATE = 1e-3  # BASELINE.md:31


def rmse_rel(got, ref) -> tuple[float, float]:
    """(relative RMSE, max relative error) of film ``got`` against ``ref``
    (arrays or tensors of one shape), both over max |ref|
    (tools/rmse_gate.py:65-67)."""
    got = torch.as_tensor(got).detach().to("cpu", torch.float64)
    ref = torch.as_tensor(ref).detach().to("cpu", torch.float64)
    if got.shape != ref.shape:
        raise ValueError(f"film shapes differ: {tuple(got.shape)} vs {tuple(ref.shape)}")
    scale = max(float(ref.abs().max()), 1e-12)
    diff = got - ref
    return (float(diff.square().mean().sqrt()) / scale, float(diff.abs().max()) / scale)


def check_rmse(got, ref, what: str = "film", limit: float = GATE) -> tuple[float, float]:
    """``rmse_rel`` that raises AssertionError unless the relative RMSE is
    below ``limit`` (or the film is not finite)."""
    r, m = rmse_rel(got, ref)
    if not r < limit:  # NaN fails too
        raise AssertionError(f"north-star RMSE gate FAILED on {what}: relative RMSE "
                             f"{r:.4e} >= {limit:g} (max rel err {m:.4e})")
    return r, m


# a view of the statue from 0.25 away (eye (0, -0.34, 0.72), looking at
# (0, -0.46, 0.5)): at 8x8 the statue takes 10 pixels' primary rays
STATUE_EYE = np.array([0.0, -0.34, 0.72])
STATUE_CENTER = np.array([0.0, -0.46, 0.5])


def statue_view(camera) -> None:
    """Aim an orbit camera (eye at r around the origin, looking at
    ``eye_center``) at the statue from ``STATUE_EYE``."""
    r = float(np.linalg.norm(STATUE_EYE))
    camera.r = r
    camera.up_angle = math.degrees(math.asin(STATUE_EYE[1] / r))
    camera.rotate_angle = 0.0
    camera.eye_center = STATUE_CENTER.copy()


def gate_scene(tris: int = 300, statue: bool = False):
    """The gate's demo scene: jade with a statue of ``tris`` triangles,
    a 16x32 sky, the camera moved in to r 2.0 (tools/rmse_gate.py's view,
    where an 8x8 film's primary rays miss the statue: they see the mirror
    floor, the sky and the light); ``statue``: the camera on the statue
    (``statue_view``), so that its SSS and mirror branches run."""
    from ..models import demo

    ds = demo.jade_scene(n_buddha_tris=tris, env_shape=(16, 32))
    ds.camera.r = 2.0
    if statue:
        statue_view(ds.camera)
    return ds


def main(argv=None) -> dict:
    """Run the gate -> {'rmse_rel', 'max_rel', 'oracle_s', 'pipeline_s',
    'rays', 'device'}; raises SystemExit (non-zero) when it fails."""
    ap = argparse.ArgumentParser(prog="jade-rmse-gate")
    ap.add_argument("--spp", type=int, default=1024)
    ap.add_argument("--size", type=int, default=8)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--tris", type=int, default=300)
    ap.add_argument("--spp-batch", dest="spp_batch", type=int, default=8)
    ap.add_argument("--engine", choices=["mega", "pool", "scan"], default="pool")
    ap.add_argument("--traversal", default="sweep",
                    choices=["sweep", "clusters", "gemm", "bvh", "brute"],
                    help="the JAX CLI's choices; every one walks the BVH here")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the pipeline renders (default cuda); the oracle "
                         "always runs on the CPU")
    ap.add_argument("--statue", action="store_true",
                    help="aim the camera at the statue (gate_scene)")
    args = ap.parse_args(argv)
    device = common.select_device(args)

    from ..cpuref import integrator as oracle
    from ..integrator import render as R
    from ..scene.scene import assemble
    from ..utils.config import RenderConfig

    ds = gate_scene(args.tris, args.statue)
    cfg = RenderConfig(width=args.size, height=args.size, spp=args.spp,
                       spp_batch=args.spp_batch, max_depth=args.depth,
                       traversal=args.traversal, engine=args.engine)
    sd_cpu = assemble(ds.objects, ds.env_map, device="cpu")
    sd = sd_cpu if device.type == "cpu" else assemble(ds.objects, ds.env_map, device=device)

    t0 = time.perf_counter()
    ref = oracle.render_radiance(sd_cpu, ds.camera, cfg)
    t_oracle = time.perf_counter() - t0

    stats = {}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    got = R.render_film(sd, ds.camera, cfg, stats=stats).mean().cpu()
    t_pipe = time.perf_counter() - t0

    r, m = rmse_rel(got, ref)
    where = common.card() if device.type == "cuda" else "cpu"
    print(f"RMSE gate: {args.size}x{args.size} @ {args.spp} spp depth {args.depth} "
          f"({args.tris} tris{', statue view' if args.statue else ''}, "
          f"{args.engine}+{args.traversal}, device={where}): "
          f"relative RMSE = {r:.4e}, max rel err = {m:.4e} (gate < {GATE:g}; "
          f"oracle {t_oracle:.3f}s, pipeline {t_pipe:.3f}s, {stats['rays']:.0f} useful rays)",
          flush=True)
    if not r < GATE:
        raise SystemExit("north-star RMSE gate FAILED")
    print("PASS")
    return {"rmse_rel": r, "max_rel": m, "oracle_s": t_oracle, "pipeline_s": t_pipe,
            "rays": stats["rays"], "device": where}


if __name__ == "__main__":
    main()
