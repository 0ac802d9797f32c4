"""Monte-Carlo convergence: relative RMSE against spp, from a high-spp
reference render (expected log-log slope -0.5).

The JAX package's docs/convergence.py: the bench's jade scene (20k
statue triangles, a 128x256 sky, camera r 2.2, up angle 10), 64^2, depth
6, engine ``pool``; a 2048-spp reference at seed 0, then spp 1, 4, 16,
64 and 256 at seed 1 (an independent stream), each row's RMSE over max
|reference|, and the slope of log2(RMSE) against log2(spp). Writes a
markdown table to ``--out``.

    python -m jaderaytracerendering_tpu_torch.cli.convergence
    python -m jaderaytracerendering_tpu_torch.cli.convergence --engine mega
    python -m jaderaytracerendering_tpu_torch.cli.convergence --device cpu \\
        --size 8 --tris 300 --ref-spp 64
"""

from __future__ import annotations

import argparse
import pathlib
import time

import numpy as np

from ..integrator.render import ENGINES
from . import common
from .rmse_gate import rmse_rel

REPO = pathlib.Path(__file__).resolve().parents[2]
SPPS = (1, 4, 16, 64, 256)


def main(argv=None) -> dict:
    """Run the study -> {'rows': [(spp, relative RMSE)], 'slope', ...}."""
    ap = argparse.ArgumentParser(prog="jade-convergence")
    ap.add_argument("--engine", choices=list(ENGINES), default="pool")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the scene and the renders live (default cuda)")
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--tris", type=int, default=20_000)
    ap.add_argument("--ref-spp", dest="ref_spp", type=int, default=2048)
    ap.add_argument("--out", default=str(REPO / "chiprun_out" / "convergence.md"),
                    help="the markdown table")
    args = ap.parse_args(argv)
    device = common.select_device(args)

    from ..integrator import render as R
    from ..models import demo
    from ..scene.scene import assemble
    from ..utils.config import RenderConfig

    ds = demo.jade_scene(n_buddha_tris=args.tris, env_shape=(128, 256))
    ds.camera.r = 2.2
    ds.camera.up_angle = 10.0
    sd = assemble(ds.objects, ds.env_map, device=device)

    def render(spp, seed):
        cfg = RenderConfig(width=args.size, height=args.size, spp=spp,
                           spp_batch=min(spp, 8), max_depth=6, traversal="sweep",
                           engine=args.engine, seed=seed)
        return R.render_film(sd, ds.camera, cfg).mean()

    t0 = time.perf_counter()
    ref = render(args.ref_spp, seed=0)
    rows = []
    for spp in SPPS:
        rmse = rmse_rel(render(spp, seed=1), ref)[0]  # independent stream from the reference
        rows.append((spp, rmse))
        print(f"spp={spp:4d}  relative RMSE={rmse:.6f}", flush=True)
    secs = time.perf_counter() - t0
    slope = float(np.polyfit(np.log2([s for s, _ in rows]), np.log2([r for _, r in rows]), 1)[0])
    where = common.card() if device.type == "cuda" else "cpu"
    print(f"log-log slope: {slope:.4f} (ideal -0.5); {args.engine}, {where}, {secs:.3f} s")

    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(
        f"# Monte-Carlo convergence (jade demo, {args.tris} statue tris, "
        f"{args.size}x{args.size}, depth 6)\n\n"
        f"Relative RMSE of the {args.engine} engine at spp s against a {args.ref_spp}-spp\n"
        "reference render (independent RNG streams). Expected ~1/sqrt(spp);\n"
        f"measured log-log slope: **{slope:.4f}** (ideal -0.5).\n\n"
        "| spp | relative RMSE |\n|---|---|\n"
        + "".join(f"| {s} | {r:.6f} |\n" for s, r in rows)
        + f"\nWritten by jaderaytracerendering_tpu_torch/cli/convergence.py on {where}.\n")
    print(f"# wrote {out}")
    return {"rows": rows, "slope": slope, "seconds": secs, "device": where}


if __name__ == "__main__":
    main()
