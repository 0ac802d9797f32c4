"""The readings the comparison's limits are set from, on the card at a
cell's own size, in one process:

    python3 -m benchmark.control --workload NAME [--seeds 12] [--control-seeds 3]
        [--seconds 1.5] [--first-seed N]

For each seed: a short window of the cell's client (long enough to finish
the items a run compares), the program's outputs against the reference's
(the lower readings: sound runs). For the first ``--control-seeds`` seeds
also the control: the reference computed in bfloat16, the nearest
precision below the configuration's float32, put in the program's place
and judged against the float32 reference (the upper readings). Prints one
JSON line a seed and a summary line last. The benchmark's own runs do not
run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import cells, scene
from .run import Context


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=1.5)
    ap.add_argument("--first-seed", type=int, default=5_000_000_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=None, help="the checkout (default: this one)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from . import program

    cell = cells.load(args.workload, args.root)
    dev = torch.device(args.device)
    ctx = Context(cell=cell, device=dev, raw=scene.make(cell.config["scene"]))
    ctx.sd = program.build_scene(ctx.raw, dev)
    client = cells.client(cell)(ctx)
    client.warm_up()
    lower, upper = {}, {}
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        win = client.window(args.seconds, seed)
        client.keep(win, seed)
        t0 = time.perf_counter()
        refs = client.reference(win, seed)
        ref_s = time.perf_counter() - t0
        sound = client.compare(win.kept["outputs"], refs)
        line = {"seed": seed, "items": win.attempted, "program": sound, "reference_s": ref_s}
        for k, v in sound.items():
            lower[k] = max(lower.get(k, 0.0), v)
        if i < args.control_seeds:
            low = client.reference(win, seed, torch.bfloat16, order=win.kept.get("order"))
            ctrl = client.compare(low, refs)
            line["control_bf16"] = ctrl
            for k, v in ctrl.items():
                upper[k] = min(upper.get(k, float("inf")), v)
        print(json.dumps(line), flush=True)
    print(json.dumps({"workload": args.workload, "lower": lower, "upper": upper,
                      "limits_now": cell.traffic["check"]["limits"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
