"""A/B of this tree's render CLI against another tree's on one card: the
same films rendered by both, in turns, compared bit for bit.

    python -m jaderaytracerendering_tpu_torch.cli.film_ab OTHER_ROOT [--reps 2]

``OTHER_ROOT`` is the root of another checkout of the repository (e.g. a
parent commit unpacked with ``git archive`` into a git-ignored
directory). Each render is a subprocess in its tree's root that calls
that tree's ``cli.render.main`` with ``--save-film``, so each tree builds
and runs its own kernels through its own C interface. The films: the
megakernel at the main path (the CLI's defaults: jade 20k, 1024x1024, 16
spp, depth 16), the megakernel at 96x96, 4 spp, depth 6 (chip_smoke.py's
phase 3 film) and the pool at the main path. Runs go other, this, this,
other, ``--reps`` times. Prints each run's render seconds (the CLI's
host clock around ``render_film``, ending in a synchronize) and, per
film, whether the trees agree bit for bit (the pool's film adds are float
atomics, so its films differ in the last bits from run to run); last, one
JSON object. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np

from . import common

THIS_ROOT = pathlib.Path(__file__).resolve().parents[2]
FILMS = {
    "mega-main": [],
    "mega-96x96": ["--width", "96", "--height", "96", "--spp", "4", "--max-depth", "6"],
    "pool-main": ["--engine", "pool"],
}
_RUN = ("import json, sys\n"
        "from jaderaytracerendering_tpu_torch.cli import render\n"
        "film, stats = render.main(sys.argv[1:])\n"
        "print('AB_STATS ' + json.dumps({k: stats[k] for k in ('seconds', 'rays')}))\n")


def _render(root: pathlib.Path, args: list, film: str) -> dict:
    res = subprocess.run([sys.executable, "-c", _RUN, *args, "--out",
                          film.replace(".npz", ".bmp"), "--save-film", film],
                         cwd=root, capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise SystemExit(f"film_ab: {root} {args}: exit code {res.returncode}\n"
                         f"{res.stderr[-3000:]}")
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("AB_STATS ")][-1]
    return json.loads(line[len("AB_STATS "):])


def main(argv=None):
    ap = argparse.ArgumentParser(prog="jade-film-ab")
    ap.add_argument("other", help="root of the other tree")
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    card = common.card()
    trees = {"other": pathlib.Path(args.other).resolve(), "this": THIS_ROOT}
    out = {"card": card, "other": str(trees["other"]), "films": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for name, flags in FILMS.items():
            secs = {"other": [], "this": []}
            rays = {}
            films = {}
            for rep in range(args.reps):
                for k, tree in enumerate(("other", "this", "this", "other")):
                    path = os.path.join(tmp, f"{name}-{tree}-{rep}-{k}.npz")
                    st = _render(trees[tree], flags, path)
                    secs[tree].append(st["seconds"])
                    rays.setdefault(tree, st["rays"])
                    films.setdefault(tree, np.load(path)["accum"])
            equal = bool(np.array_equal(films["this"], films["other"]))
            diff = float(np.abs(films["this"].astype(np.float64) - films["other"]).max())
            row = {"seconds": secs, "rays": rays, "bit_equal": equal, "max_abs_diff": diff}
            out["films"][name] = row
            print(f"{name}: this {' '.join(f'{s:.4f}' for s in secs['this'])} s, other "
                  f"{' '.join(f'{s:.4f}' for s in secs['other'])} s; films "
                  f"{'bit-equal' if equal else f'differ (max abs {diff:.3e})'}; useful rays "
                  f"{'equal' if rays['this'] == rays['other'] else rays} [{card}]", flush=True)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
