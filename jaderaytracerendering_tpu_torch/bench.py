"""Throughput bench of the port: the jade scene in useful Mrays/s on one card.

The JAX package's bench.py for the PyTorch/CUDA port:

    python -m jaderaytracerendering_tpu_torch.bench                  # pool, 256^2 16 spp depth 6, 20k tris
    python -m jaderaytracerendering_tpu_torch.bench --engine mega
    python -m jaderaytracerendering_tpu_torch.bench --all            # the matrix
    python -m jaderaytracerendering_tpu_torch.bench --small --device cpu

Rays counted are *useful* rays (bench.py:6-10): primary rays plus every
NEE shadow, HDR visibility and continuation ray of live paths, as
``render_film(..., stats=)["rays"]`` counts them for every engine (the
megakernel's row 3, the pool's ``C_RAYS``, the scan engine's counts).

Protocol (``PROTOCOL``, named in every line): the scene is built and one
render warms up, then ``--reps`` renders of the same samples run back to
back, each into a fresh film. ``value`` is the sustained rate, useful rays
x reps over the wall seconds of the whole run (the device synchronised at
both ends); ``single_ms`` the min, median and max of each render's CUDA
event time. Every rep's ms is printed on a line of its own, then one JSON
line with the card's ``nvidia-smi`` name and power limit. A failure
raises: there is no retry at a smaller size.

``--all`` runs bench.py's matrix: ``default``, ``depth16``, ``tris100k``
and ``tris400k``, each through ``mega`` and through ``pool`` (two lines,
neither kept over the other), and the four 1024^2 preview rows (a warm
frame, then ``PREVIEW_FRAMES`` frames with the display's u8 frame copied
to the host as the barrier; the ``pool`` rows run the torch preview
integrator on the card, as the JAX route runs jnp code). It writes the
rows to ``--out``. ``--mega-gather``, ``--mega-tile`` and
``--rays-per-launch`` tuned the TPU kernels: accepted and ignored.
"""

from __future__ import annotations

import argparse
import copy
import json
import pathlib
import statistics
import time

import torch

from .cli import common

REPO = pathlib.Path(__file__).resolve().parents[1]
DEFAULT_OUT = REPO / "chiprun_out" / "bench_matrix.json"
PROTOCOL = ("sustained: scene built and one warm render, then reps renders of the same "
            "samples back to back, each into a fresh film; value = useful rays x reps / "
            "wall seconds of the reps (device synchronized at both ends); single_ms = "
            "CUDA events around each render (host clock on the CPU)")
PREVIEW_PROTOCOL = ("a warm frame, then frames display frames back to back, the u8 frame "
                    "copied to the host as each frame's barrier; value = frames / wall seconds")
DEFAULT = dict(width=256, height=256, spp=16, depth=6, tris=20_000)  # bench.py:30-37
SMALL = dict(width=32, height=32, spp=2, depth=3, tris=2_000)
MATRIX = (("default", {}), ("depth16", {"depth": 16}), ("tris100k", {"tris": 100_000}),
          ("tris400k", {"tris": 400_000}))
MATRIX_ENGINES = ("mega", "pool")
PREVIEW_ROWS = (("preview1024", "pool", 1), ("preview1024_mega", "mega", 1),
                ("preview1024_band4", "pool", 4), ("preview1024_mega_band4", "mega", 4))
PREVIEW_FRAMES = 6
PREVIEW_SIZE = 1024  # the reference's window (PathTrace.cu:24-30 -DLARGE)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="jade-bench-torch")
    for k, v in DEFAULT.items():
        ap.add_argument(f"--{k}", type=int, default=v)
    ap.add_argument("--spp-batch", dest="spp_batch", type=int, default=4,
                    help="samples per scan-engine batch")
    ap.add_argument("--traversal", default="sweep",
                    help="a JAX traversal name; every one walks the BVH here")
    ap.add_argument("--engine", default="pool", choices=["pool", "scan", "mega"])
    ap.add_argument("--reps", type=int, default=8, help="timed renders after the warm one")
    ap.add_argument("--spawn-rounds", dest="spawn_rounds", type=int, default=0,
                    help="pool: spawn rounds per iteration (0 = the config's default)")
    for flag in ("--rays-per-launch", "--mega-gather", "--mega-tile"):
        ap.add_argument(flag, help="accepted for the JAX bench's command lines; ignored")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the scene and the render live (default cuda)")
    ap.add_argument("--small", action="store_true", help="tiny smoke config (32^2, 2 spp, "
                    "depth 3, 2,000 tris)")
    ap.add_argument("--all", action="store_true",
                    help="run the matrix; one JSON line per row and engine")
    ap.add_argument("--out", default=str(DEFAULT_OUT), help="--all: the matrix's JSON file")
    args = ap.parse_args(argv)
    if args.reps < 1:
        ap.error("--reps must be at least 1")
    if args.small:
        for k, v in SMALL.items():
            setattr(args, k, v)
    return args


def device_info(device: torch.device) -> dict:
    """{"name", "power_limit"} of the card (``nvidia-smi``), or of the CPU."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    name, limit = (s.strip() for s in common.card().rsplit(",", 1))
    return {"name": name, "power_limit": limit}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _scene(tris: int, device: torch.device):
    """bench.py:197-207's scene: jade with ``tris`` statue triangles, a
    128x256 sky, camera r 2.2 and up angle 10, the default BVH builder.
    Its build is set-up, printed on a line of its own and never timed."""
    from .models import demo
    from .scene.scene import assemble

    ds = demo.jade_scene(n_buddha_tris=tris, env_shape=(128, 256))
    ds.camera.r = 2.2
    ds.camera.up_angle = 10.0
    t0 = time.perf_counter()
    sd = assemble(ds.objects, ds.env_map, device=device)
    _sync(device)
    print(f"scene: jade --tris {tris}: {sd.n_triangles} triangles, {sd.n_nodes} BVH nodes, "
          f"depth {sd.bvh_depth}, {sd.bvh_builder} builder, built in "
          f"{time.perf_counter() - t0:.4f} s (not timed)", flush=True)
    return ds, sd


def _config_name(args) -> str:
    shape = {k: getattr(args, k) for k in DEFAULT}
    return "small" if shape == SMALL else "default" if shape == DEFAULT else "custom"


def measure(args, device: torch.device, config: str) -> dict:
    """One engine's throughput line (module docstring's protocol)."""
    from .integrator import render as R
    from .ops import kernels
    from .utils.config import RenderConfig

    ds, sd = _scene(args.tris, device)
    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       spp_batch=args.spp_batch, max_depth=args.depth,
                       traversal=args.traversal, engine=args.engine)
    if args.spawn_rounds:
        cfg = cfg.replace(spawn_rounds=args.spawn_rounds)

    def render():
        st = {}
        film = R.render_film(sd, ds.camera, cfg, stats=st)
        return film, st["rays"]

    _, rays = render()  # warm
    cuda = device.type == "cuda"
    kernels.reset_launches()
    marks, got = [], []
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(args.reps):
        if cuda:
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            film, n = render()
            ev[1].record()
        else:
            ev = time.perf_counter()
            film, n = render()
            ev = (ev, time.perf_counter())
        marks.append(ev)
        got.append(n)
    _sync(device)
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    ms = [s.elapsed_time(e) if cuda else (e - s) * 1e3 for s, e in marks]
    if any(n != rays for n in got):
        raise AssertionError(f"{args.engine}: useful rays differ between renders of the same "
                             f"samples: warm {rays}, reps {got}")
    if not (bool(torch.isfinite(film.accum).all()) and float(film.accum.sum()) > 0):
        raise AssertionError(f"{args.engine}: the film is not finite and positive")
    for i, m in enumerate(ms):
        print(f"rep {i}: {m:.4f} ms ({args.engine}, {config})", flush=True)
    metric = "Mrays/sec/chip" if cuda else "Mrays/sec on the CPU (plain versions)"
    return {"metric": metric, "value": rays * args.reps / wall / 1e6,
            "unit": "Mrays/s", "engine": args.engine, "config": config,
            "shape": {k: getattr(args, k) for k in DEFAULT}, "rays": rays, "reps": args.reps,
            "protocol": PROTOCOL, "wall_s": wall,
            "single_ms": {"min": min(ms), "median": statistics.median(ms), "max": max(ms)},
            "launches": launches, "device": device_info(device)}


def measure_preview_fps(args, device: torch.device, name: str, engine: str,
                        bands: int) -> dict:
    """Frames/s of the progressive 2-bounce preview at ``PREVIEW_SIZE``^2
    (bench.py:210-245): a warm frame, then ``PREVIEW_FRAMES`` displayed
    frames."""
    from .core.film import Film
    from .integrator import render as R
    from .ops import kernels
    from .utils.config import RenderConfig

    ds, sd = _scene(20_000, device)
    cfg = RenderConfig(width=PREVIEW_SIZE, height=PREVIEW_SIZE, spp=1, spp_batch=1, max_depth=2,
                       traversal=args.traversal, integrator="preview", engine=engine,
                       preview_bands=bands)
    film = Film.create(cfg.height, cfg.width, device)
    film, disp = R.render_film_preview(sd, ds.camera, cfg, film=film, display=True,
                                       frame_idx=0)
    disp.cpu()
    kernels.reset_launches()
    frame_ms = []
    t0 = time.perf_counter()
    for fi in range(1, PREVIEW_FRAMES + 1):
        tf = time.perf_counter()
        film, disp = R.render_film_preview(sd, ds.camera, cfg, film=film, display=True,
                                           frame_idx=fi)
        disp.cpu()
        frame_ms.append((time.perf_counter() - tf) * 1e3)
    wall = time.perf_counter() - t0
    label = (f"preview FPS @{PREVIEW_SIZE}x{PREVIEW_SIZE} ({engine}"
             + (f", {bands} bands)" if bands > 1 else ")"))
    if device.type != "cuda":
        label += " on the CPU"
    return {"metric": label, "value": PREVIEW_FRAMES / wall, "unit": "frames/s",
            "engine": engine, "config": name, "frames": PREVIEW_FRAMES, "frame_ms": frame_ms,
            "protocol": PREVIEW_PROTOCOL,
            "launches": {k: v for k, v in kernels.LAUNCHES.items() if v},
            "device": device_info(device)}


def run_matrix(args, device: torch.device) -> dict:
    """bench.py's ``--all`` rows -> {row: {engine: line}} (throughput rows)
    or {row: line} (preview rows), also written to ``args.out``."""
    results = {}
    for name, over in MATRIX:
        results[name] = {}
        for engine in MATRIX_ENGINES:
            a = copy.copy(args)
            for k, v in over.items():
                setattr(a, k, v)
            a.engine = engine
            results[name][engine] = measure(a, device, name)
            print(json.dumps(results[name][engine]), flush=True)
    for name, engine, bands in PREVIEW_ROWS:
        results[name] = measure_preview_fps(args, device, name, engine, bands)
        print(json.dumps(results[name]), flush=True)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    print(f"# wrote {out}")
    return results


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = common.select_device(args)
    if args.all:
        return run_matrix(args, device)
    line = measure(args, device, _config_name(args))
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
