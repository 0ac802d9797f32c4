"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path (``jaderaytracerendering_tpu_torch``) on the
card and checks its CUDA kernels against their plain PyTorch versions:

  0. environment: a CUDA device; the card's name and power limit;
  1. build: compiles csrc/mega.cu with nvcc (timed);
  2. traversal: 2^16 random rays through the kernel's BVH walk
     (``bvh_nearest``) and the plain torch walk on the jade scene;
  3. megakernel vs plain: jade, 96x96, 4 spp, depth 6, the whole image;
  4. main path: the render CLI at its defaults (jade, 20k statue
     triangles, 1024x1024, 16 spp, depth 16) through the megakernel, with
     the launch counter, the film and the BMP checked, and the film held
     against the plain version on a random subset of its pixels.

Every phase prints one line; any failure raises (exit code != 0). The
line before the last is the kernels' JSON record, the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

MAIN_TRIS = 20_000
RTOL, ATOL_FRAC = 1e-3, 1e-4     # per pixel: |a-b| <= ATOL_FRAC*max + RTOL*|b|
MAX_OUTLIER_FRAC = 1e-3          # share of pixels allowed outside that bound
MEAN_RTOL = 1e-4                 # image mean, relative
TRAV_ID_FRAC = 0.9999            # traversal: share of rays with equal ids
TRAV_T_RTOL = 1e-5               # traversal: t where ids differ


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, reps: int = 1) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare_images(kernel: torch.Tensor, plain: torch.Tensor, what: str):
    """kernel/plain [3, P] radiance sums -> (max_abs_err, n_outside)."""
    a, b = kernel.double().cpu(), plain.double().cpu()
    if not bool(torch.isfinite(a).all()):
        raise AssertionError(f"{what}: kernel output is not finite")
    err = (a - b).abs()
    bound = ATOL_FRAC * float(b.abs().max()) + RTOL * b.abs()
    outside = int((err > bound).any(dim=0).sum())
    n = a.shape[1]
    mean_rel = abs(float(a.mean()) - float(b.mean())) / max(abs(float(b.mean())), 1e-30)
    if outside > MAX_OUTLIER_FRAC * n or mean_rel > MEAN_RTOL:
        raise AssertionError(
            f"{what}: {outside}/{n} pixels outside rtol={RTOL} "
            f"atol={ATOL_FRAC}*max (allowed {MAX_OUTLIER_FRAC * n:.1f}); "
            f"image mean rel diff {mean_rel:.3e} (allowed {MEAN_RTOL})")
    return float(err.max()), outside, mean_rel


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is false)")
    from jaderaytracerendering_tpu_torch.cli import render as cli_render
    from jaderaytracerendering_tpu_torch.core import camera as camera_mod
    from jaderaytracerendering_tpu_torch.integrator.render import render_batch
    from jaderaytracerendering_tpu_torch.models import demo
    from jaderaytracerendering_tpu_torch.ops import build, mega as megak, traverse
    from jaderaytracerendering_tpu_torch.scene.scene import assemble
    from jaderaytracerendering_tpu_torch.utils.config import RenderConfig

    dev = torch.device("cuda")
    gpu = card()
    log(f"phase 0 env: {gpu}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    megak.library()
    log(f"phase 1 build: csrc/mega.cu with nvcc {' '.join(build.NVCC_FLAGS)} "
        f"in {time.perf_counter() - t0:.1f}s")

    # ---- phase 2: traversal ----------------------------------------------
    ds = demo.jade_scene(n_buddha_tris=MAIN_TRIS)
    sd = assemble(ds.objects, ds.env_map, device=dev)
    rng = np.random.default_rng(0)
    n = 1 << 16
    o = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    tgt = rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
    d = (tgt - o).astype(np.float32)
    ex = rng.integers(-1, sd.n_triangles, n).astype(np.int32)
    o_t, d_t = torch.tensor(o, device=dev), torch.tensor(d, device=dev)
    ex_t = torch.tensor(ex, device=dev)
    hk, ik, tk = megak.bvh_nearest(sd, o_t, d_t, ex_t)
    hp, ip, tp = traverse.nearest_hit_bvh(o_t, d_t, ex_t, sd)
    torch.cuda.synchronize()
    trav_ms = cuda_ms(lambda: megak.bvh_nearest(sd, o_t, d_t, ex_t), reps=5)
    trav_plain_ms = cuda_ms(lambda: traverse.nearest_hit_bvh(o_t, d_t, ex_t, sd))
    diff = ik != ip
    n_diff = int(diff.sum())
    if bool((hk != hp).any()):
        raise AssertionError(f"traversal: {int((hk != hp).sum())} rays differ in hit/miss")
    t_rel = ((tk - tp).abs() / tp.abs().clamp_min(1e-30))
    t_rel_diff = float(t_rel[diff].max()) if n_diff else 0.0
    if n_diff > (1 - TRAV_ID_FRAC) * n or t_rel_diff > TRAV_T_RTOL:
        raise AssertionError(f"traversal: {n_diff}/{n} ids differ, t rel err "
                             f"{t_rel_diff:.3e} where they do")
    log(f"phase 2 traversal: {n} rays, jade {sd.n_triangles} tris, "
        f"{float(hk.float().mean()):.3f} hit; ids differ {n_diff}; max t rel err "
        f"{float(t_rel[hk].max()):.3e}; kernel {trav_ms:.3f} ms, plain torch "
        f"{trav_plain_ms:.1f} ms [{gpu}]")

    # ---- phase 3: megakernel vs plain on one whole image -------------------
    cfg3 = RenderConfig(width=96, height=96, spp=4, max_depth=6)
    eye, rot = camera_mod.camera_tensors(ds.camera, dev)
    out_k = megak.mega_render(sd, eye, rot, cfg3, 0, cfg3.spp)
    torch.cuda.synchronize()
    ms3 = cuda_ms(lambda: megak.mega_render(sd, eye, rot, cfg3, 0, cfg3.spp), reps=5)
    t_plain = time.perf_counter()
    out_p = megak.mega_render_plain(sd, eye, rot, cfg3, 0, cfg3.spp)
    torch.cuda.synchronize()
    plain_ms3 = (time.perf_counter() - t_plain) * 1e3
    err3, outside3, mean3 = compare_images(out_k[:3], out_p[:3], "phase 3")
    rays_eq = float((out_k[3] == out_p[3]).float().mean())
    log(f"phase 3 mega vs plain: jade 96x96 4spp depth 6: max abs err {err3:.3e} "
        f"(max {float(out_p[:3].abs().max()):.3e}), {outside3}/{96 * 96} pixels "
        f"outside, mean rel diff {mean3:.3e}, ray counts equal on {rays_eq:.4f}; "
        f"kernel {ms3:.2f} ms, plain torch {plain_ms3:.0f} ms [{gpu}]")

    # ---- phase 4: the main path through the CLI ----------------------------
    with tempfile.TemporaryDirectory() as tmp:
        bmp = os.path.join(tmp, "main.bmp")
        megak.reset_launches()
        film, stats = cli_render.main(["--out", bmp])
        launches = dict(megak.LAUNCHES)
        cfg4 = RenderConfig()
        if launches["mega_render"] < 1:
            raise AssertionError(f"main path did not launch mega_render: {launches}")
        acc = film.accum
        # a few channel sums may be negative: the reference's exit Fresnel
        # R0 - (1-R0)(1-c)^5 goes below 0 at grazing angles (sampling.py);
        # the subset check below holds them against the plain version
        n_neg = int((acc < 0).sum())
        if not (bool(torch.isfinite(acc).all()) and float(acc.mean()) > 0
                and n_neg <= 1e-4 * acc.numel()):
            raise AssertionError(f"main path film: finite {bool(torch.isfinite(acc).all())}, "
                                 f"mean {float(acc.mean())}, {n_neg} negative values")
        size = os.path.getsize(bmp)
        want = 54 + cfg4.height * (cfg4.width * 3 + (-cfg4.width * 3) % 4)
        if size != want or film.accum.shape != (cfg4.height, cfg4.width, 3):
            raise AssertionError(f"main path BMP {size} bytes (want {want}), "
                                 f"film {tuple(film.accum.shape)}")
    secs = stats["seconds"]
    samples = cfg4.width * cfg4.height * cfg4.spp
    log(f"phase 4 main path: jade {MAIN_TRIS} statue tris ({sd.n_triangles} total) "
        f"{cfg4.width}x{cfg4.height} {cfg4.spp}spp depth {cfg4.max_depth}: "
        f"{secs:.3f} s, {samples / secs / 1e6:.3f} Msamples/s, "
        f"{stats['rays'] / secs / 1e6:.3f} useful Mrays/s, launches {launches}, {n_neg} negative channel "
        f"sums, BMP {size} bytes [{gpu}]")

    # the main path's film against the plain version on random pixels
    npix = cfg4.width * cfg4.height
    ids = torch.tensor(np.sort(rng.choice(npix, 4096, replace=False)), device=dev)
    t_plain = time.perf_counter()
    rad_p, _ = render_batch(sd, eye, rot, ids, 0, cfg4, cfg4.spp)
    torch.cuda.synchronize()
    plain_sub_s = time.perf_counter() - t_plain
    rad_k = film.accum.reshape(-1, 3)[ids]
    err4, outside4, mean4 = compare_images(rad_k.T, rad_p.T, "phase 4 subset")
    main_ms = cuda_ms(lambda: megak.mega_render(sd, eye, rot, cfg4, 0, cfg4.spp))
    log(f"phase 4 check: film vs plain torch on {ids.numel()} random pixels: max abs "
        f"err {err4:.3e} (max {float(rad_p.abs().max()):.3e}), {outside4} outside, "
        f"mean rel diff {mean4:.3e} (plain {plain_sub_s:.1f} s); one mega_render "
        f"at the main-path shape {main_ms:.1f} ms [{gpu}]")

    kernels = [{
        "name": "mega_render",
        "route": "cuda",
        "source": "jaderaytracerendering_tpu_torch/csrc/mega.cu",
        "replaces": "jaderaytracerendering_tpu/ops/pallas/mega.py:782",
        "launches": launches["mega_render"],
        "max_abs_err": err3,
        "ms": ms3,
        "plain_ms": plain_ms3,
        "shape": "jade 20k, 96x96, 4 spp, depth 6 (ms, plain_ms, max_abs_err)",
        "main_path_ms": main_ms,
        "main_path_max_abs_err": err4,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
