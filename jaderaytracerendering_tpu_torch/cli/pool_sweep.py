"""Measure the pool engine at the main path on the card: its render time
at several pool sizes beside the megakernel's, and one traced render of
each configuration for the device's busy and idle share, the time per
kernel and, per kernel wrapper of ops/, its device time and launches;
optionally the megakernel itself from other builds.

    python -m jaderaytracerendering_tpu_torch.cli.pool_sweep \
        [--lanes 18 19 20 21 22 23] [--reps 3] [--out sweep.json] \
        [--mega-builds OTHER/csrc ...] [--mega-reps 10] [--preview FRAMES]

The main path is the render CLI's defaults (jade, 20,000 statue triangles,
1024x1024, 16 spp, depth 16). Render time is host time around
``render_film`` ending in a synchronize (scene build excluded), taken in
turns: mega, then the pool sizes up and back down, ``--reps`` rounds.

``--mega-builds`` builds the ``mega.cu`` (with the ``.cuh`` beside it) of
each other source directory given, e.g. an older checkout's ``csrc``;
each needs this tree's C interface (``mega_chunk()`` and the ten-argument
``mega_render`` of the megakernel's work items; a build without them is
refused as it loads, and an older kernel is timed by its own tree's
``pool_sweep``). Each build's ``mega_render`` is
timed with CUDA events, one launch each in turns with this tree's, and
must give this tree's output bit for bit; its ptxas registers, stack and
spills are printed. ``--preview`` times the preview kernel at the preview
main path's banded frames (each quarter of the film, 1 spp, 2 bounces) by
profiler device time, with its ptxas figures. Prints one line per
configuration and, last, one JSON object. Needs a CUDA device; it does not
fall back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import time

from . import common


def _render_s(render, sd, cam, cfg, stats=None) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    render(sd, cam, cfg, stats=stats)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


# each wrapper of ops/ and the device kernel it launches (a substring of
# its name in a profiler trace)
WRAPPER_KERNELS = {"mega_render": "mega_render_kernel",
                   "spawn_primary": "spawn_primary_kernel",
                   "trace_segments": "trace_segments_kernel",
                   "front_bounce": "front_bounce_kernel",
                   "resolve_bounce": "resolve_bounce_kernel"}


def trace_render(render, sd, cam, cfg) -> dict:
    """One render under torch.profiler -> wall ms, device-busy ms, idle
    share, device ms by kernel (the eight largest), and by wrapper
    (``WRAPPER_KERNELS``): its device ms and its kernels' launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = _render_s(render, sd, cam, cfg)
    kernels, launches = {}, {}
    for e in prof.key_averages():
        # the host's profiler ranges (the program's spans) come back as
        # device-side annotations too: they are no device work
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                not getattr(e, "is_user_annotation", False):
            kernels[e.key] = kernels.get(e.key, 0.0) + e.self_device_time_total / 1e3
            launches[e.key] = launches.get(e.key, 0) + e.count
    busy = sum(kernels.values())
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:8])
    by_wrapper = {}
    for name, sub in WRAPPER_KERNELS.items():
        keys = [k for k in kernels if sub in k]
        if keys:
            by_wrapper[name] = dict(device_ms=sum(kernels[k] for k in keys),
                                    launches=sum(launches[k] for k in keys))
    return dict(wall_ms=wall * 1e3, busy_ms=busy, idle_share=1.0 - busy / (wall * 1e3),
                kernels_ms=top, wrappers=by_wrapper)


def _ptxas(log_path, kernel: str = "mega_render_kernel") -> dict:
    """Registers, stack frame and spill bytes of ``kernel`` in a build's
    ptxas log (its instance without direct refraction)."""
    lines = log_path.read_text().splitlines()
    out = {}
    for i, line in enumerate(lines):
        if "Compiling entry" in line and kernel in line and "ILb1E" not in line:
            for nxt in lines[i + 1:i + 6]:
                if "stack frame" in nxt:
                    nums = [int(w) for w in nxt.replace(",", " ").split() if w.isdigit()]
                    out.update(stack=nums[0], spill_stores=nums[1], spill_loads=nums[2])
                if "Used" in nxt:
                    out["registers"] = int(nxt.split("Used")[1].split("registers")[0])
                    return out
    return out


def _mega_ab(sd, cam, cfg, dirs, reps, card) -> list:
    """``mega_render`` at the main path from this tree's library and the
    other builds, one launch each in turns -> rows (ms, ptxas figures)."""
    import pathlib

    import torch

    from ..integrator import mega as mega_mod
    from ..ops import build, kernels
    from ..ops import mega as megak

    eye, rot = mega_mod.host_camera(cam)
    builds = {"this": (kernels.library(),
                       build.library_path("kernels", kernels.SOURCES))}
    for k, d in enumerate(dirs):
        src_dir = pathlib.Path(d).resolve()
        lib = build.load_library(f"mega-other{k}", ["mega.cu"], src_dir)
        try:
            kernels.bind(lib, ("mega_render", "mega_chunk"))
        except AttributeError as e:
            raise SystemExit(f"--mega-builds {d}: {e}. A build must have this tree's C "
                             "interface: mega_chunk() and mega_render(s, r, pix0, n_px, out, "
                             "ld, part, next_item, stamps, stream)") from None
        builds[d] = (lib, build.library_path(f"mega-other{k}", ["mega.cu"], src_dir))

    def launch(lib):
        return megak.mega_render(sd, eye, rot, cfg, 0, cfg.spp, lib=lib)

    ref = launch(builds["this"][0])
    for name, (lib, _) in builds.items():
        if not torch.equal(launch(lib), ref):
            raise AssertionError(f"mega build {name!r} differs from this tree's output")
    names = list(builds)
    order = names + names[::-1]
    times = {n: [] for n in names}
    for _ in range(reps):
        for n in order:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            launch(builds[n][0])
            end.record()
            torch.cuda.synchronize()
            times[n].append(start.elapsed_time(end))
    rows = []
    for n in names:
        ts = sorted(times[n])
        row = dict(build=n, **_ptxas(builds[n][1].with_suffix(".log")),
                   median_ms=ts[len(ts) // 2], min_ms=ts[0], max_ms=ts[-1], runs=len(ts))
        rows.append(row)
        print(f"mega_render {n}: ptxas {_ptxas(builds[n][1].with_suffix('.log'))}, median "
              f"{row['median_ms']:.3f} ms ({row['min_ms']:.3f}-{row['max_ms']:.3f}, "
              f"{row['runs']} launches), output equal to this tree's [{card}]", flush=True)
    return rows


def _preview_frames(sd, cam, frames, card) -> dict:
    """The preview main path's banded frames (``cli.preview``'s defaults: a
    quarter of the 1024x1024 film, 1 spp, 2 bounces): the preview kernel's
    device ms per launch in each of the four bands, over ``frames``
    launches each under torch.profiler (averaged over the launches the
    trace holds: it can lose some), their mean (a rotation's frame), and
    its ptxas figures. The camera is passed on the host, as the preview
    path passes it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..integrator import mega as mega_mod
    from ..ops import build, kernels
    from ..ops import mega as megak
    from ..utils.config import RenderConfig

    pcfg = RenderConfig(integrator="preview", spp=1)
    eye, rot = mega_mod.host_camera(cam)
    n_px = pcfg.width * pcfg.height // 4
    band = torch.zeros((n_px, 3), device=sd.device)
    band_ms = []
    for p0 in range(0, 4 * n_px, n_px):
        megak.render_preview_mega(sd, eye, rot, pcfg, 0, 1, band, p0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for f in range(frames):
                megak.render_preview_mega(sd, eye, rot, pcfg, f + 1, 1, band, p0)
            torch.cuda.synchronize()
        seen = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)
                and "preview_render_kernel" in e.key]
        if not seen:
            raise RuntimeError("pool_sweep: the trace holds no preview kernel launch")
        band_ms.append(sum(e.self_device_time_total for e in seen)
                       / sum(e.count for e in seen) / 1e3)
    out = dict(frames=frames, band_px=n_px, band_ms=band_ms, device_ms=sum(band_ms) / 4,
               **_ptxas(build.library_path("kernels", kernels.SOURCES).with_suffix(".log"),
                        "preview_render_kernel"))
    print(f"preview: {out['device_ms']:.4f} ms device time per banded frame, the mean of the "
          f"bands' " + " ".join(f"{ms:.4f}" for ms in band_ms) + f" ({n_px} pixels, {frames} "
          f"frames each), ptxas {out} [{card}]", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="jade-pool-sweep")
    ap.add_argument("--lanes", type=int, nargs="+", default=[18, 19, 20, 21, 22, 23],
                    help="pool sizes as powers of two")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--mega-builds", nargs="*", default=[],
                    help="source directories whose mega.cu is timed against this tree's")
    ap.add_argument("--mega-reps", type=int, default=10)
    ap.add_argument("--preview", type=int, default=0, metavar="FRAMES",
                    help="also time the preview kernel over this many banded frames")
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("pool_sweep: no CUDA device")
    from ..integrator import pool, render
    from ..models import demo
    from ..scene.scene import assemble
    from ..utils.config import RenderConfig

    card = common.card()
    ds = demo.jade_scene(n_buddha_tris=20_000)
    sd = assemble(ds.objects, ds.env_map, device="cuda")
    cfg = RenderConfig()
    samples = cfg.width * cfg.height * cfg.spp

    def engine(lanes):
        if lanes is None:
            return lambda s, c, f, stats=None: render.render_film(s, c, f, stats=stats)
        return lambda s, c, f, stats=None: pool.render_film_pool(
            s, c, f.replace(engine="pool"), stats=stats, pool_m=1 << lanes)

    names = [None] + list(args.lanes)
    order = names + names[::-1][:-1]
    for n in names:  # warm up: the build and the first allocations
        _render_s(engine(n), sd, ds.camera, cfg)
    times = {n: [] for n in names}
    info = {}
    for _ in range(args.reps):
        for n in order:
            stats = {}
            torch.cuda.reset_peak_memory_stats()
            times[n].append(_render_s(engine(n), sd, ds.camera, cfg, stats))
            info[n] = dict(rays=stats["rays"], iterations=stats.get("iterations", 1),
                           peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20)
    rows = []
    for n in names:
        ts = sorted(times[n])
        med = ts[len(ts) // 2]
        row = dict(engine="mega" if n is None else "pool",
                   lanes=None if n is None else 1 << n, median_ms=med * 1e3,
                   min_ms=ts[0] * 1e3, max_ms=ts[-1] * 1e3, runs=len(ts),
                   msamples_s=samples / med / 1e6,
                   useful_mrays_s=info[n]["rays"] / med / 1e6, **info[n])
        rows.append(row)
        print(f"{row['engine']} lanes {row['lanes']}: median {row['median_ms']:.3f} ms "
              f"({row['min_ms']:.3f}-{row['max_ms']:.3f}, {row['runs']} runs), "
              f"{row['msamples_s']:.1f} Msamples/s, {row['useful_mrays_s']:.1f} useful "
              f"Mrays/s, {row['iterations']} iterations, peak {row['peak_mib']:.0f} MiB "
              f"[{card}]", flush=True)
    traces = {"mega" if n is None else f"pool 2^{n}": trace_render(engine(n), sd, ds.camera, cfg)
              for n in names}
    for k, v in traces.items():
        print(f"trace {k}: wall {v['wall_ms']:.3f} ms, device busy {v['busy_ms']:.3f} ms, "
              f"idle {100 * v['idle_share']:.1f}%; " + ", ".join(
                  f"{name} {w['device_ms']:.3f} ms in {w['launches']} launches"
                  for name, w in v["wrappers"].items())
              + "; " + ", ".join(f"{name[:40]} {ms:.3f}" for name, ms in v["kernels_ms"].items())
              + f" [{card}]", flush=True)
    mega_ab = (_mega_ab(sd, ds.camera, cfg, args.mega_builds, args.mega_reps, card)
               if args.mega_builds else [])
    preview = _preview_frames(sd, ds.camera, args.preview, card) if args.preview else None
    out = dict(card=card, torch=torch.__version__, samples=samples, rows=rows,
               traces=traces, pool_lanes=pool.POOL_LANES, mega_ab=mega_ab, preview=preview)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
