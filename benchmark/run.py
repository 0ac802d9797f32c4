"""The benchmark of ``jaderaytracerendering_tpu_torch``: one cell, one run.

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout. The run builds the cell's scene, warms the
cell's client up (every shape it will use), measures for ``--seconds``
(with ``--trace 1`` under torch.profiler, for at most the traffic's
``trace_seconds``), compares the outputs it kept with the plain
reference's, and prints one JSON line last on standard output: the
cell's end-to-end metrics (``--trace 0``) or per-layer metrics
(``--trace 1``), ``correct``, the device, and last the compared numbers
with their limits (``checks``), which also close standard error. It
exits with 2, printing no result, without as many CUDA devices as the
cell asks for, and with 3 if JAX or the JAX package is loaded once the
window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # noqa: E402  (set-up is counted from here)

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

# modules that may not be loaded in a run, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "jaderaytracerendering_tpu")
MAX_ITEMS_LISTED = 2000  # items whose every ms an earlier line lists


@dataclasses.dataclass
class Context:
    """What a client works on: the cell, the device, the raw scene and the
    program's scene built from it."""

    cell: object
    device: object
    raw: object
    sd: object = None
    ref_tables: dict = dataclasses.field(default_factory=dict)

    def tables(self, dtype):
        """The plain reference's tables of the raw scene in ``dtype``,
        built once."""
        if dtype not in self.ref_tables:
            from .reference import scene as ref_scene

            self.ref_tables[dtype] = ref_scene.build(self.raw, self.device, dtype)
        return self.ref_tables[dtype]

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    @property
    def settings(self) -> dict:
        return self.cell.settings


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""

    cell: object
    window: object      # clients.Window
    trace: object       # profiling.Trace, or None
    setup_s: float
    scene_build_s: float


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, device: str = "cuda", root=None, t_start: float = T_START) -> int:
    """One run; returns the exit code. ``device="cpu"`` (the tests) skips
    the look for a card and runs the program's plain versions."""
    args = parse(sys.argv[1:] if argv is None else argv)
    from . import cells, check, profiling, scene

    cell = cells.load(args.workload, root)
    import torch

    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell.chips):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this machine has {n}",
              file=sys.stderr)
        return 2
    from . import program

    dev = torch.device(device)
    phases = {"imports": time.perf_counter() - t_start}
    t0 = time.perf_counter()
    raw = scene.make(cell.config["scene"])
    phases["scene_make"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    program.load_libraries(dev)
    phases["libraries"] = time.perf_counter() - t0
    ctx = Context(cell=cell, device=dev, raw=raw)
    t0 = time.perf_counter()
    with torch.profiler.record_function("benchmark.scene_build"):
        ctx.sd = program.build_scene(ctx.raw, dev)
        _sync(dev)
    scene_build_s = phases["scene_build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    client = cells.client(cell)(ctx)
    client.warm_up()
    _sync(dev)
    phases["warm_up"] = time.perf_counter() - t0
    setup_s = time.perf_counter() - t_start
    print(f"setup_s phases {json.dumps(phases)}", flush=True)

    seconds = args.seconds
    if args.trace:
        seconds = min(seconds, float(cell.traffic["trace_seconds"]))
    with profiling.profiled(bool(args.trace)) as prof:
        win = client.window(seconds, args.seed)
        _sync(dev)
    trace = profiling.read(prof) if prof is not None else None
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    _report_window(cell, win, trace, setup_s, scene_build_s)

    t_check = time.perf_counter()
    client.keep(win, args.seed)
    ctx.sd = None  # the program's state is freed before the reference runs
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = client.compare(win.kept["outputs"], client.reference(win, args.seed))
    print(f"comparison with the reference took {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr)
    correct, checks = check.verdict(numbers, cell.traffic["check"]["limits"])

    run = Run(cell=cell, window=win, trace=trace, setup_s=setup_s, scene_build_s=scene_build_s)
    wanted = cell.per_layer if args.trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = cells.reader(m["name"], cell.root)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    found = forbidden_modules()
    if found:
        print(f"loaded in this run: {', '.join(found)} (JAX or the JAX package)",
              file=sys.stderr)
        return 3
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind,
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": win.attempted,
              "failed": 0 if correct else len(win.kept["outputs"]),
              "metrics": metrics, "device": device_info}
    if trace is not None:
        device_info.update(busy_s=trace.busy_s, window_s=trace.window_s)
        result["breakdown"] = {"device_ops": trace.top_kernels(), "idle_gaps": trace.top_gaps()}
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def _report_window(cell, win, trace, setup_s, scene_build_s) -> None:
    """The earlier lines: every item's ms and the program's counters."""
    import numpy as np

    ms = [(e - s) * 1e3 for s, e in zip(win.starts, win.ends)]
    print(f"{cell.name}: setup {setup_s:.4f} s (scene build {scene_build_s:.4f} s); "
          f"{len(ms)} items in {win.seconds:.4f} s", flush=True)
    if len(ms) <= MAX_ITEMS_LISTED:
        print(f"item_ms {json.dumps(ms)}", flush=True)
    else:  # a preview window's tens of thousands of frames
        q = np.percentile(ms, [0, 5, 25, 50, 75, 95, 99, 100])
        print(f"item_ms percentiles 0,5,25,50,75,95,99,100: {json.dumps(q.tolist())}",
              flush=True)
    for k, v in win.counters.items():
        print(f"counter {k} {json.dumps(v)}", flush=True)
    if trace is not None:
        print(f"trace window {trace.window_s:.6f} s busy {trace.busy_s:.6f} s kernels "
              f"{trace.kernel_s:.6f} s copies {trace.copies_s:.6f} s", flush=True)


if __name__ == "__main__":
    sys.exit(main())
