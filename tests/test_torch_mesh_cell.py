"""The four-rank cell ``jade_offline.mesh_tile4`` on the CPU: the spans
and counters of ``parallel/sharding.py``, the stats' window times, the
benchmark's ``mesh`` client and its readers.

One worker script runs as 4 gloo ranks (each its own process, a
``file://`` rendezvous in the test's temporary directory) over
``demo.tiny_scene()`` at 8x8, 4 spp, depth 2, and renders the meshes
(4, 1) and (2, 2) through the engines scan, pool and mega: one image
without a profiler, then two under one on rank 0. Rank 0 writes its
spans, counters and stats; every rank writes its stats.

The client runs through ``benchmark.run.main(device="cpu")`` in a
subprocess (the run refuses a process in which JAX is loaded, as this
one is) on the benchmark's files cut to 8x8 x 2 spp and a 300-triangle
statue (``benchmark/test_benchmark_harness.tiny_root``), depth 4: its last line
is ``correct``, with the kept films bit for bit the one-device films
(``single_card_off_share`` 0.0). A rank killed during the window ends
the run with a non-zero exit code well inside the group's timeout, and
no rank is left behind.
"""

import json
import os
import pathlib
import signal
import subprocess
import sys
import time
import types

import pytest

from benchmark import cells
from benchmark.clients import mesh as mesh_client
from benchmark.test_benchmark_harness import tiny_root
from jaderaytracerendering_tpu_torch.utils import logging as tlog

REPO = pathlib.Path(__file__).resolve().parent.parent
WORLD = 4
MESHES = [(4, 1), (2, 2)]
ENGINES = ["scan", "pool", "mega"]
PROFILED_IMAGES = 2
SIZE = dict(width=8, height=8, spp=4, spp_batch=2, max_depth=2, traversal="bvh")
CELL = "jade_offline.mesh_tile4"
SEED = 4_294_967_999  # past 32 bits, as the driver's seeds are
TIMEOUT = 300

_WORKER = r"""
import json, sys
import torch
from torch.profiler import ProfilerActivity, profile

torch.set_num_threads(1)
rank, world, init_file, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]

from jaderaytracerendering_tpu_torch.integrator import render
from jaderaytracerendering_tpu_torch.models import demo
from jaderaytracerendering_tpu_torch.parallel import sharding as sh
from jaderaytracerendering_tpu_torch.scene.scene import assemble
from jaderaytracerendering_tpu_torch.utils import logging as tlog
from jaderaytracerendering_tpu_torch.utils.config import RenderConfig

sh.init_distributed(f"file://{init_file}", world, rank, device="cpu")
ds = demo.tiny_scene()
sd = assemble(ds.objects, ds.env_map, bvh_backend="numpy", device="cpu")
cfg = RenderConfig(**json.loads(sys.argv[5]))
images = int(sys.argv[8])
result = {}
for shape in json.loads(sys.argv[6]):
    mesh = sh.make_mesh(shape)
    for engine in json.loads(sys.argv[7]):
        c = cfg.replace(engine=engine)
        key = f"{engine}_{shape[0]}x{shape[1]}"
        tlog.reset()
        plain = {}
        sh.render_film_distributed(sd, ds.camera, c, mesh, stats=plain)
        unprofiled = {"spans": len(tlog.spans()), "counters": dict(tlog.counters())}
        profiled = {}
        if rank == 0:
            with profile(activities=[ProfilerActivity.CPU]):
                tlog.reset()
                for _ in range(images):
                    sh.render_film_distributed(sd, ds.camera, c, mesh, stats=profiled)
                spans = [[s.name, s.parent] for s in tlog.spans()]
                counters = dict(tlog.counters())
        else:
            for _ in range(images):
                sh.render_film_distributed(sd, ds.camera, c, mesh, stats=profiled)
            spans, counters = [], {}
        one = {}
        if rank == 0:
            render.render_film(sd, ds.camera, c, stats=one)
        result[key] = {"stats": plain, "profiled_stats": profiled, "unprofiled": unprofiled,
                       "spans": spans, "counters": counters, "one_device_rays": one.get("rays")}
with open(f"{out}/rank{rank}.json", "w") as f:
    json.dump(result, f)
torch.distributed.destroy_process_group()
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 4 ranks' results -> [{mesh key: result}] in rank order."""
    tmp = tmp_path_factory.mktemp("ranks")
    worker = tmp / "worker.py"
    worker.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    for k in mesh_client._ENV:
        env.pop(k, None)
    args = [json.dumps(SIZE), json.dumps(MESHES), json.dumps(ENGINES), str(PROFILED_IMAGES)]
    procs = [subprocess.Popen([sys.executable, str(worker), str(r), str(WORLD),
                               str(tmp / "rendezvous"), str(tmp)] + args,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=tmp)
             for r in range(WORLD)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, f"rank failed:\n{err[-3000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(WORLD)]


CASES = [f"{e}_{t}x{s}" for t, s in MESHES for e in ENGINES]


@pytest.mark.parametrize("profiled", [True, False], ids=["profiled", "unprofiled"])
@pytest.mark.parametrize("key", CASES)
def test_spans_are_recorded_on_rank_0_under_the_profiler(ranks, key, profiled):
    r0 = ranks[0][key]
    if not profiled:
        assert r0["unprofiled"] == {"spans": 0, "counters": {}}
        return
    names = [n for n, _ in r0["spans"] if n.startswith("parallel.")]
    n_spp = 2 if key.endswith("x2") else 1
    # every engine renders its window once an image (the scan in spp_batch steps)
    assert names.count("parallel.sharding.window") == PROFILED_IMAGES
    # the film's gather, and on a (2, 2) mesh the spp reduction
    reduces = 1 + (n_spp > 1)
    assert names.count("parallel.sharding.all_reduce") == PROFILED_IMAGES * reduces
    assert len(names) == PROFILED_IMAGES * (1 + reduces)
    # the spans sit at the top (no render span opens around them here)
    assert all(parent == -1 for n, parent in r0["spans"] if n.startswith("parallel."))


@pytest.mark.parametrize("key", CASES)
def test_stats_keep_the_rays_and_give_each_rank_its_window(ranks, key):
    r0 = ranks[0][key]
    # the windows partition the film: the mesh's rays are the one-device render's
    assert r0["stats"]["rays"] == r0["one_device_rays"]
    assert r0["profiled_stats"]["rays"] == PROFILED_IMAGES * r0["one_device_rays"]
    win = r0["stats"]["window_ms"]
    assert len(win) == WORLD and all(w > 0 for w in win)
    for r in range(1, WORLD):  # one all_reduce carries every rank's window to every rank
        assert ranks[r][key]["stats"]["window_ms"] == win
        assert ranks[r][key]["stats"]["rays"] == r0["stats"]["rays"]


@pytest.mark.parametrize("key", CASES)
def test_tile_counters_bound_the_slowest_tile(ranks, key):
    c = ranks[0][key]["counters"]
    slowest, total = c["parallel.tile_us_max"], c["parallel.tile_us_sum"]
    assert c["parallel.tile_windows"] == WORLD * PROFILED_IMAGES
    n_tile = int(key.split("_")[1].split("x")[0])  # rank 0 renders rows 0, n_tile, ..
    assert c["parallel.tile_rows"] == PROFILED_IMAGES * len(range(0, SIZE["height"], n_tile))
    assert total / WORLD <= slowest <= total  # the slowest tile is at least the mean
    us = [round(w * 1e3) for w in ranks[0][key]["profiled_stats"]["window_ms"]]
    assert total == pytest.approx(sum(us), abs=WORLD * PROFILED_IMAGES)
    for r in range(1, WORLD):  # only rank 0 counts
        assert ranks[r][key]["counters"] == {}


# ---- the readers ------------------------------------------------------------

def _recorder() -> tlog.Recorder:
    rec = tlog.Recorder()
    rec.spans = [tlog.Span("parallel.sharding.window", 0.0, 0.1),
                 tlog.Span("parallel.sharding.all_reduce", 0.1, 0.15),
                 tlog.Span("parallel.sharding.window", 0.2, 0.3),
                 tlog.Span("parallel.sharding.all_reduce", 0.3, 0.4)]
    # two images of four tiles: 100, 100, 100, 300 us, then 200 x 4
    rec.counters = {"parallel.tile_us_max": 300 + 200, "parallel.tile_us_sum": 600 + 800,
                    "parallel.tile_windows": 8}
    return rec


READINGS = {"allreduce_pct": 100.0 * 0.15 / 0.5,
            "tile_imbalance_pct": 100.0 * (500 * 4 / 1400 - 1.0)}


def _run(trace=True):
    return types.SimpleNamespace(trace=types.SimpleNamespace(window_s=0.5) if trace else None,
                                 window=types.SimpleNamespace(ends=[0.25, 0.5]))


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_mesh_reader_on_a_hand_built_recorder(monkeypatch, metric):
    monkeypatch.setattr(tlog, "RECORDER", _recorder())
    assert cells.reader(metric)(_run()) == pytest.approx(READINGS[metric], rel=1e-12)


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_mesh_reader_reads_nothing_where_nothing_was_recorded(monkeypatch, metric):
    read = cells.reader(metric)
    monkeypatch.setattr(tlog, "RECORDER", tlog.Recorder())
    assert read(_run()) is None  # a program without the spans and counters
    monkeypatch.setattr(tlog, "RECORDER", _recorder())
    assert read(_run(trace=False)) is None  # no device trace
    monkeypatch.delattr(tlog, "spans")  # a program without the recorder
    assert read(_run()) is None


# ---- the client through the benchmark's run ---------------------------------

_RUN = r"""
import pathlib, sys
import torch
torch.set_num_threads(1)
from benchmark import run
sys.exit(run.main(sys.argv[2:], device="cpu", root=pathlib.Path(sys.argv[1])))
"""


@pytest.fixture(scope="module")
def tiny(tmp_path_factory) -> pathlib.Path:
    """The benchmark's files cut to 8x8 x 2 spp, the mesh cell's depth to 4
    (the CPU's plain megakernel runs a bounce as a batch of torch ops, and
    a traced run reads every one of them back)."""
    root = tiny_root(tmp_path_factory.mktemp("tiny"), film=8, spp=2)
    f = root / "benchmark" / "configs" / "jade_offline_mesh4.json"
    c = json.loads(f.read_text())
    c["render"]["max_depth"] = 4
    f.write_text(json.dumps(c))
    return root


def _start_run(root, seconds: float, trace: int = 0) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    for k in mesh_client._ENV:
        env.pop(k, None)
    argv = ["--workload", CELL, "--seed", str(SEED), "--seconds", str(seconds),
            "--trace", str(trace)]
    return subprocess.Popen([sys.executable, "-c", _RUN, str(root)] + argv, cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


@pytest.mark.parametrize("trace", [0, 1])
def test_mesh_client_runs_correct_and_bit_equal_to_one_device(tiny, trace):
    p = _start_run(tiny, 0.3, trace)
    try:
        out, _ = p.communicate(timeout=TIMEOUT)
    finally:
        p.kill()
    assert p.returncode == 0, out[-3000:]
    lines = out.strip().splitlines()
    res = json.loads(lines[-1])
    assert res["correct"] is True and res["attempted"] >= 1, res["checks"]
    assert res["checks"]["single_card_off_share"] == {"value": 0.0, "limit": 0.0}
    assert set(res["checks"]) == {"pixel_off_share", "u8_off_share", "single_card_off_share"}
    assert res["device"]["count"] == WORLD
    assert any(line.startswith("mesh: 4 ranks over gloo") for line in lines)
    win = next(json.loads(line.split(" ", 2)[2]) for line in lines
               if line.startswith("counter window_ms "))
    assert len(win) == res["attempted"] and all(len(w) == WORLD for w in win)
    if trace:  # the CPU has no device trace: the host-clock metric alone
        assert set(res["metrics"]) == {"scene_build_s"}
    else:
        assert set(res["metrics"]) == {"render_msamples_s", "setup_s"}


def _alive(pid: int) -> bool:
    """The process runs (a zombie that waits to be reaped does not)."""
    try:
        stat = pathlib.Path(f"/proc/{pid}/stat").read_text()
    except FileNotFoundError:
        return False
    return stat.rsplit(")", 1)[1].split()[0] != "Z"


def test_a_rank_that_dies_in_the_window_ends_the_run(tiny):
    p = _start_run(tiny, 600)
    try:
        pids = None
        for line in p.stdout:
            if line.startswith("mesh: ranks 1-3 pids "):
                pids = json.loads(line.split("pids ", 1)[1])
            if line.startswith("setup_s phases"):  # the window opens next
                break
        assert pids and len(pids) == WORLD - 1
        os.kill(pids[1], signal.SIGKILL)
        t0 = time.perf_counter()
        out, _ = p.communicate(timeout=mesh_client.GROUP_TIMEOUT_S)
        took = time.perf_counter() - t0
    finally:
        p.kill()
    assert p.returncode != 0, out[-3000:]
    assert took < 30, out[-3000:]  # the watcher, not the group's timeout
    assert "mesh-rank2 ended with exit code -9 during the run" in out
    deadline = time.perf_counter() + 10
    while any(_alive(pid) for pid in pids) and time.perf_counter() < deadline:
        time.sleep(0.1)
    assert not any(_alive(pid) for pid in pids)
