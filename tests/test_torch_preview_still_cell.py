"""The cell ``jade_preview.still`` on the CPU: the ``preview_still``
client's window (one film at the configuration's camera, no camera
command, the band counter never restarted), its warm-up, and the client
through ``benchmark.run``.

The run goes through ``benchmark.run.main(device="cpu")`` in a
subprocess (the run refuses a process in which JAX is loaded, as this
one is) on the benchmark's files cut by
``benchmark/test_benchmark_harness.tiny_root`` (8^2 films, a
300-triangle statue, 32 compared pixels), ``first_frames`` cut to 2.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from benchmark import cells, program
from benchmark import scene as bscene
from benchmark.clients import preview_still
from benchmark.run import Context
from benchmark.test_benchmark_harness import tiny_root

REPO = pathlib.Path(__file__).resolve().parent.parent
CELL = "jade_preview.still"
SEED = 4_294_967_999  # past 32 bits, as a run's --seed may be
TIMEOUT = 300
FIRST_FRAMES = 2


@pytest.fixture(scope="module")
def tiny(tmp_path_factory) -> pathlib.Path:
    """The benchmark's files cut to 8^2 films, ``first_frames`` to 2."""
    root = tiny_root(tmp_path_factory.mktemp("tiny"), film=8, spp=1)
    f = root / "benchmark" / "traffic" / "still_1spp.json"
    t = json.loads(f.read_text())
    t["first_frames"] = FIRST_FRAMES
    f.write_text(json.dumps(t))
    return root


_RUN = r"""
import pathlib, sys
from benchmark import run
sys.exit(run.main(sys.argv[2:], device="cpu", root=pathlib.Path(sys.argv[1])))
"""


@pytest.mark.parametrize("trace", [0, 1])
def test_still_client_runs_correct(tiny, trace):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    argv = ["--workload", CELL, "--seed", str(SEED), "--seconds", "0.5", "--trace", str(trace)]
    p = subprocess.run([sys.executable, "-c", _RUN, str(tiny)] + argv, cwd=REPO, env=env,
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                       timeout=TIMEOUT)
    assert p.returncode == 0, p.stdout[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["attempted"] > FIRST_FRAMES, res
    assert set(res["checks"]) == {"pixel_off_share", "u8_off_share"}
    if trace:  # the CPU has no device trace: the host-clock metric alone
        assert set(res["metrics"]) == {"scene_build_s"}
    else:
        assert set(res["metrics"]) == {"preview_frame_p95_ms", "setup_s"}


@pytest.fixture
def client(tiny, monkeypatch):
    """The cell's client on the CPU at the tiny sizes, its films and
    frames recorded: (client, films made, frames as (camera eye, camera
    rotation, film sums' address, frame_idx))."""
    cell = cells.load(CELL, tiny)
    ctx = Context(cell=cell, device=torch.device("cpu"), raw=bscene.make(cell.config["scene"]))
    ctx.sd = program.build_scene(ctx.raw, ctx.device)
    films, frames = [], []
    create = program.Film.create
    render = program.render.render_film_preview

    def film_create(*a, **kw):
        films.append(create(*a, **kw))
        return films[-1]

    def preview(sd, cam, cfg, film=None, display=False, frame_idx=None):
        frames.append((tuple(cam.eye), tuple(map(tuple, cam.camera_rotate)),
                       film.accum.data_ptr(), frame_idx))
        return render(sd, cam, cfg, film, display, frame_idx)

    monkeypatch.setattr(program.Film, "create", staticmethod(film_create))
    monkeypatch.setattr(program.render, "render_film_preview", preview)
    return preview_still.Client(ctx), films, frames


def test_the_window_keeps_one_film_and_one_camera(client):
    c, films, frames = client
    win = c.window(0.5, SEED)
    assert len(films) == 1  # the film is made once in the window
    n = win.attempted
    assert n == len(frames) > FIRST_FRAMES
    assert len({f[:2] for f in frames}) == 1  # the camera never moves
    assert {f[2] for f in frames} == {films[0].accum.data_ptr()}
    assert [f[3] for f in frames] == list(range(n))  # the band counter never restarts
    first, last = win.kept["first"], win.kept["last"]
    assert 0 <= first[0] < FIRST_FRAMES and last[0] == last[1] == n - 1
    cam = c.ctx.config["camera"]
    assert first[2:4] == last[2:4] == (cam["up_deg"], cam["rotate_deg"])


def test_the_warm_up_renders_first_frames_and_two_band_rotations(client):
    c, films, frames = client
    c.warm_up()
    assert len(films) == 1
    assert [f[3] for f in frames] == list(range(FIRST_FRAMES + 2 * c.bands))
