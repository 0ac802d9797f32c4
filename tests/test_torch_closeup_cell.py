"""The cell ``jade_offline.closeup`` on the CPU: its framing (the
configuration's look-center), the port's megakernel path at that framing
against the benchmark's plain reference, the ``offline_framed`` client
through ``benchmark.run``, the megakernel's bounce counters on the plain
path, and the ``mega_bounce_ns`` reader.

The run goes through ``benchmark.run.main(device="cpu")`` in a
subprocess (the run refuses a process in which JAX is loaded, as this
one is) on the benchmark's files cut by
``benchmark/test_benchmark_harness.tiny_root`` (8^2 x 2 spp, a
300-triangle statue), the close-up's depth cut to 3, a window of one image.
"""

import json
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import cells, check, program
from benchmark import scene as bscene
from benchmark.reference import camera as ref_camera, pathtrace
from benchmark.reference import scene as rscene
from benchmark.test_benchmark_harness import tiny_root
from jaderaytracerendering_tpu_torch.core import camera as camera_mod
from jaderaytracerendering_tpu_torch.models import demo
from jaderaytracerendering_tpu_torch.ops import mega as megak
from jaderaytracerendering_tpu_torch.scene.scene import assemble
from jaderaytracerendering_tpu_torch.utils import logging as tlog
from jaderaytracerendering_tpu_torch.utils.config import RenderConfig

REPO = pathlib.Path(__file__).resolve().parent.parent
CELL = "jade_offline.closeup"
CONFIG = json.loads((REPO / "benchmark" / "configs" / "jade_offline_closeup.json").read_text())
SEED = 4_294_967_999  # past 32 bits, as a run's --seed may be
TIMEOUT = 300


def _cameras():
    """(the program's OrbitCamera, the reference's (eye, camera_rotate)) of
    the configuration's framing."""
    c = CONFIG["camera"]
    cam = camera_mod.OrbitCamera(up_angle=c["up_deg"], rotate_angle=c["rotate_deg"], r=c["r"],
                                 eye_center=np.asarray(c["center"], np.float64))
    eye = ref_camera.eye(c["up_deg"], c["rotate_deg"], c["r"])
    rot = ref_camera.camera_rotate(eye, c["center"])
    return cam, (eye.astype(np.float32), rot.astype(np.float32))


@pytest.fixture(scope="module")
def small():
    """The configuration's scene with a 3,000-triangle statue and a 16 x 32
    sky -> (raw scene, the reference's tables, the program's scene)."""
    raw = bscene.make(dict(CONFIG["scene"], statue_tris=3000, env_shape=[16, 32]))
    return raw, rscene.build(raw, "cpu"), program.build_scene(raw, torch.device("cpu"))


def test_the_program_camera_is_the_references():
    cam, (eye, rot) = _cameras()
    np.testing.assert_allclose(cam.eye, eye, rtol=0, atol=1e-6)
    np.testing.assert_allclose(cam.camera_rotate, rot, rtol=0, atol=1e-6)


def test_the_framing_has_the_whole_statue_in_front_and_on_half_the_rays(small):
    raw, t, _ = small
    _, cam = _cameras()
    eye, rot = (np.asarray(a, np.float64) for a in cam)
    z = (raw.vertices("statue") - eye) @ rot[2, :3]
    assert (z < 0).all()  # every vertex in front of the eye
    assert len(check.object_pixels(raw.vertices("statue"), cam, 64, 64))
    hit = check.object_hit_pixels(raw, "statue", cam, 64, 64, t)
    assert len(hit) / (64 * 64) >= 0.5


def test_render_film_mega_matches_the_reference_at_the_closeup(small):
    """The port's main path (engine mega, its plain version on the CPU) at
    the framed camera, 16^2 x 8 spp at depth 8, against the reference
    under the light order the program agrees with: every pixel's sums
    within ``check.RTOL``."""
    raw, t, sd = small
    cam, ref_cam = _cameras()
    w, spp, seed = 16, 8, 2 ** 31 + 5
    s = dict(CONFIG["render"], width=w, height=w, max_depth=8)
    cfg = program.render_config(dict(s, spp=spp, engine="mega", seed=seed))
    film = program.render.render_film(sd, cam, cfg).accum.reshape(-1, 3).numpy()
    rcfg = {k: s[k] for k in ("width", "height", "max_depth", "rr_rate", "sss_rate",
                              "hdr_clamp", "max_refract_bounces", "internal_reflect_rate")}
    offs = {}
    for order in pathtrace.light_orders(t):
        ref = pathtrace.render_pixels(t, rcfg, ref_cam, torch.arange(w * w), spp, seed, order)
        offs[order] = check.pixel_off_share(film, ref.numpy())
    assert min(offs.values()) == 0.0, offs
    assert max(offs.values()) > 0.5  # the light order matters on the statue


@pytest.fixture(scope="module")
def tiny(tmp_path_factory) -> pathlib.Path:
    """The benchmark's files cut to 8^2 x 2 spp, the close-up's depth to 3
    (a traced run records every torch op of the plain megakernel)."""
    root = tiny_root(tmp_path_factory.mktemp("tiny"), film=8, spp=2)
    f = root / "benchmark" / "configs" / "jade_offline_closeup.json"
    c = json.loads(f.read_text())
    c["render"]["max_depth"] = 3
    f.write_text(json.dumps(c))
    return root


_RUN = r"""
import pathlib, sys
from benchmark import run
sys.exit(run.main(sys.argv[2:], device="cpu", root=pathlib.Path(sys.argv[1])))
"""


@pytest.mark.parametrize("trace", [0, 1])
def test_closeup_client_runs_correct_with_focus_pixels(tiny, trace):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    argv = ["--workload", CELL, "--seed", str(SEED), "--seconds", "0.01", "--trace", str(trace)]
    p = subprocess.run([sys.executable, "-c", _RUN, str(tiny)] + argv, cwd=REPO, env=env,
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                       timeout=TIMEOUT)
    assert p.returncode == 0, p.stdout[-3000:]
    lines = p.stdout.strip().splitlines()
    res = json.loads(lines[-1])
    assert res["correct"] is True and res["attempted"] >= 1, res["checks"]
    assert set(res["checks"]) == {"pixel_off_share", "u8_off_share"}
    # the light order is chosen on pilot pixels, which are drawn among the focus
    assert any(line.startswith("light order ") for line in lines)
    counters = {ln.split(" ", 2)[1]: json.loads(ln.split(" ", 2)[2]) for ln in lines
                if ln.startswith("counter ")}
    if trace:  # the CPU has no device trace: the host-clock metric alone
        assert set(res["metrics"]) == {"scene_build_s"}
        assert 0 < counters["sss_share_pct"] < 100
        assert 0 < counters["bounces_per_sample"] <= 3
    else:
        assert set(res["metrics"]) == {"render_msamples_s", "setup_s"}
        assert "sss_share_pct" not in counters


def _plain_counts(sd, cam, cfg) -> tuple:
    """``mega_render_plain`` of the whole film under the recorder -> (its
    counters, the useful rays)."""
    eye, rot = camera_mod.camera_tensors(cam, "cpu")
    tlog.reset()
    out = megak.mega_render_plain(sd, eye, rot, cfg, 0, cfg.spp)
    assert tlog.counters() == {}  # no profiler: nothing counted
    with profile(activities=[ProfilerActivity.CPU]):
        tlog.reset()
        out = megak.mega_render_plain(sd, eye, rot, cfg, 0, cfg.spp)
        got = dict(tlog.counters())
    tlog.reset()
    return got, float(out[3].sum())


@pytest.mark.parametrize("scene", ["closeup", "tiny"])
def test_plain_megakernel_counts_its_bounces(small, scene):
    """``ops.mega.bounces``: every bounce a path entered, at most depth x
    samples, and the useful rays' count (the primary, then E + 2 a
    bounce); ``ops.mega.sss_bounces``: those that took SSS entry or exit,
    some at the close-up, none in the tiny scene (no SSS material)."""
    cfg = RenderConfig(width=16, height=16, spp=2, max_depth=6)
    if scene == "closeup":
        _, _, sd = small
        cam = _cameras()[0]
    else:
        ds = demo.tiny_scene()
        sd, cam = assemble(ds.objects, ds.env_map, device="cpu"), ds.camera
    got, rays = _plain_counts(sd, cam, cfg)
    samples = cfg.width * cfg.height * cfg.spp
    b, s = got["ops.mega.bounces"], got["ops.mega.sss_bounces"]
    assert 0 < b <= cfg.max_depth * samples
    assert b * (sd.n_emit + 2) == rays - samples
    if scene == "closeup":
        assert 0 < s < b
    else:
        assert s == 0


def _run_with(counters, trace=True):
    tlog.reset()
    for k, v in counters.items():
        tlog.RECORDER.count(k, v)
    return types.SimpleNamespace(trace=object() if trace else None)


@pytest.mark.parametrize("counters,trace,want", [
    ({"ops.mega.launch_us": 2_000, "ops.mega.bounces": 4_000_000}, True, 0.5),
    ({"ops.mega.launch_us": 2_000, "ops.mega.bounces": 4_000_000}, False, None),
    ({"ops.mega.launch_us": 2_000, "ops.mega.tail_us": 10}, True, None),
    ({"ops.mega.launch_us": 2_000, "ops.mega.bounces": 0}, True, None),
    ({"ops.mega.bounces": 10}, True, None),
], ids=["counted", "untraced", "no-bounce-counter", "no-bounces", "no-launch-time"])
def test_mega_bounce_ns_reader(counters, trace, want):
    read = cells.reader("mega_bounce_ns.closeup")
    try:
        got = read(_run_with(counters, trace))
    finally:
        tlog.reset()
    assert got == (None if want is None else pytest.approx(want))
