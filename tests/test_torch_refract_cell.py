"""The cell ``jade_offline.refract`` on the CPU: the ``offline_material``
client's material override (the program's scene and the reference's
tables), the port's megakernel path on a DIR_REFRACT statue at the
close-up framing against the benchmark's plain reference, the client
through ``benchmark.run``, the megakernel's march counters on the plain
path, and the ``mega_step_ns`` reader.

The run goes through ``benchmark.run.main(device="cpu")`` in a
subprocess (the run refuses a process in which JAX is loaded, as this
one is) on the benchmark's files cut by
``benchmark/test_benchmark_harness.tiny_root`` (8^2 x 2 spp, a
300-triangle statue), the depth cut to 3 and the march to 2 traces (a
traced run records every torch op of the plain megakernel, and the plain
march steps all lanes while any is inside), a window of one image.
"""

import copy
import dataclasses
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
from benchmark.clients import offline_material
from benchmark.reference import camera as ref_camera, pathtrace
from benchmark.run import Context
from benchmark.test_benchmark_harness import tiny_root
from jaderaytracerendering_tpu_torch.core import camera as camera_mod
from jaderaytracerendering_tpu_torch.ops import mega as megak
from jaderaytracerendering_tpu_torch.utils import logging as tlog
from jaderaytracerendering_tpu_torch.utils.config import RenderConfig

REPO = pathlib.Path(__file__).resolve().parent.parent
CELL = "jade_offline.refract"
CONFIG = json.loads((REPO / "benchmark" / "configs" / "jade_offline_refract.json").read_text())
CLOSEUP = json.loads((REPO / "benchmark" / "configs" / "jade_offline_closeup.json").read_text())
SEED = 4_294_967_999  # past 32 bits, as a run's --seed may be
TIMEOUT = 300


def test_the_configuration_is_the_closeup_but_for_the_statue_material():
    assert {k: v for k, v in CONFIG.items() if k != "materials"}.keys() == CLOSEUP.keys()
    for k in ("scene", "camera", "render", "precision", "reduced", "statue_share"):
        assert CONFIG[k] == CLOSEUP[k], k
    assert CONFIG["reduced"] == []
    assert CONFIG["materials"] == {"statue": {"refract_mode": bscene.DIR_REFRACT}}
    assert set(CONFIG["assumed"]) == set(CLOSEUP["assumed"]) | {"material"}


def _small_raw():
    return bscene.make(dict(CONFIG["scene"], statue_tris=3000, env_shape=[16, 32]))


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
    sky, its materials applied by the client -> (raw scene, the
    reference's tables, the program's scene)."""
    cell = cells.load(CELL)
    ctx = Context(cell=cell, device=torch.device("cpu"), raw=_small_raw())
    ctx.sd = program.build_scene(ctx.raw, ctx.device)
    assert not ctx.sd.has_refract  # the jade statue: SSS
    offline_material.Client(ctx)
    return ctx.raw, ctx.tables(torch.float32), ctx.sd


def test_the_material_override_reaches_the_program_and_the_reference(small):
    raw, t, sd = small
    statue = [o.name for o in raw.objects].index("statue")
    mat = raw.objects[statue].material
    assert mat.refract_mode == bscene.DIR_REFRACT
    # every other field is the jade's
    assert mat == dataclasses.replace(bscene.JADE, refract_mode=bscene.DIR_REFRACT)
    assert sd.has_refract
    assert int(sd.mat_refract[statue]) == bscene.DIR_REFRACT
    assert int(t.refract[statue]) == bscene.DIR_REFRACT
    others = [i for i in range(len(raw.objects)) if i != statue]
    assert all(int(t.refract[i]) != bscene.DIR_REFRACT for i in others)


@pytest.mark.parametrize("materials,error", [
    ({"plinth": {"refract_mode": 2}}, KeyError),
    ({"statue": {"refract_mood": 2}}, TypeError),
], ids=["unknown-object", "unknown-field"])
def test_an_unknown_object_or_field_raises(materials, error):
    cell = copy.deepcopy(cells.load(CELL))
    cell.config["materials"] = materials
    ctx = Context(cell=cell, device=torch.device("cpu"), raw=_small_raw())
    with pytest.raises(error):
        offline_material.Client(ctx)


def test_render_film_mega_matches_the_reference_on_the_refracting_statue(small):
    """The port's main path (engine mega, its plain version on the CPU) at
    the framed camera on the DIR_REFRACT statue, 16^2 x 8 spp at depth 8,
    against the reference under the light order the program agrees with:
    every pixel's sums within ``check.RTOL``."""
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


@pytest.fixture(scope="module")
def tiny(tmp_path_factory) -> pathlib.Path:
    """The benchmark's files cut to 8^2 x 2 spp, the depth to 3, the march
    to 2 traces."""
    root = tiny_root(tmp_path_factory.mktemp("tiny"), film=8, spp=2)
    f = root / "benchmark" / "configs" / "jade_offline_refract.json"
    c = json.loads(f.read_text())
    c["render"].update(max_depth=3, max_refract_bounces=2)
    f.write_text(json.dumps(c))
    return root


_RUN = r"""
import pathlib, sys
from benchmark import run
sys.exit(run.main(sys.argv[2:], device="cpu", root=pathlib.Path(sys.argv[1])))
"""


@pytest.mark.parametrize("trace", [0, 1])
def test_refract_client_runs_correct(tiny, trace):
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
    counters = {ln.split(" ", 2)[1]: json.loads(ln.split(" ", 2)[2]) for ln in lines
                if ln.startswith("counter ")}
    if trace:  # the CPU has no device trace: the host-clock metric alone
        assert set(res["metrics"]) == {"scene_build_s"}
        assert 0 < counters["refract_share_pct"] < 100
        assert 1 <= counters["march_steps_per_refract"] <= 2
        assert counters["sss_share_pct"] == 0
    else:
        assert set(res["metrics"]) == {"render_msamples_s", "setup_s"}
        assert "refract_share_pct" not in counters


def _plain_counts(sd, cam, cfg) -> dict:
    """``mega_render_plain`` of the whole film under the recorder -> its
    counters."""
    eye, rot = camera_mod.camera_tensors(cam, "cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        tlog.reset()
        megak.mega_render_plain(sd, eye, rot, cfg, 0, cfg.spp)
        got = dict(tlog.counters())
    tlog.reset()
    return got


@pytest.mark.parametrize("statue", ["dir-refract", "jade"])
def test_plain_megakernel_counts_its_marches(small, statue):
    """``ops.mega.refract_bounces``: the bounces that took direct
    refraction, some on the refracting statue, none on the jade one;
    ``ops.mega.march_steps``: their march's traces, at least one and at
    most ``max_refract_bounces`` a march."""
    cfg = RenderConfig(width=8, height=8, spp=2, max_depth=4, max_refract_bounces=8)
    if statue == "dir-refract":
        sd = small[2]
    else:
        sd = program.build_scene(_small_raw(), torch.device("cpu"))
    got = _plain_counts(sd, _cameras()[0], cfg)
    b, r, m = (got[f"ops.mega.{k}"] for k in ("bounces", "refract_bounces", "march_steps"))
    assert 0 < b
    if statue == "dir-refract":
        assert 0 < r < b and r <= m <= cfg.max_refract_bounces * r
        assert got["ops.mega.sss_bounces"] == 0
    else:
        assert r == m == 0 < got["ops.mega.sss_bounces"]


def _run_with(counters, trace=True):
    tlog.reset()
    for k, v in counters.items():
        tlog.RECORDER.count(k, v)
    return types.SimpleNamespace(trace=object() if trace else None)


@pytest.mark.parametrize("counters,trace,want", [
    ({"ops.mega.launch_us": 3_000, "ops.mega.bounces": 4_000_000,
      "ops.mega.march_steps": 2_000_000}, True, 0.5),
    ({"ops.mega.launch_us": 2_000, "ops.mega.bounces": 4_000_000,
      "ops.mega.march_steps": 0}, True, 0.5),
    ({"ops.mega.launch_us": 3_000, "ops.mega.bounces": 4_000_000,
      "ops.mega.march_steps": 2_000_000}, False, None),
    ({"ops.mega.launch_us": 2_000, "ops.mega.bounces": 4_000_000}, True, None),
    ({"ops.mega.launch_us": 2_000, "ops.mega.bounces": 0, "ops.mega.march_steps": 0},
     True, None),
    ({"ops.mega.bounces": 10, "ops.mega.march_steps": 5}, True, None),
], ids=["counted", "no-march", "untraced", "no-march-counter", "no-steps", "no-launch-time"])
def test_mega_step_ns_reader(counters, trace, want):
    read = cells.reader("mega_step_ns.refract")
    try:
        got = read(_run_with(counters, trace))
    finally:
        tlog.reset()
    assert got == (None if want is None else pytest.approx(want))
