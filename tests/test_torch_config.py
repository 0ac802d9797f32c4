"""Port parity: RenderConfig has the JAX package's fields and defaults,
every shipped config loads to equal configs in both packages, and the
reference-parity presets are equal; one command line gives equal configs
through both CLIs' parsers. The render CLI's ``--mesh``: 2 gloo ranks on
the CPU (the CLI spawns them) against the single-rank CLI, and a mesh
that does not fit the process group refused.

Tolerance: none for configs (exact equality of every field); the
``--mesh 2x1`` BMP and film byte for byte; ``--mesh 1x2`` rtol 1e-4 +
atol 1e-5 on the mean film (the spp split sums two halves)."""

import dataclasses
import glob
import os

import pytest
import torch

from jaderaytracerendering_tpu.utils import config as jcfg
from jaderaytracerendering_tpu_torch.utils import config as tcfg

torch.set_num_threads(1)

CONFIGS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..",
                                        "configs", "*.json")))


def test_fields_and_defaults_equal():
    jf = [(f.name, f.default) for f in dataclasses.fields(jcfg.RenderConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tcfg.RenderConfig)]
    assert tf == jf


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_files_load_equal(path):
    text = open(path).read()
    a = dataclasses.asdict(jcfg.RenderConfig.from_json(text))
    b = dataclasses.asdict(tcfg.RenderConfig.from_json(text))
    assert a == b


def test_from_json_tolerates_unknown_fields():
    cfg = tcfg.RenderConfig(width=33, mesh_shape=(2, 2))
    text = cfg.to_json().replace('"width": 33', '"width": 33, "pallas_shading": true')
    back = tcfg.RenderConfig.from_json(text)
    assert back == cfg and back.mesh_shape == (2, 2)


def test_cli_flags_give_equal_configs():
    """One JAX command line through both packages' CLI parsers and
    ``config_from_args``: equal configs, ``--rays-per-launch`` carried (and
    ignored by the port)."""
    import argparse

    from jaderaytracerendering_tpu.cli import common as jcommon
    from jaderaytracerendering_tpu_torch.cli import common as tcommon

    argv = ["--traversal", "clusters", "--spp-batch", "3", "--rays-per-launch", "4096",
            "--width", "24", "--height", "16", "--spp", "5", "--max-depth", "7",
            "--seed", "9", "--tonemap", "reinhard", "--engine", "scan"]
    cfgs = []
    for common in (jcommon, tcommon):
        ap = argparse.ArgumentParser()
        common.add_common_args(ap)
        cfgs.append(dataclasses.asdict(common.config_from_args(ap.parse_args(argv))))
        with pytest.raises(SystemExit):  # argparse refuses a name outside the choices
            ap.parse_args(["--traversal", "octree"])
    assert cfgs[0] == cfgs[1]
    assert (cfgs[1]["traversal"], cfgs[1]["spp_batch"], cfgs[1]["rays_per_launch"]) == \
        ("clusters", 3, 4096)


def test_render_cli_refuses_mesh(tmp_path):
    """A --mesh whose ranks differ from the process group's is refused
    with a clear SystemExit, before any render."""
    import torch.distributed as dist

    from jaderaytracerendering_tpu_torch.cli import render

    out = tmp_path / "out.bmp"
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
                            world_size=1, rank=0)
    try:
        with pytest.raises(SystemExit, match="--mesh 2x1: 2 ranks, but the process group has 1"):
            render.main(["--mesh", "2x1", "--device", "cpu", "--scene", "tiny", "--out",
                         str(out)])
    finally:
        dist.destroy_process_group()
    assert not out.exists()
    with pytest.raises(SystemExit, match="want TILExSPP"):
        render.main(["--mesh", "2", "--device", "cpu", "--scene", "tiny", "--out", str(out)])


CLI_SIZE = ["--device", "cpu", "--scene", "tiny", "--width", "8", "--height", "8", "--spp", "2",
            "--max-depth", "2"]


@pytest.fixture(scope="module")
def mesh_cli(tmp_path_factory):
    """The render CLI started plainly with --mesh 2x1 and --mesh 1x2 (each
    spawns its 2 gloo ranks) beside the single-rank CLI -> {name: (BMP
    bytes, film accum, count)}."""
    import subprocess
    import sys

    import numpy as np

    from jaderaytracerendering_tpu_torch.cli import render

    tmp = tmp_path_factory.mktemp("mesh_cli")
    repo = os.path.join(os.path.dirname(__file__), "..")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(repo), OMP_NUM_THREADS="1")
    procs = {m: subprocess.Popen(
        [sys.executable, "-m", "jaderaytracerendering_tpu_torch.cli.render", *CLI_SIZE,
         "--mesh", m, "--out", str(tmp / f"{m}.bmp"), "--save-film", str(tmp / f"{m}.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=tmp)
        for m in ("2x1", "1x2")}
    render.main([*CLI_SIZE, "--out", str(tmp / "one.bmp"), "--save-film", str(tmp / "one.npz")])
    logs = {}
    for m, p in procs.items():
        try:
            _, logs[m] = p.communicate(timeout=240)
        finally:
            if p.poll() is None:
                p.kill()
        assert p.returncode == 0, logs[m][-3000:]
    out = {}
    for name in ("one", "2x1", "1x2"):
        film = np.load(tmp / f"{name}.npz")
        out[name] = ((tmp / f"{name}.bmp").read_bytes(), film["accum"], int(film["count"]),
                     logs.get(name, ""))
    return out


def test_render_cli_mesh_2x1_writes_the_single_rank_bmp(mesh_cli):
    bmp, accum, count, log = mesh_cli["2x1"]
    assert bmp == mesh_cli["one"][0] and count == 2
    assert (accum == mesh_cli["one"][1]).all()
    assert "[rank 0/2]" in log and "[rank 1/2]" in log and "mesh 2x1 (gloo)" in log


def test_render_cli_mesh_1x2_film_within_tolerance(mesh_cli):
    """The spp split sums two halves: rtol 1e-4 + atol 1e-5 on the mean
    film (the JAX tests' tolerance, tests/test_parallel.py)."""
    import numpy as np

    _, accum, count, log = mesh_cli["1x2"]
    assert count == 2 and "mesh 1x2 (gloo)" in log
    np.testing.assert_allclose(accum / 2, mesh_cli["one"][1] / 2, rtol=1e-4, atol=1e-5)


def test_parity_presets_equal():
    """cuda_parity, gl_render_parity and gl_preview_parity field for field,
    with and without overrides."""
    for name in ("cuda_parity", "gl_render_parity", "gl_preview_parity"):
        for kw in ({}, {"spp": 7, "width": 32}):
            a = dataclasses.asdict(getattr(jcfg, name)(**kw))
            b = dataclasses.asdict(getattr(tcfg, name)(**kw))
            assert a == b, name
