"""Port parity: RenderConfig has the JAX package's fields and defaults,
and every shipped config loads to equal configs in both packages; one
command line gives equal configs through both CLIs' parsers.

Tolerance: none — exact equality of every field."""

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
    from jaderaytracerendering_tpu_torch.cli import render

    out = tmp_path / "out.bmp"
    with pytest.raises(SystemExit, match="--mesh 2x1: multi-device rendering is not ported"):
        render.main(["--mesh", "2x1", "--device", "cpu", "--scene", "tiny", "--out", str(out)])
    assert not out.exists()
