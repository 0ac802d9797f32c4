"""Port parity: RenderConfig has the JAX package's fields and defaults,
and every shipped config loads to equal configs in both packages.

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
