"""Port parity: the scene tables the GPU path reads are array-equal to
the JAX package's ``assemble(..., xp=np, bvh_backend='numpy')``, and
``scene_from_numpy`` carries the JAX arrays across unchanged.

Tolerance: none — exact array equality."""

import dataclasses

import numpy as np
import pytest
import torch

from jaderaytracerendering_tpu.models import demo as jdemo
from jaderaytracerendering_tpu.scene.scene import assemble as jassemble
from jaderaytracerendering_tpu_torch.models import demo as tdemo
from jaderaytracerendering_tpu_torch.scene import scene as tscene

torch.set_num_threads(1)

SCENES = {
    "jade": dict(n_buddha_tris=300, env_shape=(16, 32)),
    "cornell": {},
    "tiny": {},
}
STATIC = ("n_triangles", "n_objects", "n_emit", "n_nodes", "leaf_size",
          "has_sss", "has_refract", "has_mirror", "bvh_depth")


def _pair(name):
    kw = SCENES[name]
    j = getattr(jdemo, f"{name}_scene")(**kw)
    t = getattr(tdemo, f"{name}_scene")(**kw)
    return (jassemble(j.objects, j.env_map, xp=np, bvh_backend="numpy"),
            tscene.assemble(t.objects, t.env_map, bvh_backend="numpy", device="cpu"))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_tables_equal(name):
    sj, st = _pair(name)
    for k, dt in tscene.TABLES.items():
        got = getattr(st, k)
        assert got.dtype == dt, k
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(sj, k)),
                                      err_msg=k)
    for k in STATIC:
        assert getattr(st, k) == getattr(sj, k), k


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_from_numpy_round_trip(name):
    sj, st = _pair(name)
    fields = {f.name: getattr(sj, f.name) for f in dataclasses.fields(sj)}
    back = tscene.scene_from_numpy(fields, device="cpu")
    for k in tscene.TABLES:
        assert torch.equal(getattr(back, k), getattr(st, k)), k
    for k in STATIC:
        assert getattr(back, k) == getattr(st, k), k
