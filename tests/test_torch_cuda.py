"""The port's CUDA kernels on the card, held against their plain PyTorch
versions on the same inputs. Marked ``cuda``; each test skips (with the
reason) where there is no CUDA device or no nvcc. On a GPU machine:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerances: BVH ids exact and t within 1e-6 relative; radiance sums per
pixel atol = 1e-4 * max, rtol = 1e-3 (the kernel is built with
--fmad=false and matches the plain version to a few ulps)."""

import numpy as np
import pytest
import torch

from jaderaytracerendering_tpu_torch.core import camera as camera_mod
from jaderaytracerendering_tpu_torch.integrator import render as trender
from jaderaytracerendering_tpu_torch.models import demo
from jaderaytracerendering_tpu_torch.ops import mega as megak, traverse
from jaderaytracerendering_tpu_torch.scene.scene import assemble
from jaderaytracerendering_tpu_torch.utils.config import RenderConfig

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def jade_cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    try:
        megak.build.find_nvcc()
    except RuntimeError as e:
        pytest.skip(str(e))
    ds = demo.jade_scene(n_buddha_tris=2000, env_shape=(32, 64))
    ds.camera.r = 2.0
    return ds, assemble(ds.objects, ds.env_map, device="cuda")


def test_bvh_nearest_kernel_matches_plain(jade_cuda):
    _, sd = jade_cuda
    g = np.random.default_rng(0)
    o = g.uniform(-1.5, 1.5, (8192, 3)).astype(np.float32)
    d = (g.uniform(-0.6, 0.6, (8192, 3)).astype(np.float32) - o)
    ex = g.integers(-1, sd.n_triangles, 8192).astype(np.int32)
    o, d, ex = (torch.tensor(a, device="cuda") for a in (o, d, ex))
    hk, ik, tk = megak.bvh_nearest(sd, o, d, ex)
    hp, ip, tp = traverse.nearest_hit_bvh(o, d, ex, sd)
    assert torch.equal(hk, hp) and torch.equal(ik, ip)
    torch.testing.assert_close(tk, tp, rtol=1e-6, atol=0)


def test_mega_render_kernel_matches_plain(jade_cuda):
    ds, sd = jade_cuda
    cfg = RenderConfig(width=32, height=32, spp=2, max_depth=5)
    eye, rot = camera_mod.camera_tensors(ds.camera, "cuda")
    before = megak.LAUNCHES["mega_render"]
    k = megak.mega_render(sd, eye, rot, cfg, 3, cfg.spp)
    assert megak.LAUNCHES["mega_render"] == before + 1
    p = megak.mega_render_plain(sd, eye, rot, cfg, 3, cfg.spp)
    torch.cuda.synchronize()
    torch.testing.assert_close(k[:3], p[:3], rtol=1e-3,
                               atol=1e-4 * float(p[:3].abs().max()))
    assert torch.equal(k[3], p[3])


def test_render_film_mega_on_cuda_uses_the_kernel(jade_cuda):
    ds, sd = jade_cuda
    megak.reset_launches()
    stats = {}
    film = trender.render_film(sd, ds.camera,
                               RenderConfig(width=16, height=16, spp=3,
                                            mega_spp_batch=2), stats=stats)
    assert megak.LAUNCHES["mega_render"] == 2 and film.count == 3
    assert bool(torch.isfinite(film.accum).all()) and stats["rays"] > 0
