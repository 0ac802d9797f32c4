"""Port parity: the port's ``engine='mega'`` on CPU tensors (its wrapper
runs the plain version there) against the JAX package's
``mega.render_film_mega`` in interpret mode, at the size of
tests/test_mega.py (8x8, 4 spp, depth 4, mega_gather='take'). The CUDA
wrapper must not count a launch on the CPU.

Tolerance: atol = 1e-4 * max|film|, rtol = 1e-3 (tests/test_integrator.py
precedent; the JAX megakernel itself is held to the scan engine at
1e-6/1e-5, and the torch engine to the scan engine at this tolerance)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaderaytracerendering_tpu.integrator import mega as jmega
from jaderaytracerendering_tpu.models import demo as jdemo
from jaderaytracerendering_tpu.scene.scene import assemble as jassemble
from jaderaytracerendering_tpu.utils.config import RenderConfig as JConfig
from jaderaytracerendering_tpu_torch.integrator import render as trender
from jaderaytracerendering_tpu_torch.models import demo as tdemo
from jaderaytracerendering_tpu_torch.ops import kernels, mega as megak
from jaderaytracerendering_tpu_torch.scene import scene as tscene
from jaderaytracerendering_tpu_torch.utils.config import RenderConfig as TConfig

torch.set_num_threads(1)

SIZE = dict(width=8, height=8, spp=4, spp_batch=4, max_depth=4,
            rays_per_launch=64, mega_gather="take")


def test_mega_cornell_matches_jax_mega():
    ds = jdemo.cornell_scene()
    # the NumPy SAH builder, as the port's: the triangle order fixes the
    # light order and so each light's RNG sites
    sdj = jassemble(ds.objects, ds.env_map, xp=jnp, bvh_backend="numpy")
    a = np.asarray(jmega.render_film_mega(
        sdj, ds.camera, JConfig(**SIZE, traversal="sweep")).mean())
    t = tdemo.cornell_scene()
    st = tscene.assemble(t.objects, t.env_map, bvh_backend="numpy", device="cpu")
    kernels.reset_launches()
    film = trender.render_film(st, t.camera, TConfig(**SIZE, engine="mega"))
    assert set(kernels.LAUNCHES.values()) == {0}
    assert film.count == 4
    b = film.mean().numpy()
    scale = max(np.abs(a).max(), 1.0)
    np.testing.assert_allclose(b, a, atol=1e-4 * scale, rtol=1e-3)


@pytest.mark.parametrize("batch", [1, 3])
def test_mega_batches_equal_scan(batch):
    """mega_spp_batch splits the samples over launches; the film and the
    useful-ray count equal the scan engine's."""
    ds = tdemo.jade_scene(n_buddha_tris=300, env_shape=(16, 32))
    ds.camera.r = 2.0
    st = tscene.assemble(ds.objects, ds.env_map, device="cpu")
    cfg = TConfig(**SIZE, mega_spp_batch=batch)
    s_mega, s_scan = {}, {}
    a = trender.render_film(st, ds.camera, cfg.replace(engine="mega"), stats=s_mega)
    b = trender.render_film(st, ds.camera, cfg.replace(engine="scan"), stats=s_scan)
    assert a.count == b.count == 4
    np.testing.assert_allclose(a.accum.numpy(), b.accum.numpy(), rtol=1e-5,
                               atol=1e-5 * float(b.accum.abs().max()))
    assert s_mega["rays"] == s_scan["rays"]


def test_wrapper_rejects_a_non_cuda_device():
    ds = tdemo.tiny_scene()
    st = tscene.assemble(ds.objects, ds.env_map, device="cpu").to("meta")
    eye, rot = torch.zeros(3), torch.eye(4)
    with pytest.raises(ValueError):
        megak.mega_render(st, eye, rot, TConfig(**SIZE), 0, 1)


def test_kernel_struct_matches_scene_tables():
    """The ctypes structures in ops/kernels.py mirror csrc/path.cuh's
    SceneArgs and RenderArgs and csrc/pool.cu's PoolArgs field for field."""
    import re

    src = "".join((kernels.build.CSRC_DIR / f).read_text()
                  for f in ("path.cuh", "pool.cu"))

    def fields(name):
        body = re.search(r"struct %s \{(.*?)\n\};" % name, src, re.S).group(1)
        return [re.search(r"(\w+)(\[\d+\])?;", line.split("//")[0]).group(1)
                for line in body.splitlines() if ";" in line]

    assert fields("SceneArgs") == [f[0] for f in kernels.SceneArgs._fields_]
    assert fields("RenderArgs") == [f[0] for f in kernels.RenderArgs._fields_]
    assert fields("PoolArgs") == [f[0] for f in kernels.PoolArgs._fields_]
