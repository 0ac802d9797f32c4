"""Port parity of the display step and the preview's files and CLIs:

- ``ops/postfx.postfx`` (on CPU tensors its plain version) against the JAX
  package's Pallas ``postfx(interpret=True)`` in the three modes, and the
  zero-count guard (mirrors tests/test_postfx.py); its ``flip`` and
  ``span`` options against the plain flip of one call; a ``split`` with
  two counts against two JAX calls, one per count;
- ``render_args.txt`` and the JSON spec written by each package and read
  by the other, byte for byte;
- ``cli.preview --device cpu`` headless and through its f command, and
  ``cli.render --render-args`` (mirrors tests/test_cli.py:37-59).

Tolerance: u8 within 1 (the JAX kernel and the port round the same
operations; the NumPy reference of tests/test_postfx.py divides where
both multiply by 1/count).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaderaytracerendering_tpu.models import demo as jdemo
from jaderaytracerendering_tpu.ops.pallas import postfx as jpostfx
from jaderaytracerendering_tpu.scene import serialization as jser
from jaderaytracerendering_tpu_torch.cli import preview as preview_cli
from jaderaytracerendering_tpu_torch.cli import render as render_cli
from jaderaytracerendering_tpu_torch.integrator import render as trender
from jaderaytracerendering_tpu_torch.models import demo as tdemo
from jaderaytracerendering_tpu_torch.ops import kernels, postfx
from jaderaytracerendering_tpu_torch.post import image_io
from jaderaytracerendering_tpu_torch.scene import serialization as tser

torch.set_num_threads(1)


@pytest.mark.parametrize("mode", ["aces", "reinhard", "none"])
def test_postfx_matches_jax_kernel(mode):
    g = np.random.default_rng(1)
    accum = g.uniform(0, 40, (16, 128, 3)).astype(np.float32)
    accum[0, :8] = -g.uniform(0, 1, (8, 3))  # negative sums clamp to 0
    want = np.asarray(jpostfx.postfx(jnp.asarray(accum), 4, mode, interpret=True))
    kernels.reset_launches()
    got = postfx.postfx(torch.from_numpy(accum), 4, mode)
    assert kernels.LAUNCHES["postfx"] == 0  # CPU: the plain version
    assert got.dtype == torch.uint8 and got.shape == (16, 128, 3)
    assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1
    assert got.numpy().min() == 0 and got.numpy().max() > 200


@pytest.mark.parametrize("h,w,span,split", [
    (7, 1021, None, 2 * 1021 + 517),       # a ragged width, the split inside a row
    (7, 1021, (3, 5 * 1021 - 1), 1021),    # odd span bounds, the split on a row edge
    (5, 12, (13, 59), 13),                 # no pixel below the split
    (5, 12, (1, 47), 47),                  # none from it on
])
def test_postfx_split_matches_two_jax_calls(h, w, span, split):
    """One call with a split and two counts (a banded frame's display)
    equals the JAX kernel run once per count, each on its own span."""
    g = np.random.default_rng(5)
    accum = g.uniform(-1, 30, (h, w, 3)).astype(np.float32)
    p0, p1 = span or (0, h * w)
    full = [np.asarray(jpostfx.postfx(jnp.asarray(accum), n, "aces", interpret=True))
            .reshape(-1, 3) for n in (3, 2)]
    want = np.full((h * w, 3), 7, np.uint8)
    want[p0:split], want[split:p1] = full[0][p0:split], full[1][split:p1]
    out = torch.full((h, w, 3), 7, dtype=torch.uint8)
    got = postfx.postfx_plain(torch.from_numpy(accum), 3, "aces", flip=True, span=span,
                              out=out, split=split, count_hi=2).numpy()
    assert np.abs(got.astype(int) - want.reshape(h, w, 3)[::-1].astype(int)).max() <= 1
    with pytest.raises(ValueError):
        postfx.postfx_plain(torch.from_numpy(accum), 3, split=split)  # no count_hi
    with pytest.raises(ValueError):
        postfx.postfx_plain(torch.from_numpy(accum), 3, span=span, split=p0 - 1, count_hi=2)


def test_postfx_zero_count_guard():
    got = postfx.postfx(torch.zeros((8, 128, 3)), 0, "aces")
    assert (got.numpy() == 0).all()


@pytest.mark.parametrize("span", [None, (0, 90), (37, 96)])
def test_postfx_flip_and_span(span):
    g = np.random.default_rng(2)
    accum = torch.from_numpy(g.uniform(0, 5, (8, 12, 3)).astype(np.float32))
    whole = postfx.postfx(accum, 3, "reinhard").numpy()
    out = torch.full((8, 12, 3), 7, dtype=torch.uint8)
    got = postfx.postfx(accum, 3, "reinhard", flip=True, span=span, out=out).numpy()
    p0, p1 = span or (0, 96)
    want = np.full((96, 3), 7, np.uint8)
    want[p0:p1] = whole.reshape(-1, 3)[p0:p1]
    np.testing.assert_array_equal(got, want.reshape(8, 12, 3)[::-1])
    with pytest.raises(ValueError):
        postfx.postfx(accum, 3, "filmic")
    with pytest.raises(ValueError):
        postfx.postfx(accum, 3, "aces", span=(0, 97))


def _spec(demo_mod):
    ds = demo_mod.jade_scene(n_buddha_tris=100, env_shape=(8, 16))
    ds.camera.orbit(d_up=20.0, d_rotate=-40.0)
    return demo_mod.to_spec(ds)


def test_render_args_cross_packages(tmp_path):
    t_path, j_path = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
    tser.write_render_args(t_path, _spec(tdemo))
    jser.write_render_args(j_path, _spec(jdemo))
    assert open(t_path, "rb").read() == open(j_path, "rb").read()
    for read, path in ((jser.read_render_args, t_path), (tser.read_render_args, j_path)):
        back = read(path)
        want = _spec(tdemo)
        np.testing.assert_allclose(back.eye, want.eye, rtol=1e-5)
        # the format keeps 6 significant digits (%g, PathTrace.cpp:883-918)
        np.testing.assert_allclose(back.camera_rotate, want.camera_rotate, rtol=1e-5,
                                   atol=1e-5)
        assert [o.path for o in back.objects] == [o.path for o in want.objects]
        assert [o.material.refract_mode for o in back.objects] == [1, 0, 0]  # jade: SSS
    assert tser.spec_to_json(_spec(tdemo)) == jser.spec_to_json(_spec(jdemo))
    back = tser.spec_from_json(jser.spec_to_json(_spec(jdemo)))
    assert back.objects[0].material == _spec(tdemo).objects[0].material


def test_preview_cli_headless_frames(tmp_path):
    out = str(tmp_path / "prev.png")
    film, info = preview_cli.main(["--device", "cpu", "--scene", "tiny", "--width", "8",
                                   "--height", "8", "--frames", "2", "--out", out])
    assert info["frames"] == 2 and os.path.exists(out)
    # 4 bands of 16 pixels: after two frames bands 0-1 hold a sample
    a = film.accum.reshape(-1, 3)
    assert film.count == 1 and a[:32].abs().sum() > 0 and a[32:].abs().sum() == 0
    # the last frame shown: the banded display of frame 1 (two counts)
    assert len(info["frame_s"]) == 2
    want = trender.display_banded(film.accum, 1, 4, 1, "aces")
    np.testing.assert_array_equal(info["display"].numpy(), want.numpy())


def test_preview_f_command_then_render_args(tmp_path):
    """The reference's workflow: the preview's f writes render_args.txt,
    the render CLI renders that view."""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(__file__)),
               OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "jaderaytracerendering_tpu_torch.cli.preview", "--device", "cpu",
         "--scene", "tiny", "--width", "8", "--height", "8"],
        input="k\nf\n", cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    ra = tmp_path / "render_args.txt"
    spec = jser.read_render_args(str(ra))  # the JAX package reads it too
    assert [o.path for o in spec.objects] == ["procedural://floor", "procedural://light"]
    out = str(tmp_path / "out.bmp")
    film, _ = render_cli.main(["--device", "cpu", "--render-args", str(ra), "--width", "8",
                               "--height", "8", "--spp", "1", "--max-depth", "2",
                               "--out", out])
    assert film.count == 1 and image_io.read_bmp(out).shape == (8, 8, 3)


def test_render_cli_render_args_and_scene_json(tmp_path):
    spec = jdemo.to_spec(jdemo.tiny_scene())
    ra = str(tmp_path / "render_args.txt")
    jser.write_render_args(ra, spec)
    js = str(tmp_path / "scene.json")
    with open(js, "w") as f:
        f.write(jser.spec_to_json(spec))
    films = []
    for flag, path in (("--render-args", ra), ("--scene-json", js)):
        out = str(tmp_path / f"out{len(films)}.bmp")
        film, _ = render_cli.main(["--device", "cpu", flag, path, "--width", "8", "--height",
                                   "8", "--spp", "1", "--max-depth", "2", "--out", out])
        assert os.path.exists(out)
        films.append(film.accum.numpy())
    np.testing.assert_allclose(films[0], films[1], rtol=1e-5, atol=1e-6)
