"""The port stands alone: it imports without JAX, runs its CLI on the
CPU, and refuses a missing CUDA device instead of falling back."""

import os
import pathlib
import subprocess
import sys

import torch

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "jaderaytracerendering_tpu_torch"


def _run(code, tmp_path, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_cli_renders_on_cpu_without_jax(tmp_path):
    code = f"""
import sys, pkgutil, importlib
import jaderaytracerendering_tpu_torch as p
for m in pkgutil.walk_packages(p.__path__, p.__name__ + "."):
    importlib.import_module(m.name)
from jaderaytracerendering_tpu_torch.cli import render
film, stats = render.main(["--device", "cpu", "--scene", "tiny", "--width", "8",
                           "--height", "8", "--spp", "2", "--max-depth", "3",
                           "--out", {str(tmp_path / 'out.bmp')!r}])
assert film.count == 2 and film.accum.shape == (8, 8, 3)
print("JAX_LOADED", "jax" in sys.modules, "jaderaytracerendering_tpu" in sys.modules)
"""
    res = _run(code, tmp_path)
    assert res.returncode == 0, res.stderr
    assert "JAX_LOADED False False" in res.stdout
    assert (tmp_path / "out.bmp").stat().st_size == 54 + 8 * 8 * 3


def test_cli_refuses_missing_cuda(tmp_path):
    code = """
import torch
torch.cuda.is_available = lambda: False
from jaderaytracerendering_tpu_torch.cli import render
render.main(["--scene", "tiny", "--width", "4", "--height", "4", "--spp", "1"])
"""
    res = _run(code, tmp_path)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert not list(tmp_path.glob("*.bmp"))


def test_sources_never_import_jax():
    offenders = [str(p) for p in PKG.rglob("*.py")
                 if "import jax" in p.read_text() or "from jax" in p.read_text()]
    assert offenders == []


def test_preview_cli_refuses_missing_cuda(tmp_path):
    """The preview CLI runs on the card unless --device cpu asks for the
    CPU; a missing GPU is an error, not a fall back."""
    code = """
import torch
torch.cuda.is_available = lambda: False
from jaderaytracerendering_tpu_torch.cli import preview
preview.main(["--scene", "tiny", "--width", "4", "--height", "4", "--frames", "1"])
"""
    res = _run(code, tmp_path)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert not list(tmp_path.glob("*.bmp"))
