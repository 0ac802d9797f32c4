"""The port's bench (``jaderaytracerendering_tpu_torch/bench.py``) on the
CPU at bench.py's ``--small`` setting (32^2, 2 spp, depth 3, 2,000 statue
triangles): each engine prints one JSON line with the bench's fields, the
three engines count the same useful rays, and that count equals the JAX
package's (``wavefront.trace_radiance(..., with_stats=True)`` on its NumPy
route, traversal ``sweep`` as bench.py's default), exactly: a ray count is
an integer fact of the paths, which both packages draw from the same
keyed streams. ``--all`` names bench.py's eight rows and writes its
matrix to ``--out``. And ``cli/convergence.py``, cut to size on the CPU.
"""

import ast
import json
import pathlib

import numpy as np
import pytest
import torch

from jaderaytracerendering_tpu.core import camera as jcamera
from jaderaytracerendering_tpu.integrator import render as jrender, wavefront as jwf
from jaderaytracerendering_tpu.models import demo as jdemo
from jaderaytracerendering_tpu.scene.scene import assemble as jassemble
from jaderaytracerendering_tpu.utils.config import RenderConfig as JConfig
from jaderaytracerendering_tpu_torch import bench

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
FIELDS = {"metric", "value", "unit", "engine", "config", "shape", "rays", "reps", "protocol",
          "wall_s", "single_ms", "launches", "device"}


def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def small_lines():
    """Each engine's line from ``bench.main`` (stdout captured by hand: a
    module fixture has no capsys)."""
    import contextlib
    import io

    lines = {}
    for engine in ("mega", "pool", "scan"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ret = bench.main(["--small", "--device", "cpu", "--engine", engine, "--reps", "2"])
        lines[engine] = (buf.getvalue(), ret)
    return lines


@pytest.mark.parametrize("engine", ["mega", "pool", "scan"])
def test_small_prints_one_json_line(small_lines, engine):
    text, ret = small_lines[engine]
    line = _last_json(text)
    assert line == ret and set(line) == FIELDS
    assert line["engine"] == engine and line["config"] == "small" and line["reps"] == 2
    assert line["shape"] == dict(width=32, height=32, spp=2, depth=3, tris=2000)
    assert line["value"] > 0 and line["unit"] == "Mrays/s"
    assert line["metric"] != "Mrays/sec/chip"  # a CPU run never takes the card's metric name
    assert line["device"] == {"name": "cpu", "power_limit": None}
    assert line["launches"] == {}  # CPU tensors run the plain versions
    sm = line["single_ms"]
    assert 0 < sm["min"] <= sm["median"] <= sm["max"]
    assert "sustained" in line["protocol"]
    reps = [ln for ln in text.splitlines() if ln.startswith("rep ")]
    assert len(reps) == 2 and all(ln.endswith(f"({engine}, small)") for ln in reps)
    assert sum(1 for ln in text.splitlines() if ln.startswith("{")) == 1


def test_engines_count_the_jax_useful_rays(small_lines):
    rays = {e: _last_json(t)["rays"] for e, (t, _) in small_lines.items()}
    assert rays["mega"] == rays["pool"] == rays["scan"], rays
    ds = jdemo.jade_scene(n_buddha_tris=2000, env_shape=(128, 256))
    ds.camera.r, ds.camera.up_angle = 2.2, 10.0
    sd = jassemble(ds.objects, ds.env_map, xp=np)
    cfg = JConfig(width=32, height=32, spp=2, max_depth=3, traversal="sweep")
    pid = np.tile(np.arange(32 * 32, dtype=np.uint32), 2)
    sid = np.repeat(np.arange(2, dtype=np.uint32), 32 * 32)
    o, d = jcamera.generate_rays(np, ds.camera.eye, ds.camera.camera_rotate, 32, 32, pid, sid,
                                 cfg.seed, cfg.jitter)
    _, n = jwf.trace_radiance(o, d, pid, sid, sd, cfg, np, jrender.make_nearest(sd, cfg, np),
                              with_stats=True)
    assert rays["mega"] == float(n) > 32 * 32 * 2


def _jax_bench_rows() -> list:
    """The row names of bench.py's ``_run_matrix`` (its matrix list and its
    preview tuple), read from its source."""
    tree = ast.parse((REPO / "bench.py").read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "_run_matrix")
    return [n.elts[0].value for n in ast.walk(fn)
            if isinstance(n, ast.Tuple) and n.elts and isinstance(n.elts[0], ast.Constant)
            and isinstance(n.elts[0].value, str)
            and (len(n.elts) == 3 or isinstance(n.elts[1], ast.Dict))]


def test_all_rows_are_the_jax_benchs_eight():
    rows = [n for n, _ in bench.MATRIX] + [n for n, _, _ in bench.PREVIEW_ROWS]
    assert sorted(rows) == sorted(_jax_bench_rows()) and len(rows) == 8
    assert bench.MATRIX_ENGINES == ("mega", "pool")


def test_all_writes_every_row_to_out(tmp_path, monkeypatch, capsys):
    """``--all`` on the CPU, cut to size: the default row at ``--small``
    through both engines, and the four preview rows at 8x8."""
    monkeypatch.setattr(bench, "MATRIX", bench.MATRIX[:1])
    monkeypatch.setattr(bench, "PREVIEW_SIZE", 8)
    out = tmp_path / "matrix.json"
    ret = bench.main(["--all", "--small", "--device", "cpu", "--reps", "1", "--out", str(out)])
    text = capsys.readouterr().out
    saved = json.loads(out.read_text())
    assert saved == json.loads(json.dumps(ret))
    assert list(saved) == ["default"] + [n for n, _, _ in bench.PREVIEW_ROWS]
    assert [saved["default"][e]["engine"] for e in ("mega", "pool")] == ["mega", "pool"]
    assert saved["default"]["mega"]["rays"] == saved["default"]["pool"]["rays"]
    for name, engine, bands in bench.PREVIEW_ROWS:
        row = saved[name]
        assert row["engine"] == engine and row["frames"] == bench.PREVIEW_FRAMES
        assert row["value"] > 0 and len(row["frame_ms"]) == bench.PREVIEW_FRAMES
        assert ("bands" in row["metric"]) == (bands > 1)
    assert sum(1 for ln in text.splitlines() if ln.startswith("{")) == 2 + 4


def test_convergence_cli_on_cpu(tmp_path, capsys):
    """``cli/convergence.py`` cut to size on the CPU: the five spp rows
    against a reference at seed 0, the slope of their log-log fit, and the
    markdown table written to ``--out``."""
    from jaderaytracerendering_tpu_torch.cli import convergence

    out = tmp_path / "conv.md"
    ret = convergence.main(["--device", "cpu", "--size", "4", "--tris", "300",
                            "--ref-spp", "64", "--out", str(out)])
    spps = [s for s, _ in ret["rows"]]
    errs = np.array([r for _, r in ret["rows"]])
    assert spps == [1, 4, 16, 64, 256] and np.isfinite(errs).all() and (errs > 0).all()
    assert errs[-1] < errs[0]
    assert ret["slope"] == pytest.approx(np.polyfit(np.log2(spps), np.log2(errs), 1)[0])
    table = out.read_text()
    assert f"**{ret['slope']:.4f}**" in table and table.count("\n| ") == 6
    assert "log-log slope" in capsys.readouterr().out
