"""CPU tests of the benchmark's harness: cells resolved by name, a cell
added by files alone, the trace and metric arithmetic, the result line,
and the runs' faults that the comparison has to catch.

    python -m pytest benchmark -q

Runs on the CPU at tiny sizes (the program's plain versions); the test
marked ``cuda`` runs a cell on the card and skips without one."""

from __future__ import annotations

import json
import pathlib
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from benchmark import cells, check, profiling, roofline, run
from benchmark.clients import Window

ROOT = pathlib.Path(__file__).resolve().parent.parent
SEED = 4_294_967_999  # past 32 bits, as the driver's seeds are


def tiny_root(dst: pathlib.Path, film: int = 16, spp: int = 4, tris: int = 300) -> pathlib.Path:
    """A copy of BENCHMARK.json and the cells' data files, cut to a size the
    CPU renders in a second: a 300-triangle statue, a 16 x 32 sky, 16^2
    films, 4 spp, an orbit key every 8 frames, 32 compared pixels."""
    (dst / "benchmark").mkdir(parents=True)
    shutil.copy(ROOT / "BENCHMARK.json", dst)
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(ROOT / "benchmark" / d, dst / "benchmark" / d)
    for f in (dst / "benchmark" / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        c["scene"].update(statue_tris=tris, env_shape=[16, 32])
        c["render"].update(width=film, height=film)
        f.write_text(json.dumps(c))
    for f in (dst / "benchmark" / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        if "render" in t:
            t["render"].update(width=film, height=film, spp=spp)
        if "orbit_every" in t:
            t["orbit_every"] = 8
        t["check"]["pixels"] = 32
        f.write_text(json.dumps(t))
    return dst


@pytest.fixture(scope="module")
def tiny(tmp_path_factory) -> pathlib.Path:
    return tiny_root(tmp_path_factory.mktemp("tiny"))


def run_cell(root, workload, capsys, seconds="0.3", trace="0", seed=SEED) -> dict:
    rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds", seconds,
                   "--trace", trace], device="cpu", root=root)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


def test_every_cell_resolves_its_files_by_name():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    for w in bench["workloads"]:
        cell = cells.load(w["name"])
        assert cell.config["name"] == w["config"]
        assert cells.client(cell).__name__ == "Client"
        for m in cell.end_to_end + cell.per_layer:
            assert callable(cells.reader(m["name"]))
        # every cell reports setup_s, another end-to-end metric and a per-layer one
        got = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in got and len(got) >= 2 and cell.per_layer
    for name in names:
        assert cells.reader_path(name).parent == ROOT / "benchmark" / "metrics"
    for c in bench["configs"]:
        assert (ROOT / c["file"]).exists()


def test_a_cell_added_as_files_alone_is_picked_up(tiny, tmp_path, capsys):
    root = tmp_path / "root"
    shutil.copytree(tiny, root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "benchmark" / "configs" / "jade_offline.json").read_text())
    cfg["name"] = "jade_small"
    (root / "benchmark" / "configs" / "jade_small.json").write_text(json.dumps(cfg))
    traffic = json.loads((root / "benchmark" / "traffic" / "render_256_256spp_mega.json")
                         .read_text())
    traffic["render"].update(width=8, height=8, spp=2)
    (root / "benchmark" / "traffic" / "render_8_2spp_mega.json").write_text(json.dumps(traffic))
    (root / "benchmark" / "metrics" / "images_done.py").write_text(
        "def read(run):\n    return float(len(run.window.ends))\n")
    bench["configs"].append(dict(bench["configs"][0], name="jade_small",
                                 file="benchmark/configs/jade_small.json"))
    bench["workloads"].append({"name": "jade_small.tile", "config": "jade_small",
                               "traffic": "render_8_2spp_mega", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "images_done", "unit": "images", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["jade_small.tile"]})
    for m in bench["end_to_end"]:
        if m["name"] == "render_msamples_s":
            m["workloads"].append("jade_small.tile")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = run_cell(root, "jade_small.tile", capsys)
    assert res["correct"] is True
    assert res["metrics"]["images_done"]["value"] >= 1
    assert set(res["metrics"]) == {"images_done", "render_msamples_s", "setup_s"}


def _profile(events, window):
    """A stand-in for a torch.profiler profile: device events (name, start,
    end in us) and the window span."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, lo, hi, kind):
        return types.SimpleNamespace(name=name, device_type=kind,
                                     time_range=types.SimpleNamespace(start=lo, end=hi))

    evs = [ev(n, lo, hi, cuda) for n, lo, hi in events]
    evs.append(ev(profiling.WINDOW, *window, cpu))
    # the profiler lists the host's spans again as device-side annotations
    evs.append(ev(profiling.WINDOW, *window, cuda))
    evs.append(ev("benchmark.finish", 600.0, 900.0, cpu))
    return types.SimpleNamespace(events=lambda: evs)


def test_idle_share_on_a_synthetic_trace():
    # window 0..1000 us; kernels 0-300 and 200-500 overlap (busy 500), a
    # copy 950-1000 (busy 50), a kernel 990-1100 clipped at 1000
    prof = _profile([("k1", 0.0, 300.0), ("k2", 200.0, 500.0),
                     ("Memcpy DtoH", 950.0, 1000.0), ("k1", 990.0, 1100.0)], (0.0, 1000.0))
    tr = profiling.read(prof)
    assert tr.window_s == pytest.approx(1e-3)
    assert tr.busy_s == pytest.approx(550e-6)
    assert tr.idle_share == pytest.approx(0.45)
    assert tr.kernel_s == pytest.approx((300 + 300 + 10) * 1e-6)
    assert tr.copies_s == pytest.approx(50e-6)
    assert tr.top_kernels()[0] == ["k1", pytest.approx(310e-6)]
    # the idle gap 500-950 (its midpoint inside the host's finish span)
    assert tr.top_gaps()[0] == ["benchmark.finish", pytest.approx(450e-6)]
    assert profiling.read(_profile([], (0.0, 1.0))) is None


def test_frame_p95_and_rates_on_a_synthetic_window():
    ends = list(np.cumsum([1e-3] * 95 + [10e-3] * 5))
    starts = [0.0] + ends[:-1]
    w = Window(t0=0.0, ends=ends, starts=starts, samples=[100] * 100, bound_s=1e-3,
               counters={}, kept={})
    r = run.Run(cell=None, window=w, trace=None, setup_s=1.0, scene_build_s=0.1)
    p95 = cells.reader("preview_frame_p95_ms")(r)
    assert p95 == pytest.approx(float(np.percentile([1.0] * 95 + [10.0] * 5, 95)))
    assert cells.reader("render_msamples_s")(r) == pytest.approx(1e4 / 0.145 / 1e6)
    assert cells.reader("device_idle_pct.mega")(r) is None  # no trace: nothing to read
    assert cells.reader("mega_roofline")(r) is None
    r.trace = profiling.Trace(window_s=0.2, busy_s=0.05, kernels=[("k", 0.04)], copies_s=0.0,
                              gaps=[])
    assert cells.reader("device_idle_pct.preview")(r) == pytest.approx(75.0)
    assert cells.reader("preview_roofline")(r) == pytest.approx(2.5)


def test_roofline_arithmetic():
    # 1 GB at 3.35 TB/s against 1 GFLOP at 67 TFLOP/s: bytes bind
    assert roofline.bound_s(1e9, 1e9) == pytest.approx(1e9 / 3.35e12)
    assert roofline.bound_s(1e3, 67e9) == pytest.approx(1e-3)
    assert roofline.scene_bytes(10, 4) == 10 * 64 + 4 * 12


@pytest.mark.parametrize("workload", ["jade_offline.mega_1024", "jade_offline.pool_1024",
                                      "jade_offline.mega_256", "jade_preview.orbit"])
def test_last_line_keys(tiny, capsys, workload):
    res = run_cell(tiny, workload, capsys)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    cell = cells.load(workload, tiny)
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert set(res["checks"]) == {"pixel_off_share", "u8_off_share"}
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]


def test_traced_line_reports_per_layer_metrics(tiny, capsys):
    res = run_cell(tiny, "jade_preview.orbit", capsys, trace="1")
    # the CPU has no device trace: only the host-clock per-layer metrics
    assert set(res["metrics"]) == {"scene_build_s"}


def test_one_reader_serves_the_names_a_quantity_is_split_into(tmp_path):
    metrics = ROOT / "benchmark" / "metrics"
    assert cells.reader_path("render_msamples_s.pool") == metrics / "render_msamples_s.py"
    assert cells.reader_path("device_idle_pct.preview") == metrics / "device_idle_pct.py"
    assert cells.reader_path("pool_roofline") == metrics / "roofline.py"
    assert cells.reader_path("mega_roofline.tile") == metrics / "roofline.py"
    # a reader of the split name's own, added later, is taken first
    root = tmp_path / "root"
    shutil.copytree(metrics, root / "benchmark" / "metrics")
    (root / "benchmark" / "metrics" / "device_idle_pct.pool.py").write_text(
        "def read(run):\n    return 1.0\n")
    assert cells.reader("device_idle_pct.pool", root)(None) == 1.0
    assert cells.reader_path("device_idle_pct.mega", root).name == "device_idle_pct.py"
    with pytest.raises(FileNotFoundError):
        cells.reader_path("no_such_metric.x")


def test_same_seed_same_inputs():
    from benchmark import seeds
    from benchmark.clients import preview

    t = {"orbit_deg": 20.0, "max_up_deg": 60.0}
    assert preview.orbit_keys(SEED, t, 0.0, 0.0) == preview.orbit_keys(SEED, t, 0.0, 0.0)
    assert all(abs(up) <= 60.0 for _, up, _ in preview.orbit_keys(SEED, t, 0.0, 0.0))
    assert seeds.derive(SEED, "image", 3) == seeds.derive(SEED, "image", 3)
    assert seeds.derive(SEED, "image", 3) != seeds.derive(SEED + 1, "image", 3)
    assert 0 <= seeds.derive(2 ** 40, "x") < 2 ** 31


# ---- faults the comparison has to catch ----------------------------------------

def _fault_unchanged(monkeypatch):
    """A step that returns its state unchanged: the film comes back as it
    went in (fresh films stay zero; a preview frame adds nothing)."""
    from benchmark import program

    def render_film(sd, cam, cfg, film=None, stats=None, **kw):
        f = program.Film.create(cfg.height, cfg.width, sd.device)
        if stats is not None:
            stats["rays"] = stats.get("rays", 0.0)
        return program.Film(f.accum, cfg.spp)

    real = program.render.render_film_preview

    def preview(sd, cam, cfg, film=None, display=False, frame_idx=None):
        out = real(sd, cam, cfg.replace(spp=0), film, display, frame_idx)
        return out

    monkeypatch.setattr(program.render, "render_film", render_film)
    monkeypatch.setattr(program.render, "render_film_preview", preview)


def _fault_half(monkeypatch):
    """Half of the batch left out, the mean taken over the rest: half the
    samples rendered, the film counting them as all."""
    from benchmark import program

    real = program.render.render_film
    real_p = program.render.render_film_preview

    def render_film(sd, cam, cfg, film=None, stats=None, **kw):
        f = real(sd, cam, cfg.replace(spp=max(1, cfg.spp // 2)), film, stats=stats)
        return program.Film(f.accum * 2.0, cfg.spp)

    def preview(sd, cam, cfg, film=None, display=False, frame_idx=None):
        # every other band skipped: half of the pixels get no samples
        if frame_idx is not None and frame_idx % 2:
            return real_p(sd, cam, cfg.replace(spp=0), film, display, frame_idx)
        return real_p(sd, cam, cfg, film, display, frame_idx)

    monkeypatch.setattr(program.render, "render_film", render_film)
    monkeypatch.setattr(program.render, "render_film_preview", preview)


def _fault_altered(monkeypatch):
    """An answer altered where it is produced: each film's sums scaled by
    1.001 as the render returns them; each displayed frame's u8 raised by
    two levels where it is made."""
    from benchmark import program

    real = program.render.render_film
    real_p = program.render.render_film_preview

    def render_film(sd, cam, cfg, film=None, stats=None, **kw):
        f = real(sd, cam, cfg, film, stats=stats)
        return program.Film(f.accum * 1.001, f.count)

    def preview(sd, cam, cfg, film=None, display=False, frame_idx=None):
        f, disp = real_p(sd, cam, cfg, film, display, frame_idx)
        return f, torch.clamp(disp.to(torch.int32) + 2, 0, 255).to(torch.uint8)

    monkeypatch.setattr(program.render, "render_film", render_film)
    monkeypatch.setattr(program.render, "render_film_preview", preview)


@pytest.mark.parametrize("fault", [_fault_unchanged, _fault_half, _fault_altered],
                         ids=["state-unchanged", "half-left-out", "answer-altered"])
@pytest.mark.parametrize("workload", ["jade_offline.mega_1024", "jade_preview.orbit"])
def test_a_broken_timed_path_is_not_correct(tmp_path, capsys, monkeypatch, fault, workload):
    # a view that sees the statue and the light, so every fault changes pixels
    root = tiny_root(tmp_path / "root")
    for f in (root / "benchmark" / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        c["camera"].update(r=1.2, up_deg=10.0)
        f.write_text(json.dumps(c))
    for f in (root / "benchmark" / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        t["check"]["pixels"] = 256
        f.write_text(json.dumps(t))
    fault(monkeypatch)
    res = run_cell(root, workload, capsys, seconds="0.5")
    assert res["correct"] is False, res["checks"]


def test_the_limits_lie_between_their_readings():
    """Each limit in the traffic files lies between what sound runs read
    and what the control reads (PERF.md gives the readings): a few pixels
    of sound runs may take another branch; the control moves most."""
    for f in (ROOT / "benchmark" / "traffic").glob("*.json"):
        lim = json.loads(f.read_text())["check"]["limits"]
        assert set(lim) == {"pixel_off_share", "u8_off_share"}, f.name
        assert 0 < lim["pixel_off_share"] <= 0.2 and 0 < lim["u8_off_share"] <= 0.05, f.name


def test_verdict():
    ok, checks = check.verdict({"a": 1e-7, "b": 0.0}, {"a": 1e-5, "b": 0.0})
    assert ok and checks["a"] == {"value": 1e-7, "limit": 1e-5}
    assert not check.verdict({"a": float("nan")}, {"a": 1.0})[0]
    assert not check.verdict({"a": 2.0}, {"a": 1.0})[0]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell runs the port's CUDA kernels")


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(card):
    res = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "jade_preview.orbit", "--seed", str(SEED), "--seconds", "2",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
