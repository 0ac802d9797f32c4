"""The port's spans and counters (``utils/logging.py``) and the
benchmark's readers of them (``benchmark/spans.py``,
``benchmark/metrics/``), on the CPU with the plain versions: the jade
scene at 300 statue triangles, 4x4, 2 spp, depth 4 (the profiler's
event list of a larger render takes seconds to read).

Nothing is recorded without an active torch.profiler; under one, a pool
render records one iteration span (with its sync child) an iteration
under one ``render_film`` span, the same ranges the profiler lists; a
preview frame records its frame span with the host camera, preview and
postfx children; an image's spans share its request's number;
``kernels.reset_launches`` clears the recorder; the
readers compute their metrics from a hand-built recorder and read
nothing from an empty one."""

import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import cells
from jaderaytracerendering_tpu_torch.integrator import pool as tpool
from jaderaytracerendering_tpu_torch.integrator import render as trender
from jaderaytracerendering_tpu_torch.models import demo as tdemo
from jaderaytracerendering_tpu_torch.ops import kernels
from jaderaytracerendering_tpu_torch.scene import scene as tscene
from jaderaytracerendering_tpu_torch.utils import logging as tlog
from jaderaytracerendering_tpu_torch.utils.config import RenderConfig as TConfig

torch.set_num_threads(1)

SIZE = dict(width=4, height=4, spp=2, spp_batch=2, max_depth=4)
FRAME = "integrator.render.render_film_preview"
FRAME_CHILDREN = ["integrator.mega.host_camera", "ops.mega.render_preview_mega",
                  "ops.postfx.postfx"]


@pytest.fixture(scope="module")
def scene():
    t = tdemo.jade_scene(n_buddha_tris=300, env_shape=(16, 32))
    t.camera.r = 2.0
    return t, tscene.assemble(t.objects, t.env_map, bvh_backend="numpy", device="cpu")


@pytest.fixture(autouse=True)
def _clean_recorder():
    tlog.reset()
    yield
    tlog.reset()


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        kernels.reset_launches()
        out = fn()
    return out, prof


def _children(spans, parent):
    return [s for s in spans if s.parent == parent]


def test_nothing_is_recorded_without_a_profiler(scene, monkeypatch):
    t, sd = scene

    def entered(*a, **k):
        raise AssertionError("a span was entered with no profiler active")

    monkeypatch.setattr(torch.profiler, "record_function", entered)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", entered)
    monkeypatch.setattr(tlog.RECORDER, "record", entered)
    monkeypatch.setattr(tlog.RECORDER, "count", entered)
    assert tlog.span("integrator.pool.iteration") is tlog.span("post.tonemap.finalize")
    stats = {}
    trender.render_image(sd, t.camera, TConfig(**SIZE, engine="pool"))
    tpool.render_film_pool(sd, t.camera, TConfig(**SIZE), stats=stats, pool_m=12)
    trender.render_film_preview(sd, t.camera, TConfig(**SIZE, preview_bands=4),
                                display=True, frame_idx=0)
    assert stats["iterations"] > 1
    assert tlog.spans() == [] and tlog.counters() == {}


def test_pool_render_spans_nest_as_the_profiler_lists_them(scene):
    t, sd = scene
    stats = {}
    _, prof = _profiled(lambda: trender.render_film(sd, t.camera,
                                                    TConfig(**SIZE, engine="pool"), stats=stats))
    spans = tlog.spans()
    tops = _children(spans, -1)
    assert [s.name for s in tops] == ["integrator.render.render_film"]
    top = spans.index(tops[0])
    iters = [i for i, s in enumerate(spans) if s.name == "integrator.pool.iteration"]
    assert len(iters) == stats["iterations"] > 1
    assert all(spans[i].parent == top for i in iters)
    for i in iters:
        assert [s.name for s in _children(spans, i)] == ["integrator.pool.sync"]
    assert {s.item for s in spans} == {0}
    assert all(s.start <= s.end for s in spans)
    assert all(spans[s.parent].start <= s.start and s.end <= spans[s.parent].end
               for s in spans if s.parent >= 0)
    events = {}
    for e in prof.events():
        events.setdefault(e.name, []).append(e)
    assert len(events["integrator.render.render_film"]) == 1
    assert len(events["integrator.pool.iteration"]) == stats["iterations"]
    assert all(e.cpu_parent.name == "integrator.render.render_film"
               for e in events["integrator.pool.iteration"])
    assert len(events["integrator.pool.sync"]) == stats["iterations"]
    assert all(e.cpu_parent.name == "integrator.pool.iteration"
               for e in events["integrator.pool.sync"])


@pytest.mark.parametrize("pool_m,rounds", [(12, 1), (12, 2), (32, 1)])
def test_live_lanes_never_exceed_lane_slots(scene, monkeypatch, pool_m, rounds):
    """Per iteration 0 <= live <= M, and the counters sum the iterations;
    12 lanes do not divide the 32 samples, so the last spawns cut the
    queue."""
    t, sd = scene
    seen = []

    def count(name, n):
        seen.append((name, n))
        tlog.count(name, n)

    monkeypatch.setattr(tpool, "count", count)
    stats = {}
    _profiled(lambda: tpool.render_film_pool(sd, t.camera, TConfig(**SIZE, spawn_rounds=rounds),
                                             stats=stats, pool_m=pool_m))
    live = [n for k, n in seen if k == "pool.live_lanes"]
    slots = [n for k, n in seen if k == "pool.lane_slots"]
    assert len(live) == len(slots) == stats["iterations"]
    assert all(0 <= a <= b == pool_m for a, b in zip(live, slots))
    assert live[-1] == 0 and max(live) > 0
    assert tlog.counters() == {"pool.live_lanes": sum(live), "pool.lane_slots": sum(slots)}


@pytest.mark.parametrize("bands", [1, 4])
def test_a_preview_frame_records_its_host_path(scene, bands):
    t, sd = scene
    cfg = TConfig(**SIZE, engine="mega", preview_bands=bands)
    (film, disp), prof = _profiled(lambda: trender.render_film_preview(
        sd, t.camera, cfg, display=True, frame_idx=0))
    assert disp.dtype == torch.uint8
    spans = tlog.spans()
    assert [s.name for s in _children(spans, -1)] == [FRAME]
    assert [s.name for s in _children(spans, 0)] == FRAME_CHILDREN
    assert len(spans) == 4 and {s.item for s in spans} == {0}
    names = [e.name for e in prof.events()]
    assert all(names.count(n) == 1 for n in [FRAME, *FRAME_CHILDREN])


def test_spans_are_numbered_by_request_and_reset_clears_them(scene):
    """An image's tone map, a top-level span of its own, carries the
    number of the image's ``render_film``; a span before any request
    carries -1, and a request span inside another starts no request."""
    t, sd = scene
    cfg = TConfig(**SIZE, engine="pool")

    def two_images():
        with tlog.span("post.tonemap.finalize"):
            pass
        trender.render_image(sd, t.camera, cfg)
        trender.render_image(sd, t.camera, cfg)
        trender.render_film(sd, t.camera, TConfig(**SIZE, integrator="preview"))

    _profiled(two_images)
    spans = tlog.spans()
    tops = _children(spans, -1)
    assert [(s.name, s.item) for s in tops] == [
        ("post.tonemap.finalize", -1),
        ("integrator.render.render_film", 0), ("post.tonemap.finalize", 0),
        ("integrator.render.render_film", 1), ("post.tonemap.finalize", 1),
        ("integrator.render.render_film", 2)]
    assert all(s.item == spans[s.parent].item for s in spans if s.parent >= 0)
    assert [s.item for s in spans if s.name == FRAME] == [2]
    assert tlog.counters()["pool.lane_slots"] > 0
    kernels.LAUNCHES["postfx"] = 3
    kernels.reset_launches()
    assert tlog.spans() == [] and tlog.counters() == {}
    assert set(kernels.LAUNCHES.values()) == {0}


def _span(name, start_us, end_us, parent=-1, item=0):
    return tlog.Span(name, start_us * 1e-6, end_us * 1e-6, parent=parent, item=item)


def _hand_built() -> tlog.Recorder:
    rec = tlog.Recorder()
    rec.spans = [
        _span("integrator.render.render_film", 0, 1000),            # 0
        _span("integrator.pool.iteration", 0, 100, 0),               # 1
        _span("integrator.pool.sync", 40, 100, 1),                   # 2: self 40
        _span("integrator.pool.iteration", 100, 300, 0),             # 3
        _span("integrator.pool.sync", 250, 300, 3),                  # 4: self 150
        _span("integrator.pool.sync", 400, 500, 0),                  # 5: no iteration's
        _span("post.tonemap.finalize", 1000, 31000, item=1),        # 30 ms
        _span("post.tonemap.finalize", 40000, 90000, item=2),       # 50 ms
    ]
    rec.spans += [_span(FRAME, 1e5 + 1e4 * k, 1e5 + 1e4 * k + 1e3 * k, item=3 + k)
                  for k in range(1, 21)]                              # 1 .. 20 ms
    rec.counters = {"pool.live_lanes": 300, "pool.lane_slots": 400}
    return rec


READINGS = {"tonemap_ms": 40.0, "tonemap_ms.pool": 40.0, "pool_host_us": 95.0,
            "pool_lane_use_pct": 75.0, "preview_host_ms": float(np.percentile(
                np.arange(1, 21), 95))}


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_reader_on_a_hand_built_recorder(monkeypatch, metric):
    monkeypatch.setattr(tlog, "RECORDER", _hand_built())
    run = types.SimpleNamespace(trace=object())
    assert cells.reader(metric)(run) == pytest.approx(READINGS[metric], rel=1e-9)


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_reader_reads_nothing_where_nothing_was_recorded(monkeypatch, metric):
    read = cells.reader(metric)
    traced = types.SimpleNamespace(trace=object())
    assert read(traced) is None  # an empty recorder
    monkeypatch.setattr(tlog, "RECORDER", _hand_built())
    assert read(types.SimpleNamespace(trace=None)) is None  # no device trace
    monkeypatch.delattr(tlog, "spans")  # a program without the recorder
    assert read(traced) is None
