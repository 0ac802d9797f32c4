"""The interactive preview left running on one view: the preview client's
frame loop (``clients/preview.py``: each frame
``render.render_film_preview(..., display=True, frame_idx=...)``, its u8
image copied to pinned host memory on a side stream, the previous
frame's copy waited for) with no camera command, so one film at the
configuration's camera accumulates for the whole window and the band
counter never starts again. The warm-up renders ``first_frames`` + 2 x
bands frames on a film of its own, then drops it.

The comparison: one frame drawn from the seed among the first
``first_frames`` and the window's last frame, whose film holds every
sample of the window (about 14,000 a pixel in a 50 s window at ~0.86 ms
a frame and 4 bands), at ``check.pixels`` pixels drawn from the seed: the
displayed u8 values against the reference's display of its own film,
and the last frame's float32 film sums against the reference's, added
in sample order as the film adds them (``clients/preview.py``)."""

from __future__ import annotations

import time

import torch

from .. import program, seeds
from ..profiling import WINDOW
from . import Window, preview


class Client(preview.Client):
    def __init__(self, ctx):
        super().__init__(ctx)
        self.first_frames = ctx.traffic["first_frames"]

    def _loop(self, frames: int | None, seconds: float | None, seed: int, keep_frame=None):
        """The CLI's frame loop on one film for ``frames`` frames or
        ``seconds``, with no camera command."""
        dev, sd = self.ctx.device, self.ctx.sd
        up, rot = self.ctx.config["camera"]["up_deg"], self.ctx.config["camera"]["rotate_deg"]
        cfg = self.frame_cfg.replace(seed=seeds.derive(seed, "preview"))
        cam = self._camera(up, rot)
        film = program.Film.create(self.cfg.height, self.cfg.width, dev)
        display = preview._Display(dev)
        pending = None
        frame = 0
        ends, kept = [], {}
        t0 = time.perf_counter()
        while True:
            with torch.profiler.record_function("benchmark.frame"):
                film, disp = program.render.render_film_preview(sd, cam, cfg, film=film,
                                                                display=True, frame_idx=frame)
                handle = display.submit(disp)
            with torch.profiler.record_function("benchmark.wait"):
                display.wait(pending if pending is not None else handle)
            pending = handle
            if frame == keep_frame:
                kept["first"] = (frame, frame, up, rot, handle)
            frame += 1
            ends.append(time.perf_counter())
            if (frames is not None and frame >= frames) or \
                    (seconds is not None and ends[-1] - t0 >= seconds):
                break
        kept["last"] = (frame - 1, frame - 1, up, rot, pending, film)
        return t0, ends, kept, cfg.seed

    def warm_up(self) -> None:
        _, _, kept, _ = self._loop(self.first_frames + self.bands * 2, None,
                                   seeds.derive(0, "warm-up"))
        preview._Display.wait(kept["last"][4])

    def window(self, seconds: float, seed: int) -> Window:
        first = int(seeds.rng(seed, "first frame").integers(self.first_frames))
        program.reset_launches()
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize()
        with torch.profiler.record_function(WINDOW):
            t0, ends, kept, rseed = self._loop(None, seconds, seed, keep_frame=first)
        kept["render_seed"] = rseed
        n = len(ends)
        return Window(t0=t0, ends=ends, starts=[t0] + ends[:-1],
                      samples=[self.npix // self.bands * self.frame_cfg.spp] * n,
                      bound_s=self.frame_bound_s * n,
                      counters={"launches": program.launches()}, kept=kept, attempted=n)
