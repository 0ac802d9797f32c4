"""The interactive preview's client: the preview CLI's frame loop
(``cli/preview.py``), copied so that it runs without the CLI. Each frame
is ``render.render_film_preview(..., display=True, frame_idx=...)``; its
u8 image is copied to pinned host memory on a side stream, and the loop
waits for the previous frame's copy after queuing this frame's, as the
CLI's display does. Every ``orbit_every`` frames the user presses an
orbit key (up, down, left or right, drawn from the seed; up and down
turned round where they would pass ``max_up_deg``): the camera turns by
``orbit_deg`` and the film and the band counter start again.

The comparison: one frame drawn from the seed among the first
``orbit_every`` and the window's last frame, at ``check.pixels`` pixels
drawn from the seed: the displayed u8 values against the reference's
display of its own film, and the last frame's film sums against the
reference's."""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import check, program, roofline, seeds
from ..profiling import WINDOW
from ..reference import camera as ref_camera, post, preview as ref_preview
from . import Window

KEYS = {"up": (1, 0), "down": (-1, 0), "left": (0, 1), "right": (0, -1)}
N_KEYS = 1 << 13  # camera commands drawn for one window, more than a window uses


class _Display:
    """The CLI's pipelined display (cli/preview._Display)."""

    def __init__(self, device):
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def submit(self, disp):
        if self.stream is None:
            return disp, None
        ready = torch.cuda.Event()
        ready.record()
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(ready)
            host = torch.empty(disp.shape, dtype=disp.dtype, pin_memory=True)
            host.copy_(disp, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        disp.record_stream(self.stream)
        return host, done

    @staticmethod
    def wait(handle):
        host, done = handle
        if done is not None:
            done.synchronize()
        return host


def orbit_keys(seed: int, traffic: dict, up: float, rot: float) -> list:
    """The window's camera commands: (key, up angle, rotate angle) after
    each, from the starting angles ``up`` and ``rot``."""
    names = list(KEYS)
    draws = seeds.rng(seed, "orbit keys").integers(len(names), size=N_KEYS)
    step, top = traffic["orbit_deg"], traffic["max_up_deg"]
    out = []
    for d in draws:
        key = names[d]
        du, dr = KEYS[key]
        if abs(up + du * step) > top:
            key, du = ("down" if du > 0 else "up"), -du
        up, rot = up + du * step, rot + dr * step
        out.append((key, up, rot))
    return out


class Client:
    def __init__(self, ctx):
        self.ctx = ctx
        s = ctx.settings
        self.cfg = program.render_config(s)
        self.frame_cfg = self.cfg.replace(spp=self.cfg.spp_batch)
        self.npix = self.cfg.width * self.cfg.height
        self.bands = self.cfg.preview_bands
        t = ctx.traffic
        band_px = self.npix // self.bands
        nbytes = (roofline.scene_bytes(ctx.raw.n_triangles, ctx.raw.env.size // 3)
                  + band_px * 12 + self.npix * 3)
        ops = band_px * self.frame_cfg.spp * t["ops_per_sample"] + self.npix * t["ops_per_pixel"]
        self.frame_bound_s = roofline.bound_s(nbytes, ops)

    def _camera(self, up, rot):
        return program.OrbitCamera(up_angle=up, rotate_angle=rot, r=self.ctx.config["camera"]["r"])

    def _loop(self, frames: int | None, seconds: float | None, seed: int, keep_frame=None):
        """The CLI's frame loop for ``frames`` frames or ``seconds``."""
        t = self.ctx.traffic
        dev, sd = self.ctx.device, self.ctx.sd
        up, rot = self.ctx.config["camera"]["up_deg"], self.ctx.config["camera"]["rotate_deg"]
        keys = orbit_keys(seed, t, up, rot)
        cfg = self.frame_cfg.replace(seed=seeds.derive(seed, "preview"))
        every = t["orbit_every"]
        cam = self._camera(up, rot)
        film = program.Film.create(self.cfg.height, self.cfg.width, dev)
        display = _Display(dev)
        pending = None
        bframe = frame = 0
        ends, kept = [], {}
        t0 = time.perf_counter()
        while True:
            with torch.profiler.record_function("benchmark.frame"):
                film, disp = program.render.render_film_preview(sd, cam, cfg, film=film,
                                                                display=True, frame_idx=bframe)
                handle = display.submit(disp)
            with torch.profiler.record_function("benchmark.wait"):
                display.wait(pending if pending is not None else handle)
            pending = handle
            if frame == keep_frame:
                kept["first"] = (frame, bframe, up, rot, handle)
            bframe += 1
            frame += 1
            ends.append(time.perf_counter())
            if (frames is not None and frame >= frames) or \
                    (seconds is not None and ends[-1] - t0 >= seconds):
                break
            if frame % every == 0:
                _, up, rot = keys[frame // every - 1]
                cam = self._camera(up, rot)
                film = program.Film.create(self.cfg.height, self.cfg.width, dev)
                bframe = 0
                pending = None
        kept["last"] = (frame - 1, bframe - 1, up, rot, pending, film)
        return t0, ends, kept, cfg.seed

    def warm_up(self) -> None:
        every = self.ctx.traffic["orbit_every"]
        _, _, kept, _ = self._loop(every + self.bands * 2, None, seeds.derive(0, "warm-up"))
        _Display.wait(kept["last"][4])

    def window(self, seconds: float, seed: int) -> Window:
        first = int(seeds.rng(seed, "first frame").integers(self.ctx.traffic["orbit_every"]))
        program.reset_launches()
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize()
        with torch.profiler.record_function(WINDOW):
            t0, ends, kept, rseed = self._loop(None, seconds, seed, keep_frame=first)
        kept["render_seed"] = rseed
        n = len(ends)
        starts = [t0] + ends[:-1]
        return Window(t0=t0, ends=ends, starts=starts,
                      samples=[self.npix // self.bands * self.frame_cfg.spp] * n,
                      bound_s=self.frame_bound_s * n,
                      counters={"launches": program.launches()}, kept=kept, attempted=n)

    def counts(self, bframe: int) -> np.ndarray:
        """Samples each pixel holds after banded frame ``bframe`` of a film."""
        band = np.arange(self.npix) // (self.npix // self.bands)
        n = (bframe - band) // self.bands + 1
        return np.where(bframe >= band, n, 0) * self.frame_cfg.spp

    def keep(self, win: Window, seed: int) -> None:
        """Keep the compared pixels of the kept frames on the host: their
        u8 values, the samples each pixel held and the camera, and the
        last frame's film sums. Each frame draws its own pixels, half of
        them in the statue's screen box under that frame's camera."""
        spec = self.ctx.traffic["check"]
        r = self.ctx.config["camera"]["r"]
        last = win.kept.pop("last")
        first = win.kept.pop("first", None)
        frames = {}
        for item in ([first] if first is not None and first[0] != last[0] else []) + [last]:
            frame, bframe, up, rot, handle = item[:5]
            focus = check.object_hit_pixels(self.ctx.raw, spec["focus"],
                                            ref_camera.orbit(up, rot, r), self.cfg.width,
                                            self.cfg.height, self.ctx.tables(torch.float32))
            pix, _ = check.pixels(self.npix, spec["pixels"], seeds.rng(seed, "pixels", frame),
                                  focus)
            ys, xs = pix // self.cfg.width, pix % self.cfg.width
            u8 = _Display.wait(handle)
            if isinstance(u8, torch.Tensor):
                u8 = u8.cpu().numpy()
            frames[frame] = {"pixels": pix, "counts": self.counts(bframe)[pix], "up": up,
                             "rot": rot, "u8": u8[self.cfg.height - 1 - ys, xs].copy()}
        film = last[5]
        pix = frames[last[0]]["pixels"]
        idx = torch.as_tensor(pix, device=film.accum.device)
        frames[last[0]]["sums"] = film.accum.reshape(-1, 3)[idx].cpu().numpy()
        win.kept = {"outputs": frames, "render_seed": win.kept["render_seed"]}

    def reference(self, win: Window, seed: int, dtype=torch.float32, order=None) -> dict:
        """The reference's outputs of the kept frames ({frame: {"sums",
        "u8"}}) in ``dtype`` (the preview has no light slots: ``order`` is
        not used)."""
        t = self.ctx.tables(dtype)
        s = self.ctx.settings
        cfg = {k: s[k] for k in ("width", "height", "preview_bounces", "hdr_clamp")}
        out = {}
        for frame, f in sorted(win.kept["outputs"].items()):
            pix = torch.as_tensor(f["pixels"], device=self.ctx.device)
            counts = torch.as_tensor(f["counts"], device=self.ctx.device)
            cam = ref_camera.orbit(f["up"], f["rot"], self.ctx.config["camera"]["r"])
            ref = ref_preview.render_pixels(t, cfg, cam, pix, counts, win.kept["render_seed"])
            out[frame] = {"sums": ref.float().cpu().numpy(),
                          "u8": post.display(ref.float(), counts).cpu().numpy()}
        return out

    @staticmethod
    def compare(outputs: dict, refs: dict) -> dict:
        """The compared numbers: u8 over every kept frame, film sums of the
        last frame (the one whose film the window left)."""
        film_off = max(check.pixel_off_share(outputs[k]["sums"], refs[k]["sums"])
                       for k in refs if "sums" in outputs[k])
        u8_off = max(check.u8_off_share(outputs[k]["u8"], refs[k]["u8"]) for k in refs)
        return {"pixel_off_share": film_off, "u8_off_share": u8_off}
