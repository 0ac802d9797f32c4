"""The offline renderer's client: a closed loop with one client, each
job one image of the traffic's film size and samples per pixel, rendered
into a fresh film and finished on the host as the render CLI finishes it
(``render.render_film``, the film's mean copied to the host, then
``post.tonemap.finalize``; the file write left out). Image k draws its
samples under the render seed ``seeds.derive(seed, "image", k)``.

The comparison: one image drawn from the seed among the first
``check.first_images`` and the window's last image, at ``check.pixels``
pixels drawn from the seed; their film sums and u8 values against the
reference's, which renders those pixels' samples again."""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .. import check, program, roofline, seeds
from ..profiling import WINDOW
from ..reference import camera as ref_camera, pathtrace, post
from . import Window


class Client:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = program.render_config(ctx.settings)
        cam = ctx.config["camera"]
        self.cam = program.OrbitCamera(up_angle=cam["up_deg"], rotate_angle=cam["rotate_deg"],
                                       r=cam["r"])
        self.npix = self.cfg.width * self.cfg.height
        self.samples = self.npix * self.cfg.spp
        t = ctx.traffic
        nbytes = (roofline.scene_bytes(ctx.raw.n_triangles, ctx.raw.env.size // 3)
                  + self.npix * 12)
        self.image_bound_s = roofline.bound_s(nbytes, self.samples * t["ops_per_sample"])

    def _image(self, seed: int, stats: dict):
        film = program.render.render_film(self.ctx.sd, self.cam, self.cfg.replace(seed=seed),
                                          stats=stats)
        with torch.profiler.record_function("benchmark.finish"):
            img = program.tonemap.finalize(film.mean().cpu().numpy()[::-1], self.cfg.tonemap)
        return film, img

    def warm_up(self) -> None:
        self._image(seeds.derive(0, "warm-up"), {})

    def window(self, seconds: float, seed: int) -> Window:
        first = int(seeds.rng(seed, "first image").integers(
            self.ctx.traffic["check"]["first_images"]))
        program.reset_launches()
        stats, rays, kept = {}, [], {}
        starts, ends = [], []
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize()
        with torch.profiler.record_function(WINDOW):
            t0 = time.perf_counter()
            k = 0
            while time.perf_counter() - t0 < seconds:
                ts = time.perf_counter()
                before = stats.get("rays", 0.0)
                film, img = self._image(seeds.derive(seed, "image", k), stats)
                ends.append(time.perf_counter())
                starts.append(ts)
                rays.append(stats["rays"] - before)
                if k == first:
                    kept[k] = (film, img)
                kept["last"] = (k, film, img)
                k += 1
        counters = {"rays": rays, "iterations": stats.get("iterations"),
                    "launches": program.launches()}
        return Window(t0=t0, ends=ends, starts=starts, samples=[self.samples] * k,
                      bound_s=self.image_bound_s * k, counters=counters, kept=kept,
                      attempted=k)

    def _ref_camera(self):
        cam = self.ctx.config["camera"]
        return ref_camera.orbit(cam["up_deg"], cam["rotate_deg"], cam["r"])

    def keep(self, win: Window, seed: int) -> None:
        """Keep the compared pixels of the kept images on the host: their
        film sums, u8 values and sample counts."""
        spec = self.ctx.traffic["check"]
        focus = check.object_hit_pixels(self.ctx.raw, spec["focus"], self._ref_camera(),
                                        self.cfg.width, self.cfg.height,
                                        self.ctx.tables(torch.float32))
        pix, drawn = check.pixels(self.npix, spec["pixels"], seeds.rng(seed, "pixels"), focus)
        k_last, film_last, img_last = win.kept.pop("last")
        images = dict(win.kept)
        images[k_last] = (film_last, img_last)
        ys, xs = pix // self.cfg.width, pix % self.cfg.width
        idx = torch.as_tensor(pix, device=film_last.accum.device)
        win.kept = {"pixels": pix, "pilot": drawn[:check.PILOT_PIXELS], "outputs": {
            k: {"sums": film.accum.reshape(-1, 3)[idx].cpu().numpy(),
                "u8": img[self.cfg.height - 1 - ys, xs].copy(), "count": film.count}
            for k, (film, img) in images.items()}}

    def reference(self, win: Window, seed: int, dtype=torch.float32, order=None) -> dict:
        """The reference's outputs of the kept images ({image: {"sums",
        "u8", "count"}}) in ``dtype``, every image's pixels in one batch;
        the order of its light slots is ``order``, or, where None, the one
        the program's outputs agree with (``check.light_order`` on the
        first image's pilot pixels), kept in ``win.kept["order"]``."""
        cam = self._ref_camera()
        t = self.ctx.tables(dtype)
        s = self.ctx.settings
        cfg = {k: s[k] for k in ("width", "height", "max_depth", "rr_rate", "sss_rate",
                                 "hdr_clamp", "max_refract_bounces", "internal_reflect_rate")}
        pix = win.kept["pixels"]
        images = sorted(win.kept["outputs"])
        rseeds = [seeds.derive(seed, "image", k) for k in images]
        if order is None:
            pilot = win.kept["pilot"]
            if len(pilot):
                sums = win.kept["outputs"][images[0]]["sums"][np.searchsorted(pix, pilot)]
                order, readings = check.light_order(
                    t, cfg, cam, torch.as_tensor(pilot, device=self.ctx.device), self.cfg.spp,
                    rseeds[0], sums)
                print(f"light order {order} (readings "
                      f"{ {str(o): r for o, r in readings.items()} })", file=sys.stderr)
            else:
                order = pathtrace.light_orders(t)[0]
            win.kept["order"] = order
        all_pix = torch.as_tensor(np.tile(pix, len(images)), device=self.ctx.device)
        all_seeds = torch.as_tensor(np.repeat(rseeds, len(pix)), device=self.ctx.device)
        ref = pathtrace.render_pixels(t, cfg, cam, all_pix, self.cfg.spp, all_seeds, order)
        ref = ref.float().cpu().numpy().reshape(len(images), len(pix), 3)
        out = {}
        for k, r in zip(images, ref):
            count = win.kept["outputs"][k]["count"]
            out[k] = {"sums": r, "u8": post.finalize(r / np.float32(count)), "count": count}
        return out

    @staticmethod
    def compare(outputs: dict, refs: dict) -> dict:
        """The compared numbers, each the worst over the compared images."""
        film_off = max(check.pixel_off_share(outputs[k]["sums"], refs[k]["sums"]) for k in refs)
        u8_off = max(check.u8_off_share(outputs[k]["u8"], refs[k]["u8"]) for k in refs)
        return {"pixel_off_share": film_off, "u8_off_share": u8_off}
