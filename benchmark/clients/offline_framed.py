"""The offline renderer's client at a framed shot: the offline client
(``clients/offline.py``) with the configuration's look-center, as the
reference's interactive app frames a shot before F writes
``render_args.txt`` (the eye orbits the origin at ``r``, ``up_deg`` and
``rotate_deg`` and looks at ``camera.center``; the origin where the
configuration gives none). The program's camera gets it as
``OrbitCamera.eye_center``, the reference's as ``camera_rotate(eye,
center)``; the loop, the kept images and the comparison are the offline
client's.

After the window, where the program's recorder counted the
megakernel's bounces (a traced run), the earlier lines also give
``counter bounces_per_sample`` and ``counter sss_share_pct``: 100 x the
bounces whose branch is SSS entry or exit over every bounce."""

from __future__ import annotations

import numpy as np

from ..reference import camera as ref_camera
from . import Window, offline


def _center(config: dict) -> np.ndarray:
    return np.asarray(config["camera"].get("center", (0.0, 0.0, 0.0)), np.float64)


def _counters() -> dict:
    """The program's counters over the window (empty where it has none)."""
    from jaderaytracerendering_tpu_torch.utils import logging as recorder

    return dict(recorder.counters()) if hasattr(recorder, "counters") else {}


class Client(offline.Client):
    def __init__(self, ctx):
        super().__init__(ctx)
        self.cam.eye_center = _center(ctx.config)

    def _ref_camera(self):
        cam = self.ctx.config["camera"]
        eye = ref_camera.eye(cam["up_deg"], cam["rotate_deg"], cam["r"])
        return (eye.astype(np.float32),
                ref_camera.camera_rotate(eye, _center(self.ctx.config)).astype(np.float32))

    def window(self, seconds: float, seed: int) -> Window:
        win = super().window(seconds, seed)
        found = _counters()
        bounces, sss = found.get("ops.mega.bounces"), found.get("ops.mega.sss_bounces")
        if bounces and sss is not None and win.samples:
            win.counters["bounces_per_sample"] = bounces / sum(win.samples)
            win.counters["sss_share_pct"] = 100.0 * sss / bounces
        return win
