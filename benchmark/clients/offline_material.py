"""The framed offline client (``clients/offline_framed.py``) on a scene
whose materials the configuration changes: ``materials`` maps an
object's name to the fields of its ``benchmark.scene.Material`` to
replace, as a user of the reference picks each object's material in its
hard-coded scene block (PathTrace.cpp:981-1068). The client applies them
to the raw scene before anything reads it, frees the program's scene and
builds it again from the changed raw scene (``program.build_scene``); the
reference then builds its tables from the same raw scene. An object or
a field the scene does not have raises.

After the window, where the program's recorder counted the megakernel's
marches (a traced run), the earlier lines also give ``counter
refract_share_pct``: 100 x the bounces whose branch is direct refraction
over every bounce, and ``counter march_steps_per_refract``: the march's
traces (each one walk) a direct refraction bounce."""

from __future__ import annotations

import dataclasses

import torch

from .. import program
from . import Window, offline_framed


def apply_materials(raw, materials: dict) -> None:
    """Replace the fields ``materials`` gives ({object: {field: value}}) in
    the materials of ``raw``'s objects."""
    objects = {o.name: o for o in raw.objects}
    for name, fields in materials.items():
        if name not in objects:
            raise KeyError(f"no object {name!r} in the scene (have {sorted(objects)})")
        o = objects[name]
        o.material = dataclasses.replace(o.material, **fields)


class Client(offline_framed.Client):
    def __init__(self, ctx):
        apply_materials(ctx.raw, ctx.config["materials"])
        ctx.sd = None  # the first scene is freed before the second is built
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        ctx.sd = program.build_scene(ctx.raw, ctx.device)
        super().__init__(ctx)

    def window(self, seconds: float, seed: int) -> Window:
        win = super().window(seconds, seed)
        found = offline_framed._counters()
        bounces, refract = found.get("ops.mega.bounces"), found.get("ops.mega.refract_bounces")
        steps = found.get("ops.mega.march_steps")
        if bounces and refract is not None:
            win.counters["refract_share_pct"] = 100.0 * refract / bounces
        if refract and steps is not None:
            win.counters["march_steps_per_refract"] = steps / refract
        return win
