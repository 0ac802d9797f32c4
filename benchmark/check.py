"""The comparisons that decide ``correct``: the program's outputs against
the plain reference's, number by number, each against its limit.

- ``pixel_off_share``: the share of compared pixels whose film sums
  differ from the reference's by more than ``RTOL`` of the sum (plus
  ``ATOL`` of the largest sum) in any channel. Both sides draw the same
  keyed samples, so a pixel differs by rounding alone (about 1e-6) unless
  one of its paths took another branch: the program walks its BVH, the
  reference finds the nearest of all triangles by its own clusters, and
  a ray that grazes an edge or a box can meet another triangle on one
  side than on the other, after which that path differs. Such pixels
  are few; a wrong render moves nearly all of them.
- ``u8_off_share``: the share of compared u8 channel values of the
  displayed image that differ from the reference's display of its own
  film by more than one level (one level is rounding at a level's edge).

The limits live in the traffic file (``check.limits``); PERF.md gives
the readings each was set from."""

from __future__ import annotations

import numpy as np
import torch

from .reference import camera as ref_camera, pathtrace

RTOL, ATOL = 1e-4, 1e-6
PILOT_PIXELS = 16  # statue pixels that choose the order of the light slots


def pixel_off_share(prog, ref) -> float:
    p = np.asarray(prog, np.float64)
    r = np.asarray(ref, np.float64)
    if not np.isfinite(p).all():
        return 1.0
    tol = RTOL * np.abs(r) + ATOL * float(np.abs(r).max())
    return float(np.mean((np.abs(p - r) > tol).any(axis=-1)))


def rel_rmse(prog, ref) -> float:
    p = np.asarray(prog, np.float64)
    r = np.asarray(ref, np.float64)
    scale = float(np.abs(r).max()) if r.size else 0.0
    if not np.isfinite(p).all():
        return float("inf")
    return float(np.sqrt(np.mean((p - r) ** 2)) / max(scale, 1e-30))


def u8_off_share(prog, ref) -> float:
    d = np.abs(np.asarray(prog, np.int32) - np.asarray(ref, np.int32))
    return float(np.mean(d > 1))


def object_pixels(points: np.ndarray, cam, width: int, height: int) -> np.ndarray:
    """Flat ids of the film pixels inside the screen box of ``points``
    [N, 3] (an object's vertices) seen from ``cam`` (eye, camera_rotate
    as ``reference.camera.orbit`` gives them); empty where the object is
    not in front of the camera. A direction's camera coordinates are its
    dot products with camera_rotate's first three columns, and a primary
    ray's film plane lies at z = -1.5 (PathTrace.cu:1430-1435)."""
    eye, rot = (np.asarray(a, np.float64) for a in cam)
    d = np.asarray(points, np.float64) - eye
    x, y, z = d @ rot[0, :3], d @ rot[1, :3], d @ rot[2, :3]
    if not (z < 0).all():
        return np.zeros(0, np.int64)
    px = (1.5 * x / -z + 1.0) * width / 2.0
    py = (1.5 * y / -z + 1.0) * height / 2.0
    x0, x1 = max(int(np.floor(px.min())) - 1, 0), min(int(np.ceil(px.max())) + 1, width)
    y0, y1 = max(int(np.floor(py.min())) - 1, 0), min(int(np.ceil(py.max())) + 1, height)
    if x0 >= x1 or y0 >= y1:
        return np.zeros(0, np.int64)
    ys, xs = np.meshgrid(np.arange(y0, y1), np.arange(x0, x1), indexing="ij")
    return (ys * width + xs).ravel()


def object_hit_pixels(raw, name: str, cam, width: int, height: int, t) -> np.ndarray:
    """The pixels inside the screen box of the object ``name`` whose first
    primary ray (sample 0) meets that object, found by the reference (its
    tables ``t`` of ``raw``)."""
    box = object_pixels(raw.vertices(name), cam, width, height)
    if not len(box):
        return box
    pix = torch.as_tensor(box, device=t.obj.device)
    o, d = ref_camera.primary_rays(cam, width, height, pix, torch.zeros_like(pix), 0)
    hit, idx, _ = pathtrace.nearest(t, o, d, torch.full_like(pix, -1))
    obj = [o.name for o in raw.objects].index(name)
    return box[(hit & (t.obj[idx] == obj)).cpu().numpy()]


def pixels(npix: int, count: int, gen, focus=None):
    """``count`` distinct flat pixel ids drawn from ``gen``: half of them
    among ``focus`` (the pixels that see the statue, so that its SSS,
    mirror and light-sampling paths are compared, though it covers under
    1% of the film), the rest uniformly over the film -> (the ids,
    sorted; those drawn among ``focus``, in the order drawn)."""
    count = min(count, npix)
    first = np.zeros(0, np.int64)
    if focus is not None and len(focus):
        first = gen.choice(np.asarray(focus), size=min(count // 2, len(focus)), replace=False)
    rest = np.setdiff1d(np.arange(npix), first)
    more = gen.choice(rest, size=count - len(first), replace=False)
    return np.sort(np.concatenate([first, more])), first


def light_order(t, cfg, cam, pix: torch.Tensor, spp: int, seed: int, prog_sums) -> tuple:
    """The order of the light triangles over the program's light slots.
    PathTrace.cu numbers its lights in the order its BVH leaves them,
    which a reference without that BVH cannot know: a few statue pixels
    (``pix``; their program sums ``prog_sums``) of one compared image are
    rendered under each order, and the order the program agrees with is
    kept for every image of the run -> (order, {order: rel_rmse})."""
    readings = {}
    for order in pathtrace.light_orders(t):
        ref = pathtrace.render_pixels(t, cfg, cam, pix, spp, seed, order)
        readings[order] = rel_rmse(prog_sums, ref.float().cpu().numpy())
    return min(readings, key=readings.get), readings


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}}); a
    number that is not finite fails."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = all(np.isfinite(v) and v <= limits[k] for k, v in numbers.items())
    return bool(ok), checks
