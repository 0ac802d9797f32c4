"""Procedural meshes replacing the repo's missing demo assets.

The reference scene loads ``happyBuddha.obj``, ``light.obj`` and
``box.obj`` (PathTrace.cpp:1002, 1010, 1037) — none are shipped in the
repo. These generators produce deterministic equivalents: a unit box, a
light quad, UV/ico spheres, and a "buddha stand-in" (a displaced sphere
blob with a tunable triangle count for 100k+-triangle BVH benchmarks).
All outputs are (vertices [V,3] float64, faces [F,3] int64) ready for
``objloader.mesh_from_arrays`` or ``objloader.write_obj``.
"""

from __future__ import annotations

import numpy as np


def box() -> tuple[np.ndarray, np.ndarray]:
    """Unit cube centered at origin, 12 triangles, outward winding."""
    v = np.array(
        [
            [-0.5, -0.5, -0.5], [0.5, -0.5, -0.5], [0.5, 0.5, -0.5], [-0.5, 0.5, -0.5],
            [-0.5, -0.5, 0.5], [0.5, -0.5, 0.5], [0.5, 0.5, 0.5], [-0.5, 0.5, 0.5],
        ],
        np.float64,
    )
    f = np.array(
        [
            [0, 2, 1], [0, 3, 2],  # -z
            [4, 5, 6], [4, 6, 7],  # +z
            [0, 1, 5], [0, 5, 4],  # -y
            [3, 6, 2], [3, 7, 6],  # +y
            [0, 7, 3], [0, 4, 7],  # -x
            [1, 2, 6], [1, 6, 5],  # +x
        ],
        np.int64,
    )
    return v, f


def quad() -> tuple[np.ndarray, np.ndarray]:
    """Unit square in the XY plane (the light.obj stand-in), 2 triangles."""
    v = np.array(
        [[-0.5, -0.5, 0.0], [0.5, -0.5, 0.0], [0.5, 0.5, 0.0], [-0.5, 0.5, 0.0]],
        np.float64,
    )
    f = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
    return v, f


def uv_sphere(n_lat: int = 16, n_lon: int = 32) -> tuple[np.ndarray, np.ndarray]:
    """Unit-diameter UV sphere."""
    verts = [(0.0, 0.5, 0.0)]
    for i in range(1, n_lat):
        theta = np.pi * i / n_lat
        y = 0.5 * np.cos(theta)
        rad = 0.5 * np.sin(theta)
        for j in range(n_lon):
            phi = 2 * np.pi * j / n_lon
            verts.append((rad * np.cos(phi), y, rad * np.sin(phi)))
    verts.append((0.0, -0.5, 0.0))
    v = np.asarray(verts, np.float64)

    faces = []
    # top cap
    for j in range(n_lon):
        faces.append((0, 1 + (j + 1) % n_lon, 1 + j))
    # bands
    for i in range(n_lat - 2):
        a = 1 + i * n_lon
        b = 1 + (i + 1) * n_lon
        for j in range(n_lon):
            j2 = (j + 1) % n_lon
            faces.append((a + j, a + j2, b + j))
            faces.append((a + j2, b + j2, b + j))
    # bottom cap
    last = len(v) - 1
    a = 1 + (n_lat - 2) * n_lon
    for j in range(n_lon):
        faces.append((last, a + j, a + (j + 1) % n_lon))
    return v, np.asarray(faces, np.int64)


def _displaced_sphere(n_lat, n_lon, seed, amp=0.05):
    v, f = uv_sphere(n_lat, n_lon)
    rng = np.random.default_rng(seed)
    freqs = rng.uniform(1.5, 6.0, size=(8, 3))
    phases = rng.uniform(0, 2 * np.pi, size=8)
    amps = rng.uniform(0.4, 1.6, size=8) * amp
    p = v * 2.0
    disp = np.zeros(len(v))
    for k in range(8):
        disp += amps[k] * np.sin(
            p[:, 0] * freqs[k, 0] + p[:, 1] * freqs[k, 1]
            + p[:, 2] * freqs[k, 2] + phases[k]
        )
    return v * (1.0 + disp)[:, None], f


def _merge(parts):
    vs, fs, off = [], [], 0
    for v, f, scale, shift in parts:
        vv = v * np.asarray(scale)[None, :] + np.asarray(shift)[None, :]
        vs.append(vv)
        fs.append(f + off)
        off += len(vv)
    return np.concatenate(vs), np.concatenate(fs)


def buddha_standin(n_triangles: int = 100_000, seed: int = 7) -> tuple[np.ndarray, np.ndarray]:
    """Seated-statue stand-in with ~n_triangles triangles.

    A deterministic figure — broad displaced-sphere body, head, two
    shoulder lobes and a plinth — approximating happyBuddha.obj's
    silhouette and giving the BVH organic, concave geometry to chew on.
    """
    # body ~60% of the budget, head ~20%, shoulders ~8% each; fractions
    # sum to 0.89, so rescale to land on the requested count
    def latlon(frac, lo=6):
        n_lat = max(lo, int(np.sqrt(max(n_triangles, 200) * frac / 0.88 / 4.0)))
        return n_lat, 2 * n_lat

    body = _displaced_sphere(*latlon(0.55), seed=seed, amp=0.06)
    head = _displaced_sphere(*latlon(0.18), seed=seed + 1, amp=0.04)
    sh_l = _displaced_sphere(*latlon(0.08), seed=seed + 2, amp=0.05)
    sh_r = _displaced_sphere(*latlon(0.08), seed=seed + 3, amp=0.05)
    base = box()
    v, f = _merge([
        (body[0], body[1], (0.72, 0.60, 0.52), (0.0, -0.12, 0.0)),
        (head[0], head[1], (0.34, 0.38, 0.34), (0.0, 0.32, 0.02)),
        (sh_l[0], sh_l[1], (0.26, 0.22, 0.26), (-0.33, 0.05, 0.0)),
        (sh_r[0], sh_r[1], (0.26, 0.22, 0.26), (0.33, 0.05, 0.0)),
        (base[0], base[1], (0.95, 0.14, 0.72), (0.0, -0.42, 0.0)),
    ])
    # emit z-up like the real happyBuddha.obj: the demo scene applies the
    # reference's rotate(-90deg, x) (PathTrace.cpp:1002), which maps
    # (x, y, z) -> (x, z, -y); pre-rotate so the statue lands upright.
    v = np.stack([v[:, 0], -v[:, 2], v[:, 1]], axis=1)
    return v, f


def mesh_stats(v: np.ndarray, f: np.ndarray) -> str:
    return f"{len(v)} verts, {len(f)} tris"
