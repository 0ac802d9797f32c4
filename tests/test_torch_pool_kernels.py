"""Port parity of the pool engine's kernels, through their plain versions
(what the wrappers run on CPU tensors), against the JAX package:

- ``spawn_primary_plain`` against the Pallas ``spawn_front.spawn_primary``
  in interpret mode at M = 256, the queue running out inside the call;
- ``front_bounce_plain`` and ``resolve_bounce_plain`` against
  ``wavefront.front_precompute`` / ``bounce_front`` / ``resolve_tail``
  (NumPy backend) on the same random lane state, the resolve followed by
  the pool's accumulation as ops/pallas/bounce_resolve.py does it;
- ``trace_segments_plain`` against ``traverse.nearest_hit_bvh_np`` and
  ``bruteforce.nearest_hit_np`` with exclusions, a constructed tie and an
  any-hit segment.

Tolerances: integer rows, masks, ids and counters exact; directions
within 1e-6 (both normalize the same camera ray); other floats atol 1e-5 * scale,
rtol 1e-5 (NumPy and torch libm cos/sin/exp/atan2 differ by an ulp);
trace t within 1e-6 relative (tests/test_torch_traverse.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaderaytracerendering_tpu.core import vecmath as jvm
from jaderaytracerendering_tpu.core.vecmath import V3 as JV3
from jaderaytracerendering_tpu.integrator import wavefront as jwf
from jaderaytracerendering_tpu.models import demo as jdemo
from jaderaytracerendering_tpu.ops import bruteforce as jbrute, scanops as jscan
from jaderaytracerendering_tpu.ops import traverse as jtrav
from jaderaytracerendering_tpu.ops.pallas import spawn_front as jspawn
from jaderaytracerendering_tpu.scene.scene import assemble as jassemble
from jaderaytracerendering_tpu.utils.config import RenderConfig as JConfig
from jaderaytracerendering_tpu_torch.core import camera as tcamera
from jaderaytracerendering_tpu_torch.models import demo as tdemo
from jaderaytracerendering_tpu_torch.ops import bounce_front, bounce_resolve, kernels
from jaderaytracerendering_tpu_torch.ops import scanops, spawn_front, trace
from jaderaytracerendering_tpu_torch.ops.lanes import (C_DONE, C_NEXT, C_RAYS, F_DIR,
                                                       F_L, F_LE0, F_SRC, F_T, I_ACTIVE,
                                                       I_BOUNCE, I_HIT, I_PIX, I_SLOT,
                                                       I_SMP, PoolState)
from jaderaytracerendering_tpu_torch.scene import material, scene as tscene
from jaderaytracerendering_tpu_torch.scene.objloader import MeshData
from jaderaytracerendering_tpu_torch.utils.config import RenderConfig as TConfig

torch.set_num_threads(1)

M = 256
CFG = dict(width=8, height=8, spp=4, max_depth=4, seed=3)
INF = kernels.INF


@pytest.fixture(scope="module")
def jade():
    j = jdemo.jade_scene(n_buddha_tris=300, env_shape=(16, 32))
    t = tdemo.jade_scene(n_buddha_tris=300, env_shape=(16, 32))
    j.camera.r = t.camera.r = 2.0
    return (j, jassemble(j.objects, j.env_map, xp=np, bvh_backend="numpy"),
            t, tscene.assemble(t.objects, t.env_map, bvh_backend="numpy", device="cpu"))


def _state(st_scene, cam, total, m=M):
    cfg = TConfig(**CFG)
    eye, rot = tcamera.camera_tensors(cam, "cpu")
    return PoolState.create(st_scene, cfg, eye, rot, m, total, 5), cfg


def test_cumsum_indicator_matches_jax():
    x = np.random.default_rng(0).integers(0, 2, 1000).astype(np.int32)
    np.testing.assert_array_equal(scanops.cumsum_indicator(torch.from_numpy(x)).numpy(),
                                  np.asarray(jscan.cumsum_indicator(jnp.asarray(x))))


SPAWN_CASES = [  # jitter, lanes, fresh share, queue left: "half" of the fresh
    # lanes, "plenty", or the lane at which it runs out
    pytest.param("cuda", M, 0.5, "half", id="cuda"),
    pytest.param("gl", M, 0.5, "half", id="gl"),
    pytest.param("cuda", 700, 0.05, "plenty", id="sparse"),
    pytest.param("gl", 700, 1.0, 300, id="all"),
    pytest.param("cuda", 700, 0.5, 400, id="cut_in_block"),
]


@pytest.mark.parametrize("jitter,m,share,queue", SPAWN_CASES)
def test_spawn_matches_pallas_spawn(jade, jitter, m, share, queue):
    """The plain spawn against the Pallas spawn at the fresh patterns the
    kernel's scan and compaction are sensitive to: scattered (5%), half,
    all fresh; M = 700 is a partial 1024-lane tile of the kernel, and the
    queue runs out inside it at lane 300 or 400, in the second warp's 256
    lanes (a thread scans 8)."""
    j, _, t, st_scene = jade
    g = np.random.default_rng(1)
    npix = CFG["width"] * CFG["height"]
    fresh = (g.uniform(size=m) < share).astype(np.int32)
    old = g.integers(0, npix, (3, m)).astype(np.int32)
    total, n_fresh = npix * 64, int(fresh.sum())
    if queue == "half":
        nxt = total - n_fresh // 2
    elif queue == "plenty":
        nxt = total - n_fresh - 7
    else:  # the fresh lanes before lane `queue` take the last samples
        nxt = total - int(fresh[:queue].sum())
    want_got = fresh != 0
    want_got &= np.cumsum(fresh) <= total - nxt

    su = np.zeros((8, m), np.int32)
    su[0], su[1:4] = fresh, old
    ints = np.zeros((1, 8), np.int32)
    ints[0, :3] = (nxt, total, 5)
    cam = np.zeros((1, 24), np.float32)
    cam[0, :16] = np.asarray(j.camera.camera_rotate, np.float32).reshape(-1)
    cam[0, 16:19] = np.asarray(j.camera.eye, np.float32)
    _, meta, daux = jspawn.spawn_primary(
        jnp.asarray(su), jnp.asarray(ints), jnp.asarray(cam), npix, CFG["width"],
        CFG["height"], CFG["seed"], jitter, -1.5, interpret=True)
    meta, daux = np.asarray(meta), np.asarray(daux)

    st, _ = _state(st_scene, t.camera, total, m)
    st.cfg = st.cfg.replace(jitter=jitter)
    st.is_[I_ACTIVE] = torch.from_numpy(1 - fresh)
    st.is_[I_SLOT:I_SMP + 1] = torch.from_numpy(old)
    st.cnt[C_NEXT] = nxt
    aux = torch.empty((8, m))
    kernels.reset_launches()
    spawn_front.spawn_primary(st, aux)
    assert kernels.LAUNCHES["spawn_primary"] == 0

    got = aux[7].numpy() != 0
    np.testing.assert_array_equal(got, meta[0] != 0)
    np.testing.assert_array_equal(got, want_got)
    assert got.sum() == min(n_fresh, total - nxt) > 0
    for row, jrow in ((I_SLOT, 1), (I_PIX, 2), (I_SMP, 3)):
        np.testing.assert_array_equal(st.is_[row].numpy(), meta[jrow])
    consumed = min(int(meta[4, -1]), total - nxt)
    assert int(st.cnt[C_NEXT]) == nxt + consumed == (nxt + n_fresh if queue == "plenty"
                                                      else total)
    np.testing.assert_allclose(aux[0:3].numpy()[:, got], daux[0:3][:, got], atol=1e-6)
    # every sample taken is a useful ray; misses finish at once
    assert int(st.cnt[C_RAYS]) == got.sum()
    miss = got & (aux[3].numpy() >= INF)
    assert int(st.cnt[C_DONE]) == miss.sum()
    started = st.is_[I_ACTIVE].numpy() != 0
    np.testing.assert_array_equal(started, (1 - fresh).astype(bool) | (got & ~miss))


def _random_state(st_scene, cam, g):
    """A pool state with random live paths on random triangles."""
    st, cfg = _state(st_scene, cam, 1 << 20)
    tri = g.integers(0, st_scene.n_triangles, M)
    tri[:8] = st_scene.emit_idx.numpy()[np.arange(8) % st_scene.n_emit]  # emission breaks
    uv = g.uniform(0.05, 0.45, (2, M)).astype(np.float32)
    p1, p2, p3 = (getattr(st_scene, k).numpy()[tri] for k in ("tri_p1", "tri_p2", "tri_p3"))
    src = p1 + (p2 - p1) * uv[0][:, None] + (p3 - p1) * uv[1][:, None]
    out = g.normal(size=(M, 3)).astype(np.float32)
    out /= np.linalg.norm(out, axis=1, keepdims=True)
    st.fs[F_SRC:F_SRC + 3] = torch.from_numpy(src.T.copy())
    st.fs[F_DIR:F_DIR + 3] = torch.from_numpy(out.T.copy())
    st.fs[F_T:F_T + 3] = torch.from_numpy(g.uniform(0.1, 2, (3, M)).astype(np.float32))
    st.fs[F_L:F_L + 3] = torch.from_numpy(g.uniform(0, 3, (3, M)).astype(np.float32))
    st.fs[F_LE0:F_LE0 + 3] = torch.from_numpy(g.uniform(0, 1, (3, M)).astype(np.float32))
    st.is_[I_ACTIVE] = torch.from_numpy((g.uniform(size=M) < 0.85).astype(np.int32))
    st.is_[I_HIT] = torch.from_numpy(tri.astype(np.int32))
    st.is_[I_BOUNCE] = torch.from_numpy(g.integers(0, CFG["max_depth"], M).astype(np.int32))
    npix = CFG["width"] * CFG["height"]
    st.is_[I_SLOT] = st.is_[I_PIX] = torch.from_numpy(g.integers(0, npix, M).astype(np.int32))
    st.is_[I_SMP] = torch.from_numpy(g.integers(0, 16, M).astype(np.int32))
    return st, cfg


def test_front_and_resolve_match_jax_wavefront(jade):
    _, sdj, t, st_scene = jade
    st, _ = _random_state(st_scene, t.camera, np.random.default_rng(2))
    jcfg = JConfig(**CFG)
    e_cnt, n_seg = sdj.n_emit, sdj.n_emit + 2
    fs, is_ = st.fs.numpy().copy(), st.is_.numpy().copy()
    active = is_[I_ACTIVE] != 0
    src, out = JV3(*fs[F_SRC:F_SRC + 3]), JV3(*fs[F_DIR:F_DIR + 3])
    b, pix, smp = is_[I_BOUNCE], is_[I_PIX].astype(np.uint32), is_[I_SMP].astype(np.uint32)
    hit_idx = is_[I_HIT]

    # ---- the JAX front (NumPy backend) and its segment rays ----
    tri = np.where(active, hit_idx, 0)
    trow_t, mrow_t = jwf._tri_mat_rows_t(sdj, tri, np)
    state = (active, src, out, hit_idx, np.zeros(M, bool))
    pre = jwf.front_precompute(state, b, pix, smp, tri, trow_t, mrow_t, sdj, jcfg, np, None)
    lpt = lambda tbl, i: JV3(tbl[i, 0], tbl[i, 1], tbl[i, 2])  # noqa: E731
    lights = [(lpt(sdj.light_p1, i), lpt(sdj.light_p2, i), lpt(sdj.light_p3, i))
              for i in range(e_cnt)]
    f = jwf.bounce_front(active, src, out, tri, trow_t, mrow_t, pre, lights, e_cnt,
                         sdj.has_sss, sdj.has_refract, jcfg, np)
    assert f.sss_exit.any() and f.sss_entry.any() and f.is_mirror.any()
    assert f.emit_break.any() and (f.alive & ~f.needs_nee).any()
    vw = lambda mask, v: jvm.vwhere(mask, v, 0.0, np)  # noqa: E731
    seg_o = [vw(f.needs_nee, f.nee_src)] * (e_cnt + 1) + [vw(f.alive, f.cont_src)]
    seg_d = [vw(f.needs_nee, ld) for ld in f.ldirs] + [vw(f.needs_nee, f.hdir),
                                                       vw(f.alive, f.cdir)]
    o_want = np.stack([np.stack(v) for v in seg_o])
    d_want = np.stack([np.stack(v) for v in seg_d])

    o, d, x = bounce_front.front_bounce(st)  # CPU state: the plain version
    np.testing.assert_array_equal(x.numpy(), np.stack([f.nee_excl] * (e_cnt + 1)
                                                      + [f.cont_excl]))
    scale = max(np.abs(o_want).max(), np.abs(d_want).max())
    np.testing.assert_allclose(o.numpy(), o_want, rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(d.numpy(), d_want, rtol=1e-5, atol=1e-5 * scale)

    # ---- the trace of the JAX segments (NumPy walk), fed to both resolves ----
    hits, idxs, ts = [], [], []
    for s in range(n_seg):
        d_u = jvm.vnormalize(JV3(*d_want[s]), np, eps=1e-30)
        h, i, tt = jtrav.nearest_hit_bvh_np(o_want[s].T, np.stack(d_u, -1),
                                            np.asarray(f.nee_excl), sdj, stack_size=128)
        hits.append(h), idxs.append(i), ts.append(tt)
    bt = torch.from_numpy(np.where(np.stack(hits), np.stack(ts), INF).astype(np.float32))
    bi = torch.from_numpy(np.stack(idxs).astype(np.int32))

    # ---- the JAX resolve_tail + the pool's accumulation (bounce_resolve) ----
    c_hit, c_t = hits[e_cnt + 1], ts[e_cnt + 1]
    c_idx = np.where(c_hit, idxs[e_cnt + 1], 0)
    cdir_u, hdir_u = jwf._unit_p(f.cdir, np), jwf._unit_p(f.hdir, np)
    from jaderaytracerendering_tpu.scene import envmap as jenv
    sky = jenv.sample_env_sd_p(sdj, hdir_u, np, clamp=jcfg.hdr_clamp)
    sky_c = jenv.sample_env_sd_p(sdj, cdir_u, np, clamp=jcfg.hdr_clamp)
    crow_t, c_mrow_t = jwf._tri_mat_rows_t(sdj, c_idx, np)
    l_oks = [f.l_gates[i] & hits[i] & (idxs[i] == sdj.emit_idx[i]) for i in range(e_cnt)]
    dir_b, rate_b, new_src, accept, _ = jwf.resolve_tail(
        np, e_cnt, sdj.has_sss, sdj.has_refract, jcfg.rr_rate, jcfg.sss_rate,
        f.ldirs, l_oks, [lpt(sdj.light_norm, i) for i in range(e_cnt)],
        [lpt(sdj.light_emis, i) for i in range(e_cnt)],
        [sdj.light_area[i] for i in range(e_cnt)], sky, sky_c, f.hdir, cdir_u,
        f.nee_norm, f.exit_norm, f.bss, f.fr, f.fr_alb, f.emissive,
        jvm.v3rows(c_mrow_t, 0), f.cont_src, f.ref_rate, f.r0_sss, f.total_area, f.k,
        f.u_rr, c_t, f.sss_entry, f.sss_exit, f.is_mirror, f.is_dirref, f.alive,
        active, f.emit_break, np.zeros(M, bool), f.needs_nee, c_hit, hits[e_cnt],
        f.ref_escaped)
    t_put, l_acc = JV3(*fs[F_T:F_T + 3]), JV3(*fs[F_L:F_L + 3])
    l_acc = l_acc + t_put * dir_b
    t_put = t_put * rate_b
    b2 = np.where(active, b + 1, b)
    capped = accept & (b2 >= CFG["max_depth"])
    l_acc = l_acc + jvm.vwhere(capped, t_put * dir_b, 0.0, np)
    finished = (active & ~accept) | capped
    still = accept & ~capped
    l_final = np.stack(l_acc + JV3(*fs[F_LE0:F_LE0 + 3]), -1)
    film_want = np.zeros((CFG["width"] * CFG["height"], 3), np.float32)
    np.add.at(film_want, is_[I_SLOT][finished], l_final[finished])
    assert finished.any() and still.any() and capped.any()

    bounce_resolve.resolve_bounce(st, bt, bi)  # CPU state: the plain version
    np.testing.assert_array_equal(st.is_[I_ACTIVE].numpy() != 0, still)
    np.testing.assert_array_equal(st.is_[I_BOUNCE].numpy(), np.where(still, b2, b))
    np.testing.assert_array_equal(st.is_[I_HIT].numpy(), np.where(still, c_idx, hit_idx))
    assert int(st.cnt[C_DONE]) == finished.sum()
    assert int(st.cnt[C_RAYS]) == active.sum() * n_seg
    for row, v in ((F_SRC, new_src), (F_DIR, -cdir_u), (F_T, t_put), (F_L, l_acc)):
        want = np.where(still, np.stack(v), fs[row:row + 3])
        np.testing.assert_allclose(st.fs[row:row + 3].numpy(), want, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(want).max(), 1.0))
    np.testing.assert_allclose(st.film.numpy(), film_want, rtol=1e-5,
                               atol=1e-5 * np.abs(film_want).max())


def test_stacked_trace_matches_jax_walks(jade):
    _, sdj, _, st_scene = jade
    g = np.random.default_rng(4)
    n_seg, n = 3, 600
    o = g.uniform(-1.5, 1.5, (n_seg, 3, n)).astype(np.float32)
    d = (g.uniform(-0.6, 0.6, (n_seg, 3, n)).astype(np.float32) - o).astype(np.float32)
    x = g.integers(-1, st_scene.n_triangles, (n_seg, n)).astype(np.int32)
    d[:, :, :5] = 0.0  # zero directions are misses
    kernels.reset_launches()
    bt, bi = trace.trace_segments(st_scene, *(torch.from_numpy(a) for a in (o, d, x)),
                                  anyhit_seg=1)
    assert kernels.LAUNCHES["trace_segments"] == 0
    for s in range(n_seg):
        d_u = np.stack(jvm.vnormalize(JV3(*d[s]), np, eps=1e-30), -1)
        walk = jtrav.nearest_hit_bvh_np(o[s].T, d_u, x[s], sdj, stack_size=128)
        brute = jbrute.nearest_hit_np(o[s].T, d_u, x[s], sdj.tri_p1, sdj.tri_p2,
                                      sdj.tri_p3)
        for want in (walk, brute):
            np.testing.assert_array_equal(bt[s].numpy() < INF, want[0])
            if s == 1:
                continue  # the any-hit segment: its hit flag only
            np.testing.assert_array_equal(bi[s].numpy(), want[1])
            np.testing.assert_allclose(bt[s].numpy(), want[2], rtol=1e-6)
        assert want[0].mean() > 0.5 and (x[s][want[0]] != -1).any()


def test_stacked_trace_ties_go_to_the_minimum_id():
    g = np.random.default_rng(5)
    c = g.uniform(-1, 1, (40, 3))
    p1, p2, p3 = ((c + g.uniform(-0.1, 0.1, (40, 3))).astype(np.float32) for _ in range(3))

    def mesh(sl):
        nrm = np.cross(p2[sl] - p1[sl], p3[sl] - p1[sl])
        nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
        return MeshData(p1[sl], p2[sl], p3[sl], nrm)

    # the second object repeats 15 triangles exactly: every tie has a twin
    st = tscene.assemble([tscene.SceneObject(mesh(slice(0, 40)), material.Material()),
                          tscene.SceneObject(mesh(slice(0, 15)), material.Material())],
                         np.ones((4, 8, 3), np.float32), device="cpu")
    centroid = (p1[:15] + p2[:15] + p3[:15]) / 3.0
    o = np.repeat(np.array([[0.0, 0.0, 3.0]], np.float32), 15, axis=0)
    d = (centroid - o).astype(np.float32)
    o3, d3 = (torch.from_numpy(np.stack([a.T, a.T]).copy()) for a in (o, d))
    x3 = torch.full((2, 15), -1, dtype=torch.int32)
    bt, bi = trace.trace_segments(st, o3, d3, x3)
    sp = [getattr(st, k).numpy() for k in ("tri_p1", "tri_p2", "tri_p3")]
    d_u = np.stack(jvm.vnormalize(JV3(*d.T), np, eps=1e-30), -1)
    want = jbrute.nearest_hit_np(o, d_u, np.full(15, -1, np.int32), *sp)
    for s in range(2):
        np.testing.assert_array_equal(bi[s].numpy(), want[1])
    twins = [np.nonzero((sp[0] == sp[0][i]).all(1) & (sp[1] == sp[1][i]).all(1)
                        & (sp[2] == sp[2][i]).all(1))[0] for i in bi[0].numpy()]
    assert sum(len(w) > 1 for w in twins) >= 8
    assert all(i == w.min() for i, w in zip(bi[0].numpy(), twins))


def test_spawn_window_maps_slots_to_pixels(jade):
    """A queue over the pixel window [40, 47): slot = index % 7, pix = 40 +
    slot, smp = index // 7 + sample_base; the camera rays are those of the
    film's pixels; the film has the window's 7 rows."""
    *_, t, st = jade
    cfg = TConfig(**CFG)
    eye, rot = tcamera.camera_tensors(t.camera, "cpu")
    p = PoolState.create(st, cfg, eye, rot, 32, 7 * 3, 5, pix0=40, n_px=7)
    aux = torch.zeros((8, 32))
    spawn_front.spawn_primary_plain(p, aux)
    index = torch.arange(21)
    got = aux[7] == 1
    assert got.sum() == 21 and bool(got[:21].all())
    assert p.film.shape == (7, 3) and int(p.cnt[C_NEXT]) == 21
    assert torch.equal(p.is_[I_SLOT][:21], (index % 7).int())
    assert torch.equal(p.is_[I_PIX][:21], (40 + index % 7).int())
    assert torch.equal(p.is_[I_SMP][:21], (index // 7 + 5).int())
    _, d = tcamera.generate_rays_p(eye, rot, 8, 8, 40 + index % 7, index // 7 + 5, cfg.seed)
    np.testing.assert_allclose(aux[0:3, :21].numpy(), torch.stack([d.x, d.y, d.z]).numpy(),
                               atol=1e-6)
    with pytest.raises(ValueError, match="pixel window"):
        PoolState.create(st, cfg, eye, rot, 32, 7, 5, pix0=60, n_px=7)
