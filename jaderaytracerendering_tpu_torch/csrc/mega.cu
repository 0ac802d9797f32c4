// Megakernel for Hopper (sm_90a): the whole NEE path-tracing render of a
// film x spp in one launch, plus a standalone BVH nearest-hit kernel over
// the same traversal device function.
//
// Replaces the JAX package's Pallas TPU megakernel
// ops/pallas/mega.py::render_mega -> _mega_kernel (and, inside it, _sweep,
// _rows_fetch/_take_rows, _env_sample and _cdf_pick). It computes what
// that kernel and the scan engine compute — per-pixel radiance SUMS over
// spp samples plus the count of useful rays — but none of the TPU
// mechanics carry over (one-hot MXU gathers, triangular-matmul
// compaction, bf16x3 splits, 128-lane packing, VMEM budgets). The design
// is the reference's own render_pixel (PathTrace.cu:1426-1455): one
// thread owns one pixel and loops over its samples (ascending, the pool's
// per-pixel order) and bounces; the scene tables are plain global loads.
//
// Semantics are those of the plain torch version
// (integrator/wavefront.py trace_radiance_p), operation for operation:
// the counter RNG keyed by (pixel, sample, bounce, site, seed), the
// branch order of bounce_front (emission break, SSS entry/exit, mirror,
// diffuse), NEE to every emissive triangle with the exact-index
// visibility test, an any-hit HDR-visibility ray, the continuation ray,
// and resolve_tail's Russian roulette, Fresnel, BSSRDF and throughput
// update. The radiance is composited forward (L += T*dir; T *= rate) with
// the depth-cap term the backward fold seeds from its top entry
// (wavefront.py composite_p; the pool's bounce_resolve does the same).
// Built with --fmad=false so every a*b+c rounds twice, as the separate
// torch ops do; divisions by a constant are true divisions, as in the
// JAX package and the torch code. Deterministic: no atomics.
//
// What bounds it on this card: not FLOPs but divergent BVH traversal
// (threads of a warp walk different nodes and exit at different depths)
// and the per-thread traversal stack, which lives in local memory (L1/L2
// backed). This first design accepts both: one thread per pixel keeps
// the code a direct, checkable transcription of the plain version, the
// stack is a fixed 128-entry array, and any-hit early exit is used where
// only a boolean is needed. Work redistribution, wavefronts, a shorter
// stack and packed node layouts are later work.
//
// Direct refraction (DIR_REFRACT) is not handled; the wrapper raises.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float INF_T = 2147483647.0f;          // PathTrace.cu:23
constexpr double PI_D = 3.1415926;              // the reference's PI
constexpr float PI_F = (float)PI_D;
constexpr float INV_PI = (float)(1.0 / PI_D);
constexpr float TWO_PI = (float)(2.0 * PI_D);
constexpr float EIGHT_PI = (float)(8.0 * PI_D);
constexpr float EMIT_BREAK_EPS = 1.4e-5f;       // PathTrace.cu:917
constexpr float EMIT_SKIP_EPS = 1.5e-4f;        // PathTrace.cu:1005
constexpr int MAX_STACK = 128;                  // PathTrace.cu:34

constexpr uint32_t K_PIXEL = 0x9E3779B9u;
constexpr uint32_t K_SAMPLE = 0x85EBCA6Bu;
constexpr uint32_t K_BOUNCE = 0xC2B2AE35u;
constexpr uint32_t K_SITE = 0x27D4EB2Fu;
constexpr uint32_t K_SEED = 0x165667B1u;

// DrawSites (core/rng.py)
constexpr uint32_t S_JITTER_X = 0, S_JITTER_Y = 1, S_SELECT_REFRACT = 2,
                   S_SELECT_SSS = 3, S_HDR_COS = 4, S_HDR_PHI = 5, S_RR = 6,
                   S_CONT_COS = 7, S_CONT_PHI = 8, S_AREA_CDF = 9,
                   S_EXIT_U = 10, S_EXIT_V = 11, S_LIGHT_BASE = 64;

}  // namespace

// Mirrored field for field by ctypes structures in ops/mega.py.
struct SceneArgs {
  const float* tri_p1;
  const float* tri_p2;
  const float* tri_p3;
  const float* tri_norm;
  const int* tri_obj;
  const float* mat_emissive;
  const float* mat_brdf;
  const int* mat_reflex;
  const int* mat_refract;
  const float* mat_refract_rate;
  const float* mat_refract_albedo;
  const float* mat_refract_index;
  const int* emit_idx;
  const float* light_p1;
  const float* light_p2;
  const float* light_p3;
  const float* light_norm;
  const float* light_emis;
  const float* light_area;
  const float* prefix_area;
  const float* obj_total_area;
  const int* mapping;
  const int* seg_begin;
  const int* seg_end;
  const int* bvh_left;
  const int* bvh_right;
  const int* bvh_n;
  const int* bvh_index;
  const float* bvh_aa;
  const float* bvh_bb;
  const float* env_map;
  int env_h;
  int env_w;
  int n_emit;
  int n_nodes;
  int has_sss;
  int stack_size;
};

struct RenderArgs {
  float rot[16];       // camera_rotate, m[col][row] at rot[4*col + row]
  float eye[3];
  int width;
  int height;
  int npix;
  int spp;
  int max_depth;
  int jitter_gl;
  uint32_t sample_base;
  uint32_t seed;
  float ndc_sx;        // f32(2 / width)   ('cuda' jitter)
  float ndc_sy;        // f32(2 / height)
  float rr_rate;
  float sss_rate;
  float one_m_sss;     // f32(1 - sss_rate)
  float rr_over_pi;    // f32(rr_rate / PI)
  float hdr_clamp;
};

namespace {

struct V {
  float x, y, z;
};

__device__ __forceinline__ V operator+(V a, V b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V operator-(V a, V b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V operator*(V a, V b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V operator*(V a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V operator/(V a, float s) { return {a.x / s, a.y / s, a.z / s}; }
__device__ __forceinline__ V operator-(V a) { return {-a.x, -a.y, -a.z}; }

__device__ __forceinline__ float dot(V a, V b) { return (a.x * b.x + a.y * b.y) + a.z * b.z; }
__device__ __forceinline__ V cross(V a, V b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V load3(const float* p, int i) {
  return {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}

// v * (1 / sqrt(v.v)); eps floors v.v (NaN stays NaN, as torch.clamp_min)
__device__ __forceinline__ V normalize(V v) {
  float r = 1.0f / sqrtf(dot(v, v));
  return v * r;
}
__device__ __forceinline__ V unit_eps(V v) {
  float n2 = dot(v, v);
  n2 = n2 < 1e-30f ? 1e-30f : n2;
  float r = 1.0f / sqrtf(n2);
  return v * r;
}

// ---- counter RNG (core/rng.py) ---------------------------------------------
__device__ __forceinline__ uint32_t pcg(uint32_t x) {
  x = x * 747796405u + 2891336453u;
  uint32_t w = ((x >> ((x >> 28) + 4u)) ^ x) * 277803737u;
  return (w >> 22) ^ w;
}
__device__ __forceinline__ float to_unit(uint32_t bits) {
  return (float)(int)(bits >> 8) * (1.0f / 16777216.0f);
}
// hb = pcg(pixel*KP + sample*KS) + bounce*KB + seed*KSEED
__device__ __forceinline__ float draw(uint32_t hb, uint32_t site) {
  return to_unit(pcg(hb + site * K_SITE));
}

// ---- intersection (ops/intersect.py) ---------------------------------------
__device__ __forceinline__ bool ray_triangle(V o, V d, V p1, V p2, V p3, float& t) {
  V e1 = p2 - p1;
  V e2 = p3 - p1;
  V h = cross(d, e2);
  float a = dot(e1, h);
  float f = 1.0f / a;
  V s = o - p1;
  float u = f * dot(s, h);
  V q = cross(s, e1);
  float v = f * dot(d, q);
  t = f * dot(e2, q);
  return (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) && (t > 0.0f);
}

__device__ __forceinline__ void slab(float o, float inv, float a, float b,
                                     float& tmax, float& tmin) {
  float f = (b - o) * inv;
  float n = (a - o) * inv;
  tmax = f > n ? f : n;
  tmin = f < n ? f : n;
  // a NaN slab (0 * inf) drops out of both reductions (fminf/fmaxf)
  if (tmax != tmax) tmax = __int_as_float(0x7f800000);   // +inf
  if (tmin != tmin) tmin = __int_as_float(0xff800000);   // -inf
}

__device__ __forceinline__ void ray_aabb(V o, V inv, V aa, V bb, float& enter, float& dist) {
  float a0, b0, a1, b1, a2, b2;
  slab(o.x, inv.x, aa.x, bb.x, a0, b0);
  slab(o.y, inv.y, aa.y, bb.y, a1, b1);
  slab(o.z, inv.z, aa.z, bb.z, a2, b2);
  float t1 = fminf(fminf(a0, a1), a2);
  float t0 = fmaxf(fmaxf(b0, b1), b2);
  dist = t1 >= t0 ? (t0 > 0.0f ? t0 : t1) : -1.0f;
  enter = t0 < 0.0f ? 0.0f : t0;
}

// ---- BVH walk (ops/traverse.py) --------------------------------------------
// Nearest hit of the ray (o, dir) skipping triangle `excl`; `dir` is
// normalized here. On equal t the minimum id wins; a box is pruned only
// when its entry lies strictly beyond the best hit; a zero direction is a
// miss. With any_hit the walk stops at the first hit (boolean use only).
__device__ bool bvh_nearest_hit(const SceneArgs& s, V o, V dir, int excl,
                                bool any_hit, float& best_t, int& best_i) {
  best_t = INF_T;
  best_i = 0;
  if ((dir.x == 0.0f && dir.y == 0.0f && dir.z == 0.0f) || s.n_nodes <= 1)
    return false;
  V d = normalize(dir);
  V inv = {1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
  int stack[MAX_STACK];
  stack[0] = 1;  // node 0 is the sentinel, the root is node 1
  int sp = 1;
  while (sp > 0) {
    int spm = sp - 1;
    int node = stack[spm];
    int n = s.bvh_n[node];
    if (n > 0) {
      int base = s.bvh_index[node];
      for (int k = 0; k < n; ++k) {
        int id = base + k;
        if (id == excl) continue;
        float t;
        bool hit = ray_triangle(o, d, load3(s.tri_p1, id), load3(s.tri_p2, id),
                                load3(s.tri_p3, id), t);
        if (hit && t < INF_T && (t < best_t || (t == best_t && id < best_i))) {
          best_t = t;
          best_i = id;
          if (any_hit) return true;
        }
      }
      sp = spm;
    } else {
      int l = s.bvh_left[node];
      int r = s.bvh_right[node];
      float enter_l = 0.0f, dist_l = -1.0f, enter_r = 0.0f, dist_r = -1.0f;
      if (l > 0) ray_aabb(o, inv, load3(s.bvh_aa, l), load3(s.bvh_bb, l), enter_l, dist_l);
      if (r > 0) ray_aabb(o, inv, load3(s.bvh_aa, r), load3(s.bvh_bb, r), enter_r, dist_r);
      bool push_l = l > 0 && dist_l > 0.0f && enter_l <= best_t;
      bool push_r = r > 0 && dist_r > 0.0f && enter_r <= best_t;
      bool both = push_l && push_r;
      bool near_is_l = dist_l < dist_r;
      sp = spm;
      if (push_l || push_r) {
        stack[sp++] = both ? (near_is_l ? r : l) : (push_l ? l : r);
        if (both && spm + 1 < s.stack_size) stack[sp++] = near_is_l ? l : r;
      }
    }
  }
  return best_t < INF_T;
}

// The integrator's ray query (wavefront.nearest_planes): the direction is
// made unit (zero stays zero) before the walk normalizes it again.
__device__ __forceinline__ bool trace(const SceneArgs& s, V o, V dir, int excl,
                                      bool any_hit, float& t, int& idx) {
  return bvh_nearest_hit(s, o, unit_eps(dir), excl, any_hit, t, idx);
}

// ---- environment (scene/envmap.py sample_env) ------------------------------
__device__ __forceinline__ int mirror_index(int i, int n) {
  int p = 2 * n;
  i = ((i % p) + p) % p;
  return i >= n ? p - 1 - i : i;
}

__device__ V env_sample(const SceneArgs& s, V d, float clamp) {
  int h = s.env_h, w = s.env_w;
  float u = atan2f(d.z, d.x) / TWO_PI + 0.5f;
  float dy = d.y < -1.0f ? -1.0f : (d.y > 1.0f ? 1.0f : d.y);
  float v = 1.0f - (asinf(dy) / PI_F + 0.5f);
  float fx = u * (float)w - 0.5f;
  float fy = v * (float)h - 0.5f;
  float x0 = floorf(fx);
  float y0 = floorf(fy);
  float tx = fx - x0;
  float ty = fy - y0;
  int x0i = (int)x0, y0i = (int)y0;
  int x1i = mirror_index(x0i + 1, w);
  int y1i = mirror_index(y0i + 1, h);
  x0i = mirror_index(x0i, w);
  y0i = mirror_index(y0i, h);
  V c00 = load3(s.env_map, y0i * w + x0i);
  V c01 = load3(s.env_map, y0i * w + x1i);
  V c10 = load3(s.env_map, y1i * w + x0i);
  V c11 = load3(s.env_map, y1i * w + x1i);
  float a = 1.0f - tx, b = 1.0f - ty;
  V c = c00 * a * b + c01 * tx * b + c10 * a * ty + c11 * tx * ty;
  c.x = c.x > clamp ? clamp : c.x;
  c.y = c.y > clamp ? clamp : c.y;
  c.z = c.z > clamp ? clamp : c.z;
  return c;
}

// ---- sampling (integrator/sampling.py) -------------------------------------
__device__ __forceinline__ V uniform_sphere(float u_cos, float u_phi) {
  float cos_t = 2.0f * (u_cos - 0.5f);
  float s2 = 1.0f - cos_t * cos_t;
  float sin_t = sqrtf(s2 < 0.0f ? 0.0f : s2);
  float phi = TWO_PI * u_phi;
  return {sin_t * cosf(phi), sin_t * sinf(phi), cos_t};
}
__device__ __forceinline__ V fold_same(V d, V n, V ref) {
  return dot(d, n) * dot(ref, n) < 0.0f ? -d : d;
}
__device__ __forceinline__ V fold_opposite(V d, V n, V ref) {
  return dot(d, n) * dot(ref, n) > 0.0f ? -d : d;
}
__device__ __forceinline__ V triangle_point(V p1, V p2, V p3, float u, float v) {
  if (u + v > 1.0f) {
    u = 1.0f - u;
    v = 1.0f - v;
  }
  return {p1.x + (p2.x - p1.x) * u + (p3.x - p1.x) * v,
          p1.y + (p2.y - p1.y) * u + (p3.y - p1.y) * v,
          p1.z + (p2.z - p1.z) * u + (p3.z - p1.z) * v};
}
__device__ __forceinline__ float schlick_r0(float ior) {
  float r = (ior - 1.0f) / (ior + 1.0f);
  return r * r;
}
__device__ __forceinline__ float fresnel_entry(float r0, float c) {
  float oc = 1.0f - c;
  float oc2 = oc * oc;
  return r0 + (1.0f - r0) * oc2 * oc2 * oc;
}
__device__ __forceinline__ float fresnel_exit(float r0, float c) {
  float oc = 1.0f - c;
  float oc2 = oc * oc;
  return r0 - (1.0f - r0) * oc2 * oc2 * oc;
}
__device__ __forceinline__ float bssrdf_chan(float dist, float third, float s) {
  return (expf(-dist / s) + expf(-third / s)) / (s * EIGHT_PI * dist);
}
// reference bisection over the load-order prefix sums (PathTrace.cu:1031-1048)
__device__ int area_cdf_pick(const SceneArgs& s, float u, int obj) {
  float target = u * s.obj_total_area[obj];
  int left = s.seg_begin[obj], right = s.seg_end[obj], middle = 0;
  while (left < right - 1) {
    int m = (left + right) / 2;
    middle = m;
    if (target <= s.prefix_area[m]) right = m; else left = m;
  }
  return s.mapping[middle];
}

struct Path {
  V src;       // ray_src: the current hit point
  V out_dir;   // direction back toward the previous vertex
  int tri;     // hit triangle (sorted id)
};

// One bounce of an active path (wavefront.bounce_step for one lane):
// returns accept and writes the stack entry (dir_out, rate_out).
__device__ bool bounce(const SceneArgs& s, const RenderArgs& r, uint32_t hb,
                       Path& p, V& dir_out, V& rate_out) {
  const V zero3 = {0.0f, 0.0f, 0.0f};
  int tri = p.tri;
  int obj = s.tri_obj[tri];
  V normal = load3(s.tri_norm, tri);
  V emissive = load3(s.mat_emissive, obj);
  int refract = s.mat_refract[obj];
  int reflex = s.mat_reflex[obj];

  // branch selection (PathTrace.cu:923-931)
  float u_sel = draw(hb, S_SELECT_REFRACT);
  float u_sss = draw(hb, S_SELECT_SSS);
  bool emit_break = emissive.x > EMIT_BREAK_EPS || emissive.y > EMIT_BREAK_EPS ||
                    emissive.z > EMIT_BREAK_EPS;
  if (emit_break) {  // break with l_dir = Le (counted twice at bounce 0)
    dir_out = emissive;
    rate_out = zero3;
    return false;
  }
  bool take_refract = u_sel < 0.5f && refract != 0;
  bool is_sss = take_refract && refract == 1;
  bool sss_entry = is_sss && u_sss < r.sss_rate;
  bool sss_exit = is_sss && !(u_sss < r.sss_rate);
  bool is_diffuse = !take_refract && reflex == 0;
  bool is_mirror = !take_refract && reflex == 1;
  float k = refract != 0 ? 2.0f : 1.0f;
  V fr = load3(s.mat_brdf, obj) * INV_PI;
  V fr_alb = load3(s.mat_refract_albedo, obj) * INV_PI;
  V f_entry = sss_entry ? fr_alb : fr;

  // SSS exit point and its shading values (PathTrace.cu:1029-1070)
  V exit_norm = normal, inner_dir = p.out_dir, nee_src = p.src, bss = zero3;
  float r0_sss = 0.0f, total_area = 1.0f;
  int nee_excl = tri;
  if (sss_exit) {
    int et = area_cdf_pick(s, draw(hb, S_AREA_CDF), obj);
    int eobj = s.tri_obj[et];
    V ep = triangle_point(load3(s.tri_p1, et), load3(s.tri_p2, et), load3(s.tri_p3, et),
                          draw(hb, S_EXIT_U), draw(hb, S_EXIT_V));
    exit_norm = load3(s.tri_norm, et);
    inner_dir = ep - p.src;
    float inner_dist = sqrtf(dot(inner_dir, inner_dir));
    r0_sss = schlick_r0(s.mat_refract_index[obj]);
    float fres_i = fresnel_entry(r0_sss, fabsf(dot(normal, p.out_dir)));
    float dist = inner_dist < 1e-12f ? 1e-12f : inner_dist;
    float third = dist / 3.0f;
    V sigma = load3(s.mat_refract_rate, eobj);
    bss = V{bssrdf_chan(dist, third, sigma.x), bssrdf_chan(dist, third, sigma.y),
            bssrdf_chan(dist, third, sigma.z)} * fres_i;
    total_area = s.obj_total_area[eobj];
    nee_src = ep;
    nee_excl = et;
  }
  V nee_norm = sss_exit ? exit_norm : normal;
  bool needs_nee = is_diffuse || sss_entry || sss_exit;

  // NEE to each emissive triangle, exact-index visibility (PathTrace.cu:941-961)
  V l_dir = zero3;
  if (needs_nee) {
    float dot_on = dot(p.out_dir, normal);
    for (int i = 0; i < s.n_emit; ++i) {
      uint32_t li = S_LIGHT_BASE + 2u * (uint32_t)i;
      V lpoint = triangle_point(load3(s.light_p1, i), load3(s.light_p2, i),
                                load3(s.light_p3, i), draw(hb, li), draw(hb, li + 1u));
      V ldir = lpoint - nee_src;
      bool same_hemi = dot(ldir, nee_norm) * dot_on >= 0.0f;
      if (!(same_hemi || sss_exit)) continue;
      float lt;
      int lidx;
      if (!trace(s, nee_src, ldir, nee_excl, false, lt, lidx) || lidx != s.emit_idx[i])
        continue;
      float d2 = dot(ldir, ldir);
      float geom = fabsf(dot(nee_norm, ldir) * dot(load3(s.light_norm, i), ldir)) / d2 / d2 *
                   s.light_area[i];
      V l_emis = load3(s.light_emis, i);
      V contrib;
      if (sss_exit) {
        float fres_o = fresnel_exit(r0_sss, fabsf(dot(unit_eps(ldir), exit_norm)));
        contrib = (l_emis * fres_o * bss * geom) / PI_F * total_area;
      } else {
        contrib = l_emis * f_entry * geom;
      }
      l_dir = l_dir + contrib;
    }
  }

  // HDR NEE direction and continuation direction (PathTrace.cu:968-994)
  V hdir_raw = uniform_sphere(draw(hb, S_HDR_COS), draw(hb, S_HDR_PHI));
  V hdir = sss_exit ? fold_same(hdir_raw, exit_norm, inner_dir)
                    : fold_same(hdir_raw, normal, p.out_dir);
  V cdir_raw = uniform_sphere(draw(hb, S_CONT_COS), draw(hb, S_CONT_PHI));
  V cdir = sss_exit ? fold_opposite(cdir_raw, exit_norm, inner_dir)
                    : fold_same(cdir_raw, normal, p.out_dir);
  if (is_mirror) cdir = normal * (2.0f * dot(p.out_dir, normal)) - p.out_dir;  // cu:1378

  // NEE environment through an any-hit visibility ray (cu:968-980 / 1111-1130)
  if (needs_nee) {
    float ht;
    int hidx;
    if (!trace(s, nee_src, hdir, nee_excl, true, ht, hidx)) {
      V sky = env_sample(s, unit_eps(hdir), r.hdr_clamp);
      float cos_h = fabsf(dot(hdir, nee_norm));
      V env_c;
      if (sss_exit) {
        float fres_oh = fresnel_exit(r0_sss, fabsf(dot(hdir, exit_norm)));
        env_c = sky * fres_oh * bss * cos_h * 2.0f;
      } else {
        env_c = sky * f_entry * cos_h * TWO_PI;
      }
      l_dir = l_dir + env_c;
    }
  }
  // branch scale (cu:986, 1133, 1322)
  float k_entry = k / r.sss_rate;
  float k_exit = k / r.one_m_sss;
  float scale = sss_entry ? k_entry : (sss_exit ? k_exit : k);
  l_dir = needs_nee ? l_dir * scale : zero3;

  // continuation ray, Russian roulette, continuation rate
  float c_t;
  int c_idx;
  bool c_hit = trace(s, nee_src, cdir, nee_excl, false, c_t, c_idx);
  V cdir_u = unit_eps(cdir);
  bool rr_ok = draw(hb, S_RR) < r.rr_rate;
  bool accept = false;
  if (c_hit && rr_ok) {
    V cem = load3(s.mat_emissive, s.tri_obj[c_idx]);
    float m1 = cem.x > cem.y ? cem.x : cem.y;
    float mm = m1 > cem.z ? m1 : cem.z;
    accept = is_mirror || mm < EMIT_SKIP_EPS;
  }
  V rate_mirror = fr * (k / r.rr_over_pi);  // cu:1391
  if (accept) {
    if (is_mirror) {
      rate_out = rate_mirror;
      dir_out = zero3;
    } else {
      float cos_c = fabsf(dot(cdir_u, nee_norm));
      if (sss_exit) {  // cu:1160, 1166
        float cos_e = fabsf(dot(cdir_u, exit_norm));
        float fres_oc = fresnel_exit(r0_sss, cos_e);
        rate_out = (bss * fres_oc * cos_e * total_area * 2.0f) / r.rr_rate * k_exit;
      } else if (sss_entry) {  // cu:1008
        rate_out = (fr * cos_c) / r.rr_rate * k_entry;
      } else {  // cu:1344
        rate_out = (fr * cos_c) / r.rr_rate * k;
      }
      dir_out = l_dir;
    }
    p.src = nee_src + cdir_u * c_t;
    p.out_dir = -cdir_u;
    p.tri = c_idx;
    return true;
  }
  // break values (cu:1396)
  if (is_mirror) {
    dir_out = (rr_ok && !c_hit) ? env_sample(s, cdir_u, r.hdr_clamp) * rate_mirror : zero3;
  } else {
    dir_out = l_dir;
  }
  rate_out = zero3;
  return false;
}

// One jittered camera path of pixel `pix`, sample `smp` -> radiance.
__device__ V trace_sample(const SceneArgs& s, const RenderArgs& r, uint32_t pix,
                          uint32_t smp, float& rays) {
  uint32_t h0 = pcg(pix * K_PIXEL + smp * K_SAMPLE);
  uint32_t seedk = r.seed * K_SEED;
  // primary ray (core/camera.generate_rays_p)
  uint32_t hj = h0 + seedk;
  float u1 = draw(hj, S_JITTER_X);
  float u2 = draw(hj, S_JITTER_Y);
  float px = (float)(pix % (uint32_t)r.width);
  float py = (float)(pix / (uint32_t)r.width);
  float ndc_x, ndc_y;
  if (r.jitter_gl) {
    ndc_x = -1.0f + 2.0f * (px + 0.5f) / (float)r.width + (u1 - 0.5f) / (float)r.width;
    ndc_y = -1.0f + 2.0f * (py + 0.5f) / (float)r.height + (u2 - 0.5f) / (float)r.height;
  } else {
    ndc_x = -1.0f + r.ndc_sx * (px + u1 - 0.5f);
    ndc_y = -1.0f + r.ndc_sy * (py + u2 - 0.5f);
  }
  const float* m = r.rot;
  const float fz = -1.5f;  // FOCAL_Z
  V d = {m[0] * ndc_x + m[4] * ndc_y + m[8] * fz + m[12] * 0.0f,
         m[1] * ndc_x + m[5] * ndc_y + m[9] * fz + m[13] * 0.0f,
         m[2] * ndc_x + m[6] * ndc_y + m[10] * fz + m[14] * 0.0f};
  d = normalize(d);
  V o = {r.eye[0], r.eye[1], r.eye[2]};

  // wavefront.trace_radiance_p
  V d_unit = unit_eps(d);
  float t0;
  int idx0;
  rays = 1.0f;
  if (!trace(s, o, d_unit, -1, false, t0, idx0)) return env_sample(s, d_unit, r.hdr_clamp);
  V le0 = load3(s.mat_emissive, s.tri_obj[idx0]);
  Path p = {o + d_unit * t0, -d_unit, idx0};
  V L = {0.0f, 0.0f, 0.0f};
  V T = {1.0f, 1.0f, 1.0f};
  float per_bounce = (float)(s.n_emit + 2);
  for (int b = 0; b < r.max_depth; ++b) {
    rays += per_bounce;
    uint32_t hb = h0 + (uint32_t)(b + 1) * K_BOUNCE + seedk;
    V dir_b, rate_b;
    bool accept = bounce(s, r, hb, p, dir_b, rate_b);
    L = L + T * dir_b;
    T = T * rate_b;
    if (!accept) break;
    if (b == r.max_depth - 1) L = L + T * dir_b;  // the fold's depth-cap seed
  }
  return le0 + L;
}

__global__ void __launch_bounds__(128)
mega_render_kernel(SceneArgs s, RenderArgs r, float* __restrict__ out) {
  int pixel = blockIdx.x * blockDim.x + threadIdx.x;
  if (pixel >= r.npix) return;
  V sum = {0.0f, 0.0f, 0.0f};
  float rays = 0.0f;
  for (int k = 0; k < r.spp; ++k) {
    float n;
    V rad = trace_sample(s, r, (uint32_t)pixel, r.sample_base + (uint32_t)k, n);
    sum = sum + rad;
    rays += n;
  }
  out[pixel] = sum.x;
  out[r.npix + pixel] = sum.y;
  out[2 * r.npix + pixel] = sum.z;
  out[3 * r.npix + pixel] = rays;
}

__global__ void __launch_bounds__(128)
bvh_nearest_kernel(SceneArgs s, const float* __restrict__ o, const float* __restrict__ d,
                   const int* __restrict__ excl, int n, int* __restrict__ idx,
                   float* __restrict__ t) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float bt;
  int bi;
  bvh_nearest_hit(s, load3(o, i), load3(d, i), excl[i], false, bt, bi);
  idx[i] = bi;
  t[i] = bt;
}

}  // namespace

extern "C" {

// Radiance sums [3, npix] and useful rays [1, npix] into out [4, npix].
int mega_render(const SceneArgs* s, const RenderArgs* r, float* out, void* stream) {
  int threads = 128;
  int blocks = (r->npix + threads - 1) / threads;
  mega_render_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(*s, *r, out);
  return (int)cudaGetLastError();
}

// Nearest hit (idx, t) of n rays; t = 2147483647 on a miss.
int bvh_nearest(const SceneArgs* s, const float* o, const float* d, const int* excl, int n,
                int* idx, float* t, void* stream) {
  int threads = 128;
  int blocks = (n + threads - 1) / threads;
  bvh_nearest_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(*s, o, d, excl, n, idx, t);
  return (int)cudaGetLastError();
}

}  // extern "C"
