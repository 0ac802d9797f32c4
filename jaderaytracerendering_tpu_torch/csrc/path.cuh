// Device functions of the NEE path integrator, shared by the megakernel
// (mega.cu) and the pool engine's wavefront kernels (pool.cu).
//
// Semantics are those of the plain torch version (integrator/wavefront.py),
// operation for operation: the counter RNG keyed by (pixel, sample, bounce,
// site, seed), the branch order of bounce_front (emission break, SSS
// entry/exit, mirror, diffuse), NEE to every emissive triangle with the
// exact-index visibility test, an any-hit HDR-visibility ray, the
// continuation ray, and resolve_tail's Russian roulette, Fresnel, BSSRDF
// and throughput update. Built with --fmad=false so every a*b+c rounds
// twice, as the separate torch ops do; divisions by a constant are true
// divisions, as in the JAX package and the torch code.
//
// One bounce is split at its traces, as the JAX package's pool splits it
// into its front and resolve kernels: bounce_front_dev (branch selection,
// SSS exit pick), bounce_dirs_dev (the HDR/continuation directions),
// light_dir_dev (the NEE segment of light i) and light_contrib_dev, then
// resolve_tail_dev (env NEE, branch scale, RR, rates, break values). The
// megakernel calls them with its traces in between; the pool's front and
// resolve kernels call them on either side of its stacked trace. So the
// bounce math exists once.
//
// Direct refraction (DIR_REFRACT): refract_march_dev follows the refracted
// ray through the medium (wavefront.refract_march); its exit ray is the
// bounce's continuation, and an escaped march kills the path. The
// functions that read its results are templates on HR (the scene has
// direct refraction), so that a scene without it compiles to code that
// holds none of the march's state.

#pragma once

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
constexpr int LEAF_FLAG = (int)0x80000000;      // scene.LEAF_FLAG: a leaf child word

constexpr uint32_t K_PIXEL = 0x9E3779B9u;
constexpr uint32_t K_SAMPLE = 0x85EBCA6Bu;
constexpr uint32_t K_BOUNCE = 0xC2B2AE35u;
constexpr uint32_t K_SITE = 0x27D4EB2Fu;
constexpr uint32_t K_SEED = 0x165667B1u;

// DrawSites (core/rng.py)
constexpr uint32_t S_JITTER_X = 0, S_JITTER_Y = 1, S_SELECT_REFRACT = 2,
                   S_SELECT_SSS = 3, S_HDR_COS = 4, S_HDR_PHI = 5, S_RR = 6,
                   S_CONT_COS = 7, S_CONT_PHI = 8, S_AREA_CDF = 9,
                   S_EXIT_U = 10, S_EXIT_V = 11, S_REFRACT_BASE = 16,
                   S_LIGHT_BASE = 64;

}  // namespace

// Mirrored field for field by ctypes structures in ops/kernels.py.
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
  const int* bvh_nodes;     // [inner nodes, 16] packed records (scene.pack_walk_tables)
  const float* tri_packed;  // [T, 12] p1, p2, p3 per triangle
  int env_h;
  int env_w;
  int n_emit;
  int n_nodes;
  int has_sss;
  int stack_size;  // walk stack entries (BVH depth + 1)
  int has_refract;
  int bvh_root;    // the root's child word
};

// The walk stack of every kernel that walks: dynamic shared memory of
// blockDim.x x stack_size ints (walk_smem_bytes), entry k of thread i at
// k * blockDim.x + i, so the threads of a warp always hit 32 banks.
extern __shared__ int walk_stack[];

__host__ __device__ inline size_t walk_smem_bytes(const SceneArgs& s, int threads) {
  return (size_t)threads * (size_t)s.stack_size * sizeof(int);
}

// Let `kernel` take `bytes` of dynamic shared memory (above the default
// 48 KB only after this call); returns a cudaError_t.
template <class K>
inline int smem_limit(K* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

// The blocks of a persistent grid of `kernel`: SMs x the blocks of
// `threads` threads and `smem` bytes that an SM holds, at most `need`
// (after smem_limit); returns a cudaError_t.
template <class K>
inline int persistent_grid(K* kernel, int threads, size_t smem, long long need,
                           long long& blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  int rc = smem_limit(kernel, smem);
  if (!rc) rc = (int)cudaGetDevice(&dev);
  if (!rc) rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!rc) rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (rc) return rc;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  blocks = (long long)sms * per_sm;
  if (blocks > need) blocks = need;
  return 0;
}

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
  int max_refract;     // max_refract_bounces
  float internal_reflect_rate;
  int row_step;        // a pixel window's row stride (window_pixel); 1: contiguous
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

// d - 2 (d.n) n (the reflection inside direct refraction, PathTrace.cu:1217)
__device__ __forceinline__ V vreflect(V d, V n) {
  float k = 2.0f * dot(d, n);
  return {d.x - n.x * k, d.y - n.y * k, d.z - n.z * k};
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
__device__ __forceinline__ uint32_t sample_hash(uint32_t pix, uint32_t smp) {
  return pcg(pix * K_PIXEL + smp * K_SAMPLE);
}
// the hash of draw() for bounce b (the bounce counter is b + 1; 0 is the
// camera jitter)
__device__ __forceinline__ uint32_t bounce_hash(uint32_t h0, uint32_t seed, int b) {
  return h0 + (uint32_t)(b + 1) * K_BOUNCE + seed * K_SEED;
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
//
// It visits the nodes in the plain walk's order (near child popped
// first) and reads the packed tables: an inner node is one 64-byte record
// (both children's boxes and child words, four 16-byte loads through the
// read-only path); a leaf's count and first triangle ride in its child
// word on the stack; a triangle is one 48-byte record (three 16-byte
// loads). The stack is the thread's column of walk_stack (depth + 1
// entries, all a walk can occupy). Same values, same operations: every
// hit equals the plain walk's bit for bit.
//
// A walk can run in slices (walk_begin, then walk_run with a budget of
// node visits until it returns true), so that a caller can give lanes
// whose walks ended new work between slices; bvh_nearest_hit runs one
// slice to the end.
struct Walk {
  V o, d, inv;
  float best_t;
  int best_i;
  int excl;
  int sp;  // stack entries in use; 0: the walk is over
  bool any_hit;
};

__device__ __forceinline__ void walk_begin(const SceneArgs& s, V o, V dir, int excl,
                                           bool any_hit, Walk& w) {
  w.best_t = INF_T;
  w.best_i = 0;
  w.sp = 0;
  if ((dir.x == 0.0f && dir.y == 0.0f && dir.z == 0.0f) || s.n_nodes <= 1) return;
  w.o = o;
  w.d = normalize(dir);
  w.inv = {1.0f / w.d.x, 1.0f / w.d.y, 1.0f / w.d.z};
  w.excl = excl;
  w.any_hit = any_hit;
  walk_stack[threadIdx.x] = s.bvh_root;
  w.sp = 1;
}

// Up to `budget` node visits of the walk; true when it is over.
__device__ __forceinline__ bool walk_run(const SceneArgs& s, Walk& w, int budget) {
  int* stack = walk_stack + threadIdx.x;
  const int stride = blockDim.x;
  const int4* nodes = reinterpret_cast<const int4*>(s.bvh_nodes);
  const float4* tris = reinterpret_cast<const float4*>(s.tri_packed);
  int sp = w.sp;
  for (; sp > 0 && budget > 0; --budget) {
    int spm = sp - 1;
    int node = stack[spm * stride];
    sp = spm;
    if (node < 0) {  // a leaf: LEAF_FLAG | count << 24 | first triangle
      int n = (node >> 24) & 0x7f;
      int base = node & 0xffffff;
      for (int k = 0; k < n; ++k) {
        int id = base + k;
        if (id == w.excl) continue;
        float4 a = __ldg(tris + 3 * id), b = __ldg(tris + 3 * id + 1),
               c = __ldg(tris + 3 * id + 2);
        float t;
        bool hit = ray_triangle(w.o, w.d, V{a.x, a.y, a.z}, V{a.w, b.x, b.y},
                                V{b.z, b.w, c.x}, t);
        if (hit && t < INF_T && (t < w.best_t || (t == w.best_t && id < w.best_i))) {
          w.best_t = t;
          w.best_i = id;
          if (w.any_hit) {
            w.sp = 0;
            return true;
          }
        }
      }
    } else {  // an inner node's record: left aa, bb, right aa, bb, words
      const int4* rec = nodes + 4 * node;
      int4 a = __ldg(rec), b = __ldg(rec + 1), c = __ldg(rec + 2), cw = __ldg(rec + 3);
      int l = cw.x, r = cw.y;
      bool has_l = l != LEAF_FLAG, has_r = r != LEAF_FLAG;
      float enter_l = 0.0f, dist_l = -1.0f, enter_r = 0.0f, dist_r = -1.0f;
      if (has_l)
        ray_aabb(w.o, w.inv, V{__int_as_float(a.x), __int_as_float(a.y), __int_as_float(a.z)},
                 V{__int_as_float(a.w), __int_as_float(b.x), __int_as_float(b.y)}, enter_l,
                 dist_l);
      if (has_r)
        ray_aabb(w.o, w.inv, V{__int_as_float(b.z), __int_as_float(b.w), __int_as_float(c.x)},
                 V{__int_as_float(c.y), __int_as_float(c.z), __int_as_float(c.w)}, enter_r,
                 dist_r);
      bool push_l = has_l && dist_l > 0.0f && enter_l <= w.best_t;
      bool push_r = has_r && dist_r > 0.0f && enter_r <= w.best_t;
      bool both = push_l && push_r;
      bool near_is_l = dist_l < dist_r;
      if (push_l || push_r) {
        stack[(sp++) * stride] = both ? (near_is_l ? r : l) : (push_l ? l : r);
        if (both && spm + 1 < s.stack_size) stack[(sp++) * stride] = near_is_l ? l : r;
      }
    }
  }
  w.sp = sp;
  return sp == 0;
}

__device__ __forceinline__ bool bvh_nearest_hit(const SceneArgs& s, V o, V dir, int excl,
                                                bool any_hit, float& best_t, int& best_i) {
  Walk w;
  walk_begin(s, o, dir, excl, any_hit, w);
  walk_run(s, w, 0x7fffffff);
  best_t = w.best_t;
  best_i = w.best_i;
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

// ---- pixel windows (core/film.window_pixels) -------------------------------
// The film pixel of slot `slot` of the pixel window from pixel pix0: with
// r.row_step 1 the window is contiguous (pix0 + slot); with a larger step
// it holds whole film rows row0, row0 + row_step, .. (pix0 = row0 x width),
// slot j in its row j / width at column j % width.
__device__ __forceinline__ uint32_t window_pixel(const RenderArgs& r, int pix0, int slot) {
  return (uint32_t)(pix0 + slot + (slot / r.width) * ((r.row_step - 1) * r.width));
}

// ---- camera (core/camera.generate_rays_p) ----------------------------------
// Jittered primary direction of pixel `pix`; hj = sample_hash + seed*KSEED.
__device__ V camera_dir(const RenderArgs& r, uint32_t pix, uint32_t hj) {
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
  return normalize(d);
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
// Cg-style refraction (gen_refract_ray, PathTrace.cu:876-894); d_in points
// into the surface. On total internal reflection: d_in, full_reflex set.
__device__ __forceinline__ V refract_dir(V d_in, V normal, float eta, bool& full_reflex) {
  float cosi = dot(d_in, normal);
  V n = cosi > 0.0f ? -normal : normal;
  cosi = fabsf(cosi);
  float cost2 = 1.0f - eta * eta * (1.0f - cosi * cosi);
  full_reflex = cost2 <= 0.0f;
  float safe = sqrtf(cost2 > 0.0f ? cost2 : 0.0f);
  V refracted = d_in * eta + n * (eta * cosi - safe);
  return full_reflex ? d_in : refracted;
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

// What one bounce decides before its traces (wavefront.bounce_front).
struct Front {
  V emissive;    // the hit material's emission (the emit-break value)
  V fr;          // brdf / pi
  V f_entry;     // sss_entry ? albedo / pi : fr
  V exit_norm;
  V inner_dir;
  V nee_src;     // origin of every segment of this bounce
  V nee_norm;
  V bss;
  V hdir;        // HDR NEE direction (raw; bounce_dirs_dev)
  V cdir;        // continuation direction (raw; bounce_dirs_dev)
  float r0_sss;
  float total_area;
  float k;
  float dot_on;  // out_dir . normal
  int nee_excl;  // the triangle every segment skips
  bool emit_break;
  bool sss_entry;
  bool sss_exit;
  bool is_mirror;
  bool needs_nee;
  bool is_dirref;  // takes direct refraction; the march's results below
  bool ref_escaped;
  int ref_last;    // the last triangle the march hit (continuation's exclusion)
  V ref_dir;       // exit direction (raw): the continuation direction
  V ref_src;       // exit point: the continuation's origin
  V ref_rate;      // throughput through the medium
};

// Branch selection and the SSS exit point and its shading values of an
// active path (PathTrace.cu:905-1070); bounce_dirs_dev adds the directions.
// On an emission break only emissive, nee_src and nee_excl are set.
__device__ void bounce_front_dev(const SceneArgs& s, const RenderArgs& r, uint32_t hb,
                                 const Path& p, Front& f) {
  const V zero3 = {0.0f, 0.0f, 0.0f};
  int tri = p.tri;
  int obj = s.tri_obj[tri];
  V normal = load3(s.tri_norm, tri);
  f.emissive = load3(s.mat_emissive, obj);
  f.nee_src = p.src;
  f.nee_excl = tri;
  f.sss_entry = f.sss_exit = f.is_mirror = f.needs_nee = f.is_dirref = false;
  int refract = s.mat_refract[obj];
  int reflex = s.mat_reflex[obj];

  // branch selection (PathTrace.cu:923-931)
  float u_sel = draw(hb, S_SELECT_REFRACT);
  float u_sss = draw(hb, S_SELECT_SSS);
  f.emit_break = f.emissive.x > EMIT_BREAK_EPS || f.emissive.y > EMIT_BREAK_EPS ||
                 f.emissive.z > EMIT_BREAK_EPS;
  if (f.emit_break) return;  // break with l_dir = Le (counted twice at bounce 0)
  bool take_refract = u_sel < 0.5f && refract != 0;
  bool is_sss = take_refract && refract == 1;
  f.sss_entry = is_sss && u_sss < r.sss_rate;
  f.sss_exit = is_sss && !(u_sss < r.sss_rate);
  bool is_diffuse = !take_refract && reflex == 0;
  f.is_mirror = !take_refract && reflex == 1;
  f.is_dirref = take_refract && refract == 2;
  f.k = refract != 0 ? 2.0f : 1.0f;
  f.fr = load3(s.mat_brdf, obj) * INV_PI;
  V fr_alb = load3(s.mat_refract_albedo, obj) * INV_PI;
  f.f_entry = f.sss_entry ? fr_alb : f.fr;

  // SSS exit point and its shading values (PathTrace.cu:1029-1070)
  f.exit_norm = normal;
  f.inner_dir = p.out_dir;
  f.bss = zero3;
  f.r0_sss = 0.0f;
  f.total_area = 1.0f;
  if (f.sss_exit) {
    int et = area_cdf_pick(s, draw(hb, S_AREA_CDF), obj);
    int eobj = s.tri_obj[et];
    V ep = triangle_point(load3(s.tri_p1, et), load3(s.tri_p2, et), load3(s.tri_p3, et),
                          draw(hb, S_EXIT_U), draw(hb, S_EXIT_V));
    f.exit_norm = load3(s.tri_norm, et);
    f.inner_dir = ep - p.src;
    float inner_dist = sqrtf(dot(f.inner_dir, f.inner_dir));
    f.r0_sss = schlick_r0(s.mat_refract_index[obj]);
    float fres_i = fresnel_entry(f.r0_sss, fabsf(dot(normal, p.out_dir)));
    float dist = inner_dist < 1e-12f ? 1e-12f : inner_dist;
    float third = dist / 3.0f;
    V sigma = load3(s.mat_refract_rate, eobj);
    f.bss = V{bssrdf_chan(dist, third, sigma.x), bssrdf_chan(dist, third, sigma.y),
              bssrdf_chan(dist, third, sigma.z)} * fres_i;
    f.total_area = s.obj_total_area[eobj];
    f.nee_src = ep;
    f.nee_excl = et;
  }
  f.nee_norm = f.sss_exit ? f.exit_norm : normal;
  f.needs_nee = is_diffuse || f.sss_entry || f.sss_exit;
  f.dot_on = dot(p.out_dir, normal);
}

// The DIR_REFRACT march of a path that takes direct refraction
// (PathTrace.cu:1180-1234; wavefront.refract_march for one lane): refract
// into the medium, then up to max_refract steps: trace to the next
// surface, absorb rate^t, refract out (x (1 - Fresnel) x 1.25) or reflect
// inside (total internal reflection, or a draw below
// internal_reflect_rate: x Fresnel x 5). Writes f.ref_*; a trace that
// hits nothing escapes. Returns the march's steps: its traces, each one walk.
__device__ int refract_march_dev(const SceneArgs& s, const RenderArgs& r, uint32_t hb,
                                 const Path& p, Front& f) {
  float miu = s.mat_refract_index[s.tri_obj[p.tri]];
  V normal = load3(s.tri_norm, p.tri);
  float r0 = schlick_r0(miu);
  float fres_i = fresnel_entry(r0, fabsf(dot(normal, p.out_dir)));
  bool tir;
  V rdir = refract_dir(-p.out_dir, normal, 1.0f / miu, tir);
  float one_m = 1.0f - fres_i;
  V rate = {one_m, one_m, one_m};
  V src = p.src;
  int excl = p.tri;
  bool escaped = false;
  int steps = 0;
  for (int i = 0; i < r.max_refract; ++i) {
    float t;
    int idx;
    ++steps;
    if (!trace(s, src, rdir, excl, false, t, idx)) {
      escaped = true;
      break;
    }
    V rdir_u = unit_eps(rdir);
    V n_i = load3(s.tri_norm, idx);
    bool full_reflex;
    V new_rdir = refract_dir(rdir_u, n_i, miu, full_reflex);
    V rr8 = load3(s.mat_refract_rate, s.tri_obj[idx]);
    rate = rate * V{powf(rr8.x, t), powf(rr8.y, t), powf(rr8.z, t)};
    src = src + rdir_u * t;
    excl = idx;
    float fres_o = fresnel_exit(r0, fabsf(dot(new_rdir, n_i)));
    bool reflect_pick =
        full_reflex || draw(hb, S_REFRACT_BASE + (uint32_t)i) < r.internal_reflect_rate;
    if (!reflect_pick) {  // exits the medium
      rate = rate * (1.0f - fres_o) * 1.25f;
      rdir = new_rdir;
      break;
    }
    if (!full_reflex) rate = rate * fres_o * 5.0f;
    rdir = vreflect(new_rdir, n_i);
  }
  f.ref_dir = rdir;
  f.ref_src = src;
  f.ref_rate = rate;
  f.ref_last = excl;
  f.ref_escaped = escaped;
  return steps;
}

// The HDR NEE direction and the continuation direction of a path that
// did not break on emission (PathTrace.cu:968-994, 1378; with HR a direct
// refraction lane continues along the march's exit direction). Apart from
// bounce_front_dev so that the megakernel computes them after its light
// traces and does not hold them across those walks.
template <bool HR>
__device__ __forceinline__ void bounce_dirs_dev(const SceneArgs& s, uint32_t hb, const Path& p,
                                                Front& f) {
  V normal = load3(s.tri_norm, p.tri);
  V hdir_raw = uniform_sphere(draw(hb, S_HDR_COS), draw(hb, S_HDR_PHI));
  f.hdir = f.sss_exit ? fold_same(hdir_raw, f.exit_norm, f.inner_dir)
                      : fold_same(hdir_raw, normal, p.out_dir);
  V cdir_raw = uniform_sphere(draw(hb, S_CONT_COS), draw(hb, S_CONT_PHI));
  f.cdir = f.sss_exit ? fold_opposite(cdir_raw, f.exit_norm, f.inner_dir)
                      : fold_same(cdir_raw, normal, p.out_dir);
  if (f.is_mirror) f.cdir = normal * (2.0f * dot(p.out_dir, normal)) - p.out_dir;  // cu:1378
  if (HR && f.is_dirref) f.cdir = f.ref_dir;
}

// The NEE segment toward a point on light i (PathTrace.cu:941-952):
// writes its direction, returns its gate (the entry-type hemisphere test;
// exit lanes have none). Only meaningful when f.needs_nee.
__device__ __forceinline__ bool light_dir_dev(const SceneArgs& s, uint32_t hb, const Front& f,
                                              int i, V& ldir) {
  uint32_t li = S_LIGHT_BASE + 2u * (uint32_t)i;
  V lpoint = triangle_point(load3(s.light_p1, i), load3(s.light_p2, i), load3(s.light_p3, i),
                            draw(hb, li), draw(hb, li + 1u));
  ldir = lpoint - f.nee_src;
  bool same_hemi = dot(ldir, f.nee_norm) * f.dot_on >= 0.0f;
  return same_hemi || f.sss_exit;
}

// Radiance from light i along a visible NEE segment (PathTrace.cu:953-961).
__device__ __forceinline__ V light_contrib_dev(const SceneArgs& s, const Front& f, int i,
                                               V ldir) {
  float d2 = dot(ldir, ldir);
  float geom = fabsf(dot(f.nee_norm, ldir) * dot(load3(s.light_norm, i), ldir)) / d2 / d2 *
               s.light_area[i];
  V l_emis = load3(s.light_emis, i);
  if (f.sss_exit) {
    float fres_o = fresnel_exit(f.r0_sss, fabsf(dot(unit_eps(ldir), f.exit_norm)));
    return (l_emis * fres_o * f.bss * geom) / PI_F * f.total_area;
  }
  return l_emis * f.f_entry * geom;
}

// The bounce after its traces (wavefront.resolve_tail for one lane): the
// env NEE term, the branch scale, Russian roulette, the continuation rate
// and the break values (PathTrace.cu:968-1416). `l_dir` is the sum of the
// visible lights' radiance, in light order. Returns accept and writes the
// stack entry (dir_out, rate_out); on accept the path moves to the
// continuation hit (c_t, c_idx). With HR, a direct refraction lane whose
// march escaped does not continue, and the caller kills the path.
template <bool HR>
__device__ bool resolve_tail_dev(const SceneArgs& s, const RenderArgs& r, uint32_t hb,
                                 const Front& f, V l_dir, bool h_hit, bool c_hit,
                                 float c_t, int c_idx, Path& p, V& dir_out, V& rate_out) {
  const V zero3 = {0.0f, 0.0f, 0.0f};
  if (f.emit_break) {
    dir_out = f.emissive;
    rate_out = zero3;
    return false;
  }
  // NEE environment through the any-hit visibility ray (cu:968-980 / 1111-1130)
  if (f.needs_nee && !h_hit) {
    V sky = env_sample(s, unit_eps(f.hdir), r.hdr_clamp);
    float cos_h = fabsf(dot(f.hdir, f.nee_norm));
    V env_c;
    if (f.sss_exit) {
      float fres_oh = fresnel_exit(f.r0_sss, fabsf(dot(f.hdir, f.exit_norm)));
      env_c = sky * fres_oh * f.bss * cos_h * 2.0f;
    } else {
      env_c = sky * f.f_entry * cos_h * TWO_PI;
    }
    l_dir = l_dir + env_c;
  }
  // branch scale (cu:986, 1133, 1322)
  float k_entry = f.k / r.sss_rate;
  float k_exit = f.k / r.one_m_sss;
  float scale = f.sss_entry ? k_entry : (f.sss_exit ? k_exit : f.k);
  l_dir = f.needs_nee ? l_dir * scale : zero3;

  // Russian roulette, continuation acceptance and rate
  bool dirref = HR && f.is_dirref;
  V cdir_u = unit_eps(f.cdir);
  bool rr_ok = draw(hb, S_RR) < r.rr_rate;
  bool accept = false;
  if (c_hit && rr_ok) {
    V cem = load3(s.mat_emissive, s.tri_obj[c_idx]);
    float m1 = cem.x > cem.y ? cem.x : cem.y;
    float mm = m1 > cem.z ? m1 : cem.z;
    accept = f.is_mirror || dirref || mm < EMIT_SKIP_EPS;
  }
  if (dirref && f.ref_escaped) accept = false;  // the kill (cu:1254)
  V rate_mirror = f.fr * (f.k / r.rr_over_pi);  // cu:1391
  if (accept) {
    if (f.is_mirror) {
      rate_out = rate_mirror;
      dir_out = zero3;
    } else if (dirref) {
      rate_out = f.ref_rate * (f.k / r.rr_rate);
      dir_out = zero3;
    } else {
      float cos_c = fabsf(dot(cdir_u, f.nee_norm));
      if (f.sss_exit) {  // cu:1160, 1166
        float cos_e = fabsf(dot(cdir_u, f.exit_norm));
        float fres_oc = fresnel_exit(f.r0_sss, cos_e);
        rate_out = (f.bss * fres_oc * cos_e * f.total_area * 2.0f) / r.rr_rate * k_exit;
      } else if (f.sss_entry) {  // cu:1008
        rate_out = (f.fr * cos_c) / r.rr_rate * k_entry;
      } else {  // cu:1344
        rate_out = (f.fr * cos_c) / r.rr_rate * f.k;
      }
      dir_out = l_dir;
    }
    p.src = (dirref ? f.ref_src : f.nee_src) + cdir_u * c_t;
    p.out_dir = -cdir_u;
    p.tri = c_idx;
    return true;
  }
  // break values (cu:1396, 1254)
  if (f.is_mirror) {
    dir_out = (rr_ok && !c_hit) ? env_sample(s, cdir_u, r.hdr_clamp) * rate_mirror : zero3;
  } else if (dirref) {
    dir_out = (rr_ok && !c_hit && !f.ref_escaped)
                  ? env_sample(s, cdir_u, r.hdr_clamp) * f.ref_rate * (f.k / r.rr_rate)
                  : zero3;
  } else {
    dir_out = l_dir;
  }
  rate_out = zero3;
  return false;
}

}  // namespace
