// Megakernel for Hopper (sm_90a): the whole NEE path-tracing render of a
// film x spp in one launch.
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
// Semantics are those of the plain torch version (integrator/wavefront.py
// trace_radiance_p), through the device functions of path.cuh, which the
// pool engine's kernels (pool.cu) share. The radiance is composited
// forward (L += T*dir; T *= rate) with the depth-cap term the backward
// fold seeds from its top entry (wavefront.py composite_p; the pool's
// resolve kernel does the same). Deterministic: no atomics.
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
// Direct refraction (DIR_REFRACT, the in-kernel march of _mega_kernel):
// the kernel is a template on HR, and the wrapper launches the HR = true
// instance only for scenes with DIR_REFRACT materials, so the march's
// state (its loop of walks and 11 values) is not live in the code that
// renders other scenes: their instance compiles as it did without it.

#include "path.cuh"

namespace {

// One bounce of an active path (wavefront.bounce_step for one lane):
// returns accept and writes the stack entry (dir_out, rate_out); with HR,
// `killed` is set when a direct refraction march escaped.
template <bool HR>
__device__ bool bounce(const SceneArgs& s, const RenderArgs& r, uint32_t hb,
                       Path& p, V& dir_out, V& rate_out, bool& killed) {
  Front f;
  bounce_front_dev(s, r, hb, p, f);
  if (f.emit_break) {  // break with l_dir = Le (counted twice at bounce 0)
    dir_out = f.emissive;
    rate_out = {0.0f, 0.0f, 0.0f};
    return false;
  }
  V l_dir = {0.0f, 0.0f, 0.0f};
  if (f.needs_nee) {
    // NEE to each emissive triangle, exact-index visibility (cu:941-961)
    for (int i = 0; i < s.n_emit; ++i) {
      V ldir;
      if (!light_dir_dev(s, hb, f, i, ldir)) continue;
      float lt;
      int lidx;
      if (!trace(s, f.nee_src, ldir, f.nee_excl, false, lt, lidx) || lidx != s.emit_idx[i])
        continue;
      l_dir = l_dir + light_contrib_dev(s, f, i, ldir);
    }
  }
  // the march and the directions only now, so that they are not held
  // across the light walks (a direct refraction lane has no NEE)
  if (HR && f.is_dirref) refract_march_dev(s, r, hb, p, f);
  bounce_dirs_dev<HR>(s, hb, p, f);
  bool h_hit = false;
  if (f.needs_nee) {
    float ht;
    int hidx;
    h_hit = trace(s, f.nee_src, f.hdir, f.nee_excl, true, ht, hidx);
  }
  float c_t;
  int c_idx;
  V c_src = f.nee_src;
  int c_excl = f.nee_excl;
  if (HR && f.is_dirref) {  // the continuation leaves the medium at the march's exit
    c_src = f.ref_src;
    c_excl = f.ref_last;
    killed = f.ref_escaped;
  }
  bool c_hit = trace(s, c_src, f.cdir, c_excl, false, c_t, c_idx);
  return resolve_tail_dev<HR>(s, r, hb, f, l_dir, h_hit, c_hit, c_t, c_idx, p, dir_out,
                              rate_out);
}

// One jittered camera path of pixel `pix`, sample `smp` -> radiance.
template <bool HR>
__device__ V trace_sample(const SceneArgs& s, const RenderArgs& r, uint32_t pix,
                          uint32_t smp, float& rays) {
  uint32_t h0 = sample_hash(pix, smp);
  V d = camera_dir(r, pix, h0 + r.seed * K_SEED);
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
    V dir_b, rate_b;
    bool killed = false;
    bool accept = bounce<HR>(s, r, bounce_hash(h0, r.seed, b), p, dir_b, rate_b, killed);
    L = L + T * dir_b;
    T = T * rate_b;
    if (!accept) {
      if (HR && killed) L = {0.0f, 0.0f, 0.0f};  // the escape kill (cu:1254)
      break;
    }
    if (b == r.max_depth - 1) L = L + T * dir_b;  // the fold's depth-cap seed
  }
  return le0 + L;
}

template <bool HR>
__global__ void __launch_bounds__(128)
mega_render_kernel(SceneArgs s, RenderArgs r, float* __restrict__ out) {
  int pixel = blockIdx.x * blockDim.x + threadIdx.x;
  if (pixel >= r.npix) return;
  V sum = {0.0f, 0.0f, 0.0f};
  float rays = 0.0f;
  for (int k = 0; k < r.spp; ++k) {
    float n;
    V rad = trace_sample<HR>(s, r, (uint32_t)pixel, r.sample_base + (uint32_t)k, n);
    sum = sum + rad;
    rays += n;
  }
  out[pixel] = sum.x;
  out[r.npix + pixel] = sum.y;
  out[2 * r.npix + pixel] = sum.z;
  out[3 * r.npix + pixel] = rays;
}

}  // namespace

extern "C" {

// Radiance sums [3, npix] and useful rays [1, npix] into out [4, npix].
int mega_render(const SceneArgs* s, const RenderArgs* r, float* out, void* stream) {
  int threads = 128;
  int blocks = (r->npix + threads - 1) / threads;
  cudaStream_t st = (cudaStream_t)stream;
  if (s->has_refract)
    mega_render_kernel<true><<<blocks, threads, 0, st>>>(*s, *r, out);
  else
    mega_render_kernel<false><<<blocks, threads, 0, st>>>(*s, *r, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
