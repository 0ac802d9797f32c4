// Megakernel for Hopper (sm_90a): the whole NEE path-tracing render of a
// film x spp in one launch.
//
// Replaces the JAX package's Pallas TPU megakernel
// ops/pallas/mega.py::render_mega -> _mega_kernel (and, inside it, _sweep,
// _rows_fetch/_take_rows, _env_sample and _cdf_pick). It computes what
// that kernel and the scan engine compute — per-pixel radiance SUMS over
// spp samples plus the count of useful rays — but none of the TPU
// mechanics carry over (one-hot MXU gathers, triangular-matmul
// compaction, bf16x3 splits, 128-lane packing, VMEM budgets).
//
// Semantics are those of the plain torch version (integrator/wavefront.py
// trace_radiance_p), through the device functions of path.cuh, which the
// pool engine's kernels (pool.cu) share. The radiance is composited
// forward (L += T*dir; T *= rate) with the depth-cap term the reference's
// backward fold (PathTrace.cu:1410-1415, wavefront.composite_p) seeds from
// its top entry, as the pool's resolve kernel does: the same sum as the
// plain version's, rounded in another order, so the two agree to a few
// ulps. A pixel's samples run in ascending order on one thread, so its sum
// sees them in the plain version's order. Deterministic: no float atomics.
//
// What bounds it on this card: not FLOPs or bytes but the BVH walk, a
// chase of dependent loads whose length differs from ray to ray (a few
// box tests for most rays, tens for a few), and the shading between
// walks. The design serves that walk:
// - One walk call site. A thread runs a small state machine over the
//   ray queries of its path: the camera ray, then per bounce light
//   0..E-1, the HDR visibility ray, the continuation. Between walks it
//   carries only its path (Path, L, T, the summed light radiance, flags,
//   counters) in registers. The bounce's Front (branch, shading values,
//   directions, the march's exit) is made once a bounce, when the path
//   enters it, and lives in shared memory across the bounce's walks (47
//   words a thread, an odd stride: no bank conflicts).
// - Walks in slices. The loop runs every lane's walk for at most
//   MEGA_WALK_SLICE node visits; a lane whose walk ended uses its result
//   and makes its next query between two slices, while the others walk
//   on, so a long walk does not hold the lanes of its warp idle. The
//   shading (each device function at one call site) runs for the lanes
//   that need it together.
// - Path regeneration. A sample that ends starts the pixel's next sample
//   at once, and a lane whose pixel is done takes the next pixel: no lane
//   waits at a sample or bounce boundary for its warp's longest path.
// - A persistent grid (SMs x resident blocks) whose warps take pixels
//   from a global counter, as many as their lanes need, one atomicAdd a
//   warp.
// - A pixel window, as the TPU kernel's shard_px and offset: the counter
//   hands out slots 0 .. n_px-1 of the window, the pixel is pix0 + slot
//   (the camera ray and every draw key), and the output is indexed by
//   slot. A multi-device render runs one window a tile shard.
// - The packed walk tables and the shared-memory stack of path.cuh.
// Direct refraction (DIR_REFRACT): the kernel is a template on HR; the
// march (refract_march_dev, with its own walk, the second call site, in
// the HR = true instance alone) runs when the path enters the bounce and
// leaves its results in the Front.

#include "path.cuh"

namespace {

// Measured on the H100 at the main path (PERF.md): 128-thread blocks
// 12.0-12.8 ms, 256-thread blocks 12.5; register caps of 96 and 80 13.2
// and 14.1 ms, the 64-register cap spills and is the slowest; slices of
// 4-10 node visits 12.0-13.1 ms, of 12 or more, or none, 17.5-18.8.
constexpr int MEGA_THREADS = 128;
constexpr int MEGA_MIN_BLOCKS = 4;  // 65536 / (128 x 4): at most 128 registers, 25% occupancy
constexpr int MEGA_WALK_SLICE = 8;  // node visits between two looks for lanes whose walk ended

constexpr int ST_PRIMARY = -1;  // step: the camera ray; 0..E-1 light i, E HDR, E+1 continuation

// The block's dynamic shared memory: the walk stacks (path.cuh), then one
// Front a thread.
__host__ __device__ inline size_t mega_smem_bytes(const SceneArgs& s) {
  return walk_smem_bytes(s, MEGA_THREADS) + MEGA_THREADS * sizeof(Front);
}

template <bool HR>
__global__ void __launch_bounds__(MEGA_THREADS, MEGA_MIN_BLOCKS)
mega_render_kernel(SceneArgs s, RenderArgs r, int pix0, int n_px, float* __restrict__ out,
                   int* __restrict__ next_pixel) {
  const int st_hdr = s.n_emit, st_cont = s.n_emit + 1;
  const unsigned lane = threadIdx.x & 31u;
  const V eye = {r.eye[0], r.eye[1], r.eye[2]};
  const V zero3 = {0.0f, 0.0f, 0.0f};
  // the bounce's front, directions and march, made once a bounce
  Front& f = reinterpret_cast<Front*>(walk_stack + blockDim.x * s.stack_size)[threadIdx.x];

  int pix = -1;  // the thread's slot of the window; -1: take one; >= n_px: the window is done
  int k = 0;     // its sample (sample_base + k)
  V sum = zero3;
  int nray = 0;  // useful rays (integers, exact in the f32 output)
  uint32_t h0 = 0;
  int step = ST_PRIMARY, b = 0;
  bool entered = false;  // the path entered bounce b; its front is not made yet
  Path p = {zero3, zero3, 0};
  V L = zero3, T = zero3, le0 = zero3, l_dir = zero3;
  bool h_hit = false;
  V qd = zero3;              // the query's raw direction (the camera ray's, at the hit)
  Walk w;                    // the lane's walk, run in slices
  w.sp = 0;
  bool walking = false;

  auto enter_bounce = [&]() {
    nray += s.n_emit + 2;
    l_dir = zero3;
    h_hit = false;
    step = 0;
    entered = true;
  };

  for (;;) {
    bool start = false;  // begin a sample of pix this iteration
    bool query = false;  // a new query (qo, qd, qx, q_any) to walk
    V qo = zero3;
    int qx = -1;
    bool q_any = false;
    if (pix >= 0 && pix < n_px && !walking) {
      // use the ended walk's result and make the next query, in passes over
      // the steps; each device function has one call site, so lanes of a
      // warp that stand at different steps run it together
      const bool hit = w.best_t < INF_T;
      const float t = w.best_t;
      const int idx = w.best_i;
      bool consumed = false;  // the walk's result is used
      bool done = false;      // the sample ended: its radiance in rad
      V rad = zero3;
      for (;;) {
        uint32_t hb = bounce_hash(h0, r.seed, b);
        if (step == ST_PRIMARY) {  // the camera ray's hit starts the path
          consumed = true;
          if (!hit) {
            rad = env_sample(s, qd, r.hdr_clamp);
            done = true;
            break;
          }
          le0 = load3(s.mat_emissive, s.tri_obj[idx]);
          p = {eye + qd * t, -qd, idx};
          L = zero3;
          T = {1.0f, 1.0f, 1.0f};
          b = 0;
          if (r.max_depth <= 0) {
            rad = le0 + L;
            done = true;
            break;
          }
          enter_bounce();
          continue;
        }
        bool dirref = HR && f.is_dirref;
        if (entered) {
          entered = false;
          bounce_front_dev(s, r, hb, p, f);
          dirref = HR && f.is_dirref;
          if (f.emit_break) {  // break with l_dir = Le: resolved below without a walk
            step = st_cont;
            consumed = false;
          } else if (dirref) {  // the continuation leaves the medium at the march's exit
            refract_march_dev(s, r, hb, p, f);
          }
          if (!f.emit_break) bounce_dirs_dev<HR>(s, hb, p, f);
        }
        // lights: use the pending light's walk, make the next gated light's
        // query (exact-index visibility, cu:941-961)
        while (step < st_hdr && f.needs_nee) {
          V ldir;
          bool gate = light_dir_dev(s, hb, f, step, ldir);
          if (!consumed) {
            consumed = true;
            if (hit && idx == s.emit_idx[step]) l_dir = l_dir + light_contrib_dev(s, f, step, ldir);
          } else if (gate) {
            qo = f.nee_src;
            qd = ldir;
            qx = f.nee_excl;
            q_any = false;
            query = true;
            break;
          }
          ++step;
        }
        if (query) break;
        if (step < st_hdr) step = st_cont;  // no NEE: no light and no HDR ray
        if (step == st_hdr) {
          if (!consumed) {
            consumed = true;
            h_hit = hit;
            step = st_cont;
          } else if (f.needs_nee) {
            qo = f.nee_src;
            qd = f.hdir;
            qx = f.nee_excl;
            q_any = true;
            query = true;
            break;
          } else {
            step = st_cont;
          }
        }
        if (consumed) {  // the continuation's query
          qo = dirref ? f.ref_src : f.nee_src;
          qd = f.cdir;
          qx = dirref ? f.ref_last : f.nee_excl;
          q_any = false;
          query = true;
          break;
        }
        consumed = true;  // resolve the bounce (wavefront.bounce_step)
        V dir_b, rate_b;
        bool accept = resolve_tail_dev<HR>(s, r, hb, f, l_dir, h_hit, hit, t, idx, p, dir_b,
                                           rate_b);
        L = L + T * dir_b;
        T = T * rate_b;
        if (accept && b < r.max_depth - 1) {
          ++b;
          enter_bounce();
          continue;
        }
        if (accept) L = L + T * dir_b;                 // the fold's depth-cap seed
        else if (dirref && f.ref_escaped) L = zero3;  // the escape kill (cu:1254)
        rad = le0 + L;
        done = true;
        break;
      }
      if (done) {  // add the sample; the pixel's next, or write the pixel
        sum = sum + rad;
        if (++k < r.spp) {
          start = true;
        } else {
          out[pix] = sum.x;
          out[n_px + pix] = sum.y;
          out[2 * n_px + pix] = sum.z;
          out[3 * n_px + pix] = (float)nray;
          pix = -1;
        }
      }
    }
    // lanes without a pixel take the next ones: one atomicAdd a warp
    bool need = pix < 0;
    unsigned want = __ballot_sync(0xffffffffu, need);
    if (want) {
      int leader = __ffs(want) - 1;
      int base = 0;
      if ((int)lane == leader) base = atomicAdd(next_pixel, __popc(want));
      base = __shfl_sync(0xffffffffu, base, leader);
      if (need) {
        pix = base + __popc(want & ((1u << lane) - 1u));
        k = 0;
        sum = zero3;
        nray = 0;
        start = pix < n_px;
      }
    }
    if (start) {  // the camera ray of sample k (wavefront.trace_radiance_p)
      const uint32_t gpix = (uint32_t)(pix0 + pix);  // the film's pixel
      h0 = sample_hash(gpix, r.sample_base + (uint32_t)k);
      qo = eye;
      qd = unit_eps(camera_dir(r, gpix, h0 + r.seed * K_SEED));
      qx = -1;
      q_any = false;
      step = ST_PRIMARY;
      nray += 1;
      query = true;
    }
    if (query) {  // the one walk of the loop (trace(): the direction made unit)
      walk_begin(s, qo, unit_eps(qd), qx, q_any, w);
      walking = true;
    }
    if (!__any_sync(0xffffffffu, pix < n_px)) break;  // every lane holds a slot here
    if (walking) walking = !walk_run(s, w, MEGA_WALK_SLICE);
  }
}

}  // namespace

extern "C" {

// Radiance sums [3, n_px] and useful rays [1, n_px] of the pixels pix0 ..
// pix0 + n_px - 1 into out [4, n_px]; next_pixel: one int, zero at the
// launch (the wrapper's).
int mega_render(const SceneArgs* s, const RenderArgs* r, int pix0, int n_px, float* out,
                int* next_pixel, void* stream) {
  if (n_px <= 0) return 0;
  auto kernel = s->has_refract ? mega_render_kernel<true> : mega_render_kernel<false>;
  size_t smem = mega_smem_bytes(*s);
  long long blocks = 0;
  int rc = persistent_grid(kernel, MEGA_THREADS, smem, (n_px + MEGA_THREADS - 1) / MEGA_THREADS,
                           blocks);
  if (rc) return rc;
  kernel<<<(unsigned)blocks, MEGA_THREADS, smem, (cudaStream_t)stream>>>(*s, *r, pix0, n_px, out,
                                                                          next_pixel);
  return (int)cudaGetLastError();
}

}  // extern "C"
