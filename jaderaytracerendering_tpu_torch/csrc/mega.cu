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
// ulps.
//
// Work items and the fold. A launch of spp samples over a window of n_px
// slots has n_px x spp items: item i is sample i % spp of slot i / spp, so
// a pixel's samples sit side by side and spread over neighbouring lanes. A
// lane runs its item's sample and stores its radiance and useful rays as
// one float4 partial; mega_fold_kernel then sums each slot's spp partials
// in ascending sample order from zero: the additions of one thread summing
// its pixel's samples in turn. The items depend on spp alone, never on the
// window, so a pixel's sum is the same whichever lane ran which item and
// whichever window holds it. No float atomics.
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
// - Path regeneration. A lane whose sample ends takes the next item at
//   once: no lane waits at a sample or bounce boundary for its warp's
//   longest path, and once the counter runs dry a launch waits for one
//   sample's path, not for a whole pixel's.
// - A persistent grid (SMs x resident blocks) whose warps take items from
//   a global counter, as many as their lanes need, one atomicAdd a warp.
// - A pixel window, as the TPU kernel's shard_px and offset: slot j of the
//   window is the pixel window_pixel(r, pix0, j) (path.cuh: pix0 + j, or
//   whole rows r.row_step apart), which gives the camera ray and every
//   draw key, and the output is indexed by slot. A launch runs slots
//   slot0 .. of its window. A multi-device render runs one window a tile
//   rank: its film rows dealt round-robin.
// - Optional stamps (seven u64, or null): three of %globaltimer ns, the
//   warps' first start (atomicMin), the first handout that finds the
//   counter dry (atomicMin), the warps' last exit (atomicMax); then two
//   counts, the bounces resolved and those whose branch is SSS entry or
//   exit, and, in the HR = true instance alone, two more: the bounces
//   whose branch is direct refraction and their march steps (each one
//   walk). Each thread counts in registers; at exit each warp adds its
//   sums, one atomicAdd a count. ops/mega.py reads them as the launch's
//   time, its tail, its bounces and its marches.
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
constexpr int FOLD_THREADS = 256;

constexpr int ST_PRIMARY = -1;  // step: the camera ray; 0..E-1 light i, E HDR, E+1 continuation

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The block's dynamic shared memory: the walk stacks (path.cuh), then one
// Front a thread.
__host__ __device__ inline size_t mega_smem_bytes(const SceneArgs& s) {
  return walk_smem_bytes(s, MEGA_THREADS) + MEGA_THREADS * sizeof(Front);
}

template <bool HR>
__global__ void __launch_bounds__(MEGA_THREADS, MEGA_MIN_BLOCKS)
mega_render_kernel(SceneArgs s, RenderArgs r, int pix0, int slot0, int n_items,
                   float4* __restrict__ part, int* __restrict__ next_item,
                   unsigned long long* __restrict__ stamps) {
  const int st_hdr = s.n_emit, st_cont = s.n_emit + 1;
  const unsigned lane = threadIdx.x & 31u;
  if (stamps && lane == 0) atomicMin(&stamps[0], global_ns());
  const V eye = {r.eye[0], r.eye[1], r.eye[2]};
  const V zero3 = {0.0f, 0.0f, 0.0f};
  // the bounce's front, directions and march, made once a bounce
  Front& f = reinterpret_cast<Front*>(walk_stack + blockDim.x * s.stack_size)[threadIdx.x];

  int item = -1;  // the thread's work item; -1: take one; >= n_items: the launch is done
  int nray = 0;   // its useful rays (integers, exact in the f32 output)
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
  unsigned n_bounce = 0, n_sss = 0;  // bounces resolved, and of them SSS entry or exit
  unsigned n_ref = 0, n_march = 0;   // HR: direct refraction bounces, their march steps

  auto enter_bounce = [&]() {
    nray += s.n_emit + 2;
    l_dir = zero3;
    h_hit = false;
    step = 0;
    entered = true;
  };

  for (;;) {
    bool start = false;  // begin the item's sample this iteration
    bool query = false;  // a new query (qo, qd, qx, q_any) to walk
    V qo = zero3;
    int qx = -1;
    bool q_any = false;
    if (item >= 0 && item < n_items && !walking) {
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
          ++n_bounce;
          n_sss += f.sss_entry || f.sss_exit;
          dirref = HR && f.is_dirref;
          if (f.emit_break) {  // break with l_dir = Le: resolved below without a walk
            step = st_cont;
            consumed = false;
          } else if (dirref) {  // the continuation leaves the medium at the march's exit
            n_march += refract_march_dev(s, r, hb, p, f);
            ++n_ref;
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
      if (done) {  // the item's partial
        part[item] = make_float4(rad.x, rad.y, rad.z, __int_as_float(nray));
        item = -1;
      }
    }
    // lanes without an item take the next ones: one atomicAdd a warp
    bool need = item < 0;
    unsigned want = __ballot_sync(0xffffffffu, need);
    if (want) {
      int leader = __ffs(want) - 1;
      int base = 0;
      if ((int)lane == leader) {
        base = atomicAdd(next_item, __popc(want));
        if (stamps && base + __popc(want) >= n_items) atomicMin(&stamps[1], global_ns());
      }
      base = __shfl_sync(0xffffffffu, base, leader);
      if (need) {
        item = base + __popc(want & ((1u << lane) - 1u));
        nray = 0;
        start = item < n_items;
      }
    }
    if (start) {  // the camera ray of the item's sample (wavefront.trace_radiance_p)
      const uint32_t gpix = window_pixel(r, pix0, slot0 + item / r.spp);  // the film's pixel
      h0 = sample_hash(gpix, r.sample_base + (uint32_t)(item % r.spp));
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
    if (!__any_sync(0xffffffffu, item < n_items)) break;  // every lane holds an item here
    if (walking) walking = !walk_run(s, w, MEGA_WALK_SLICE);
  }
  if (stamps) {
    n_bounce = __reduce_add_sync(0xffffffffu, n_bounce);
    n_sss = __reduce_add_sync(0xffffffffu, n_sss);
    if (HR) {
      n_ref = __reduce_add_sync(0xffffffffu, n_ref);
      n_march = __reduce_add_sync(0xffffffffu, n_march);
    }
    if (lane == 0) {
      atomicMax(&stamps[2], global_ns());
      atomicAdd(&stamps[3], (unsigned long long)n_bounce);
      atomicAdd(&stamps[4], (unsigned long long)n_sss);
      if (HR) {
        atomicAdd(&stamps[5], (unsigned long long)n_ref);
        atomicAdd(&stamps[6], (unsigned long long)n_march);
      }
    }
  }
}

// Each slot's radiance sums and useful rays: its spp partials summed in
// ascending sample order from zero, into column `slot` of out (row stride ld).
__global__ void __launch_bounds__(FOLD_THREADS)
mega_fold_kernel(const float4* __restrict__ part, int n_px, int spp,
                 float* __restrict__ out, int ld) {
  const int slot = blockIdx.x * FOLD_THREADS + threadIdx.x;
  if (slot >= n_px) return;
  const float4* p = part + (size_t)slot * spp;
  V sum = {0.0f, 0.0f, 0.0f};
  int nray = 0;
  for (int c = 0; c < spp; ++c) {
    const float4 v = __ldg(p + c);
    sum = sum + V{v.x, v.y, v.z};
    nray += __float_as_int(v.w);
  }
  out[slot] = sum.x;
  out[ld + slot] = sum.y;
  out[2 * (size_t)ld + slot] = sum.z;
  out[3 * (size_t)ld + slot] = (float)nray;  // integers, exact in the f32 output
}

}  // namespace

extern "C" {

// Radiance sums [3, n_px] and useful rays [1, n_px] of the slots slot0 ..
// slot0 + n_px - 1 of the pixel window from pix0 (window_pixel) into out
// (rows 0-3, row stride ld >= n_px). part: the n_px x spp float4 partials;
// next_item: one int, zero at the launch; stamps: null, or seven u64 set to
// (max, max, 0, 0, 0, 0, 0) (the wrapper's; the HR = false instance leaves
// the last two at 0). The megakernel, then the fold, on the stream.
int mega_render(const SceneArgs* s, const RenderArgs* r, int pix0, int slot0, int n_px,
                float* out, int ld, float4* part, int* next_item, unsigned long long* stamps,
                void* stream) {
  if (n_px <= 0) return 0;
  const int spp = r->spp > 0 ? r->spp : 0;
  const long long n_items = (long long)n_px * spp;
  if (n_items > (1LL << 30) || ld < n_px) return (int)cudaErrorInvalidValue;  // int counter
  if (n_items > 0) {
    auto kernel = s->has_refract ? mega_render_kernel<true> : mega_render_kernel<false>;
    size_t smem = mega_smem_bytes(*s);
    long long blocks = 0;
    int rc = persistent_grid(kernel, MEGA_THREADS, smem,
                             (n_items + MEGA_THREADS - 1) / MEGA_THREADS, blocks);
    if (rc) return rc;
    kernel<<<(unsigned)blocks, MEGA_THREADS, smem, (cudaStream_t)stream>>>(
        *s, *r, pix0, slot0, (int)n_items, part, next_item, stamps);
  }
  mega_fold_kernel<<<(n_px + FOLD_THREADS - 1) / FOLD_THREADS, FOLD_THREADS, 0,
                     (cudaStream_t)stream>>>(part, n_px, spp, out, ld);
  return (int)cudaGetLastError();
}

}  // extern "C"
