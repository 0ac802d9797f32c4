// Preview kernel for Hopper (sm_90a): one progressive frame of the
// interactive 2-bounce preview integrator over a window of pixels.
//
// Replaces the JAX package's Pallas TPU kernel
// ops/pallas/mega.py::render_preview_mega -> _preview_kernel (the
// reference's interactive shader, fshader_preview.fsh:332-375). It computes
// what that kernel and the plain version compute (integrator/preview.py
// trace_preview_p over the window): per pixel of [pix_offset, pix_offset +
// n_px), the radiance SUM over spp jittered samples from sample_base, each
// a camera ray and up to max_bounce uniform-sphere bounces (pdf 1/2pi,
// folded away from the view direction) with multiplicative throughput,
// emission and sky on the way, no NEE; the sums are added into the
// window's rows of the film ([n_px, 3], one float add a channel, as the
// plain version adds them). Only the radiance rows of the TPU kernel's
// [8, Mp] output mean something.
//
// One thread per pixel on a fixed grid, a loop over its samples
// (ascending, the plain version's order) and bounces, the device functions
// of path.cuh (camera_dir, bvh_nearest_hit and its packed walk tables and
// shared-memory stack, env_sample, uniform_sphere). The megakernel's
// structure did not pay here on the H100 (PERF.md): its sliced walks with
// regeneration on a persistent grid measured 12-22% slower, one walk call
// site on this grid no faster. At 1 spp a pixel's path is at most three
// walks, too short for refills to pay. What bounds it on this card: divergent
// BVH traversal, as the megakernel; its bytes (the scene tables once, the
// band's sums read and written) are far below that. None of the TPU
// mechanics (one-hot MXU gathers, cluster sweeps, 128-lane tiles) carry
// over. Deterministic: a pixel belongs to one thread, no atomics.

#include "path.cuh"

namespace {

// One jittered camera path of pixel `pix`, sample `smp` at preview quality
// (preview.trace_preview_p for one lane).
__device__ V preview_sample(const SceneArgs& s, const RenderArgs& r, uint32_t pix,
                            uint32_t smp, int max_bounce) {
  uint32_t h0 = sample_hash(pix, smp);
  V d = camera_dir(r, pix, h0 + r.seed * K_SEED);
  V o = {r.eye[0], r.eye[1], r.eye[2]};
  V d_unit = unit_eps(d);
  float t0;
  int idx0;
  if (!trace(s, o, d_unit, -1, false, t0, idx0)) return env_sample(s, d_unit, r.hdr_clamp);
  V le0 = load3(s.mat_emissive, s.tri_obj[idx0]);
  V lo = {0.0f, 0.0f, 0.0f};
  V history = {1.0f, 1.0f, 1.0f};
  V point = o + d_unit * t0;
  V view = d_unit;  // toward the surface
  int tri = idx0;
  for (int b = 0; b < max_bounce; ++b) {
    uint32_t hb = bounce_hash(h0, r.seed, b);
    V normal = load3(s.tri_norm, tri);
    V brdf = load3(s.mat_brdf, s.tri_obj[tri]);
    // away from the view direction (fshader_preview.fsh:343-345)
    V wi = fold_opposite(uniform_sphere(draw(hb, S_CONT_COS), draw(hb, S_CONT_PHI)), normal,
                         view);
    float t;
    int idx;
    bool hit = trace(s, point, wi, tri, false, t, idx);
    float cos_i = fabsf(dot(wi, normal));
    V weight = brdf * INV_PI * cos_i * TWO_PI;  // f_r cos / pdf, pdf = 1 / 2pi
    V wi_u = unit_eps(wi);
    if (!hit) {
      lo = lo + history * env_sample(s, wi_u, r.hdr_clamp) * weight;
      break;
    }
    lo = lo + history * load3(s.mat_emissive, s.tri_obj[idx]) * weight;
    history = history * weight;
    point = point + wi_u * t;
    view = wi_u;
    tri = idx;
  }
  return le0 + lo;
}

__global__ void __launch_bounds__(128)
preview_render_kernel(SceneArgs s, RenderArgs r, int pix_offset, int n_px, int max_bounce,
                      float* __restrict__ band) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_px) return;
  uint32_t pix = (uint32_t)(pix_offset + i);
  V sum = {0.0f, 0.0f, 0.0f};
  for (int k = 0; k < r.spp; ++k)
    sum = sum + preview_sample(s, r, pix, r.sample_base + (uint32_t)k, max_bounce);
  float* o = band + 3 * i;
  o[0] = o[0] + sum.x;
  o[1] = o[1] + sum.y;
  o[2] = o[2] + sum.z;
}

}  // namespace

extern "C" {

// Adds the radiance sums of pixels [pix_offset, pix_offset + n_px) into
// band [n_px, 3].
int preview_render(const SceneArgs* s, const RenderArgs* r, int pix_offset, int n_px,
                   int max_bounce, float* band, void* stream) {
  int threads = 128;
  int blocks = (n_px + threads - 1) / threads;
  if (blocks == 0) return 0;
  size_t smem = walk_smem_bytes(*s, threads);
  int rc = smem_limit(preview_render_kernel, smem);
  if (rc) return rc;
  preview_render_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(*s, *r, pix_offset,
                                                                         n_px, max_bounce, band);
  return (int)cudaGetLastError();
}

}  // extern "C"
