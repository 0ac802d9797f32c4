// Postfx kernel for Hopper (sm_90a): film radiance sums -> display u8.
//
// Replaces the JAX package's Pallas TPU kernel ops/pallas/postfx.py::postfx
// -> _postfx_kernel (the reference's pass2/pass3 screen chain, and the CUDA
// path's ACES + gamma + u8 tail, PathTrace.cu:1459-1473). Per pixel of the
// film's flat range [p0, p1): c = sum * (1 / max(count, 1)), then ACES
// (mode 0) or luminance Reinhard with `limit` (mode 1) or nothing (2),
// then max(c, 0)^(1/g), x255, clamped to [0, 255], truncated to u8 — the
// operations of the plain version (ops/postfx.py), built with
// --fmad=false. With `flip`, film row y lands on display row H-1-y (film
// row 0 is the bottom of the scene), so a preview frame needs no copy for
// the flip; a banded frame, whose pixels carry two sample counts, is two
// launches over the two flat ranges.
//
// What bounds it on this card: bytes (12 read and 3 written per pixel,
// ~40 flops and a powf per channel). One thread per pixel; the loads are
// 12-byte strided and the stores bytes, which a later PR can vectorise.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float tone(float c, int mode) {
  if (mode == 0) return (c * (c * 2.51f + 0.03f)) / (c * (c * 2.43f + 0.59f) + 0.14f);
  return c;
}

__device__ __forceinline__ uint8_t quantize(float c, float inv_g) {
  float v = powf(c > 0.0f ? c : 0.0f, inv_g) * 255.0f;
  v = v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v);
  return (uint8_t)(int)v;
}

__global__ void __launch_bounds__(256)
postfx_kernel(const float* __restrict__ accum, uint8_t* __restrict__ out, int width, int height,
              int p0, int p1, float count, int mode, float inv_g, float limit, int flip) {
  int p = p0 + blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= p1) return;
  int y = p / width;
  int q = flip ? (height - 1 - y) * width + (p - y * width) : p;
  float inv_n = 1.0f / (count > 1.0f ? count : 1.0f);
  float c0 = accum[3 * p] * inv_n;
  float c1 = accum[3 * p + 1] * inv_n;
  float c2 = accum[3 * p + 2] * inv_n;
  if (mode == 1) {  // luminance Reinhard (pass3.fsh:8-11)
    float lum = 0.3f * c0 + 0.6f * c1 + 0.1f * c2;
    float sc = 1.0f / (1.0f + lum / limit);
    c0 = c0 * sc;
    c1 = c1 * sc;
    c2 = c2 * sc;
  }
  out[3 * q] = quantize(tone(c0, mode), inv_g);
  out[3 * q + 1] = quantize(tone(c1, mode), inv_g);
  out[3 * q + 2] = quantize(tone(c2, mode), inv_g);
}

}  // namespace

extern "C" {

// accum [H, W, 3] f32 -> out [H, W, 3] u8 over the film's pixels [p0, p1).
int postfx(const float* accum, uint8_t* out, int width, int height, int p0, int p1, float count,
           int mode, float inv_g, float limit, int flip, void* stream) {
  int threads = 256;
  int blocks = (p1 - p0 + threads - 1) / threads;
  if (blocks <= 0) return 0;
  postfx_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(accum, out, width, height, p0, p1,
                                                              count, mode, inv_g, limit, flip);
  return (int)cudaGetLastError();
}

}  // extern "C"
