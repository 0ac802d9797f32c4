// Postfx kernel for Hopper (sm_90a): film radiance sums -> display u8.
//
// Replaces the JAX package's Pallas TPU kernel ops/pallas/postfx.py::postfx
// -> _postfx_kernel (the reference's pass2/pass3 screen chain, and the CUDA
// path's ACES + gamma + u8 tail, PathTrace.cu:1459-1473). Per pixel p of the
// film's flat range [p0, p1): c = sum * (1 / max(n, 1)), n = count_lo for
// p < split and count_hi from split on, then ACES (mode 0) or luminance
// Reinhard with `limit` (mode 1) or nothing (2), then max(c, 0)^(1/g), x255,
// clamped to [0, 255], truncated to u8 — the operations of the plain
// version (ops/postfx.py), built with --fmad=false, so the bytes are equal.
// With `flip`, film row y lands on display row H-1-y (film row 0 is the
// bottom of the scene), so a preview frame needs no copy for the flip; a
// banded frame, whose pixels carry two sample counts, is one launch.
//
// What bounds it on this card: bytes, 12 read and 3 written a pixel (15.7 MB
// at 1024^2: 4.7 us at 3.35 TB/s), against ~270 flops a pixel (4.2 us at
// 67 TFLOP/s), most of them powf's. So every access is wide:
// - a thread takes a chunk of 4 neighbouring pixels of one row: three
//   16-byte loads of their 48 bytes of sums, and three 4-byte stores of
//   their 12 display bytes where those start on a 4-byte boundary (else 12
//   byte stores);
// - chunks start where the sums are 16-byte aligned (p = the pointer's
//   float offset mod 4), so a view at any offset still loads wide; a chunk
//   that crosses a row (width % 4 != 0) or a span edge takes the scalar
//   path, pixel by pixel;
// - the row, and the flipped row, are computed once per chunk;
// - the grid is a block per 256 chunks (1,024 blocks at 1024^2, within one
//   wave of the 132 SMs' resident blocks), walking them in a grid-stride
//   loop.
// Measured on the H100 (PERF.md), the accesses are then not what holds it
// back: powf issues ~70 instructions a channel (log2 and exp2 in extended
// precision), and a build without the power runs in less than half the
// time. powf stays, so that the bytes equal the plain version's.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int POSTFX_THREADS = 256;

__device__ __forceinline__ float tone(float c, int mode) {
  if (mode == 0) return (c * (c * 2.51f + 0.03f)) / (c * (c * 2.43f + 0.59f) + 0.14f);
  return c;
}

__device__ __forceinline__ uint32_t quantize(float c, float inv_g) {
  float v = powf(c > 0.0f ? c : 0.0f, inv_g) * 255.0f;
  v = v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v);
  return (uint32_t)(int)v;
}

// One pixel's three display bytes from its three sums, into v[0..2].
__device__ __forceinline__ void shade(float c0, float c1, float c2, float inv_n, int mode,
                                      float inv_g, float limit, uint32_t* v) {
  c0 = c0 * inv_n;
  c1 = c1 * inv_n;
  c2 = c2 * inv_n;
  if (mode == 1) {  // luminance Reinhard (pass3.fsh:8-11)
    float lum = 0.3f * c0 + 0.6f * c1 + 0.1f * c2;
    float sc = 1.0f / (1.0f + lum / limit);
    c0 = c0 * sc;
    c1 = c1 * sc;
    c2 = c2 * sc;
  }
  v[0] = quantize(tone(c0, mode), inv_g);
  v[1] = quantize(tone(c1, mode), inv_g);
  v[2] = quantize(tone(c2, mode), inv_g);
}

__global__ void __launch_bounds__(POSTFX_THREADS)
postfx_kernel(const float* __restrict__ accum, uint8_t* __restrict__ out, int width, int height,
              int p0, int split, int p1, int first, int n_chunks, float count_lo, float count_hi,
              int mode, float inv_g, float limit, int flip) {
  const float inv_lo = 1.0f / (count_lo > 1.0f ? count_lo : 1.0f);
  const float inv_hi = 1.0f / (count_hi > 1.0f ? count_hi : 1.0f);
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < n_chunks; c += gridDim.x * blockDim.x) {
    const int p = first + 4 * c;  // the sums of p .. p+3 are 16-byte aligned
    const int y = p >= p0 ? p / width : 0;
    if (p >= p0 && p + 4 <= p1 && p + 4 <= (y + 1) * width) {
      const float4* src = reinterpret_cast<const float4*>(accum + 3 * (size_t)p);
      const float4 a = __ldg(src), b = __ldg(src + 1), d = __ldg(src + 2);
      const float f[12] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, d.x, d.y, d.z, d.w};
      uint32_t v[12];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        shade(f[3 * i], f[3 * i + 1], f[3 * i + 2], p + i < split ? inv_lo : inv_hi, mode, inv_g,
              limit, v + 3 * i);
      const int q = flip ? p + (height - 1 - 2 * y) * width : p;
      uint8_t* dst = out + 3 * (size_t)q;
      if ((reinterpret_cast<uintptr_t>(dst) & 3) == 0) {
        uint32_t* w = reinterpret_cast<uint32_t*>(dst);
#pragma unroll
        for (int k = 0; k < 3; ++k)
          w[k] = v[4 * k] | v[4 * k + 1] << 8 | v[4 * k + 2] << 16 | v[4 * k + 3] << 24;
      } else {
#pragma unroll
        for (int k = 0; k < 12; ++k) dst[k] = (uint8_t)v[k];
      }
    } else {  // the ragged edge: a chunk across a row or a span edge
      for (int i = 0; i < 4; ++i) {
        const int pp = p + i;
        if (pp < p0 || pp >= p1) continue;
        const int yy = pp / width;
        const int q = flip ? pp + (height - 1 - 2 * yy) * width : pp;
        uint32_t v[3];
        shade(accum[3 * (size_t)pp], accum[3 * (size_t)pp + 1], accum[3 * (size_t)pp + 2],
              pp < split ? inv_lo : inv_hi, mode, inv_g, limit, v);
        out[3 * (size_t)q] = (uint8_t)v[0];
        out[3 * (size_t)q + 1] = (uint8_t)v[1];
        out[3 * (size_t)q + 2] = (uint8_t)v[2];
      }
    }
  }
}

}  // namespace

extern "C" {

// accum [H, W, 3] f32 -> out [H, W, 3] u8 over the film's pixels [p0, p1),
// count_lo below split and count_hi from it on. One launch.
int postfx(const float* accum, uint8_t* out, int width, int height, int p0, int split, int p1,
           float count_lo, float count_hi, int mode, float inv_g, float limit, int flip,
           void* stream) {
  if (p1 <= p0) return 0;
  // chunks of 4 pixels start at p = phase (mod 4): accum + 3p is then
  // 16-byte aligned (a float pointer is 4-byte aligned)
  const int phase = (int)((reinterpret_cast<uintptr_t>(accum) >> 2) & 3);
  const int first = p0 - ((p0 - phase) & 3);
  const int n_chunks = (p1 - first + 3) / 4;
  const int blocks = (n_chunks + POSTFX_THREADS - 1) / POSTFX_THREADS;
  postfx_kernel<<<blocks, POSTFX_THREADS, 0, (cudaStream_t)stream>>>(
      accum, out, width, height, p0, split, p1, first, n_chunks, count_lo, count_hi, mode, inv_g,
      limit, flip);
  return (int)cudaGetLastError();
}

}  // extern "C"
