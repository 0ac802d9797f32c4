// The pool engine's wavefront kernels for Hopper (sm_90a): spawn, trace,
// front and resolve over a persistent pool of M path lanes.
//
// Replace the JAX package's Pallas TPU kernels of integrator/pool.py's
// all-Pallas bounce pipeline:
//   spawn_primary  <- ops/pallas/spawn_front.py::spawn_primary -> _kernel
//   trace_segments <- ops/pallas/cluster_sweep_fused.py _feats_jnp and
//                     _stacked_jnp -> _fused_kernel (and the other sweep
//                     kernels, which compute the same function:
//                     cluster_sweep_stream, cluster_sweep, cluster_sweep_mxu)
//   front_bounce   <- ops/pallas/bounce_front.py::front_bounce -> _kernel
//   resolve_bounce <- ops/pallas/bounce_resolve.py::resolve_bounce2 -> _kernel
// Each computes what its plain PyTorch version computes (ops/spawn_front.py,
// ops/trace.py, ops/bounce_front.py, ops/bounce_resolve.py), through the
// device functions of path.cuh that the megakernel uses too, so a pool
// render and a megakernel render trace the same paths sample for sample.
//
// Lane state (ops/lanes.py), SoA so that neighbouring threads read
// neighbouring words: fs f32 [15, M] (src 0-2, out_dir 3-5, throughput T
// 6-8, radiance L 9-11, primary emission le0 12-14) and is i32 [6, M]
// (active, hit_idx, bounce, slot, pix, smp). cnt i64 [4]: next queue
// sample, finished samples, useful rays. Segments: o, d f32 [S, 3, M],
// excl i32 [S, M], S = E lights + HDR + continuation.
//
// What bounds them on this card: trace_segments (and the primary trace
// inside spawn_primary) by divergent BVH traversal, as the megakernel
// (the packed walk of path.cuh: 16-byte record loads, a shared-memory
// stack), plus one memory round trip of the segments per bounce. Its grid
// is one thread per (segment, lane) item: a persistent grid whose warps
// take 32 items at a time from a counter (Aila & Laine) measured 37-42%
// slower on the H100 at the main path's shape (PERF.md). front_bounce and
// resolve_bounce by their bytes (state, segments and trace rows, tens of
// bytes per lane) and by the scattered scene-table loads. The first design
// is one thread per lane (per lane and segment for the trace), no
// per-material queues: resolve_bounce recomputes the front's shading
// values from the lane state (a pure function of the counter RNG and the
// scene) instead of reading a stored front record, which saves ~150 bytes
// of traffic per lane for ~100 flops. The TPU's cluster slabs, bf16x3
// coefficients, resident/stream split, 128-lane row packing, [16, M]
// feature rows and 19-light mask cap have no counterpart. Film adds are
// float atomics (the order of sums within a pixel varies between runs);
// the counters are integer atomics, one per block.
//
// Direct refraction: the front kernel runs the march (refract_march_dev)
// of each lane that takes it and writes its results per lane (rf f32
// [9, M]: exit direction, exit point, rate; ri i32 [2, M]: escaped, last
// triangle; zero for other lanes), which the resolve kernel reads: the
// march traces up to max_refract segments and cannot be recomputed there
// as the rest of the front is. Front and resolve are templates on HR, and
// the HR = false instances (scenes without DIR_REFRACT) neither read nor
// write the buffers.

#include "path.cuh"

struct PoolArgs {
  float* fs;        // [15, M]
  int* is;          // [6, M]
  float* film;      // [n_px, 3] radiance sums of the window's pixels
  long long* cnt;   // [4] next sample, finished samples, useful rays, spare
  long long total;  // samples in the queue
  int m;            // lanes
  int n_px;         // the pixel window: slot = queue index % n_px,
  int pix0;         // pixel = window_pixel(r, pix0, slot) (path.cuh)
  float* rf;        // [9, M] the march's exit dir, exit point, rate (HR only)
  int* ri;          // [2, M] the march's escaped flag, last triangle (HR only)
};

namespace {

enum { F_SRC = 0, F_DIR = 3, F_T = 6, F_L = 9, F_LE0 = 12 };
enum { I_ACTIVE = 0, I_HIT = 1, I_BOUNCE = 2, I_SLOT = 3, I_PIX = 4, I_SMP = 5 };
enum { R_DIR = 0, R_SRC = 3, R_RATE = 6, R_ESCAPED = 0, R_LAST = 1 };

__device__ __forceinline__ V row3(const float* a, int row, int m, int i) {
  return {a[row * m + i], a[(row + 1) * m + i], a[(row + 2) * m + i]};
}
__device__ __forceinline__ void put3(float* a, int row, int m, int i, V v) {
  a[row * m + i] = v.x;
  a[(row + 1) * m + i] = v.y;
  a[(row + 2) * m + i] = v.z;
}
__device__ __forceinline__ void film_add(float* film, int slot, V v) {
  atomicAdd(film + 3 * slot, v.x);
  atomicAdd(film + 3 * slot + 1, v.y);
  atomicAdd(film + 3 * slot + 2, v.z);
}
__device__ __forceinline__ void count_add(long long* c, int n) {
  if (n) atomicAdd((unsigned long long*)c, (unsigned long long)n);
}

// Inclusive prefix sum of v over the block, in thread order, and the
// block's total. Every thread of the block calls it (blockDim a multiple
// of 32, at most 1024).
__device__ int block_inclusive_scan(int v, int* warp_sums, int& total) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int nw = blockDim.x >> 5;
    int w = lane < nw ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < nw) warp_sums[lane] = w;
  }
  __syncthreads();
  int res = x + (warp > 0 ? warp_sums[warp - 1] : 0);
  total = warp_sums[(blockDim.x >> 5) - 1];
  __syncthreads();  // warp_sums is free again for the next call
  return res;
}

// Measured on the H100 at the pool's main path (PERF.md).
constexpr int SPAWN_THREADS = 128;  // threads of a spawn block
constexpr int SPAWN_LANES = 8;      // lanes a thread scans: a tile is 1024 lanes
constexpr int SPAWN_TILE = SPAWN_THREADS * SPAWN_LANES;
constexpr int LANE_THREADS = 128;

// ---- spawn: one launch a round --------------------------------------------
// Fresh lanes take the next queue samples in lane order (the plain cumsum's
// order): a single-pass scan with decoupled look-back (Merrill & Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", NVIDIA 2016)
// over tiles of SPAWN_TILE lanes, one block a tile. The scratch `scan`
// (u64 [1 + tiles], zeroed once) holds a ticket counter, then one status
// word a tile: (epoch << 2 | flag) in the high half, a value in the low
// half; flag 1: the tile's fresh count, flag 2: its inclusive prefix,
// `next` plus the fresh lanes of tiles 0 .. tile. Blocks take tiles in the
// order of their tickets, so every tile a block looks back on belongs to a
// block that already runs, whatever order the scheduler starts blocks in.
// The ticket counter runs on across rounds (round e takes tickets e x tiles
// ..), so a word of an earlier round carries an older epoch and reads as
// not yet published: nothing is cleared between rounds. Tile 0 alone reads
// cnt[C_NEXT]; the last tile, whose prefix is next + all fresh lanes, alone
// writes the cut min(that, total) (= next + min(fresh, total - next)), and
// it knows that prefix only after tile 0 has published its read.
enum { C_NEXT = 0, C_DONE = 1, C_RAYS = 2 };
constexpr unsigned ST_AGGREGATE = 1u, ST_PREFIX = 2u, EPOCH_MASK = 0x3fffffffu;

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}
__device__ __forceinline__ unsigned long long tile_status(unsigned epoch, unsigned flag,
                                                          unsigned value) {
  return ((unsigned long long)(((epoch & EPOCH_MASK) << 2) | flag) << 32) | value;
}

// Warp 0 of a tile: publish its fresh count, look back over windows of 32
// predecessors (lane l reads tile - 1 - l) until one holds its inclusive
// prefix, summing the counts up to it, then publish the tile's own prefix.
// Returns the tile's exclusive prefix: the queue index of its first fresh
// lane. Values stay below 2^32: next < total < 2^31 and fresh <= M < 2^31.
__device__ unsigned spawn_lookback(unsigned long long* status, int tile, unsigned epoch,
                                   int n_fresh, const long long* cnt) {
  const int lane = (int)(threadIdx.x & 31u);
  unsigned excl = 0;
  if (tile == 0) {
    excl = (unsigned)cnt[C_NEXT];
  } else {
    if (lane == 0) st_release(status + tile, tile_status(epoch, ST_AGGREGATE, (unsigned)n_fresh));
    for (int j = tile - 1;; j -= 32) {
      const int k = j - lane;
      unsigned long long w = 0;
      unsigned flag = 0;
      if (k >= 0) {
        do {  // the tile's block runs: it publishes its count without waiting
          w = ld_acquire(status + k);
          const unsigned hi = (unsigned)(w >> 32);
          flag = (hi >> 2) == (epoch & EPOCH_MASK) ? (hi & 3u) : 0u;
        } while (flag == 0);
      }
      // the nearest predecessor with its prefix (tile 0 always has one)
      const unsigned pre = __ballot_sync(0xffffffffu, flag == ST_PREFIX);
      const int stop = pre ? __ffs(pre) - 1 : 31;
      unsigned v = (lane <= stop && k >= 0) ? (unsigned)w : 0u;
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      excl += v;
      if (pre) break;
    }
  }
  __syncwarp();  // the lanes' acquires before lane 0's release
  if (lane == 0) st_release(status + tile, tile_status(epoch, ST_PREFIX, excl + (unsigned)n_fresh));
  return excl;
}

// One spawn round: fresh lanes take queue samples, trace their primary
// rays and either start a path (hit) or add the sky to the film and stay
// fresh (miss). Thread j scans lanes SPAWN_LANES x j .. of the tile. After
// the scan each fresh lane that took a sample writes its place in the tile
// at its rank; the block's threads then serve those lanes in rank order,
// thread j the ranks j, j + SPAWN_THREADS, .., so consecutive threads trace
// the camera rays of consecutive queue samples (neighbouring pixels) and
// every warp of the block traces full warps, while each lane's state stays
// at its own position. aux (optional, [8, M]): d_u 0-2, t 3, sky 4-6, got 7
// of each lane that took a sample, zero elsewhere.
__global__ void __launch_bounds__(SPAWN_THREADS)
spawn_primary_kernel(SceneArgs s, RenderArgs r, PoolArgs q, unsigned long long* __restrict__ scan,
                     int tiles, float* __restrict__ aux) {
  __shared__ int warp_sums[32];
  __shared__ short order[SPAWN_TILE];  // places in the tile of the lanes that took samples
  __shared__ unsigned long long ticket;
  __shared__ unsigned tile_base;
  __shared__ int n_miss;
  if (threadIdx.x == 0) {
    ticket = atomicAdd(scan, 1ull);
    n_miss = 0;
  }
  __syncthreads();
  const int tile = (int)(ticket % (unsigned long long)tiles);
  const unsigned epoch = (unsigned)(ticket / (unsigned long long)tiles);
  const int m = q.m;
  const int t0 = tile * SPAWN_TILE;
  const int own = t0 + threadIdx.x * SPAWN_LANES;  // the thread's first lane
  bool fresh[SPAWN_LANES];
  int mine = 0;
  for (int j = 0; j < SPAWN_LANES; ++j) {
    fresh[j] = own + j < m && q.is[I_ACTIVE * m + own + j] == 0;
    mine += fresh[j];
  }
  int n_fresh;
  int rank = block_inclusive_scan(mine, warp_sums, n_fresh) - mine;  // 0-based, lane order
  if (threadIdx.x < 32) {
    const unsigned e = spawn_lookback(scan + 1, tile, epoch, n_fresh, q.cnt);
    if (threadIdx.x == 0) {
      tile_base = e;
      if (tile == tiles - 1) {
        const long long end = (long long)e + n_fresh;
        q.cnt[C_NEXT] = end < q.total ? end : q.total;
      }
    }
  }
  __syncthreads();
  const long long base = tile_base;
  const long long left = q.total - base;
  const int n_got = left <= 0 ? 0 : (left < n_fresh ? (int)left : n_fresh);
  for (int j = 0; j < SPAWN_LANES; ++j) {
    if (fresh[j] && rank < n_got) {
      order[rank] = (short)(own + j - t0);
    } else if (aux && own + j < m) {
      for (int row = 0; row < 8; ++row) aux[row * m + own + j] = 0.0f;
    }
    rank += fresh[j];
  }
  __syncthreads();
  int misses = 0;
  for (int k = threadIdx.x; k < n_got; k += SPAWN_THREADS) {
    const int i = t0 + order[k];
    const long long idx = base + k;
    int slot = (int)(idx % q.n_px);
    uint32_t pix = window_pixel(r, q.pix0, slot);
    uint32_t smp = (uint32_t)(idx / q.n_px) + r.sample_base;
    q.is[I_SLOT * m + i] = slot;
    q.is[I_PIX * m + i] = (int)pix;
    q.is[I_SMP * m + i] = (int)smp;
    V d = camera_dir(r, pix, sample_hash(pix, smp) + r.seed * K_SEED);
    V o = {r.eye[0], r.eye[1], r.eye[2]};
    V d_u = unit_eps(d);
    float t;
    int tri;
    const bool hit = trace(s, o, d_u, -1, false, t, tri);
    misses += !hit;
    V sky = {0.0f, 0.0f, 0.0f};
    if (!hit || aux) sky = env_sample(s, d_u, r.hdr_clamp);
    if (hit) {
      const V one = {1.0f, 1.0f, 1.0f}, zero = {0.0f, 0.0f, 0.0f};
      q.is[I_ACTIVE * m + i] = 1;
      q.is[I_HIT * m + i] = tri;
      q.is[I_BOUNCE * m + i] = 0;
      put3(q.fs, F_SRC, m, i, o + d_u * t);
      put3(q.fs, F_DIR, m, i, -d_u);
      put3(q.fs, F_T, m, i, one);
      put3(q.fs, F_L, m, i, zero);
      put3(q.fs, F_LE0, m, i, load3(s.mat_emissive, s.tri_obj[tri]));
    } else {
      film_add(q.film, slot, sky);
    }
    if (aux) {
      put3(aux, 0, m, i, d_u);
      aux[3 * m + i] = t;
      put3(aux, 4, m, i, sky);
      aux[7 * m + i] = 1.0f;
    }
  }
  if (misses) atomicAdd(&n_miss, misses);
  __syncthreads();
  if (threadIdx.x == 0) {
    count_add(q.cnt + C_RAYS, n_got);   // a primary ray per sample taken
    count_add(q.cnt + C_DONE, n_miss);  // a miss finishes its sample
  }
}

// The lane's path and bounce hash (the pool's per-lane bounce counter).
__device__ __forceinline__ Path lane_path(const PoolArgs& q, int i, uint32_t seed,
                                          uint32_t& hb) {
  int m = q.m;
  Path p = {row3(q.fs, F_SRC, m, i), row3(q.fs, F_DIR, m, i), q.is[I_HIT * m + i]};
  hb = bounce_hash(sample_hash((uint32_t)q.is[I_PIX * m + i], (uint32_t)q.is[I_SMP * m + i]),
                   seed, q.is[I_BOUNCE * m + i]);
  return p;
}

// ---- front: one bounce up to its traces, as stacked segment rays ---------
template <bool HR>
__global__ void __launch_bounds__(LANE_THREADS)
front_bounce_kernel(SceneArgs s, RenderArgs r, PoolArgs q, float* __restrict__ seg_o,
                    float* __restrict__ seg_d, int* __restrict__ seg_x) {
  int m = q.m;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const V zero = {0.0f, 0.0f, 0.0f};
  int e_cnt = s.n_emit;
  bool nee = false, alive = false, dirref = false;
  int excl = 0;
  Front f;
  uint32_t hb = 0;
  if (q.is[I_ACTIVE * m + i] != 0) {
    Path p = lane_path(q, i, r.seed, hb);
    bounce_front_dev(s, r, hb, p, f);
    if (!f.emit_break) {
      dirref = HR && f.is_dirref;
      if (dirref) refract_march_dev(s, r, hb, p, f);
      bounce_dirs_dev<HR>(s, hb, p, f);
    }
    alive = !f.emit_break;
    nee = f.needs_nee;
    excl = f.nee_excl;
  }
  if (HR) {  // the march's results for the resolve kernel; zero elsewhere
    put3(q.rf, R_DIR, m, i, dirref ? f.ref_dir : zero);
    put3(q.rf, R_SRC, m, i, dirref ? f.ref_src : zero);
    put3(q.rf, R_RATE, m, i, dirref ? f.ref_rate : zero);
    q.ri[R_ESCAPED * m + i] = dirref ? (int)f.ref_escaped : 0;
    q.ri[R_LAST * m + i] = dirref ? f.ref_last : 0;
  }
  // masked segments get zero rays, which every walk treats as a miss
  for (int l = 0; l < e_cnt; ++l) {
    V ldir = zero;
    if (nee) light_dir_dev(s, hb, f, l, ldir);
    put3(seg_o, 3 * l, m, i, nee ? f.nee_src : zero);
    put3(seg_d, 3 * l, m, i, ldir);
    seg_x[l * m + i] = excl;
  }
  put3(seg_o, 3 * e_cnt, m, i, nee ? f.nee_src : zero);
  put3(seg_d, 3 * e_cnt, m, i, nee ? f.hdir : zero);
  seg_x[e_cnt * m + i] = excl;
  put3(seg_o, 3 * (e_cnt + 1), m, i, alive ? (dirref ? f.ref_src : f.nee_src) : zero);
  put3(seg_d, 3 * (e_cnt + 1), m, i, alive ? f.cdir : zero);
  seg_x[(e_cnt + 1) * m + i] = dirref ? f.ref_last : excl;
}

// ---- trace: nearest hit per (segment, lane); one segment any-hit --------
// One thread per item g = segment * M + lane.
__global__ void __launch_bounds__(LANE_THREADS)
trace_segments_kernel(SceneArgs s, const float* __restrict__ o, const float* __restrict__ d,
                      const int* __restrict__ x, int n_seg, int m, int anyhit_seg,
                      float* __restrict__ bt, int* __restrict__ bi) {
  long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (long long)n_seg * m) return;
  int seg = (int)(g / m);
  int i = (int)(g - (long long)seg * m);
  float t = INF_T;
  int idx = 0;
  V dir = row3(d, 3 * seg, m, i);
  // a zero ray (a masked segment: over half the items at the pool's main
  // path) is a miss; its origin and exclusion are not read
  if (dir.x != 0.0f || dir.y != 0.0f || dir.z != 0.0f)
    trace(s, row3(o, 3 * seg, m, i), dir, x[g], seg == anyhit_seg, t, idx);
  bt[g] = t;
  bi[g] = idx;
}

// ---- resolve: the bounce after its traces + the pool's accumulation -----
template <bool HR>
__global__ void __launch_bounds__(LANE_THREADS)
resolve_bounce_kernel(SceneArgs s, RenderArgs r, PoolArgs q, const float* __restrict__ bt,
                      const int* __restrict__ bi) {
  int m = q.m;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool active = i < m && q.is[I_ACTIVE * m + i] != 0;
  bool finished = false;
  if (active) {
    int e_cnt = s.n_emit;
    uint32_t hb;
    Path p = lane_path(q, i, r.seed, hb);
    Front f;
    bounce_front_dev(s, r, hb, p, f);
    bool dirref = HR && !f.emit_break && f.is_dirref;
    if (dirref) {  // the front kernel's march
      f.ref_dir = row3(q.rf, R_DIR, m, i);
      f.ref_src = row3(q.rf, R_SRC, m, i);
      f.ref_rate = row3(q.rf, R_RATE, m, i);
      f.ref_escaped = q.ri[R_ESCAPED * m + i] != 0;
      f.ref_last = q.ri[R_LAST * m + i];
    }
    if (!f.emit_break) bounce_dirs_dev<HR>(s, hb, p, f);
    // visibility from the raw trace rows (bounce_resolve2's contract)
    V l_dir = {0.0f, 0.0f, 0.0f};
    if (f.needs_nee) {
      for (int l = 0; l < e_cnt; ++l) {
        V ldir;
        bool gate = light_dir_dev(s, hb, f, l, ldir);
        if (gate && bt[l * m + i] < INF_T && bi[l * m + i] == s.emit_idx[l])
          l_dir = l_dir + light_contrib_dev(s, f, l, ldir);
      }
    }
    bool h_hit = bt[e_cnt * m + i] < INF_T;
    float c_t = bt[(e_cnt + 1) * m + i];
    bool c_hit = c_t < INF_T;
    int c_idx = c_hit ? bi[(e_cnt + 1) * m + i] : 0;
    V dir_b, rate_b;
    bool accept = resolve_tail_dev<HR>(s, r, hb, f, l_dir, h_hit, c_hit, c_t, c_idx, p, dir_b,
                                       rate_b);
    // forward composite with the reference's depth-cap seed (pool.py)
    V T = row3(q.fs, F_T, m, i);
    V L = row3(q.fs, F_L, m, i);
    L = L + T * dir_b;
    T = T * rate_b;
    int b2 = q.is[I_BOUNCE * m + i] + 1;
    bool capped = accept && b2 >= r.max_depth;
    if (capped) L = L + T * dir_b;
    finished = !accept || capped;
    if (dirref && f.ref_escaped) L = {0.0f, 0.0f, 0.0f};  // the escape kill (cu:1254)
    if (finished) {
      film_add(q.film, q.is[I_SLOT * m + i], L + row3(q.fs, F_LE0, m, i));
      q.is[I_ACTIVE * m + i] = 0;
    } else {
      put3(q.fs, F_SRC, m, i, p.src);
      put3(q.fs, F_DIR, m, i, p.out_dir);
      put3(q.fs, F_T, m, i, T);
      put3(q.fs, F_L, m, i, L);
      q.is[I_HIT * m + i] = p.tri;
      q.is[I_BOUNCE * m + i] = b2;
    }
  }
  int n_active = __syncthreads_count(active);
  int n_fin = __syncthreads_count(finished);
  if (threadIdx.x == 0) {
    count_add(q.cnt + 2, n_active * (s.n_emit + 2));  // E lights + HDR + continuation
    count_add(q.cnt + 1, n_fin);
  }
}

}  // namespace

extern "C" {

// Words (u64) of the spawn's scratch for M lanes: the ticket counter and
// one status word a tile.
int spawn_scratch_words(int m) { return 1 + (m + SPAWN_TILE - 1) / SPAWN_TILE; }

// One spawn round in one launch; scan: spawn_scratch_words(M) u64, zeroed
// before the first round and kept for every later round of the same M
// (never shared by two launches in flight); aux may be null.
int spawn_primary(const SceneArgs* s, const RenderArgs* r, const PoolArgs* q,
                  unsigned long long* scan, float* aux, void* stream) {
  int tiles = spawn_scratch_words(q->m) - 1;
  size_t smem = walk_smem_bytes(*s, SPAWN_THREADS);
  int rc = smem_limit(spawn_primary_kernel, smem);
  if (rc) return rc;
  spawn_primary_kernel<<<tiles, SPAWN_THREADS, smem, (cudaStream_t)stream>>>(*s, *r, *q, scan,
                                                                             tiles, aux);
  return (int)cudaGetLastError();
}

// Segment rays of every lane's next bounce: seg_o, seg_d [E+2, 3, M],
// seg_x [E+2, M].
int front_bounce(const SceneArgs* s, const RenderArgs* r, const PoolArgs* q, float* seg_o,
                 float* seg_d, int* seg_x, void* stream) {
  int blocks = (q->m + LANE_THREADS - 1) / LANE_THREADS;
  cudaStream_t st = (cudaStream_t)stream;
  if (s->has_refract) {  // the march walks; the false instance does not
    size_t smem = walk_smem_bytes(*s, LANE_THREADS);
    int rc = smem_limit(front_bounce_kernel<true>, smem);
    if (rc) return rc;
    front_bounce_kernel<true><<<blocks, LANE_THREADS, smem, st>>>(*s, *r, *q, seg_o, seg_d,
                                                                   seg_x);
  } else
    front_bounce_kernel<false><<<blocks, LANE_THREADS, 0, st>>>(*s, *r, *q, seg_o, seg_d, seg_x);
  return (int)cudaGetLastError();
}

// Nearest hit (t, id) of n_seg x m rays; t = 2147483647 on a miss. Segment
// anyhit_seg (-1: none) stops at its first hit.
int trace_segments(const SceneArgs* s, const float* o, const float* d, const int* x, int n_seg,
                   int m, int anyhit_seg, float* bt, int* bi, void* stream) {
  long long n = (long long)n_seg * m;
  long long blocks = (n + LANE_THREADS - 1) / LANE_THREADS;
  if (blocks == 0) return 0;
  size_t smem = walk_smem_bytes(*s, LANE_THREADS);
  int rc = smem_limit(trace_segments_kernel, smem);
  if (rc) return rc;
  trace_segments_kernel<<<(unsigned)blocks, LANE_THREADS, smem, (cudaStream_t)stream>>>(
      *s, o, d, x, n_seg, m, anyhit_seg, bt, bi);
  return (int)cudaGetLastError();
}

// Resolve every active lane's bounce from the trace rows bt, bi [E+2, M].
int resolve_bounce(const SceneArgs* s, const RenderArgs* r, const PoolArgs* q, const float* bt,
                   const int* bi, void* stream) {
  int blocks = (q->m + LANE_THREADS - 1) / LANE_THREADS;
  cudaStream_t st = (cudaStream_t)stream;
  if (s->has_refract)
    resolve_bounce_kernel<true><<<blocks, LANE_THREADS, 0, st>>>(*s, *r, *q, bt, bi);
  else
    resolve_bounce_kernel<false><<<blocks, LANE_THREADS, 0, st>>>(*s, *r, *q, bt, bi);
  return (int)cudaGetLastError();
}

}  // extern "C"
