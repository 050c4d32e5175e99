// Tile compositing kernels for Hopper (sm_90a): forward and analytic backward.
//
// Replaces the Pallas TPU kernels of tpu_splat/gs/pallas_raster.py:
//   composite_fwd_kernel <- _forward_kernel / _forward_one   (pallas_call at :328)
//   composite_bwd_kernel <- _backward_kernel / _backward_one / _bwd_chunk (:366)
// The plain PyTorch versions of both live in tpu_splat_torch/gs/cuda_raster.py
// (composite_tiles_plain, composite_tiles_bwd_plain); the tests and
// chip_smoke.py hold these kernels against them.
//
// Layout: packed is channel-major (16, T, K) f32 -- channels 0:2 mean2d,
// 2:5 conic (a, b, c), 5:8 rgb, 8 opacity, 9 depth, 10:16 pad -- so for one
// tile every channel is a contiguous run of K floats and chunk loads coalesce.
// One block per 16x16 tile. The backward runs one thread per pixel (256
// threads); the forward runs 128, each compositing pixels (x, y) and (x, y + 8).
//
// What bounds them on this card: per (pixel, gaussian) pair both kernels do
// an exp and tens of f32 operations on a gaussian staged once per
// 128-gaussian chunk in shared memory and read there as a broadcast, while
// the bytes moved per tile are a few KB per chunk. Device memory is no limit;
// instruction issue is. Both keep every per-pixel quantity in registers.
//
// The forward issues about 32 instructions per pair: sigma, expf, the two
// cut-offs and the blend, and little else. It sweeps only each chunk's real
// gaussians (the slots past counts[t] hold the zero sentinel row, whose alpha
// is exactly 0); it reads a staged gaussian as three float4 broadcasts, with
// a and c halved at staging, and uses them for two pixels; and the two
// pixels, one column, share the terms that hang on x alone. On an H100 80GB
// HBM3 at 700 W (chip_smoke.py, 1280x720) it takes 0.172 ms, 2.9x the bound
// of 30 f32 operations per real pair at the card's f32 rate and about 73% of
// the rate at which an SM can issue its instructions. 48 registers, no
// spills, 6 KB of shared memory, 10 blocks per SM. A second chunk buffer
// filled during the sweep (one barrier per chunk) measured the same and is
// not used: tiles reach 1.6 chunks on average, and the other blocks on the
// SM hide the load.
//
// Semantics kept exactly from the reference:
//  * the early exit is TILE-wide and checked once per chunk, before the chunk
//    (__syncthreads_or over T > 1e-4), never per pixel;
//  * the sweep is bounded by counts[t] (ceil(count / 128) chunks);
//  * tstart holds each reached chunk's start transmittance and 0 for every
//    other chunk; the backward skips chunks whose tstart is 0 on every pixel.
//
// The backward (replaces pallas_raster.py:366) also sums, for every gaussian,
// 10 gradient channels over the tile's 256 pixels. A 5-step warp butterfly per
// channel costs 50 shuffles per (warp, gaussian), and a shuffle issues at a
// quarter of the f32 rate: those shuffles, not the ~60 operations of the pair,
// would set its pace. Instead it takes the gaussians in groups of 3 and
// reduce-scatters their 30 values (padded to 32) across the warp by recursive
// halving: 31 shuffles, about 10 per gaussian, after which lane l holds the
// warp's sum of value l and 30 lanes store at once. A group that touches no
// pixel of the warp is skipped. The per-warp sums are then added over the 8
// warps in a fixed order: no atomics, and dpacked is the same bits on every
// run. It also stops each chunk at the tile's pair count, rounded up to whole
// 16-gaussian segments: the slots past counts[t] hold the zero sentinel row,
// whose gradient is exactly 0, and are written as zeros without being swept.
//
// Backward transmittance: T_i within a chunk is recomputed forward from the
// tstart checkpoint, never by dividing back by (1 - alpha) -- with alpha up to
// 0.999 that division amplifies rounding by up to 1000x. A first pass stores
// the transmittance at the start of each 16-gaussian segment in shared memory
// (8 x 256 floats); the reverse walk then recomputes one segment at a time
// into registers (alpha and T_i for 16 gaussians) and walks it backwards: its
// last gaussian alone, then 5 groups of 3. This is exact like keeping a
// 128 x 256 prefix in shared memory, but needs 8 KB instead of 128 KB, at the
// cost of computing each alpha twice.

#include <cuda_runtime.h>

namespace {

constexpr int C_PACK = 16;
constexpr int CHUNK = 128;
constexpr int TILE = 16;
constexpr int P = TILE * TILE;  // pixels per tile = threads per block
constexpr int NCH = 10;         // channels the kernels read
constexpr int SEG = 16;         // backward recompute segment
constexpr int NSEG = CHUNK / SEG;
constexpr int NWARP = P / 32;
constexpr int NGRAD = 10;       // gradient channels written per gaussian
constexpr float TERM_THRESHOLD = 1e-4f;
constexpr float MAX_ALPHA = 0.999f;
constexpr unsigned FULL = 0xffffffffu;

struct Alpha {
  float raw;  // op * exp(-max(sigma, 0)), before the clamp
  float a;    // min(raw, 0.999), zeroed where sigma < 0 or raw < 1/255
};

// alpha is written with explicitly rounded operations (never contracted into
// FMAs), in the order of the plain version (cuda_raster._chunk_alpha): its
// two cut-offs (sigma >= 0, raw >= 1/255) are discontinuous, and a pair that
// one rounding keeps and another drops changes a pixel by up to 4e-3 * T.
// With identical rounding the kernel and the plain version drop the same pairs.
__device__ __forceinline__ Alpha chunk_alpha(const float (*s)[CHUNK], int j, float px,
                                             float py) {
  const float alpha_threshold = (float)(1.0 / 255.0);
  const float dx = __fsub_rn(px, s[0][j]);
  const float dy = __fsub_rn(py, s[1][j]);
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(s[2][j], dx), dx),
                               __fmul_rn(__fmul_rn(s[4][j], dy), dy));
  const float sigma = __fadd_rn(__fmul_rn(0.5f, quad), __fmul_rn(__fmul_rn(s[3][j], dx), dy));
  const float raw = __fmul_rn(s[8][j], expf(-fmaxf(sigma, 0.0f)));
  const bool live = sigma >= 0.0f && raw >= alpha_threshold;
  return {raw, live ? fminf(raw, MAX_ALPHA) : 0.0f};
}

constexpr int ROW = 12;               // floats per gaussian in a row-major chunk copy
constexpr int FWD_THREADS = P / 2;    // forward: two pixels per thread
static_assert(FWD_THREADS == CHUNK, "the forward stages one gaussian per thread");

// Stage the n_real gaussians of chunk c of tile t for the forward, one per
// thread, as rows of three float4: {mx, my, a/2, b}, {c/2, op, red, green},
// {blue, depth, 0, 0}. The slots past n_real are never read.
__device__ __forceinline__ void load_chunk_fwd(float4* rows, const float* packed, size_t plane,
                                               int t, int K, int c, int n_real) {
  const int i = threadIdx.x;
  if (i >= n_real) return;
  const float* g = packed + (size_t)t * K + (size_t)c * CHUNK + i;
  rows[3 * i + 0] = make_float4(g[0], g[plane], 0.5f * g[2 * plane], g[3 * plane]);
  rows[3 * i + 1] = make_float4(0.5f * g[4 * plane], g[8 * plane], g[5 * plane], g[6 * plane]);
  rows[3 * i + 2] = make_float4(g[7 * plane], g[9 * plane], 0.0f, 0.0f);
}

// alpha of a staged gaussian at one pixel, rounded as chunk_alpha rounds it.
// qx = (a/2 dx) dx and bdx = b dx hang on the pixel's x alone, so the two
// pixels of a thread (one column) share them. a/2 and c/2 in place of
// 0.5 * (a dx dx + c dy dy) change no rounding: a power-of-two scale commutes
// with it except below the normal range, where sigma ~ 0 gives the same alpha.
__device__ __forceinline__ float fwd_alpha(float qx, float bdx, float dy, float c_half,
                                           float op) {
  const float sigma =
      __fadd_rn(__fadd_rn(qx, __fmul_rn(__fmul_rn(c_half, dy), dy)), __fmul_rn(bdx, dy));
  const float raw = __fmul_rn(op, expf(-fmaxf(sigma, 0.0f)));
  const bool live = sigma >= 0.0f && raw >= (float)(1.0 / 255.0);
  return live ? fminf(raw, MAX_ALPHA) : 0.0f;
}

// What the forward accumulates for one pixel.
struct PixelFwd {
  float tr, r, g, b, d;
};

__device__ __forceinline__ void blend(PixelFwd& q, float alpha, float4 n, float4 o) {
  const float w = alpha * q.tr;
  q.r += w * n.z;
  q.g += w * n.w;
  q.b += w * o.x;
  q.d += w * o.y;
  q.tr *= 1.0f - alpha;
}

__device__ __forceinline__ void store_fwd(float* o, const PixelFwd& q) {
  o[0 * P] = q.r;
  o[1 * P] = q.g;
  o[2 * P] = q.b;
  o[3 * P] = 1.0f - q.tr;
  o[4 * P] = q.d;
  o[5 * P] = 0.0f;
  o[6 * P] = 0.0f;
  o[7 * P] = 0.0f;
}

// 128 threads per tile; thread i takes pixels i and i + 128, (x, y) and
// (x, y + 8), which share x.
__global__ void __launch_bounds__(FWD_THREADS, 8)
composite_fwd_kernel(const float* __restrict__ packed, const int* __restrict__ counts,
                     float* __restrict__ out, float* __restrict__ tstart, int T, int K,
                     int tx) {
  __shared__ float4 rows[CHUNK * ROW / 4];
  const int t = blockIdx.x;
  const int p0 = threadIdx.x, p1 = p0 + FWD_THREADS;
  const float px = (float)((t % tx) * TILE + p0 % TILE) + 0.5f;
  const float py0 = (float)((t / tx) * TILE + p0 / TILE) + 0.5f;
  const float py1 = (float)((t / tx) * TILE + p1 / TILE) + 0.5f;
  const int count = counts[t];
  const int n_chunks = K / CHUNK;
  const int n_lim = min((count + CHUNK - 1) / CHUNK, n_chunks);
  const size_t plane = (size_t)T * K;
  float* ts = tstart + (size_t)t * n_chunks * P;

  PixelFwd q0 = {1.0f, 0.0f, 0.0f, 0.0f, 0.0f}, q1 = q0;
  int c = 0;
  for (; c < n_lim; ++c) {
    // tile-wide exit; also the barrier before the chunk buffer is reused
    if (!__syncthreads_or(q0.tr > TERM_THRESHOLD || q1.tr > TERM_THRESHOLD)) break;
    ts[c * P + p0] = q0.tr;
    ts[c * P + p1] = q1.tr;
    // the chunk's real gaussians; the slots past them hold the zero sentinel
    // row, whose alpha is exactly 0 and which would change no bit
    const int n_real = min(count - c * CHUNK, CHUNK);
    load_chunk_fwd(rows, packed, plane, t, K, c, n_real);
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < n_real; ++j) {
      const float4 m = rows[3 * j], n = rows[3 * j + 1], o = rows[3 * j + 2];
      const float dx = __fsub_rn(px, m.x);
      const float qx = __fmul_rn(__fmul_rn(m.z, dx), dx);
      const float bdx = __fmul_rn(m.w, dx);
      blend(q0, fwd_alpha(qx, bdx, __fsub_rn(py0, m.y), n.x, n.y), n, o);
      blend(q1, fwd_alpha(qx, bdx, __fsub_rn(py1, m.y), n.x, n.y), n, o);
    }
  }
  for (; c < n_chunks; ++c) {
    ts[c * P + p0] = 0.0f;
    ts[c * P + p1] = 0.0f;
  }
  store_fwd(out + (size_t)t * 8 * P + p0, q0);
  store_fwd(out + (size_t)t * 8 * P + p1, q1);
}

constexpr int GROUP = 3;  // gaussians per warp reduce-scatter in the backward
static_assert((SEG - 1) % GROUP == 0, "a segment walks as one gaussian and whole groups");
constexpr size_t BWD_SMEM =
    sizeof(float) * (NCH * CHUNK + CHUNK * ROW + NSEG * P + NWARP * CHUNK * NGRAD);

// Stage chunk c of tile t twice: channel-major for the alpha recompute, and
// one row of ROW floats per gaussian -- its 10 channels, then 1 / max(op,
// 1e-12) -- that the gradient reads as three float4 broadcasts.
__device__ __forceinline__ void load_chunk_bwd(float (*s)[CHUNK], float* rows,
                                               const float* packed, size_t plane, int t, int K,
                                               int c) {
  const float* base = packed + (size_t)t * K + (size_t)c * CHUNK;
  for (int idx = threadIdx.x; idx < NCH * CHUNK; idx += P) {
    const int ch = idx / CHUNK;
    const int i = idx % CHUNK;
    const float x = base[(size_t)ch * plane + i];
    s[ch][i] = x;
    rows[i * ROW + ch] = x;
    if (ch == 8) rows[i * ROW + NCH] = 1.0f / fmaxf(x, 1e-12f);
  }
}

// What the backward knows of its pixel.
struct PixelGrad {
  float px, py;             // pixel centre
  float dCr, dCg, dCb, dD;  // cotangents of colour and depth
  float dA_tf;              // cotangent of alpha times T_final
};

// The 10 gradient terms of gaussian i at this pixel into gv[0:10], given its
// alpha and the transmittance T_i before it; then adds w * e to the suffix.
// On a live pair alpha = min(raw, 0.999), so raw < 0.999 exactly where
// alpha < 0.999, and raw = alpha there: the raw alpha is not needed.
__device__ __forceinline__ void pair_grad(const float* rows, int i, float alpha, float ti,
                                          const PixelGrad& q, float& suffix, float* gv) {
  const float4* row = reinterpret_cast<const float4*>(rows + i * ROW);
  const float4 m = row[0];  // mean x, mean y, conic a, conic b
  const float4 n = row[1];  // conic c, r, g, b
  const float4 o = row[2];  // opacity, depth, 1 / max(opacity, 1e-12), pad
  const float dx = q.px - m.x;
  const float dy = q.py - m.y;
  const float ca = m.z, cb = m.w, cc = n.x;
  const float w = alpha * ti;
  const float e = n.y * q.dCr + n.z * q.dCg + n.w * q.dCb + o.y * q.dD;
  // the SFU's reciprocal (2 ulp) in place of an IEEE division: 1 - alpha
  // lies in [1e-3, 1], far from where __fdividef loses accuracy
  const float inv_om = __fdividef(1.0f, fmaxf(1.0f - alpha, 1e-3f));
  const bool active = alpha > 0.0f && alpha < MAX_ALPHA;
  const float dalpha = active ? ti * e - suffix * inv_om + q.dA_tf * inv_om : 0.0f;
  const float dsig = -alpha * dalpha;
  const float gx = ca * dx + cb * dy;
  const float gy = cc * dy + cb * dx;
  gv[0] = -gx * dsig;
  gv[1] = -gy * dsig;
  gv[2] = 0.5f * dx * dx * dsig;
  gv[3] = dx * dy * dsig;
  gv[4] = 0.5f * dy * dy * dsig;
  gv[5] = w * q.dCr;
  gv[6] = w * q.dCg;
  gv[7] = w * q.dCb;
  gv[8] = active ? alpha * o.z * dalpha : 0.0f;
  gv[9] = w * q.dD;
  suffix += w * e;
}

// Warp reduce-scatter of 2^LOGN values per lane (LOGN 4 or 5) by recursive
// halving: at offset o each lane keeps the half of its values that bit o of
// its lane number selects and adds the partner lane's copy of that half, one
// shuffle per kept value. Lane l ends with the warp's sum of value
// l >> (5 - LOGN); with 16 values the last offset then sums lane pairs.
// 2^LOGN - 1 + (5 - LOGN) shuffles in all, and a fixed order of additions.
template <int LOGN>
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[1 << LOGN], int lane) {
  constexpr int N = 1 << LOGN;
#pragma unroll
  for (int step = 0; step < LOGN; ++step) {
    const int off = 16 >> step;
    const int half = (N / 2) >> step;
    const bool upper = lane & off;
#pragma unroll
    for (int k = 0; k < N / 2; ++k) {
      if (k < half) {
        const float send = upper ? v[k] : v[k + half];
        const float keep = upper ? v[k + half] : v[k];
        v[k] = keep + __shfl_xor_sync(FULL, send, off);
      }
    }
  }
  float r = v[0];
#pragma unroll
  for (int off = 16 >> LOGN; off > 0; off >>= 1) r += __shfl_xor_sync(FULL, r, off);
  return r;
}

// Gradients of the G gaussians base + hi, base + hi - 1, ... (in the reverse
// sweep's order) into this warp's partial sums pw (CHUNK x NGRAD), by one
// reduce-scatter after which G * NGRAD lanes store at once. A group that no
// pixel of the warp is live for stores zeros and leaves the suffix as it is
// (w = 0 on every pixel of the warp).
template <int G>
__device__ __forceinline__ void walk_group(const float* rows, int base, int hi,
                                           const float (&a)[SEG], const float (&ti)[SEG],
                                           const PixelGrad& q, float& suffix, float* pw,
                                           int lane) {
  constexpr int LOGN = G * NGRAD > 16 ? 5 : 4;
  static_assert(G * NGRAD <= (1 << LOGN), "a group's gradients fit one reduce-scatter");
  bool live = false;
#pragma unroll
  for (int m = 0; m < G; ++m) live |= a[hi - m] > 0.0f;
  if (!__any_sync(FULL, live)) {
    if (lane < G * NGRAD) pw[(base + hi - G + 1) * NGRAD + lane] = 0.0f;
    return;
  }
  float v[1 << LOGN];
#pragma unroll
  for (int m = 0; m < G; ++m) {
    pair_grad(rows, base + hi - m, a[hi - m], ti[hi - m], q, suffix, v + m * NGRAD);
  }
#pragma unroll
  for (int k = G * NGRAD; k < (1 << LOGN); ++k) v[k] = 0.0f;
  const float sum = warp_reduce_scatter<LOGN>(v, lane);
  const int idx = lane >> (5 - LOGN);  // member idx / NGRAD, channel idx % NGRAD
  if (idx < G * NGRAD && lane % (32 >> LOGN) == 0) {
    pw[(base + hi - idx / NGRAD) * NGRAD + idx % NGRAD] = sum;
  }
}

__global__ void __launch_bounds__(P, 2)
composite_bwd_kernel(const float* __restrict__ packed, const int* __restrict__ counts,
                     const float* __restrict__ gout, const float* __restrict__ tstart,
                     const float* __restrict__ t_final, float* __restrict__ dpacked, int T,
                     int K, int tx) {
  extern __shared__ __align__(16) float smem[];
  float (*s)[CHUNK] = reinterpret_cast<float (*)[CHUNK]>(smem);  // NCH x CHUNK
  float* rows = smem + NCH * CHUNK;    // CHUNK x ROW, 16-byte aligned
  float* ck = rows + CHUNK * ROW;      // NSEG x P segment-start transmittances
  float* part = ck + NSEG * P;         // NWARP x CHUNK x NGRAD per-warp sums

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int n_chunks = K / CHUNK;
  const size_t plane = (size_t)T * K;
  float* pw = part + (tid >> 5) * CHUNK * NGRAD;
  const int count = counts[t];

  PixelGrad q;
  q.px = (float)((t % tx) * TILE + tid % TILE) + 0.5f;
  q.py = (float)((t / tx) * TILE + tid / TILE) + 0.5f;
  const float* go = gout + (size_t)t * 8 * P + tid;
  q.dCr = go[0 * P];
  q.dCg = go[1 * P];
  q.dCb = go[2 * P];
  q.dD = go[4 * P];
  q.dA_tf = go[3 * P] * t_final[(size_t)t * P + tid];

  float suffix = 0.0f;  // S = sum over later gaussians of w_j e_j
  for (int c = n_chunks - 1; c >= 0; --c) {
    // the chunk's real gaussians; the slots past them hold the zero sentinel row
    const int n_real = min(max(count - c * CHUNK, 0), CHUNK);
    const float t0 = tstart[((size_t)t * n_chunks + c) * P + tid];
    float* dst = dpacked + (size_t)t * K + (size_t)c * CHUNK;
    // an empty chunk touches no shared memory; otherwise the barrier before
    // the shared buffers are reused, and the dead-chunk test
    if (n_real == 0 || !__syncthreads_or(t0 > 0.0f)) {
      for (int i = tid; i < C_PACK * CHUNK; i += P) {
        dst[(size_t)(i / CHUNK) * plane + (i % CHUNK)] = 0.0f;
      }
      continue;
    }
    load_chunk_bwd(s, rows, packed, plane, t, K, c);
    __syncthreads();
    const int n_seg = (n_real + SEG - 1) / SEG;

    // pass 1: transmittance at the start of each segment the sweep reaches
    float tr = t0;
    ck[tid] = tr;
    for (int sg = 0; sg + 1 < n_seg; ++sg) {
#pragma unroll
      for (int j = 0; j < SEG; ++j) tr *= 1.0f - chunk_alpha(s, sg * SEG + j, q.px, q.py).a;
      ck[(sg + 1) * P + tid] = tr;
    }

    // pass 2: segments in reverse, each recomputed into registers and walked
    // backwards, its last gaussian alone and then in groups of GROUP
    for (int sg = n_seg - 1; sg >= 0; --sg) {
      float a[SEG], ti[SEG];
      tr = ck[sg * P + tid];
#pragma unroll
      for (int j = 0; j < SEG; ++j) {
        a[j] = chunk_alpha(s, sg * SEG + j, q.px, q.py).a;
        ti[j] = tr;
        tr *= 1.0f - a[j];
      }
      walk_group<1>(rows, sg * SEG, SEG - 1, a, ti, q, suffix, pw, lane);
#pragma unroll
      for (int hi = SEG - 2; hi >= 0; hi -= GROUP) {
        walk_group<GROUP>(rows, sg * SEG, hi, a, ti, q, suffix, pw, lane);
      }
    }
    __syncthreads();
    // sum the per-warp partials in a fixed order; channel-major writes, with
    // zeros past the real gaussians and in the pad channels
    for (int idx = tid; idx < C_PACK * CHUNK; idx += P) {
      const int v = idx / CHUNK;
      const int i = idx % CHUNK;
      float acc = 0.0f;
      if (v < NGRAD && i < n_real) {
#pragma unroll
        for (int wp = 0; wp < NWARP; ++wp) acc += part[((size_t)wp * CHUNK + i) * NGRAD + v];
      }
      dst[(size_t)v * plane + i] = acc;
    }
  }
}

}  // namespace

extern "C" int tsp_composite_fwd(const float* packed, const int* counts, float* out,
                                 float* tstart, int T, int K, int tx, void* stream) {
  if (T <= 0) return 0;
  composite_fwd_kernel<<<T, FWD_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      packed, counts, out, tstart, T, K, tx);
  return (int)cudaGetLastError();
}

extern "C" int tsp_composite_bwd(const float* packed, const int* counts, const float* gout,
                                 const float* tstart, const float* t_final, float* dpacked,
                                 int T, int K, int tx, void* stream) {
  if (T <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      composite_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)BWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  composite_bwd_kernel<<<T, P, BWD_SMEM, static_cast<cudaStream_t>(stream)>>>(
      packed, counts, gout, tstart, t_final, dpacked, T, K, tx);
  return (int)cudaGetLastError();
}
