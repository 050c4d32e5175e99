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
// One block per 16x16 tile, one thread per pixel (256 threads), gsplat style.
//
// What bounds them on this card: per (pixel, gaussian) pair both kernels do
// an exp and ~25 (forward) / ~60 (backward) f32 operations on values that sit
// in shared memory; the bytes moved per tile are a few KB per chunk. So both
// are bound by f32/SFU operations, not by device memory. The design keeps every
// per-pixel quantity in registers and stages each 128-gaussian chunk's 10 used
// channels once in shared memory, where all 256 threads read them as
// broadcasts. The backward adds a warp-shuffle reduction per gaussian, skipped
// for warps where the gaussian touches no pixel.
//
// Semantics kept exactly from the reference:
//  * the early exit is TILE-wide and checked once per chunk, before the chunk
//    (__syncthreads_or over T > 1e-4), never per pixel;
//  * the sweep is bounded by counts[t] (ceil(count / 128) chunks);
//  * tstart holds each reached chunk's start transmittance and 0 for every
//    other chunk; the backward skips chunks whose tstart is 0 on every pixel.
//
// Backward transmittance: T_i within a chunk is recomputed forward from the
// tstart checkpoint, never by dividing back by (1 - alpha) -- with alpha up to
// 0.999 that division amplifies rounding by up to 1000x. A first pass stores
// the transmittance at the start of each 16-gaussian segment in shared memory
// (8 x 256 floats); the reverse walk then recomputes one segment at a time
// into registers (alpha, raw alpha, T_i for 16 gaussians) and walks it
// backwards. This is exact like keeping a 128 x 256 prefix in shared memory,
// but needs 8 KB instead of 128 KB, at the cost of computing each alpha twice.

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

// Stage the NCH used channels of chunk c of tile t into shared memory.
__device__ __forceinline__ void load_chunk(float (*s)[CHUNK], const float* packed,
                                           size_t plane, int t, int K, int c) {
  const float* base = packed + (size_t)t * K + (size_t)c * CHUNK;
  for (int i = threadIdx.x; i < NCH * CHUNK; i += P) {
    s[i / CHUNK][i % CHUNK] = base[(size_t)(i / CHUNK) * plane + (i % CHUNK)];
  }
}

__global__ void __launch_bounds__(P)
composite_fwd_kernel(const float* __restrict__ packed, const int* __restrict__ counts,
                     float* __restrict__ out, float* __restrict__ tstart, int T, int K,
                     int tx) {
  __shared__ float s[NCH][CHUNK];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const float px = (float)((t % tx) * TILE + tid % TILE) + 0.5f;
  const float py = (float)((t / tx) * TILE + tid / TILE) + 0.5f;
  const int n_chunks = K / CHUNK;
  const int n_lim = min((counts[t] + CHUNK - 1) / CHUNK, n_chunks);
  const size_t plane = (size_t)T * K;
  float* ts = tstart + (size_t)t * n_chunks * P;

  float tr = 1.0f, r = 0.0f, g = 0.0f, b = 0.0f, d = 0.0f;
  int c = 0;
  for (; c < n_lim; ++c) {
    // tile-wide exit; also the barrier before the chunk buffer is reused
    if (!__syncthreads_or(tr > TERM_THRESHOLD)) break;
    ts[c * P + tid] = tr;
    load_chunk(s, packed, plane, t, K, c);
    __syncthreads();
    for (int j = 0; j < CHUNK; ++j) {
      const float alpha = chunk_alpha(s, j, px, py).a;
      const float w = alpha * tr;
      r += w * s[5][j];
      g += w * s[6][j];
      b += w * s[7][j];
      d += w * s[9][j];
      tr *= 1.0f - alpha;
    }
  }
  for (; c < n_chunks; ++c) ts[c * P + tid] = 0.0f;

  float* o = out + (size_t)t * 8 * P + tid;
  o[0 * P] = r;
  o[1 * P] = g;
  o[2 * P] = b;
  o[3 * P] = 1.0f - tr;
  o[4 * P] = d;
  o[5 * P] = 0.0f;
  o[6 * P] = 0.0f;
  o[7 * P] = 0.0f;
}

constexpr size_t BWD_SMEM = sizeof(float) * (NCH * CHUNK + NSEG * P + NWARP * CHUNK * NGRAD);

__global__ void __launch_bounds__(P)
composite_bwd_kernel(const float* __restrict__ packed, const float* __restrict__ gout,
                     const float* __restrict__ tstart, const float* __restrict__ t_final,
                     float* __restrict__ dpacked, int T, int K, int tx) {
  extern __shared__ float smem[];
  float (*s)[CHUNK] = reinterpret_cast<float (*)[CHUNK]>(smem);  // NCH x CHUNK
  float* ck = smem + NCH * CHUNK;      // NSEG x P segment-start transmittances
  float* part = ck + NSEG * P;         // NWARP x CHUNK x NGRAD per-warp sums

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float px = (float)((t % tx) * TILE + tid % TILE) + 0.5f;
  const float py = (float)((t / tx) * TILE + tid / TILE) + 0.5f;
  const int n_chunks = K / CHUNK;
  const size_t plane = (size_t)T * K;

  const float* go = gout + (size_t)t * 8 * P + tid;
  const float dCr = go[0 * P], dCg = go[1 * P], dCb = go[2 * P];
  const float dA = go[3 * P], dD = go[4 * P];
  const float dA_tf = dA * t_final[(size_t)t * P + tid];

  float suffix = 0.0f;  // S = sum over later gaussians of w_j e_j
  for (int c = n_chunks - 1; c >= 0; --c) {
    const float t0 = tstart[((size_t)t * n_chunks + c) * P + tid];
    float* dst = dpacked + (size_t)t * K + (size_t)c * CHUNK;
    // barrier before shared buffers are reused, and the dead-chunk test
    if (!__syncthreads_or(t0 > 0.0f)) {
      for (int i = tid; i < C_PACK * CHUNK; i += P) {
        dst[(size_t)(i / CHUNK) * plane + (i % CHUNK)] = 0.0f;
      }
      continue;
    }
    load_chunk(s, packed, plane, t, K, c);
    __syncthreads();

    // pass 1: transmittance at the start of each segment
    float tr = t0;
    for (int sg = 0; sg < NSEG; ++sg) {
      ck[sg * P + tid] = tr;
#pragma unroll
      for (int j = 0; j < SEG; ++j) {
        tr *= 1.0f - chunk_alpha(s, sg * SEG + j, px, py).a;
      }
    }

    // pass 2: segments in reverse, each recomputed into registers
    for (int sg = NSEG - 1; sg >= 0; --sg) {
      float a[SEG], araw[SEG], ti[SEG];
      tr = ck[sg * P + tid];
#pragma unroll
      for (int j = 0; j < SEG; ++j) {
        const Alpha al = chunk_alpha(s, sg * SEG + j, px, py);
        araw[j] = al.raw;
        a[j] = al.a;
        ti[j] = tr;
        tr *= 1.0f - a[j];
      }
#pragma unroll
      for (int j = SEG - 1; j >= 0; --j) {
        const int i = sg * SEG + j;
        const float alpha = a[j];
        float* pw = part + ((size_t)warp * CHUNK + i) * NGRAD;
        // alpha > 0 exactly where the pair is live; a warp with no live pixel
        // contributes zero to every channel of this gaussian
        if (!__any_sync(FULL, alpha > 0.0f)) {
          if (lane < NGRAD) pw[lane] = 0.0f;
          continue;
        }
        const float dx = px - s[0][i];
        const float dy = py - s[1][i];
        const float ca = s[2][i], cb = s[3][i], cc = s[4][i];
        const float op = s[8][i];
        const float w = alpha * ti[j];
        const float e = s[5][i] * dCr + s[6][i] * dCg + s[7][i] * dCb + s[9][i] * dD;
        const float inv_om = 1.0f / fmaxf(1.0f - alpha, 1e-3f);
        const bool active = alpha > 0.0f && araw[j] < MAX_ALPHA;
        const float dalpha = active ? ti[j] * e - suffix * inv_om + dA_tf * inv_om : 0.0f;
        const float dsig = -alpha * dalpha;
        const float gx = ca * dx + cb * dy;
        const float gy = cc * dy + cb * dx;
        float gv[NGRAD];
        gv[0] = -gx * dsig;
        gv[1] = -gy * dsig;
        gv[2] = 0.5f * dx * dx * dsig;
        gv[3] = dx * dy * dsig;
        gv[4] = 0.5f * dy * dy * dsig;
        gv[5] = w * dCr;
        gv[6] = w * dCg;
        gv[7] = w * dCb;
        gv[8] = active ? araw[j] / fmaxf(op, 1e-12f) * dalpha : 0.0f;
        gv[9] = w * dD;
        suffix += w * e;
#pragma unroll
        for (int v = 0; v < NGRAD; ++v) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) gv[v] += __shfl_xor_sync(FULL, gv[v], off);
        }
        if (lane == 0) {
#pragma unroll
          for (int v = 0; v < NGRAD; ++v) pw[v] = gv[v];
        }
      }
    }
    __syncthreads();
    // sum the per-warp partials in a fixed order; channel-major writes
    for (int idx = tid; idx < C_PACK * CHUNK; idx += P) {
      const int v = idx / CHUNK;
      const int i = idx % CHUNK;
      float acc = 0.0f;
      if (v < NGRAD) {
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
  composite_fwd_kernel<<<T, P, 0, static_cast<cudaStream_t>(stream)>>>(packed, counts, out,
                                                                     tstart, T, K, tx);
  return (int)cudaGetLastError();
}

extern "C" int tsp_composite_bwd(const float* packed, const float* gout, const float* tstart,
                                 const float* t_final, float* dpacked, int T, int K, int tx,
                                 void* stream) {
  if (T <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      composite_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)BWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  composite_bwd_kernel<<<T, P, BWD_SMEM, static_cast<cudaStream_t>(stream)>>>(
      packed, gout, tstart, t_final, dpacked, T, K, tx);
  return (int)cudaGetLastError();
}
