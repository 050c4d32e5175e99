// The training step's Adam update for Hopper (sm_90a): every parameter leaf
// in one launch, one pass over parameter, gradient and both moments.
//
// Replaces no TPU kernel. The JAX package writes Adam as plain jnp
// (tpu_splat/gs/optim.py adam_update), which XLA fuses under jit. Eager
// PyTorch runs the same chain (tpu_splat_torch/gs/optim.py,
// adam_update_plain) as about 17 full-width passes a leaf: the alive mask,
// the moment casts, the multiplies, adds, divides and the sqrt, each reading
// and writing whole tensors, most of them through stride-0 broadcasts of the
// masks and the bias corrections. The plain version stays beside it; the
// tests and chip_smoke.py hold this kernel against it on the card.
//
// What bounds it on this card: bytes. An element needs about 15 f32
// operations for 28 bytes moved (read p, g, mu, nu; write p, mu, nu; 24 when
// mu is bf16), some 0.5 operations a byte against the card's 20: device
// memory sets the pace, and the least time is the bytes over 3.35 TB/s.
// So the design moves each byte once: a thread takes 8 consecutive elements
// of a leaf, reads each array as 16-byte loads and writes it as 16-byte
// stores (cache-streaming, the data is not read again), and keeps every
// intermediate in registers. The row flags (alive, visible: one byte a row)
// are read per element through the read-only path, where the rows of a group
// share them. The leaves are a small table passed by value; the block loop
// over them is unrolled so that each leaf's fields are read at fixed offsets
// of the parameter space, and each leaf is a grid-stride loop of the whole
// grid. A leaf whose arrays are not all 16-byte aligned (a row slice of a
// larger tensor), and the last group of a leaf whose size is no multiple of
// 8, go element by element.
//
// Arithmetic: the plain chain's, operation by operation, in f32 with every
// operation rounded on its own (no FMA contraction), IEEE division and
// square root, and the bias corrections read from the device tensors the
// caller computed from the step count; so the kernel and the plain version
// give the same bits on the card. The first moment is read and written in
// its storage type (f32, or bf16 rounded to nearest even).
//
// Every slot is written, dead ones included; rows outside `visible` get their
// inputs back unchanged. An output may be its own input (one thread reads an
// element, then writes it) but must not overlap another array.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEAVES = 8;
constexpr int GROUP = 8;      // elements a thread takes at a time
constexpr int THREADS = 256;

struct Leaf {
  const float* p;
  const float* g;
  const void* mu;        // float or __nv_bfloat16
  const float* nu;
  float* p_out;
  void* mu_out;
  float* nu_out;
  int n;                 // elements
  int width;             // elements a row
  int mu_bf16;
  int vec;               // every array 16-byte aligned
  float lr;
};

struct Table {
  Leaf leaf[MAX_LEAVES];
  int count;
};

struct Consts {
  float b1, omb1, b2, omb2, eps;
};

// One element: exactly adam_update_plain's chain.
__device__ __forceinline__ void adam_elem(float& p, float g, float& mu, float& nu, bool live,
                                          const Consts& c, float lr, float bc1, float bc2) {
  g = live ? g : 0.0f;
  mu = __fadd_rn(__fmul_rn(c.b1, mu), __fmul_rn(c.omb1, g));
  nu = __fadd_rn(__fmul_rn(c.b2, nu), __fmul_rn(c.omb2, __fmul_rn(g, g)));
  const float num = __fmul_rn(__fdiv_rn(mu, bc1), lr);
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, bc2)), c.eps);
  p = __fsub_rn(p, __fdiv_rn(num, den));
}

__device__ __forceinline__ float load_mu(const void* mu, int e, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(mu)[e])
              : static_cast<const float*>(mu)[e];
}

__device__ __forceinline__ void store_mu(void* mu, int e, float v, bool bf16) {
  if (bf16) static_cast<__nv_bfloat16*>(mu)[e] = __float2bfloat16_rn(v);
  else static_cast<float*>(mu)[e] = v;
}

// Elements [e0, e1) of a leaf, one at a time.
__device__ void leaf_scalar(const Leaf& lf, int e0, int e1, const uint8_t* alive,
                            const uint8_t* visible, const Consts& c, float bc1, float bc2) {
  const bool bf16 = lf.mu_bf16 != 0;
  for (int e = e0; e < e1; ++e) {
    const int row = e / lf.width;
    float p = lf.p[e], mu = load_mu(lf.mu, e, bf16), nu = lf.nu[e];
    if (visible == nullptr || __ldg(visible + row)) {
      const bool live = alive == nullptr || __ldg(alive + row);
      adam_elem(p, lf.g[e], mu, nu, live, c, lf.lr, bc1, bc2);
    }
    store_mu(lf.mu_out, e, mu, bf16);
    lf.p_out[e] = p;
    lf.nu_out[e] = nu;
  }
}

__device__ __forceinline__ void unpack(const float4& a, const float4& b, float* v) {
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// One aligned group of 8 elements starting at e0, MU_BF16 the first moment's type.
template <bool MU_BF16>
__device__ __forceinline__ void group_vec(const Leaf& lf, int e0, const uint8_t* alive,
                                          const uint8_t* visible, const Consts& c, float bc1,
                                          float bc2) {
  const float4* p4 = reinterpret_cast<const float4*>(lf.p + e0);
  const float4* g4 = reinterpret_cast<const float4*>(lf.g + e0);
  const float4* nu4 = reinterpret_cast<const float4*>(lf.nu + e0);
  float p[GROUP], g[GROUP], mu[GROUP], nu[GROUP];
  unpack(__ldcs(p4), __ldcs(p4 + 1), p);
  unpack(__ldcs(g4), __ldcs(g4 + 1), g);
  unpack(__ldcs(nu4), __ldcs(nu4 + 1), nu);
  if (MU_BF16) {
    const uint4 mu_bits = __ldcs(reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(lf.mu) + e0));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&mu_bits);
#pragma unroll
    for (int j = 0; j < GROUP / 2; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      mu[2 * j] = f.x;
      mu[2 * j + 1] = f.y;
    }
  } else {
    const float4* mu4 = reinterpret_cast<const float4*>(static_cast<const float*>(lf.mu) + e0);
    unpack(__ldcs(mu4), __ldcs(mu4 + 1), mu);
  }
  int row = e0 / lf.width;
  int rem = e0 - row * lf.width;
#pragma unroll
  for (int j = 0; j < GROUP; ++j) {
    if (visible == nullptr || __ldg(visible + row)) {
      const bool live = alive == nullptr || __ldg(alive + row);
      adam_elem(p[j], g[j], mu[j], nu[j], live, c, lf.lr, bc1, bc2);
    }
    if (++rem == lf.width) {
      rem = 0;
      ++row;
    }
  }

  float4* po = reinterpret_cast<float4*>(lf.p_out + e0);
  float4* nuo = reinterpret_cast<float4*>(lf.nu_out + e0);
  __stcs(po, make_float4(p[0], p[1], p[2], p[3]));
  __stcs(po + 1, make_float4(p[4], p[5], p[6], p[7]));
  __stcs(nuo, make_float4(nu[0], nu[1], nu[2], nu[3]));
  __stcs(nuo + 1, make_float4(nu[4], nu[5], nu[6], nu[7]));
  if (MU_BF16) {
    uint4 out;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
    for (int j = 0; j < GROUP / 2; ++j) h[j] = __floats2bfloat162_rn(mu[2 * j], mu[2 * j + 1]);
    __stcs(reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(lf.mu_out) + e0), out);
  } else {
    float4* muo = reinterpret_cast<float4*>(static_cast<float*>(lf.mu_out) + e0);
    __stcs(muo, make_float4(mu[0], mu[1], mu[2], mu[3]));
    __stcs(muo + 1, make_float4(mu[4], mu[5], mu[6], mu[7]));
  }
}

__device__ __forceinline__ void leaf_pass(const Leaf& lf, const uint8_t* alive,
                                          const uint8_t* visible, const Consts& c, float bc1,
                                          float bc2) {
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int groups = (lf.n + GROUP - 1) / GROUP;
  const int full = lf.vec ? lf.n / GROUP : 0;  // groups taken as vectors
  for (int q = first; q < groups; q += stride) {
    const int e0 = q * GROUP;
    if (q < full) {
      if (lf.mu_bf16) group_vec<true>(lf, e0, alive, visible, c, bc1, bc2);
      else group_vec<false>(lf, e0, alive, visible, c, bc1, bc2);
    } else {
      leaf_scalar(lf, e0, min(e0 + GROUP, lf.n), alive, visible, c, bc1, bc2);
    }
  }
}

__global__ void __launch_bounds__(THREADS) adam_step_kernel(Table t, const uint8_t* alive,
                                                            const uint8_t* visible,
                                                            const float* bc1_ptr,
                                                            const float* bc2_ptr, Consts c) {
  const float bc1 = __ldg(bc1_ptr), bc2 = __ldg(bc2_ptr);
#pragma unroll
  for (int l = 0; l < MAX_LEAVES; ++l)
    if (l < t.count) leaf_pass(t.leaf[l], alive, visible, c, bc1, bc2);
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

}  // namespace

// One Adam step over `count` leaves. ptrs: 7 a leaf (p, g, mu, nu, p_out,
// mu_out, nu_out); sizes: 3 a leaf (elements, elements a row, 1 when mu is
// bf16 else 0); lrs: one a leaf. alive and visible: one byte a row, or null
// (every row live / shown). bc1, bc2: device scalars. Returns a cudaError_t.
extern "C" int tsp_adam(void* const* ptrs, const long long* sizes, const float* lrs, int count,
                        const void* alive, const void* visible, const float* bc1,
                        const float* bc2, float b1, float omb1, float b2, float omb2, float eps,
                        void* stream) {
  if (count < 0 || count > MAX_LEAVES) return (int)cudaErrorInvalidValue;
  Table t = {};
  t.count = count;
  long long most = 0;
  for (int l = 0; l < count; ++l) {
    void* const* a = ptrs + 7 * l;
    const long long n = sizes[3 * l], width = sizes[3 * l + 1];
    if (n <= 0 || n > 0x7fffffffLL - GROUP || width <= 0 || n % width)
      return (int)cudaErrorInvalidValue;
    Leaf& lf = t.leaf[l];
    lf.p = static_cast<const float*>(a[0]);
    lf.g = static_cast<const float*>(a[1]);
    lf.mu = a[2];
    lf.nu = static_cast<const float*>(a[3]);
    lf.p_out = static_cast<float*>(a[4]);
    lf.mu_out = a[5];
    lf.nu_out = static_cast<float*>(a[6]);
    lf.n = (int)n;
    lf.width = (int)width;
    lf.mu_bf16 = sizes[3 * l + 2] != 0;
    lf.lr = lrs[l];
    lf.vec = 1;
    for (int k = 0; k < 7; ++k) lf.vec &= aligned16(a[k]);
    most = n > most ? n : most;
  }
  if (most == 0) return 0;
  static int blocks_per_sm = 0, sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, adam_step_kernel,
                                                          THREADS, 0);
    if (err != cudaSuccess) {
      sms = 0;
      return (int)err;
    }
  }
  const long long want = (most / GROUP + THREADS) / THREADS;
  const long long cap = (long long)sms * blocks_per_sm;
  const int grid = (int)(want < cap ? want : cap);
  const Consts c = {b1, omb1, b2, omb2, eps};
  adam_step_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<const uint8_t*>(alive), static_cast<const uint8_t*>(visible), bc1, bc2, c);
  return (int)cudaGetLastError();
}
