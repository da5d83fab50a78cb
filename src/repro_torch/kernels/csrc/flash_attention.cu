// GQA flash-attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::_kernel
// (launched by flash_attention_pallas).  Same function: scale D^-0.5,
// optional tanh softcap, mask causal q >= k, q - k < window and k < Sk,
// online softmax with m, l and acc in float32, q, k and v upcast to float32
// (so P.V runs in float32 for bf16 inputs too), output acc / max(l, 1e-30)
// in q's dtype.  Masked scores are the finite NEG_INF = -1e30, never -inf:
// a fully masked k-tile then adds exp(0) terms that the next valid tile
// wipes out through alpha, as on the TPU, instead of exp(-inf + inf) = NaN.
//
// Design.  One block per (q-tile of 64 rows, query head, batch); a loop
// over k-tiles of 32 keys inside the block takes the place of the TPU
// grid's sequential k axis.  K and V are read from KV head h / G, so KV
// heads are never replicated.  Four threads share a query row: each
// computes 8 of the tile's 32 scores and owns D/4 output columns; the
// row's max and sum are combined with two warp shuffles.  Q, K, V and P
// tiles are staged in shared memory as float32, rows padded by one word
// so that the eight rows a warp reads fall in distinct banks.  Loads past
// Sq or Sk are masked to zero; keys past Sk are left out of the softmax.
// For causal and windowed attention the block visits only the k-tiles
// that hold a valid key for one of its rows (skipped tiles change no
// result: a later valid tile wipes an earlier masked one, and a masked
// tile after a valid one adds exact zeros).
//
// Bound.  At the serving shape (B=4, H=28, KVH=4, Sq=Sk=1024, D=128,
// bf16, causal) the function does 30.1 GFLOP against 67 MB moved, so on
// an H100 it is bound by operations: 30.4 us at the 989 TFLOP/s bf16
// tensor-core peak.  This first kernel runs its products as float32 FMAs
// on the CUDA cores (67 TFLOP/s peak) and is further held back by one
// shared-memory load per FMA; wgmma on bf16 tiles fed by TMA, and
// pipelined loads, are the later work that closes the gap.

#include <atomic>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 32;           // keys per k-tile
constexpr int THREADS = 256;     // four threads per query row
constexpr int KPT = BK / 4;      // scores per thread per k-tile
constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, h, s;             // element strides; the head dim is dense
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int G, int Sq,
                 int Sk, Strides qs, Strides ks, Strides vs, Strides os,
                 int causal, int window, float softcap, float scale) {
  constexpr int DP = D + 1;      // padded row of Q and K
  constexpr int PP = BK + 1;     // padded row of P
  constexpr int DPT = D / 4;     // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;              // BQ x DP
  float* sK = sQ + BQ * DP;      // BK x DP
  float* sV = sK + BK * DP;      // BK x D
  float* sP = sV + BK * D;       // BQ x PP

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int row = tid >> 2;
  const int quad = tid & 3;
  const int qpos = q0 + row;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + (h / G) * ks.h;
  const T* vb = v + b * vs.b + (h / G) * vs.h;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    sQ[r * DP + d] = q0 + r < Sq ? to_f32(qb[(q0 + r) * qs.s + d]) : 0.f;
  }

  // k range holding every valid key of this block's rows; a block that
  // may hold a row with no valid key at all visits every key, so that
  // row averages V over all of them as the plain version does.
  const int q_last = min(q0 + BQ, Sq) - 1;
  int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  int k_hi = causal ? min(Sk, q_last + 1) : Sk;
  if (window > 0 && q_last >= Sk + window - 1) {
    k_lo = 0;
    k_hi = Sk;
  }

  float m_i = NEG_INF, l_i = 0.f;
  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();             // the previous tile is no longer read
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const bool in = k0 + r < Sk;
      sK[r * DP + d] = in ? to_f32(kb[(k0 + r) * ks.s + d]) : 0.f;
      sV[r * D + d] = in ? to_f32(vb[(k0 + r) * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[KPT];
#pragma unroll
    for (int j = 0; j < KPT; ++j) s[j] = 0.f;
    const float* qrow = sQ + row * DP;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int j = 0; j < KPT; ++j)
        s[j] = fmaf(qd, sK[(quad + 4 * j) * DP + d], s[j]);
    }

    float tmax = NEG_INF;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int kpos = k0 + quad + 4 * j;
      float x = s[j] * scale;
      if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
      bool ok = true;
      if (causal) ok = ok && qpos >= kpos;
      if (window > 0) ok = ok && qpos - kpos < window;
      s[j] = ok ? x : NEG_INF;
      if (kpos < Sk) tmax = fmaxf(tmax, s[j]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m_i, tmax);
    const float alpha = expf(m_i - m_new);

    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int kpos = k0 + quad + 4 * j;
      const float p = kpos < Sk ? expf(s[j] - m_new) : 0.f;
      sP[row * PP + quad + 4 * j] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l_i = l_i * alpha + psum;
    m_i = m_new;
    // a row's P is written and read only by its own four threads, which
    // sit in one warp
    __syncwarp();

#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[j] *= alpha;
    const float* prow = sP + row * PP;
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float p = prow[kk];
#pragma unroll
      for (int j = 0; j < DPT; ++j)
        acc[j] = fmaf(p, sV[kk * D + quad + 4 * j], acc[j]);
    }
  }

  if (qpos < Sq) {
    const float l = fmaxf(l_i, 1e-30f);
    T* orow = o + b * os.b + h * os.h + qpos * os.s;
#pragma unroll
    for (int j = 0; j < DPT; ++j) store(orow + quad + 4 * j, acc[j] / l);
  }
}

template <typename T, int D>
cudaError_t launch(int device, const void* q, const void* k, const void* v,
                   void* o, int B, int H, int G, int Sq, int Sk, Strides qs,
                   Strides ks, Strides vs, Strides os, int causal,
                   int window, float softcap, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_floats<D>() * sizeof(float);
  // The shared-memory limit is a per-device attribute of each instance:
  // set it on the first launch on a device, not on every launch.
  static std::atomic<unsigned long long> ready{0};
  const unsigned long long bit = 1ull << device;
  if (!(ready.load(std::memory_order_acquire) & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    ready.fetch_or(bit, std::memory_order_release);
  }
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), G, Sq, Sk, qs, ks, vs,
      os, causal, window, softcap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int device, int D, const void* q, const void* k,
                       const void* v, void* o, int B, int H, int G, int Sq,
                       int Sk, Strides qs, Strides ks, Strides vs, Strides os,
                       int causal, int window, float softcap, float scale,
                       cudaStream_t st) {
  switch (D) {
    case 8:
      return launch<T, 8>(device, q, k, v, o, B, H, G, Sq, Sk, qs, ks,
                          vs, os, causal, window, softcap, scale, st);
    case 16:
      return launch<T, 16>(device, q, k, v, o, B, H, G, Sq, Sk, qs, ks,
                           vs, os, causal, window, softcap, scale, st);
    case 32:
      return launch<T, 32>(device, q, k, v, o, B, H, G, Sq, Sk, qs, ks,
                           vs, os, causal, window, softcap, scale, st);
    case 64:
      return launch<T, 64>(device, q, k, v, o, B, H, G, Sq, Sk, qs, ks,
                           vs, os, causal, window, softcap, scale, st);
    case 128:
      return launch<T, 128>(device, q, k, v, o, B, H, G, Sq, Sk, qs, ks,
                            vs, os, causal, window, softcap, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes by repro_torch/kernels/_build.py.
// dtype: 0 float32, 1 bfloat16.  Strides are in elements, (batch, head,
// sequence) for each tensor; the head dim must be dense.  ``device`` must
// be the caller's current device, which the Python wrapper makes it.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_flash_attention_fwd(
    int device, int dtype, const void* q, const void* k, const void* v,
    void* o, int B, int H, int KVH, int Sq, int Sk, int D, long long qsb,
    long long qsh, long long qss, long long ksb, long long ksh,
    long long kss, long long vsb, long long vsh, long long vss,
    long long osb, long long osh, long long oss, int causal, int window,
    float softcap, float scale, void* stream) {
  if (device < 0 || device >= 64 || KVH <= 0 || H % KVH != 0)
    return cudaErrorInvalidValue;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / KVH;
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(device, D, q, k, v, o, B, H, G, Sq, Sk, qs, ks,
                            vs, os, causal, window, softcap, scale, st);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(device, D, q, k, v, o, B, H, G, Sq, Sk,
                                    qs, ks, vs, os, causal, window, softcap,
                                    scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
