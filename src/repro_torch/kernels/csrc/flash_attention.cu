// GQA flash-attention forward for Hopper (sm_90a), CUDA C++: two kernels.
//
// Both replace the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// _kernel (launched by flash_attention_pallas).  Same function: scale D^-0.5
// applied in float32 to Q.K^T, optional tanh softcap, mask causal q >= k,
// q - k < window and k < Sk (causal aligned top-left), online softmax with
// m, l and acc in float32, output acc / max(l, 1e-30) in q's dtype.  Masked
// scores are the finite NEG_INF = -1e30, never -inf: a fully masked k-tile
// then adds exp(0) terms that the next valid tile wipes out through alpha,
// as on the TPU, instead of exp(-inf + inf) = NaN.  Keys past Sk are left
// out of the softmax altogether, so a row with no valid key (only with a
// window, when q >= Sk + window - 1) averages V over the Sk keys.
//
// Which kernel runs is decided before launch, by dtype and head dim (the
// wrapper's kernel_route; the C entry's ``route`` argument):
//   * bfloat16 with head dim 64 or 128 -> flash_fwd_wgmma, on the tensor
//     cores.  These are the serving shapes (qwen2-7b D=128, zamba2-1.2b
//     D=64), which compute in bf16.
//   * float32 at any head dim, and bfloat16 at head dims 8, 16 and 32 ->
//     flash_fwd_simt, float32 FMAs on the CUDA cores.  This serves the
//     float32 checks and the reduced configs: a bf16 or TF32 product
//     cannot meet the float32 bar of 2e-5, and head dims below 64 do not
//     fill a 128-byte swizzled row.
//
// flash_fwd_wgmma.  One block per (128-row q tile, query head, batch), the
// heaviest causal q tiles dispatched first (blockIdx.z walks the q tiles
// from the last; heads and batches vary fastest).  Three warpgroups:
// warpgroup 2 is the producer, one thread of which issues TMA loads (Q
// once; K and V tiles into a two-stage ring, with full and empty
// mbarriers); warpgroups 0 and 1 are consumers that own 64 query rows
// each.  setmaxnreg moves registers from the producer (40) to the
// consumers (232).  Every tile lands in shared memory in 128-byte swizzled
// boxes of 64 columns (two boxes a row at D = 128), which the wgmma
// descriptors address directly.  A k-tile holds BN = 64 keys at D = 128
// and 128 at D = 64 (key_tile).  Per k-tile a consumer computes
//   S = Q.K^T  wgmma m64nBNk16, A = Q and B = K from shared memory, both
//              K-major, f32 accumulators;
//   softmax    scale in f32, softcap, masks (per element only on diagonal,
//              window-edge and ragged-Sk tiles), online max and sum in f32
//              registers, a row spread over the four threads of a quad;
//   O += P.V   wgmma m64nDk16 with P cast to bf16 in registers as the A
//              operand and V from shared memory as the MN-major B operand
//              (transpose bit), so its [key][d] tile is never transposed
//              by hand.
// The epilogue divides by max(l, 1e-30) in f32 and stores bf16 rows < Sq.
// K and V are read from KV head h / G; the visited k-tiles are those that
// hold a valid key of one of the block's rows (the whole of Sk when a row
// may have none), as in the SIMT kernel.  TMA fills rows past Sq or Sk
// with zeros; those keys get no weight and those rows are not stored.
// Numerical deviation: the TPU kernel computes P.V in float32; here P is
// rounded to bf16 before its product with V (the sum l stays in f32).
// That is the one deviation, and it holds the bf16 bar of 2e-2.
//
// flash_fwd_simt.  One block per (q-tile of 64 rows, query head, batch); a
// loop over k-tiles of 32 keys.  Four threads share a query row: each
// computes 8 of the tile's 32 scores and owns D/4 output columns; the row's
// max and sum are combined with two warp shuffles.  Q, K, V and P tiles are
// staged in shared memory as float32 (bf16 inputs upcast, so P.V runs in
// float32), rows padded by one word so that the eight rows a warp reads
// fall in distinct banks.  Loads past Sq or Sk are masked to zero.
//
// Bound.  At qwen2-7b's serving shape (B=4, H=28, KVH=4, Sq=Sk=1024,
// D=128, bf16, causal) the function does 30.1 GFLOP against 67 MB moved,
// so on an H100 it is bound by operations: 30.4 us at the 989 TFLOP/s bf16
// tensor-core peak; at zamba2-1.2b's (B=4, H=KVH=32, S=2048, D=64) 68.7
// GFLOP, 69.5 us.  The SIMT kernel ran the first at 11.4 TFLOP/s.  What
// still holds the wgmma kernel back: within a consumer the softmax waits
// on its S product and the next product waits on the softmax (only the
// other warpgroup overlaps it), and the epilogue stores from registers.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, h, s;             // element strides; the head dim is dense
};

// Set a kernel's dynamic shared-memory limit, a per-device attribute of
// each instance, on its first launch on a device only.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int device,
                       std::atomic<unsigned long long>& ready) {
  const unsigned long long bit = 1ull << device;
  if (ready.load(std::memory_order_acquire) & bit) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) ready.fetch_or(bit, std::memory_order_release);
  return err;
}

// ------------------------------------------------------------ SIMT kernel

namespace simt {

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 32;           // keys per k-tile
constexpr int THREADS = 256;     // four threads per query row
constexpr int KPT = BK / 4;      // scores per thread per k-tile

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
flash_fwd_simt(const T* __restrict__ q, const T* __restrict__ k,
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
  constexpr int smem = smem_floats<D>() * sizeof(float);
  static std::atomic<unsigned long long> ready{0};
  const cudaError_t err =
      allow_smem(flash_fwd_simt<T, D>, smem, device, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_simt<T, D><<<grid, THREADS, smem, stream>>>(
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
  }
  // bf16 at head dims 64 and 128 takes the wgmma kernel
  if constexpr (std::is_same_v<T, float>) {
    if (D == 64)
      return launch<T, 64>(device, q, k, v, o, B, H, G, Sq, Sk, qs, ks,
                           vs, os, causal, window, softcap, scale, st);
    if (D == 128)
      return launch<T, 128>(device, q, k, v, o, B, H, G, Sq, Sk, qs, ks,
                            vs, os, causal, window, softcap, scale, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace simt

// ----------------------------------------------------------- wgmma kernel

namespace hopper {

constexpr int BM = 128;          // query rows per block: two consumers of 64
constexpr int STAGES = 2;        // depth of the K/V ring
constexpr int THREADS = 384;     // warpgroups 0-1 consume, 2 produces
constexpr int ROW = 128;         // bytes of one swizzled box row (64 bf16)
constexpr float LOG2E = 1.4426950408889634f;

// Keys per k-tile.  At D = 128 a 128-key tile leaves the consumers too few
// registers (ptxas spills and serialises the wgmmas), so it takes 64 keys;
// at D = 64 the 128-key tile is the faster.
constexpr int key_tile(int D) { return D == 128 ? 64 : 128; }

template <int D, int BN>
struct Tiles {                   // shared-memory layout, in bytes
  static constexpr int Q = BM * D * 2;
  static constexpr int KV = BN * D * 2;            // one K or V tile
  static constexpr int K0 = Q;                     // K stage s at K0 + s*KV
  static constexpr int V0 = Q + STAGES * KV;       // V stage s at V0 + s*KV
  static constexpr int SMEM = V0 + STAGES * KV + 1024;   // + 1024-B align
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One TMA box of a 4-D map (d, s, head, batch) into shared memory; the
// barrier counts its bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int s, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d),
        "r"(s), "r"(h), "r"(b)
      : "memory");
}

// wgmma descriptor of a 128-byte-swizzled operand in shared memory: start
// address, leading and stride byte offsets (in 16-byte units), layout 1.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>(lbo >> 4) << 16
         | static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads of wgmma accumulators across the wait.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The accumulator operands of a wgmma m64nN f32 product, N / 2 a thread:
// "%0, ..., %<N / 2 - 1>" in the asm string, "+f"(d[i]) as constraints.
#define WG_R10(t) "%" #t "0, %" #t "1, %" #t "2, %" #t "3, %" #t "4, %" #t \
                  "5, %" #t "6, %" #t "7, %" #t "8, %" #t "9, "
#define WG_REGS32 WG_R10() WG_R10(1) WG_R10(2) "%30, %31"
#define WG_REGS64 WG_R10() WG_R10(1) WG_R10(2) WG_R10(3) WG_R10(4) \
                  WG_R10(5) "%60, %61, %62, %63"
#define WG_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_F16(i) WG_F4(i), WG_F4(i + 4), WG_F4(i + 8), WG_F4(i + 12)
#define WG_ACC32 WG_F16(0), WG_F16(16)
#define WG_ACC64 WG_ACC32, WG_F16(32), WG_F16(48)

// D[64 x N] (+)= A[64 x 16] . B[16 x N], A and B from shared memory, both
// K-major; the sum is kept when scale_d is not 0.  A, B and S name the
// operands that follow the accumulators.
#define WGMMA_SS(N, REGS, ACC, A, B, S)                                      \
  __device__ __forceinline__ void wgmma_ss_n##N(                             \
      float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {            \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " S ", 0;\n"              \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 " \
                 "{" REGS "}, " A ", " B ", p, 1, 1, 0, 0;\n}\n"             \
                 : ACC : "l"(da), "l"(db), "r"(scale_d));                    \
  }
WGMMA_SS(64, WG_REGS32, WG_ACC32, "%32", "%33", "%34")
WGMMA_SS(128, WG_REGS64, WG_ACC64, "%64", "%65", "%66")

// D[64 x N] += A[64 x 16] . B[16 x N], A from registers (bf16 pairs), B
// from shared memory, MN-major (trans-b); always accumulates.
#define WGMMA_RS(N, REGS, ACC, A, B, S)                                      \
  __device__ __forceinline__ void wgmma_rs_n##N(                             \
      float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {              \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " S ", 0;\n"              \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 " \
                 "{" REGS "}, {" A "}, " B ", p, 1, 1, 1;\n}\n"              \
                 : ACC                                                       \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),      \
                   "r"(1));                                                  \
  }
WGMMA_RS(64, WG_REGS32, WG_ACC32, "%32, %33, %34, %35", "%36", "%37")
WGMMA_RS(128, WG_REGS64, WG_ACC64, "%64, %65, %66, %67", "%68", "%69")

// Accumulator layout of wgmma m64nN (f32): thread t of the warpgroup holds,
// for each 8-column block n, d[4n + 2i + j] = row 16 (t / 32) + t % 32 / 4
// + 8i, column 8n + 2 (t % 4) + j.
template <int D, int BN>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ o, int G, int Sq, int Sk,
                Strides os, int causal, int window, float softcap,
                float scale) {
  using L = Tiles<D, BN>;
  constexpr int BOXES = D / 64;  // 128-byte boxes of a row
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 3 * STAGES];
  // 128-byte swizzled tiles start on 1024-byte boundaries
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t q_full = smem_u32(&bars[0]);
  auto k_full = [&](int s) { return smem_u32(&bars[1 + s]); };
  auto v_full = [&](int s) { return smem_u32(&bars[1 + STAGES + s]); };
  auto empty = [&](int s) { return smem_u32(&bars[1 + 2 * STAGES + s]); };

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM;
  const int wg = threadIdx.x / 128;

  // k range holding every valid key of this block's rows; a block that
  // may hold a row with no valid key at all visits every key.
  const int q_last = min(q0 + BM, Sq) - 1;
  int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  int k_hi = causal ? min(Sk, q_last + 1) : Sk;
  if (window > 0 && q_last >= Sk + window - 1) {
    k_lo = 0;
    k_hi = Sk;
  }
  const int t_lo = k_lo / BN;
  const int n_tiles = (k_hi + BN - 1) / BN - t_lo;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 8);    // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      const int kvh = h / G;
      mbar_expect_tx(q_full, L::Q);
      for (int x = 0; x < BOXES; ++x)
        tma_load(sQ + x * BM * ROW, &tq, q_full, 64 * x, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        // the stage's previous tile is released (passes at once the
        // first time round)
        mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
        const int k0 = (t_lo + it) * BN;
        const uint32_t sK = base + L::K0 + s * L::KV;
        const uint32_t sV = base + L::V0 + s * L::KV;
        mbar_expect_tx(k_full(s), L::KV);
        for (int x = 0; x < BOXES; ++x)
          tma_load(sK + x * BN * ROW, &tk, k_full(s), 64 * x, k0, kvh, b);
        mbar_expect_tx(v_full(s), L::KV);
        for (int x = 0; x < BOXES; ++x)
          tma_load(sV + x * BN * ROW, &tv, v_full(s), 64 * x, k0, kvh, b);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows q0 + 64 wg ... + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int qw0 = q0 + 64 * wg;
    const int row_a = qw0 + 16 * (t / 32) + lane / 4;   // and row_a + 8
    const int col_t = 2 * (lane % 4);
    float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;
    float acc[D / 2];
    float s[BN / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    mbar_wait(q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % STAGES;
      const uint32_t parity = (it / STAGES) & 1;
      const int k0 = (t_lo + it) * BN;
      const uint32_t sK = base + L::K0 + st * L::KV;
      const uint32_t sV = base + L::V0 + st * L::KV;

      // S = Q . K^T, 16 columns of depth at a time; box x holds columns
      // 64x ... 64x + 63, a step of 16 is 32 bytes into the row
      mbar_wait(k_full(st), parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t qa = sQ + (kk / 4) * BM * ROW + 64 * wg * ROW
                            + (kk % 4) * 32;
        const uint32_t ka = sK + (kk / 4) * BN * ROW + (kk % 4) * 32;
        if constexpr (BN == 64)
          wgmma_ss_n64(s, smem_desc(qa, 16, 8 * ROW),
                       smem_desc(ka, 16, 8 * ROW), kk);
        else
          wgmma_ss_n128(s, smem_desc(qa, 16, 8 * ROW),
                        smem_desc(ka, 16, 8 * ROW), kk);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(s);

#pragma unroll
      for (int i = 0; i < BN / 2; ++i) s[i] *= scale;
      if (softcap > 0.f) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i)
          s[i] = tanhf(s[i] / softcap) * softcap;
      }
      // per-element masks only where some score of the tile is masked
      const bool edge = k0 + BN > Sk || (causal && k0 + BN - 1 > qw0)
                        || (window > 0 && qw0 + 63 - k0 >= window);
      if (edge) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int qpos = row_a + (i & 2 ? 8 : 0);
          const int kpos = k0 + 8 * (i / 4) + col_t + (i & 1);
          if (kpos >= Sk)
            s[i] = -INFINITY;    // not a key: no weight, even in a row
                                 // whose scores are all NEG_INF
          else if ((causal && qpos < kpos)
                   || (window > 0 && qpos - kpos >= window))
            s[i] = NEG_INF;
        }
      }

      float mx_a = m_a, mx_b = m_b;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        if (i & 2) mx_b = fmaxf(mx_b, s[i]);
        else mx_a = fmaxf(mx_a, s[i]);
      }
#pragma unroll
      for (int sh = 1; sh <= 2; sh <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, sh));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, sh));
      }
      // (x - m) * log2(e), never an fma: with x = m = NEG_INF it is 0
      const float alpha_a = exp2f((m_a - mx_a) * LOG2E);
      const float alpha_b = exp2f((m_b - mx_b) * LOG2E);
      m_a = mx_a;
      m_b = mx_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        s[i] = exp2f((s[i] - (i & 2 ? m_b : m_a)) * LOG2E);
        if (i & 2) sum_b += s[i];
        else sum_a += s[i];
      }
      // each thread keeps its part of l; the quad sums them at the end
      l_a = l_a * alpha_a + sum_a;
      l_b = l_b * alpha_b + sum_b;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= i & 2 ? alpha_b : alpha_a;

      // P in bf16 as wgmma's A fragments: the accumulator layout of
      // columns 16kk ... 16kk + 15 is the A layout of k-step kk
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          pa[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);

      // O += P . V: V's [key][d] tile is the MN-major B operand; a k-step
      // is 16 key rows (2048 bytes), box x holds d = 64x ... 64x + 63
      mbar_wait(v_full(st), parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint64_t dv = smem_desc(sV + kk * 16 * ROW, BN * ROW, 8 * ROW);
        if constexpr (D == 64)
          wgmma_rs_n64(acc, pa[kk], dv);
        else
          wgmma_rs_n128(acc, pa[kk], dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(acc);
      if (lane == 0) mbar_arrive(empty(st));
    }

#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, sh);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, sh);
    }
    const float la = fmaxf(l_a, 1e-30f), lb = fmaxf(l_b, 1e-30f);
    __nv_bfloat16* ob = o + b * os.b + h * os.h;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = 8 * n + col_t;
      if (row_a < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + row_a * os.s + col) =
            __floats2bfloat162_rn(acc[4 * n] / la, acc[4 * n + 1] / la);
      if (row_a + 8 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (row_a + 8) * os.s + col) =
            __floats2bfloat162_rn(acc[4 * n + 2] / lb, acc[4 * n + 3] / lb);
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no link against libcuda.
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The 4-D map (d, s, head, batch) of a bf16 tensor with a dense head dim,
// read in boxes of 64 columns x ``rows`` rows with the 128-byte swizzle;
// rows past S are filled with zeros.  A stride of a dim of size 1 is never
// followed: it is given the dense value, so that any view passes TMA's
// 16-byte rule.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int D, int S,
                     int heads, int B, Strides st, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const long long ss = S > 1 ? st.s : D;
  const long long sh = heads > 1 ? st.h : (long long)S * D;
  const long long sb = B > 1 ? st.b : (long long)heads * S * D;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch(int device, const void* q, const void* k, const void* v,
                   void* o, int B, int H, int KVH, int Sq, int Sk,
                   Strides qs, Strides ks, Strides vs, Strides os,
                   int causal, int window, float softcap, float scale,
                   cudaStream_t stream) {
  constexpr int BN = key_tile(D);
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map(&tq, q, D, Sq, H, B, qs, BM);
  if (err == cudaSuccess) err = make_map(&tk, k, D, Sk, KVH, B, ks, BN);
  if (err == cudaSuccess) err = make_map(&tv, v, D, Sk, KVH, B, vs, BN);
  static std::atomic<unsigned long long> ready{0};
  if (err == cudaSuccess)
    err = allow_smem(flash_fwd_wgmma<D, BN>, Tiles<D, BN>::SMEM, device,
                     ready);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B, (Sq + BM - 1) / BM);
  flash_fwd_wgmma<D, BN><<<grid, THREADS, Tiles<D, BN>::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), H / KVH, Sq, Sk, os,
      causal, window, softcap, scale);
  return cudaGetLastError();
}

}  // namespace hopper
}  // namespace

// Plain C entry point, bound with ctypes by repro_torch/kernels/_build.py.
// dtype: 0 float32, 1 bfloat16.  route: 0 the SIMT kernel, 1 the wgmma
// kernel (bfloat16, D 64 or 128; q, k and v 16-byte aligned with strides
// of multiples of 8 elements, as TMA needs).  Strides are in elements,
// (batch, head, sequence) for each tensor; the head dim must be dense.
// ``device`` must be the caller's current device, which the Python wrapper
// makes it.  Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_flash_attention_fwd(
    int device, int dtype, int route, const void* q, const void* k,
    const void* v, void* o, int B, int H, int KVH, int Sq, int Sk, int D,
    long long qsb, long long qsh, long long qss, long long ksb,
    long long ksh, long long kss, long long vsb, long long vsh,
    long long vss, long long osb, long long osh, long long oss, int causal,
    int window, float softcap, float scale, void* stream) {
  if (device < 0 || device >= 64 || KVH <= 0 || H % KVH != 0)
    return cudaErrorInvalidValue;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / KVH;
  cudaError_t err = cudaErrorInvalidValue;
  if (route == 1 && dtype == 1) {
    if (D == 64)
      err = hopper::launch<64>(device, q, k, v, o, B, H, KVH, Sq, Sk, qs, ks,
                               vs, os, causal, window, softcap, scale, st);
    else if (D == 128)
      err = hopper::launch<128>(device, q, k, v, o, B, H, KVH, Sq, Sk, qs,
                                ks, vs, os, causal, window, softcap, scale,
                                st);
  } else if (route == 0 && dtype == 0) {
    err = simt::dispatch_d<float>(device, D, q, k, v, o, B, H, G, Sq, Sk, qs,
                                  ks, vs, os, causal, window, softcap, scale,
                                  st);
  } else if (route == 0 && dtype == 1) {
    err = simt::dispatch_d<__nv_bfloat16>(device, D, q, k, v, o, B, H, G, Sq,
                                          Sk, qs, ks, vs, os, causal, window,
                                          softcap, scale, st);
  }
  return static_cast<int>(err);
}
