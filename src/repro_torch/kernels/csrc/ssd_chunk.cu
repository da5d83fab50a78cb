// Mamba2 SSD chunk kernel for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py::_chunk_kernel
// (launched by ssd_chunk_pallas).  Same function, all in float32, for one
// (batch, chunk, head) of chunk length L, head dim P and state dim N:
//   M[i, j] = (C_i . B_j) * exp(cum_i - cum_j) * dt_j   for j <= i, else 0
//   y[i, :] = sum_j M[i, j] x[j, :]                           (L x P)
//   state   = sum_j (B_j * exp(cum_{L-1} - cum_j) * dt_j) (x) x_j  (N x P)
// x is float32 or bfloat16 (upcast on load); B, C, dt and cum are float32;
// y and the states are written as float32.  Entries above the diagonal are
// never formed: there exp(cum_i - cum_j) grows without bound.
//
// Design.  One block per (head, chunk, batch), as the TPU grid has it; the
// blocks run in parallel and share nothing.  The chunk is cut into 64-row
// tiles.  For each row tile i, the block walks the key tiles j <= i (tiles
// above the diagonal are skipped whole) and does three small matrix
// products through shared memory, as a 16 x 16 grid of threads that each
// own a 4 x 4 piece of the output:
//   S = C_i . B_j^T  (64 x 64, depth N), scaled and masked into M;
//   y_i += M . x_j   (64 x P, depth 64), kept in registers across j;
//   state += (B_j w_j)^T . x_j  (N x P, depth 64; 8 x 4 a thread), on the
//   diagonal step only, where each key tile comes exactly once.
// C and B tiles are staged transposed ([n][row]), so the inner loops read
// one 16-byte word of each operand per 16 FMAs.  The kernel reads its
// inputs through the element strides it is given, so the model-layout
// views (x a slice of the conv output) copy nothing.
//
// Bound.  At mamba2-370m's prefill shape (b=4, S=2048, L=256, nh=32,
// P=64, N=128; 1024 blocks) the function needs 8.9 GFLOP (C.B^T once per
// (batch, chunk) on the lower triangle, M.x on the lower triangle, the
// states) and moves 145 MB with bf16 x, so on an H100 it is bound by
// operations: 0.133 ms at the 67 TFLOP/s float32 peak (0.043 ms for the
// bytes at 3.35 TB/s).  This kernel recomputes C.B^T for every head (nh
// times the needed products) and computes whole diagonal tiles, so it does
// about 20 GFLOP, all as float32 FMAs on the CUDA cores.  Tensor cores,
// TMA and sharing C.B^T across heads are the later work.

#include <atomic>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;     // a 16 x 16 grid of threads
constexpr int T = 64;            // rows of an i tile and of a j tile
constexpr int MAX_L = 256;
constexpr int PMAX = 64;         // head dim P <= 64: 16 threads x 4 columns
constexpr int NMAX = 128;        // state dim N <= 128: 16 threads x 8 rows
constexpr int MS = T + 4;        // padded row of the M tile

struct Strides5 {
  long long b, c, l, h, p;       // x: (batch, chunk, row, head, col)
};
struct Strides4 {
  long long b, c, l, k;          // B, C: (.., row, n); dt, cum: (.., row, head)
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// sCt, sBt (NMAX x T each), sX (T x PMAX), sM (T x MS), four T vectors:
// 98 KB, so two blocks fit an SM's 227 KB, as the registers allow.  The
// loops run to the runtime N, so one size serves every N.
constexpr int SMEM_FLOATS = 2 * NMAX * T + T * PMAX + T * MS + 4 * T;

// rows [r0, r0 + T) of a (.., row, n) matrix into dst[n * T + r], zero
// past L
__device__ __forceinline__ void load_transposed(
    float* dst, const float* __restrict__ src, long long sl, long long sk,
    int r0, int L, int N) {
  for (int idx = threadIdx.x; idx < T * N; idx += THREADS) {
    const int n = idx / T, r = idx - n * T;
    dst[idx] = r0 + r < L ? src[(r0 + r) * sl + n * sk] : 0.f;
  }
}

template <typename T_>
__global__ void __launch_bounds__(THREADS, 2)
ssd_chunk_kernel(const T_* __restrict__ x, const float* __restrict__ B,
                 const float* __restrict__ C, const float* __restrict__ dt,
                 const float* __restrict__ cum, float* __restrict__ y,
                 float* __restrict__ states, int nc, int L, int nh, int P,
                 int N, Strides5 xs, Strides4 bs, Strides4 cs, Strides4 ds,
                 Strides4 qs) {
  extern __shared__ __align__(16) float smem[];
  float* sCt = smem;                 // C_i tile, [n][i]
  float* sBt = sCt + NMAX * T;       // B_j tile, [n][j]
  float* sX = sBt + NMAX * T;        // x_j tile, [j][p]
  float* sM = sX + T * PMAX;         // M tile, [i][j]
  float* sCumI = sM + T * MS;
  float* sCumJ = sCumI + T;
  float* sDt = sCumJ + T;
  float* sW = sDt + T;               // state weights of the j tile

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  const T_* xb = x + b * xs.b + c * xs.c + h * xs.h;
  const float* Bb = B + b * bs.b + c * bs.c;
  const float* Cb = C + b * cs.b + c * cs.c;
  const float* db = dt + b * ds.b + c * ds.c + h * ds.k;
  const float* qb = cum + b * qs.b + c * qs.c + h * qs.k;
  const float cum_last = qb[(L - 1) * qs.l];
  const int ntiles = (L + T - 1) / T;

  float st[8][4];                    // state rows ty*8 + e, cols tx*4 + q
#pragma unroll
  for (int e = 0; e < 8; ++e)
#pragma unroll
    for (int q = 0; q < 4; ++q) st[e][q] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int i0 = it * T;
    float ya[4][4];                  // y rows i0 + ty*4 + a, cols tx*4 + q
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 4; ++q) ya[a][q] = 0.f;
    __syncthreads();                 // the last i tile is no longer read
    load_transposed(sCt, Cb, cs.l, cs.k, i0, L, N);
    if (tid < T) sCumI[tid] = i0 + tid < L ? qb[(i0 + tid) * qs.l] : 0.f;

    for (int jt = 0; jt <= it; ++jt) {   // key tiles above i: skipped
      const int j0 = jt * T;
      __syncthreads();               // the last j tile is no longer read
      load_transposed(sBt, Bb, bs.l, bs.k, j0, L, N);
      for (int idx = tid; idx < T * P; idx += THREADS) {
        const int r = idx / P, p = idx - r * P;
        sX[r * PMAX + p] = j0 + r < L ? to_f32(xb[(j0 + r) * xs.l + p * xs.p])
                                      : 0.f;
      }
      if (tid < T) {
        const int j = j0 + tid;
        const float d = j < L ? db[j * ds.l] : 0.f;
        const float q = j < L ? qb[j * qs.l] : 0.f;
        sCumJ[tid] = q;
        sDt[tid] = d;
        sW[tid] = j < L ? expf(cum_last - q) * d : 0.f;
      }
      __syncthreads();

      // S = C_i . B_j^T, rows ty*4 + a, cols tx*4 + q
      float s[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) s[a][q] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        const float4 cv = *reinterpret_cast<const float4*>(sCt + n * T + ty * 4);
        const float4 bv = *reinterpret_cast<const float4*>(sBt + n * T + tx * 4);
        const float ca[4] = {cv.x, cv.y, cv.z, cv.w};
        const float bq[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < 4; ++q) s[a][q] = fmaf(ca[a], bq[q], s[a][q]);
      }
      // M = S * exp(cum_i - cum_j) * dt_j on j <= i, else 0
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int ir = ty * 4 + a;
        float m[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int jr = tx * 4 + q;
          m[q] = j0 + jr <= i0 + ir
                     ? s[a][q] * expf(sCumI[ir] - sCumJ[jr]) * sDt[jr]
                     : 0.f;
        }
        *reinterpret_cast<float4*>(sM + ir * MS + tx * 4) =
            make_float4(m[0], m[1], m[2], m[3]);
      }

      // the chunk state, once per key tile (here on the diagonal)
      if (jt == it && ty * 8 < N) {
#pragma unroll 2
        for (int jr = 0; jr < T; ++jr) {
          const float4 xv = *reinterpret_cast<const float4*>(sX + jr * PMAX + tx * 4);
          const float xq[4] = {xv.x, xv.y, xv.z, xv.w};
          const float w = sW[jr];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float bw = sBt[(ty * 8 + e) * T + jr] * w;
#pragma unroll
            for (int q = 0; q < 4; ++q) st[e][q] = fmaf(bw, xq[q], st[e][q]);
          }
        }
      }
      __syncthreads();               // M is written

      // y_i += M . x_j
#pragma unroll 4
      for (int jr = 0; jr < T; ++jr) {
        const float4 xv = *reinterpret_cast<const float4*>(sX + jr * PMAX + tx * 4);
        const float xq[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float m = sM[(ty * 4 + a) * MS + jr];
#pragma unroll
          for (int q = 0; q < 4; ++q) ya[a][q] = fmaf(m, xq[q], ya[a][q]);
        }
      }
    }

    if (tx * 4 < P) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty * 4 + a;
        if (i < L)
          *reinterpret_cast<float4*>(
              y + ((static_cast<long long>(b * nc + c) * L + i) * nh + h) * P
              + tx * 4) = make_float4(ya[a][0], ya[a][1], ya[a][2], ya[a][3]);
      }
    }
  }

  if (tx * 4 < P) {
    float* sb = states + static_cast<long long>((b * nc + c) * nh + h) * N * P;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int n = ty * 8 + e;
      if (n < N)
        *reinterpret_cast<float4*>(sb + n * P + tx * 4) =
            make_float4(st[e][0], st[e][1], st[e][2], st[e][3]);
    }
  }
}

template <typename T_>
cudaError_t launch(int device, const void* x, const void* B, const void* C,
                   const void* dt, const void* cum, void* y, void* st, int b,
                   int nc, int L, int nh, int P, int N, Strides5 xs,
                   Strides4 bs, Strides4 cs, Strides4 ds, Strides4 qs,
                   cudaStream_t stream) {
  constexpr size_t smem = SMEM_FLOATS * sizeof(float);
  // The shared-memory limit is a per-device attribute of each instance:
  // set it on the first launch on a device, not on every launch.
  static std::atomic<unsigned long long> ready{0};
  const unsigned long long bit = 1ull << device;
  if (!(ready.load(std::memory_order_acquire) & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_kernel<T_>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    ready.fetch_or(bit, std::memory_order_release);
  }
  const dim3 grid(nh, nc, b);
  ssd_chunk_kernel<T_><<<grid, THREADS, smem, stream>>>(
      static_cast<const T_*>(x), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<const float*>(dt),
      static_cast<const float*>(cum), static_cast<float*>(y),
      static_cast<float*>(st), nc, L, nh, P, N, xs, bs, cs, ds, qs);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes by repro_torch/kernels/_build.py.
// dtype (of x): 0 float32, 1 bfloat16.  Shapes: x (b, nc, L, nh, P); B, C
// (b, nc, L, N); dt, cum (b, nc, L, nh); outputs y (b, nc, L, nh, P) and
// states (b, nc, nh, N, P), both contiguous float32.  Input strides are in
// elements, one per axis.  Takes 1 <= L <= 256, P <= 64 and N <= 128, P
// and N multiples of 4.  ``device`` must be the caller's current device,
// which the Python wrapper makes it.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int repro_ssd_chunk_fwd(
    int device, int dtype, const void* x, const void* B, const void* C,
    const void* dt, const void* cum, void* y, void* states, int b, int nc,
    int L, int nh, int P, int N, long long xsb, long long xsc, long long xsl,
    long long xsh, long long xsp, long long bsb, long long bsc,
    long long bsl, long long bsn, long long csb, long long csc,
    long long csl, long long csn, long long dsb, long long dsc,
    long long dsl, long long dsh, long long qsb, long long qsc,
    long long qsl, long long qsh, void* stream) {
  if (device < 0 || device >= 64 || b <= 0 || nc <= 0 || nh <= 0 || L < 1 ||
      L > MAX_L || P <= 0 || P > PMAX || P % 4 != 0 || N <= 0 || N > NMAX ||
      N % 4 != 0)
    return cudaErrorInvalidValue;
  const Strides5 xs{xsb, xsc, xsl, xsh, xsp};
  const Strides4 bs{bsb, bsc, bsl, bsn}, cs{csb, csc, csl, csn},
      ds{dsb, dsc, dsl, dsh}, qs{qsb, qsc, qsl, qsh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(device, x, B, C, dt, cum, y, states, b, nc, L, nh,
                        P, N, xs, bs, cs, ds, qs, st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(device, x, B, C, dt, cum, y, states, b, nc,
                                L, nh, P, N, xs, bs, cs, ds, qs, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
