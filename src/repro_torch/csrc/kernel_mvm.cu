// Forward distance-tile kernel MVM for Hopper (sm_90a), fp32 on CUDA cores.
//
//   out[i, :] = sum_j kappa(||u_i - w_j||^2) v[j, :]
//
// u (n, d), w (m, d) are lengthscale-pre-scaled inputs, v (m, s); all fp32,
// row-major and contiguous. K is never materialised. This replaces the TPU
// kernel `kernel_mvm_pallas` (src/repro/kernels/tiled.py:98, body
// `_mvm_kernel`); the profiles and their floors are those of
// src/repro/kernels/registry.py.
//
// What bounds it on an H100: operations. A call does 2*n*m*(d+s) flops plus
// n*m profile evaluations on ~(n+m)*(d+s)*4 bytes of input: at the GP path's
// CG shape (n=m=12150, d=26, s=65) that is ~27 Gflop on ~9 MB, so the
// least time is the fp32 CUDA-core rate (67 TFLOP/s), ~0.40 ms, far above
// the memory time (~3 us).
//
// Design, and what it does about that bound:
//  * One block per (row tile of BM rows of u, chunk of SC columns of v). The
//    block walks over every column tile of (w, v) itself and keeps its
//    (BM x SC) accumulator in registers, so the TPU's sequential inner grid
//    axis becomes a loop, with no atomics and no second pass.
//  * u's row tile is staged once in shared memory; each column tile of w
//    (transposed) and v is staged per step; the (BM x BN) profile tile goes
//    through shared memory between the two contractions.
//  * r2 is computed by direct differences sum_k (u_ik - w_jk)^2 in true fp32
//    (no TF32, no expanded uu + ww - 2uw form): coincident points give an
//    exact 0, which avoids the cancellation that costs the expanded form
//    ~1e-3 in the Matérn-1/2 profile.
//  * SC = 16 * TS with TS chosen per call from s (s = 65 -> TS = 5, one
//    chunk of 80), so the profile is evaluated once per pair for s <= 128.
//  * Ragged n, m and s edges are masked in the kernel: out-of-range rows of
//    w and v stage as zeros (a zero row of v contributes nothing), and rows
//    or columns past n or s are never stored.
// Not yet done (later work): wgmma/TMA pipelining, double buffering, and a
// split over m for short n (the prediction shape runs n/BM blocks only).

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;        // rows of u per block
constexpr int BN = 64;        // rows of (w, v) per column tile
constexpr int KS = BN + 16;   // padded row stride of the profile tile
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int TM = BM / 16;   // accumulator rows per thread
constexpr int TB = BN / 16;   // profile-tile columns per thread

constexpr float kSqrt3 = 1.7320508075688772f;
constexpr float kSqrt5 = 2.23606797749979f;
constexpr float kR2Floor = 1e-30f;     // registry _R2_FLOOR
constexpr float kR2FloorM12 = 1e-12f;  // registry _R2_FLOOR_M12

enum Kind { kRbf = 0, kMatern12 = 1, kMatern32 = 2, kMatern52 = 3 };

template <int KIND>
__device__ __forceinline__ float kappa(float r2) {
  if (KIND == kRbf) {
    return expf(-0.5f * r2);
  } else if (KIND == kMatern12) {
    return expf(-sqrtf(fmaxf(r2, kR2FloorM12)));
  } else if (KIND == kMatern32) {
    const float a = kSqrt3 * sqrtf(fmaxf(r2, kR2Floor));
    return (1.0f + a) * expf(-a);
  } else {
    const float r = sqrtf(fmaxf(r2, kR2Floor));
    return (1.0f + kSqrt5 * r + (5.0f / 3.0f) * r2) * expf(-kSqrt5 * r);
  }
}

template <int KIND, int TS>
__global__ void __launch_bounds__(THREADS)
kernel_mvm_fwd(const float* __restrict__ u, const float* __restrict__ w,
               const float* __restrict__ v, float* __restrict__ out,
               int n, int m, int d, int s) {
  constexpr int SC = 16 * TS;
  extern __shared__ float smem[];
  float* us = smem;              // [BM][d]
  float* wt = us + BM * d;       // [d][BN]  (transposed)
  float* vs = wt + d * BN;       // [BN][SC]
  float* ks = vs + BN * SC;      // [BM][KS]

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int row0 = blockIdx.x * BM;
  const int c0 = blockIdx.y * SC;
  const long long ud = static_cast<long long>(n) * d;
  const long long wd = static_cast<long long>(m) * d;

  for (int idx = tid; idx < BM * d; idx += THREADS) {
    const long long g = static_cast<long long>(row0) * d + idx;
    us[idx] = g < ud ? u[g] : 0.0f;
  }

  float acc[TM][TS];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int c = 0; c < TS; ++c) acc[a][c] = 0.0f;

  for (int j0 = 0; j0 < m; j0 += BN) {
    for (int idx = tid; idx < BN * d; idx += THREADS) {
      const long long g = static_cast<long long>(j0) * d + idx;
      const int c = idx / d;
      const int k = idx - c * d;
      wt[k * BN + c] = g < wd ? w[g] : 0.0f;
    }
    for (int idx = tid; idx < BN * SC; idx += THREADS) {
      const int c = idx / SC;
      const int q = idx - c * SC;
      const int jr = j0 + c;
      const int col = c0 + q;
      vs[idx] = (jr < m && col < s)
                    ? v[static_cast<long long>(jr) * s + col] : 0.0f;
    }
    __syncthreads();

    float r2[TM][TB];
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int b = 0; b < TB; ++b) r2[a][b] = 0.0f;
#pragma unroll 2
    for (int k = 0; k < d; ++k) {
      float ua[TM], wb[TB];
#pragma unroll
      for (int a = 0; a < TM; ++a) ua[a] = us[(ty + 16 * a) * d + k];
#pragma unroll
      for (int b = 0; b < TB; ++b) wb[b] = wt[k * BN + tx + 16 * b];
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int b = 0; b < TB; ++b) {
          const float df = ua[a] - wb[b];
          r2[a][b] = fmaf(df, df, r2[a][b]);
        }
    }
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int b = 0; b < TB; ++b)
        ks[(ty + 16 * a) * KS + tx + 16 * b] = kappa<KIND>(r2[a][b]);
    __syncthreads();

#pragma unroll 8
    for (int j = 0; j < BN; ++j) {
      float ka[TM], vb[TS];
#pragma unroll
      for (int a = 0; a < TM; ++a) ka[a] = ks[(ty + 16 * a) * KS + j];
#pragma unroll
      for (int c = 0; c < TS; ++c) vb[c] = vs[j * SC + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int c = 0; c < TS; ++c) acc[a][c] = fmaf(ka[a], vb[c], acc[a][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < TM; ++a) {
    const int row = row0 + ty + 16 * a;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < TS; ++c) {
      const int col = c0 + tx + 16 * c;
      if (col < s) out[static_cast<long long>(row) * s + col] = acc[a][c];
    }
  }
}

template <int KIND, int TS>
cudaError_t launch(const float* u, const float* w, const float* v, float* out,
                   int n, int m, int d, int s, cudaStream_t stream) {
  constexpr int SC = 16 * TS;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(BM) * d + static_cast<size_t>(d) * BN +
                       BN * SC + BM * KS);
  auto kern = kernel_mvm_fwd<KIND, TS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BM - 1) / BM, (s + SC - 1) / SC);
  kern<<<grid, THREADS, smem, stream>>>(u, w, v, out, n, m, d, s);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t launch_kind(const float* u, const float* w, const float* v,
                        float* out, int n, int m, int d, int s,
                        cudaStream_t stream) {
  const int ts = s > 16 * 8 ? 8 : (s + 15) / 16;
  switch (ts) {
    case 1: return launch<KIND, 1>(u, w, v, out, n, m, d, s, stream);
    case 2: return launch<KIND, 2>(u, w, v, out, n, m, d, s, stream);
    case 3: return launch<KIND, 3>(u, w, v, out, n, m, d, s, stream);
    case 4: return launch<KIND, 4>(u, w, v, out, n, m, d, s, stream);
    case 5: return launch<KIND, 5>(u, w, v, out, n, m, d, s, stream);
    case 6: return launch<KIND, 6>(u, w, v, out, n, m, d, s, stream);
    case 7: return launch<KIND, 7>(u, w, v, out, n, m, d, s, stream);
    default: return launch<KIND, 8>(u, w, v, out, n, m, d, s, stream);
  }
}

}  // namespace

// Plain C interface (bound with ctypes). Returns 0 or a cudaError_t code;
// -1 for an unknown kind, -2 for shapes the kernel does not take.
extern "C" int repro_kernel_mvm_fwd(const float* u, const float* w,
                                    const float* v, float* out, int n, int m,
                                    int d, int s, int kind, void* stream) {
  if (n <= 0 || m < 0 || d <= 0 || s <= 0) return -2;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kRbf: return launch_kind<kRbf>(u, w, v, out, n, m, d, s, st);
    case kMatern12: return launch_kind<kMatern12>(u, w, v, out, n, m, d, s, st);
    case kMatern32: return launch_kind<kMatern32>(u, w, v, out, n, m, d, s, st);
    case kMatern52: return launch_kind<kMatern52>(u, w, v, out, n, m, d, s, st);
    default: return -1;
  }
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
