// Backward distance-tile kernel for Hopper (sm_90a), fp32 on CUDA cores.
//
//   du[i, :] = 2 * sum_j D_ij (u_i - w_j),   D = (g v^T) .* dkappa/dr2(r2)
//
// with r2_ij = ||u_i - w_j||^2, for u (n, d), w (m, d), g (n, s), v (m, s);
// all fp32, row-major and contiguous. This is the cotangent of u for
// out = kappa(u, w) @ v with output cotangent g; called with (u, w) and
// (g, v) swapped it gives the cotangent of w. It replaces the TPU kernel
// `kernel_mvm_bwd_pallas` (src/repro/kernels/tiled.py:131, body
// `_mvm_bwd_kernel`); the slopes and their floors are those of
// src/repro/kernels/registry.py.
//
// What bounds it on an H100: operations. One call does 2*n*m*d for r2,
// 2*n*m*s for g v^T, 2*n*m*d for the contraction with the differences, and
// 3*n*m for the slope, the product and the row sum. At the CG shape
// (n = m = 12150, d = 26, s = 65) that is 7,676,370,000 + 19,190,925,000 +
// 7,676,370,000 + 442,867,500 = 34,986,532,500 operations, 0.522 ms at the
// fp32 CUDA-core peak of 67 TFLOP/s; its ~10 MB of inputs and outputs take
// ~3 us at 3.35 TB/s.
//
// Design, and what it does about that bound:
//  * One block per row tile of BM = 64 rows of u. The block walks every
//    column tile of (w, v) itself and keeps its (64 x d) du accumulator in
//    registers, so the TPU's sequential column axis becomes a loop: no
//    atomics, no second pass, deterministic.
//  * u and g are staged once in shared memory; w and v are staged per
//    column tile. Row strides are padded to odd widths, so both the
//    row-broadcast and the column-sweep reads are free of bank conflicts.
//  * Per column tile each thread computes a 4 x 4 patch of r2 (direct
//    differences) and of g v^T in registers, forms D, and writes it to a
//    shared (64 x 64) tile; the second contraction then reads D from there.
//  * r2 is computed by direct differences in true fp32: coincident points
//    give exactly 0, so the Matérn-1/2 slope is exactly 0 there (the
//    registry's clamped region), and the sum is taken in difference form,
//    sum_j D_ij (u_ik - w_jk), so a large D_ij at a near-coincident pair
//    multiplies a small difference instead of cancelling two large terms.
//  * Ragged n, m, s and d are masked in the kernel: out-of-range rows of w
//    and v stage as zeros (D is then 0), rows past n and columns past d are
//    never stored. d <= 16 * KQ_MAX.
// Not yet done (later work): wgmma/TMA for the two contractions, double
// buffering, and a split over m to fill all SMs (190 blocks on 132 SMs at
// the CG shape).

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;        // rows of u per block
constexpr int BN = 64;        // rows of (w, v) per column tile
constexpr int KS = BN + 16;   // row stride of the D tile
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int TM = BM / 16;   // D-tile rows per thread
constexpr int TB = BN / 16;   // D-tile columns per thread
constexpr int KQ_MAX = 6;     // du columns per thread: d <= 96

constexpr float kSqrt3 = 1.7320508075688772f;
constexpr float kSqrt5 = 2.23606797749979f;
constexpr float kR2Floor = 1e-30f;     // registry _R2_FLOOR
constexpr float kR2FloorM12 = 1e-12f;  // registry _R2_FLOOR_M12

enum Kind { kRbf = 0, kMatern12 = 1, kMatern32 = 2, kMatern52 = 3 };

template <int KIND>
__device__ __forceinline__ float dkappa(float r2) {
  if (KIND == kRbf) {
    return -0.5f * expf(-0.5f * r2);
  } else if (KIND == kMatern12) {
    const float r = sqrtf(fmaxf(r2, kR2FloorM12));
    return r2 > kR2FloorM12 ? -expf(-r) / (2.0f * r) : 0.0f;
  } else if (KIND == kMatern32) {
    return -1.5f * expf(-kSqrt3 * sqrtf(fmaxf(r2, kR2Floor)));
  } else {
    const float r = sqrtf(fmaxf(r2, kR2Floor));
    return -(5.0f / 6.0f) * (1.0f + kSqrt5 * r) * expf(-kSqrt5 * r);
  }
}

__host__ __device__ constexpr int odd(int x) { return x | 1; }

__host__ __device__ inline size_t smem_floats(int d, int s) {
  return static_cast<size_t>(BM + BN) * (odd(d) + odd(s)) +
         static_cast<size_t>(BM) * KS;
}

// Stage rows [r0, r0 + rows) of a (total x width) row-major matrix into a
// (rows x stride) shared tile, zero past `total`.
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      int r0, int rows, int total, int width,
                                      int stride) {
  for (int idx = threadIdx.x; idx < rows * width; idx += THREADS) {
    const int r = idx / width;
    const int c = idx - r * width;
    dst[r * stride + c] =
        r0 + r < total ? src[static_cast<long long>(r0 + r) * width + c] : 0.0f;
  }
}

template <int KIND, int KQ>
__global__ void __launch_bounds__(THREADS)
kernel_mvm_bwd(const float* __restrict__ u, const float* __restrict__ w,
               const float* __restrict__ g, const float* __restrict__ v,
               float* __restrict__ du, int n, int m, int d, int s) {
  const int dp = odd(d);
  const int sp = odd(s);
  extern __shared__ float smem[];
  float* us = smem;             // [BM][dp]
  float* gs = us + BM * dp;     // [BM][sp]
  float* ws = gs + BM * sp;     // [BN][dp]
  float* vs = ws + BN * dp;     // [BN][sp]
  float* ds = vs + BN * sp;     // [BM][KS]

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int row0 = blockIdx.x * BM;

  stage(us, u, row0, BM, n, d, dp);
  stage(gs, g, row0, BM, n, s, sp);
  __syncthreads();

  // This thread's du entries: rows ty + 16a, columns tx + 16q (< d).
  float ur[TM][KQ], acc[TM][KQ];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int q = 0; q < KQ; ++q) {
      const int k = min(tx + 16 * q, d - 1);
      ur[a][q] = us[(ty + 16 * a) * dp + k];
      acc[a][q] = 0.0f;
    }

  for (int j0 = 0; j0 < m; j0 += BN) {
    stage(ws, w, j0, BN, m, d, dp);
    stage(vs, v, j0, BN, m, s, sp);
    __syncthreads();

    float r2[TM][TB], e[TM][TB];
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int b = 0; b < TB; ++b) {
        r2[a][b] = 0.0f;
        e[a][b] = 0.0f;
      }
#pragma unroll 2
    for (int k = 0; k < d; ++k) {
      float ua[TM], wb[TB];
#pragma unroll
      for (int a = 0; a < TM; ++a) ua[a] = us[(ty + 16 * a) * dp + k];
#pragma unroll
      for (int b = 0; b < TB; ++b) wb[b] = ws[(tx + 16 * b) * dp + k];
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int b = 0; b < TB; ++b) {
          const float df = ua[a] - wb[b];
          r2[a][b] = fmaf(df, df, r2[a][b]);
        }
    }
#pragma unroll 4
    for (int c = 0; c < s; ++c) {
      float ga[TM], vb[TB];
#pragma unroll
      for (int a = 0; a < TM; ++a) ga[a] = gs[(ty + 16 * a) * sp + c];
#pragma unroll
      for (int b = 0; b < TB; ++b) vb[b] = vs[(tx + 16 * b) * sp + c];
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int b = 0; b < TB; ++b) e[a][b] = fmaf(ga[a], vb[b], e[a][b]);
    }
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int b = 0; b < TB; ++b)
        ds[(ty + 16 * a) * KS + tx + 16 * b] = e[a][b] * dkappa<KIND>(r2[a][b]);
    __syncthreads();

#pragma unroll 8
    for (int j = 0; j < BN; ++j) {
      float da[TM], wk[KQ];
#pragma unroll
      for (int a = 0; a < TM; ++a) da[a] = ds[(ty + 16 * a) * KS + j];
#pragma unroll
      for (int q = 0; q < KQ; ++q) wk[q] = ws[j * dp + min(tx + 16 * q, d - 1)];
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int q = 0; q < KQ; ++q)
          acc[a][q] = fmaf(da[a], ur[a][q] - wk[q], acc[a][q]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < TM; ++a) {
    const int row = row0 + ty + 16 * a;
    if (row >= n) continue;
#pragma unroll
    for (int q = 0; q < KQ; ++q) {
      const int k = tx + 16 * q;
      if (k < d) du[static_cast<long long>(row) * d + k] = 2.0f * acc[a][q];
    }
  }
}

template <int KIND, int KQ>
cudaError_t launch(const float* u, const float* w, const float* g,
                   const float* v, float* du, int n, int m, int d, int s,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(d, s);
  auto kern = kernel_mvm_bwd<KIND, KQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BM - 1) / BM);
  kern<<<grid, THREADS, smem, stream>>>(u, w, g, v, du, n, m, d, s);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t launch_kind(const float* u, const float* w, const float* g,
                        const float* v, float* du, int n, int m, int d, int s,
                        cudaStream_t stream) {
  switch ((d + 15) / 16) {
    case 1: return launch<KIND, 1>(u, w, g, v, du, n, m, d, s, stream);
    case 2: return launch<KIND, 2>(u, w, g, v, du, n, m, d, s, stream);
    case 3: return launch<KIND, 3>(u, w, g, v, du, n, m, d, s, stream);
    case 4: return launch<KIND, 4>(u, w, g, v, du, n, m, d, s, stream);
    case 5: return launch<KIND, 5>(u, w, g, v, du, n, m, d, s, stream);
    default: return launch<KIND, KQ_MAX>(u, w, g, v, du, n, m, d, s, stream);
  }
}

}  // namespace

// Plain C interface (bound with ctypes). Returns 0 or a cudaError_t code;
// -1 for an unknown kind, -2 for shapes the kernel does not take.
extern "C" int repro_kernel_mvm_bwd(const float* u, const float* w,
                                    const float* g, const float* v, float* du,
                                    int n, int m, int d, int s, int kind,
                                    void* stream) {
  if (n <= 0 || m < 0 || d <= 0 || d > 16 * KQ_MAX || s <= 0) return -2;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kRbf: return launch_kind<kRbf>(u, w, g, v, du, n, m, d, s, st);
    case kMatern12: return launch_kind<kMatern12>(u, w, g, v, du, n, m, d, s, st);
    case kMatern32: return launch_kind<kMatern32>(u, w, g, v, du, n, m, d, s, st);
    case kMatern52: return launch_kind<kMatern52>(u, w, g, v, du, n, m, d, s, st);
    default: return -1;
  }
}
