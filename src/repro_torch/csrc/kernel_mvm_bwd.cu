// Backward distance-tile kernel for Hopper (sm_90a).
//
//   du[i, :] = 2 * sum_j D_ij (u_i - w_j),   D = (g v^T) .* dkappa/dr2(r2)
//
// with r2_ij = ||u_i - w_j||^2, for u (n, d), w (m, d), g (n, s), v (m, s);
// all fp32, row-major and contiguous. This is the cotangent of u for
// out = kappa(u, w) @ v with output cotangent g; called with (u, w) and
// (g, v) swapped it gives the cotangent of w, and called with
// (u, u, [g | v], [v | g]) it gives du + dw of kappa(u, u) @ v in one
// sweep (the GP case; kernels/tiled.py::kernel_mvm_bwd_fused_cuda). It
// replaces the TPU kernel `kernel_mvm_bwd_pallas`
// (src/repro/kernels/tiled.py:131, body `_mvm_bwd_kernel`); the slopes and
// their floors are those of src/repro/kernels/registry.py.
//
// What bounds it on an H100, as the design splits the work between units.
// Per pair (i, j): r2 (2d operations), the slope and the product with the
// Gram (~3) and the contraction with the differences (2d) on the fp32 CUDA
// cores (67 TFLOP/s), and the Gram g_i . v_j (2s flops, three times for the
// 3xTF32 split) on the TF32 tensor cores (495 TFLOP/s dense). At the fused
// CG shape (n = m = 12150, d = 26, s' = 2 * 65 = 130) that is
// 4nmd + 3nm = 15.80 GFLOP, 0.2358 ms, on the CUDA cores against
// 3 * 2nms' = 115.1 GFLOP, 0.2326 ms, on the tensor cores; the 8.9 MB that
// the function must move (u, g and v read once, du written once) take
// 2.6 us at 3.35 TB/s. All in fp32 on the CUDA cores (the earlier design)
// the same call is 0.809 ms. On the card the kernel's time is close to the
// sum of its parts rather than the larger (tools/torch_kernel_ablation.py
// times variants with one part cut, PERF.md): the Gram's mma.sync
// products, r2 and the contraction each take a comparable share, and
// running half the warps in the other order (r2 first, then the Gram)
// gained nothing.
//
// Design, and what it does about that:
//  * Split over the column range. A block is (row tile of BM = 128 rows of
//    u and g, column split z); it walks only the column tiles (BN = 64 rows
//    of w and v) of its split, [z * T / splits, (z+1) * T / splits) of T
//    tiles. The wrapper plans `splits` from the shapes and the SM count
//    (kernels/tiled.py::bwd_split_plan): 4 at the CG shape, where 95 row
//    tiles alone would leave 37 SMs idle. With splits > 1 each block writes
//    its partial du to a (splits, n, d) workspace and a second kernel here
//    adds the partials in split order 0, 1, 2, ...: no atomics, so two
//    launches give bitwise equal outputs. With one split the blocks write
//    du and no second pass runs.
//  * The Gram g v^T on the tensor cores in 3xTF32 with mma.sync.m16n8k8.
//    Each of the 8 warps owns 32 rows x 32 columns of the block's
//    (128 x 64) tile. A is the g row tile and B the v column tile, both
//    read straight from their row-major rows in shared memory (B as the
//    .col operand) with one 8-byte load per fragment pair: within a k-step
//    the physical columns 2t, 2t + 1 stand for the logical k = t, t + 4 of
//    both operands, a permutation of the summed index that leaves the Gram
//    unchanged. Both operands are split as x = big + small, big =
//    cvt.rna.tf32(x), small = cvt.rna.tf32(x - big), and small*big +
//    big*small + big*big is summed: one TF32 product misses the 2e-5
//    tolerance by ~9x (tests/test_torch_bwd_split.py). Each
//    tile's Gram is summed from 0 over the whole of s; it is not carried
//    across tiles, so the tensor cores' fp32 accumulation, which does not
//    round to nearest, never holds a long sum.
//  * r2 and the slope for exactly the (row, column) pairs that a thread's C
//    fragments hold (rows g + 8q, columns 2t + e + 8nt for lane = 4g + t),
//    so D = C .* slope stays in registers. r2 is taken by direct
//    differences in fp32 (no expanded uu + ww - 2uw form): coincident
//    points give an exact 0, so the Matérn-1/2 slope is exactly 0 there
//    (the registry's clamped region). The slopes run on the special-function
//    units (x * rsqrt(x), exp2) within a few ulps.
//  * The contraction sum_j D_ij (u_ik - w_jk) on the CUDA cores, in
//    difference form: a large D_ij at a near-coincident Matérn-1/2 pair
//    multiplies a small difference instead of cancelling two large terms
//    (rowsum * u - D @ w). Rows of u and w sit in shared memory with a
//    padded stride dp (d rounded up to 4, dp = 4 mod 8) and are read as
//    float4 without bank conflicts: 12 loads feed 32 pairs x 4 coordinates
//    (256 FP32 instructions), where the earlier kernel issued 6 scalar
//    loads per 16. Per 4 coordinates a thread sums its 8 columns, then the
//    four lanes of a quad (same rows, other columns) reduce-scatter their
//    sums with two shuffle steps in a fixed order, so that lane t keeps
//    coordinate 4c + t of its 4 rows; those partial sums stay in registers
//    over the whole column walk (4 * 4KQ of them, KQ = ceil(d / 16)). The
//    two warps that share a row range add their sums in a fixed order at
//    the end.
//  * Copies overlap compute: the next (w, v) column tile is staged with
//    cp.async into the second of two buffers while the current one is
//    computed. A row is copied 16 bytes at a time where its width is a
//    multiple of 4 floats (the fused wrapper pads s' to a multiple of 8),
//    else 4 bytes at a time (w at d = 26). Where two buffers do not fit in
//    227 KB (d = 96 with s' = 136) one is used and the copy follows the
//    compute. u and g are staged once per block.
//  * The range. The per-thread sums above cover d <= 96 (KQ <= 6 groups of
//    16 coordinates). For d > 96 a second kernel (kernel_mvm_bwd_wide)
//    gives each block 96 coordinates of du (a third grid dimension) and
//    streams u and w through shared memory 96 coordinates at a time, so
//    every block sums r2 over all of d: ceil(d / 96) times the r2 work,
//    for a range no paper dataset reaches. s is bounded by the row tiles
//    of g and v in shared memory (s <= 264 at d = 26, 200 at d >= 96);
//    the wrapper splits wider (g, v) over launches and adds the du's
//    (kernels/tiled.py::bwd_s_chunks), exact since D is a sum over s.
//  * Ragged n, m, s and d are masked in the kernel: rows of w and v past m
//    stage as zeros (their Gram and D are 0), rows of u and g past n stage
//    as zeros and are never stored, coordinates past d and columns past s
//    are zero in both operands.
//  * Lanes. B independent systems (u, w, g, v stacked on a leading axis, as
//    `vmap` of the TPU kernel adds a grid axis) take one launch: the lane
//    is folded into the grid's y axis as blockIdx.y = lane * splits + z,
//    each block offsets its operands by its lane in 64 bits, and the
//    workspace is (splits, B, n, d). The fused call of B lanes is one
//    launch on [g_l | v_l], [v_l | g_l]; the wrapper's column chunks split
//    columns, never lanes. With B = 1 the launch is the single-system one.
// Not done here (later work): a wgmma/TMA warp-specialised pipeline, and
// operands pre-split in device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROW_WARPS = 4;             // warps along the rows of a block
constexpr int BM = 32 * ROW_WARPS;       // rows of u and g per block
constexpr int BN = 64;                   // rows of (w, v) per column tile
constexpr int THREADS = 64 * ROW_WARPS;  // warps: (row part, column half)
constexpr int KQ_MAX = 6;                // 16-coordinate groups: d <= 96
constexpr int DC = 16 * KQ_MAX;          // coordinates per chunk, d > 96

constexpr float kSqrt3 = 1.7320508075688772f;
constexpr float kSqrt5 = 2.23606797749979f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kR2Floor = 1e-30f;     // registry _R2_FLOOR
constexpr float kR2FloorM12 = 1e-12f;  // registry _R2_FLOOR_M12

enum Kind { kRbf = 0, kMatern12 = 1, kMatern32 = 2, kMatern52 = 3 };

__device__ __forceinline__ float exp_neg(float y) {
  return exp2f(-kLog2e * y);
}

// The registry slopes dkappa/dr2 on the special-function units.
template <int KIND>
__device__ __forceinline__ float dkappa(float r2) {
  if (KIND == kRbf) {
    return -0.5f * exp_neg(0.5f * r2);
  } else if (KIND == kMatern12) {
    // -exp(-r) / (2r), exactly 0 on the clamped region r2 <= floor.
    const float x = fmaxf(r2, kR2FloorM12);
    const float inv = rsqrtf(x);
    return r2 > kR2FloorM12 ? -0.5f * exp_neg(x * inv) * inv : 0.0f;
  } else if (KIND == kMatern32) {
    const float x = fmaxf(r2, kR2Floor);
    return -1.5f * exp_neg(kSqrt3 * (x * rsqrtf(x)));
  } else {
    const float x = fmaxf(r2, kR2Floor);
    const float r = x * rsqrtf(x);
    return -(5.0f / 6.0f) * (1.0f + kSqrt5 * r) * exp_neg(kSqrt5 * r);
  }
}

// Row stride of u and w in shared memory: d rounded up to 4 (float4 reads),
// and 4 mod 8 so that the rows read by a quarter warp hit distinct banks.
__host__ __device__ __forceinline__ int padded_d(int d) {
  const int dp = (d + 3) & ~3;
  return (dp & 7) ? dp : dp + 4;
}

// Row stride of g and v in shared memory: s rounded up to 8 (one mma
// k-step), and 8 or 24 mod 32 so that the 8-byte fragment reads of a half
// warp (rows g < 4, columns 2t) hit distinct banks.
__host__ __device__ __forceinline__ int padded_s(int s) {
  return 8 * (((s + 7) / 8) | 1);
}

// Dynamic shared memory: g's and u's row tiles and `stages` (w, v)
// column-tile buffers.
__host__ __device__ __forceinline__ size_t smem_bytes(int d, int s,
                                                      int stages) {
  const size_t dp = padded_d(d), sp = padded_s(s);
  return sizeof(float) * (BM * (sp + dp) + stages * BN * (dp + sp));
}

constexpr size_t kMaxSmem = 232448;  // dynamic shared memory of one block

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both TF32 (the low 13 bits of each word are zero).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Asynchronous copy global -> shared of VEC floats (1 or 4); a copy that is
// not `ok` zero-fills.
template <int VEC>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool ok) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (VEC == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
                 "l"(src), "r"(ok ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr),
                 "l"(src), "r"(ok ? 4 : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy `rows` rows of `width` floats (global row stride `width`) into BN
// rows of shared memory (row stride `dst_stride`), VEC floats per copy
// (width % VEC == 0); the rows past `rows` are zero-filled. Element
// e = tid + THREADS * i lies in row j, unit k, tracked without a division.
template <int VEC>
__device__ __forceinline__ void copy_rows(float* dst, int dst_stride,
                                          const float* __restrict__ src,
                                          int width, int rows) {
  const int units = width / VEC;
  const int count = rows * units;
  const int dj = THREADS / units, dk = THREADS % units;
  int j = threadIdx.x / units, k = threadIdx.x % units;
  for (int e = threadIdx.x; e < BN * units; e += THREADS) {
    const bool ok = e < count;
    cp_async<VEC>(dst + j * dst_stride + k * VEC,
                  ok ? src + static_cast<long long>(j) * width + k * VEC : src,
                  ok);
    k += dk;
    j += dj;
    if (k >= units) {
      k -= units;
      ++j;
    }
  }
}

// Copy coordinates [0, width) of `rows` rows (global row stride
// `src_stride`) into ROWS rows of DC floats in shared memory (row stride
// `dst_stride`), 4 bytes at a time; coordinates [width, DC) and the rows
// past `rows` are zero-filled.
template <int ROWS>
__device__ __forceinline__ void copy_chunk(float* dst, int dst_stride,
                                           const float* __restrict__ src,
                                           int src_stride, int width,
                                           int rows) {
  for (int e = threadIdx.x; e < ROWS * DC; e += THREADS) {
    const int j = e / DC, k = e - (e / DC) * DC;
    const bool ok = j < rows && k < width;
    cp_async<1>(dst + j * dst_stride + k,
                ok ? src + static_cast<long long>(j) * src_stride + k : src,
                ok);
  }
}

// C = g v^T for this warp's 32 x 32 part of the tile, summed from 0 over
// all of s (ksteps k-steps of 8): 2 m16 x 4 n8 tiles, 3 products each.
// arow points at row g, column 2t of the warp's g rows; brow at row g,
// column 2t of its v rows. C fragment c[mt][nt]: rows g + 16mt (+8 for
// c[2], c[3]), columns 8nt + 2t (+1 for c[1], c[3]).
__device__ __forceinline__ void tile_gram(float (&c)[2][4][4],
                                          const float* arow,
                                          const float* brow, int sp,
                                          int ksteps) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int x = 0; x < 4; ++x) c[mt][nt][x] = 0.0f;
#pragma unroll 1
  for (int kk = 0; kk < ksteps; ++kk) {
    const int k = kk * 8;
    uint32_t abig[2][4], asmall[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float2 lo = *reinterpret_cast<const float2*>(arow + 16 * mt * sp + k);
      const float2 hi =
          *reinterpret_cast<const float2*>(arow + (16 * mt + 8) * sp + k);
      split_tf32(lo.x, abig[mt][0], asmall[mt][0]);  // (g,     t)
      split_tf32(hi.x, abig[mt][1], asmall[mt][1]);  // (g + 8, t)
      split_tf32(lo.y, abig[mt][2], asmall[mt][2]);  // (g,     t + 4)
      split_tf32(hi.y, abig[mt][3], asmall[mt][3]);  // (g + 8, t + 4)
    }
    uint32_t bbig[4][2], bsmall[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float2 b = *reinterpret_cast<const float2*>(brow + 8 * nt * sp + k);
      split_tf32(b.x, bbig[nt][0], bsmall[nt][0]);  // (k = t,     n = g)
      split_tf32(b.y, bbig[nt][1], bsmall[nt][1]);  // (k = t + 4, n = g)
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_tf32(c[mt][nt], asmall[mt], bbig[nt]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_tf32(c[mt][nt], abig[mt], bsmall[nt]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_tf32(c[mt][nt], abig[mt], bbig[nt]);
  }
}

// r2[q][b] += sum over dk coordinates of (u - w)^2 for the thread's pairs:
// rows g + 8q (q = 2mt + h), columns 2t + e + 8nt (b = 2nt + e). urow points
// at row g of the warp's u rows, wrow at row 2t of its w rows.
__device__ __forceinline__ void tile_r2(float (&r2)[4][8], const float* urow,
                                        const float* wrow, int dp, int dk) {
#pragma unroll 1
  for (int k = 0; k < dk; k += 4) {
    float4 ua[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      ua[q] = *reinterpret_cast<const float4*>(urow + 8 * q * dp + k);
#pragma unroll
    for (int b = 0; b < 8; ++b) {  // column 2t + (b & 1) + 8 (b >> 1)
      const float4 wb = *reinterpret_cast<const float4*>(
          wrow + ((b & 1) + 8 * (b >> 1)) * dp + k);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float df = ua[q].x - wb.x;
        float r = fmaf(df, df, r2[q][b]);
        df = ua[q].y - wb.y;
        r = fmaf(df, df, r);
        df = ua[q].z - wb.z;
        r = fmaf(df, df, r);
        df = ua[q].w - wb.w;
        r2[q][b] = fmaf(df, df, r);
      }
    }
  }
}

// D = C .* dkappa(r2) for the thread's pairs (the layout of tile_r2).
template <int KIND>
__device__ __forceinline__ void apply_slope(float (&c)[2][4][4],
                                            const float (&r2)[4][8]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int b = 0; b < 8; ++b)
      c[q >> 1][b >> 1][2 * (q & 1) + (b & 1)] *= dkappa<KIND>(r2[q][b]);
}

// D = C .* dkappa(r2), r2 by direct differences over dk coordinates.
template <int KIND>
__device__ __forceinline__ void tile_slope(float (&c)[2][4][4],
                                           const float* urow,
                                           const float* wrow, int dp,
                                           int dk) {
  float r2[4][8];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int b = 0; b < 8; ++b) r2[q][b] = 0.0f;
  tile_r2(r2, urow, wrow, dp, dk);
  apply_slope<KIND>(c, r2);
}

// acc[c4][q] += sum over the tile's columns j of D_ij (u_ik - w_jk) for
// row g + 8q and coordinate k = 4 c4 + t: per 4 coordinates the thread sums
// its 8 columns, then the quad's 4 lanes reduce-scatter in a fixed order
// (lanes t ^ 1, then t ^ 2), so lane t keeps coordinate 4 c4 + t.
template <int NC>
__device__ __forceinline__ void tile_contract(float (&acc)[NC][4],
                                              const float (&c)[2][4][4],
                                              const float* urow,
                                              const float* wrow, int dp,
                                              int dk, int t) {
  const bool b0 = t & 1, b1 = t & 2;
#pragma unroll
  for (int c4 = 0; c4 < NC; ++c4) {
    if (4 * c4 >= dk) break;  // uniform across the warp
    const int k = 4 * c4;
    float4 ua[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      ua[q] = *reinterpret_cast<const float4*>(urow + 8 * q * dp + k);
    float p[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int x = 0; x < 4; ++x) p[q][x] = 0.0f;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const float4 wb = *reinterpret_cast<const float4*>(
          wrow + ((b & 1) + 8 * (b >> 1)) * dp + k);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float dij = c[q >> 1][b >> 1][2 * (q & 1) + (b & 1)];
        p[q][0] = fmaf(dij, ua[q].x - wb.x, p[q][0]);
        p[q][1] = fmaf(dij, ua[q].y - wb.y, p[q][1]);
        p[q][2] = fmaf(dij, ua[q].z - wb.z, p[q][2]);
        p[q][3] = fmaf(dij, ua[q].w - wb.w, p[q][3]);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      // Lane t ^ 1 holds the same rows' other columns: keep coordinates
      // (t & 1) and 2 + (t & 1), send the other two.
      float k0 = b0 ? p[q][1] : p[q][0];
      float k1 = b0 ? p[q][3] : p[q][2];
      k0 += __shfl_xor_sync(0xffffffffu, b0 ? p[q][0] : p[q][1], 1);
      k1 += __shfl_xor_sync(0xffffffffu, b0 ? p[q][2] : p[q][3], 1);
      // Then lane t ^ 2: keep coordinate t.
      float kt = b1 ? k1 : k0;
      kt += __shfl_xor_sync(0xffffffffu, b1 ? k0 : k1, 2);
      acc[c4][q] += kt;
    }
  }
}

// Blocks of THREADS threads: warp (rh, jh) owns rows 32 rh .. 32 rh + 31 of
// the block's BM rows and columns 32 jh .. 32 jh + 31 of each column tile.
// With `stages` = 2 the next column tile is copied while this one is
// computed; with 1 (when two buffers do not fit) it is copied after.
template <int KIND, int KQ>
__global__ void __launch_bounds__(THREADS, 1)
kernel_mvm_bwd(const float* __restrict__ u, const float* __restrict__ w,
               const float* __restrict__ g, const float* __restrict__ v,
               float* __restrict__ du, float* __restrict__ workspace, int n,
               int m, int d, int s, int splits, int lanes, int stages,
               int vec_w, int vec_v) {
  constexpr int NC = 4 * KQ;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int tl = tid & 31, warp = tid >> 5;
  const int gq = tl >> 2, t = tl & 3;
  const int rh = warp % ROW_WARPS, jh = warp / ROW_WARPS;
  const int row0 = blockIdx.x * BM;
  const int lane = blockIdx.y / splits;
  const int z = blockIdx.y - lane * splits;
  u += static_cast<long long>(lane) * n * d;
  w += static_cast<long long>(lane) * m * d;
  g += static_cast<long long>(lane) * n * s;
  v += static_cast<long long>(lane) * m * s;
  du += static_cast<long long>(lane) * n * d;
  const int dp = padded_d(d), sp = padded_s(s);
  const int dk = (d + 3) & ~3;
  const int stage_len = BN * (dp + sp);
  float* gs = smem;            // [BM][sp]
  float* us = gs + BM * sp;    // [BM][dp]
  float* buf0 = us + BM * dp;  // `stages` buffers: [BN][dp] of w, [BN][sp] of v
  const int tiles = (m + BN - 1) / BN;
  const int t_lo = static_cast<int>(static_cast<long long>(z) * tiles / splits);
  const int t_hi =
      static_cast<int>(static_cast<long long>(z + 1) * tiles / splits);

  auto load = [&](float* buf, int jt) {
    const int j0 = jt * BN;
    const int rows = m - j0 < BN ? m - j0 : BN;
    const float* wsrc = w + static_cast<long long>(j0) * d;
    const float* vsrc = v + static_cast<long long>(j0) * s;
    if (vec_w) copy_rows<4>(buf, dp, wsrc, d, rows);
    else copy_rows<1>(buf, dp, wsrc, d, rows);
    if (vec_v) copy_rows<4>(buf + BN * dp, sp, vsrc, s, rows);
    else copy_rows<1>(buf + BN * dp, sp, vsrc, s, rows);
  };

  if (t_lo < t_hi) load(buf0, t_lo);
  cp_async_commit();
  for (int idx = tid; idx < BM * sp; idx += THREADS) {
    const int r = idx / sp;
    const int k = idx - r * sp;
    gs[idx] = (row0 + r < n && k < s)
                  ? g[static_cast<long long>(row0 + r) * s + k] : 0.0f;
  }
  for (int idx = tid; idx < BM * dp; idx += THREADS) {
    const int r = idx / dp;
    const int k = idx - r * dp;
    us[idx] = (row0 + r < n && k < d)
                  ? u[static_cast<long long>(row0 + r) * d + k] : 0.0f;
  }
  // Coordinates d..dp-1 of w and columns s..sp-1 of v stay zero in every
  // buffer (the copies write only the others).
  for (int r = tid; r < stages * BN; r += THREADS) {
    float* wr = buf0 + (r / BN) * stage_len + (r % BN) * dp;
    float* vr = buf0 + (r / BN) * stage_len + BN * dp + (r % BN) * sp;
    for (int k = d; k < dp; ++k) wr[k] = 0.0f;
    for (int k = s; k < sp; ++k) vr[k] = 0.0f;
  }

  const float* arow = gs + (rh * 32 + gq) * sp + 2 * t;
  const float* urow = us + (rh * 32 + gq) * dp;
  const int wofs = (jh * 32 + 2 * t) * dp;
  const int vofs = BN * dp + (jh * 32 + gq) * sp + 2 * t;
  float acc[NC][4];
#pragma unroll
  for (int c4 = 0; c4 < NC; ++c4)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[c4][q] = 0.0f;
  float c[2][4][4];
  for (int jt = t_lo; jt < t_hi; ++jt) {
    cp_async_wait_all();
    __syncthreads();  // tile jt has landed; every warp is done with jt - 1
    float* cur = buf0 + ((jt - t_lo) % stages) * stage_len;
    if (stages == 2 && jt + 1 < t_hi) {
      load(cur == buf0 ? buf0 + stage_len : buf0, jt + 1);
    }
    cp_async_commit();
    tile_gram(c, arow, cur + vofs, sp, sp / 8);
    tile_slope<KIND>(c, urow, cur + wofs, dp, dk);
    tile_contract<NC>(acc, c, urow, cur + wofs, dp, dk, t);
    if (stages == 1 && jt + 1 < t_hi) {
      __syncthreads();  // every warp is done with the only buffer
      load(buf0, jt + 1);
      cp_async_commit();
    }
  }
  cp_async_wait_all();
  __syncthreads();  // every warp is done with us

  // Each row's sum is the two column halves' (jh = 0, then jh = 1): the
  // jh = 1 warps leave theirs in us, the jh = 0 warps add and store.
  if (jh == 1) {
#pragma unroll
    for (int c4 = 0; c4 < NC; ++c4) {
      if (4 * c4 >= dk) break;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        us[(rh * 32 + gq + 8 * q) * dp + 4 * c4 + t] = acc[c4][q];
    }
  }
  __syncthreads();
  if (jh == 1) return;
  float* dst = splits > 1
                   ? workspace + (static_cast<long long>(z) * lanes + lane) *
                                     n * d
                   : du;
#pragma unroll
  for (int c4 = 0; c4 < NC; ++c4) {
    const int k = 4 * c4 + t;
    if (4 * c4 >= dk) break;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = rh * 32 + gq + 8 * q;
      if (row0 + r < n && k < d)
        dst[static_cast<long long>(row0 + r) * d + k] =
            2.0f * (acc[c4][q] + us[r * dp + k]);
    }
  }
}

// The path for d > 96, where the sums of the kernel above do not fit in
// registers. Block (row tile, column split z, coordinate chunk kc) writes
// du's coordinates [96 kc, 96 kc + 96); per column tile it streams u and w
// through shared memory 96 coordinates at a time to sum r2 over all of d,
// ending with chunk kc, then takes the slope and contracts with chunk kc.
// So the r2 work is done once per chunk of du (ceil(d / 96) times), and no
// copy overlaps compute: a path for a range no paper dataset reaches.
template <int KIND>
__global__ void __launch_bounds__(THREADS, 1)
kernel_mvm_bwd_wide(const float* __restrict__ u, const float* __restrict__ w,
                    const float* __restrict__ g, const float* __restrict__ v,
                    float* __restrict__ du, float* __restrict__ workspace,
                    int n, int m, int d, int s, int splits, int lanes,
                    int vec_v) {
  constexpr int NC = 4 * KQ_MAX;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int tl = tid & 31, warp = tid >> 5;
  const int gq = tl >> 2, t = tl & 3;
  const int rh = warp % ROW_WARPS, jh = warp / ROW_WARPS;
  const int row0 = blockIdx.x * BM;
  const int lane = blockIdx.y / splits;
  const int z = blockIdx.y - lane * splits;
  u += static_cast<long long>(lane) * n * d;
  w += static_cast<long long>(lane) * m * d;
  g += static_cast<long long>(lane) * n * s;
  v += static_cast<long long>(lane) * m * s;
  du += static_cast<long long>(lane) * n * d;
  const int kc = blockIdx.z, chunks = gridDim.z;
  const int k0 = kc * DC;
  const int dp = padded_d(DC), sp = padded_s(s);
  const int rows_u = n - row0 < BM ? n - row0 : BM;
  float* gs = smem;           // [BM][sp]
  float* vs = gs + BM * sp;   // [BN][sp]
  float* us = vs + BN * sp;   // [BM][dp]: a chunk of u's row tile
  float* ws = us + BM * dp;   // [BN][dp]: the same chunk of w's column tile
  const int tiles = (m + BN - 1) / BN;
  const int t_lo = static_cast<int>(static_cast<long long>(z) * tiles / splits);
  const int t_hi =
      static_cast<int>(static_cast<long long>(z + 1) * tiles / splits);

  for (int idx = tid; idx < BM * sp; idx += THREADS) {
    const int r = idx / sp;
    const int k = idx - r * sp;
    gs[idx] = (row0 + r < n && k < s)
                  ? g[static_cast<long long>(row0 + r) * s + k] : 0.0f;
  }
  // Columns s..sp-1 of v stay zero (the copies write only the others).
  for (int r = tid; r < BN; r += THREADS)
    for (int k = s; k < sp; ++k) vs[r * sp + k] = 0.0f;

  const float* arow = gs + (rh * 32 + gq) * sp + 2 * t;
  const float* urow = us + (rh * 32 + gq) * dp;
  const int wofs = (jh * 32 + 2 * t) * dp;
  const float* brow = vs + (jh * 32 + gq) * sp + 2 * t;
  float acc[NC][4];
#pragma unroll
  for (int c4 = 0; c4 < NC; ++c4)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[c4][q] = 0.0f;
  // Chunk i of a column tile's walk over the coordinates (the last is kc),
  // and with i = 0 the tile's rows of v; its width rounded up to 4.
  auto load_chunk = [&](int i, int j0, int rows_w) {
    const int c0 = ((kc + 1 + i) % chunks) * DC;
    const int width = d - c0 < DC ? d - c0 : DC;
    copy_chunk<BM>(us, dp, u + static_cast<long long>(row0) * d + c0, d,
                   width, rows_u);
    copy_chunk<BN>(ws, dp, w + static_cast<long long>(j0) * d + c0, d,
                   width, rows_w);
    if (i == 0) {
      const float* vsrc = v + static_cast<long long>(j0) * s;
      if (vec_v) copy_rows<4>(vs, sp, vsrc, s, rows_w);
      else copy_rows<1>(vs, sp, vsrc, s, rows_w);
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();  // the chunk (and the v tile) has landed
    return (width + 3) & ~3;
  };

  float c[2][4][4];
  for (int jt = t_lo; jt < t_hi; ++jt) {
    const int j0 = jt * BN;
    const int rows_w = m - j0 < BN ? m - j0 : BN;
    __syncthreads();  // every warp is done with the previous tile's buffers
    int dk = load_chunk(0, j0, rows_w);
    tile_gram(c, arow, brow, sp, sp / 8);
    float r2[4][8];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int b = 0; b < 8; ++b) r2[q][b] = 0.0f;
    tile_r2(r2, urow, ws + wofs, dp, dk);
    for (int i = 1; i < chunks; ++i) {
      __syncthreads();  // every warp is done with the previous chunk
      dk = load_chunk(i, j0, rows_w);
      tile_r2(r2, urow, ws + wofs, dp, dk);
    }
    apply_slope<KIND>(c, r2);
    tile_contract<NC>(acc, c, urow, ws + wofs, dp, dk, t);
  }
  __syncthreads();  // every warp is done with us

  // Each row's sum is the two column halves' (jh = 0, then jh = 1): the
  // jh = 1 warps leave theirs in us, the jh = 0 warps add and store.
  if (jh == 1) {
#pragma unroll
    for (int c4 = 0; c4 < NC; ++c4) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        us[(rh * 32 + gq + 8 * q) * dp + 4 * c4 + t] = acc[c4][q];
    }
  }
  __syncthreads();
  if (jh == 1) return;
  float* dst = splits > 1
                   ? workspace + (static_cast<long long>(z) * lanes + lane) *
                                     n * d
                   : du;
#pragma unroll
  for (int c4 = 0; c4 < NC; ++c4) {
    const int k = k0 + 4 * c4 + t;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = rh * 32 + gq + 8 * q;
      if (row0 + r < n && k < d)
        dst[static_cast<long long>(row0 + r) * d + k] =
            2.0f * (acc[c4][q] + us[r * dp + 4 * c4 + t]);
    }
  }
}

// du[e] = sum over z of workspace[z][e], in split order z = 0, 1, ...;
// e runs over all lanes' outputs (B * n * d).
__global__ void __launch_bounds__(256)
kernel_mvm_bwd_reduce(const float* __restrict__ workspace,
                      float* __restrict__ du, long long nd, int splits) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < nd; e += stride) {
    float sum = workspace[e];
    for (int z = 1; z < splits; ++z) sum += workspace[z * nd + e];
    du[e] = sum;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// After the main kernel: the launch's error, and with splits > 1 the
// second pass over the workspace.
cudaError_t reduce_splits(const float* workspace, float* du, int n, int d,
                          int splits, int lanes, cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long nd = static_cast<long long>(lanes) * n * d;
  long long blocks = (nd + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  kernel_mvm_bwd_reduce<<<static_cast<int>(blocks), 256, 0, stream>>>(
      workspace, du, nd, splits);
  return cudaGetLastError();
}

template <int KIND, int KQ>
cudaError_t launch(const float* u, const float* w, const float* g,
                   const float* v, float* du, float* workspace, int n, int m,
                   int d, int s, int splits, int lanes, cudaStream_t stream) {
  static size_t smem_set = 0;  // dynamic shared memory granted so far
  const int stages = smem_bytes(d, s, 2) <= kMaxSmem ? 2 : 1;
  const size_t smem = smem_bytes(d, s, stages);
  auto kern = kernel_mvm_bwd<KIND, KQ>;
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  const int vec_w = d % 4 == 0 && aligned16(w);
  const int vec_v = s % 4 == 0 && aligned16(v);
  const dim3 grid((n + BM - 1) / BM, lanes * splits);
  kern<<<grid, THREADS, smem, stream>>>(u, w, g, v, du, workspace, n, m, d, s,
                                        splits, lanes, stages, vec_w, vec_v);
  return reduce_splits(workspace, du, n, d, splits, lanes, stream);
}

// The path for d > 96: one block per (row tile, split, 96 coordinates of
// du), one (w, v) buffer.
template <int KIND>
cudaError_t launch_wide(const float* u, const float* w, const float* g,
                        const float* v, float* du, float* workspace, int n,
                        int m, int d, int s, int splits, int lanes,
                        cudaStream_t stream) {
  static size_t smem_set = 0;  // dynamic shared memory granted so far
  const size_t smem = smem_bytes(DC, s, 1);
  auto kern = kernel_mvm_bwd_wide<KIND>;
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  const int vec_v = s % 4 == 0 && aligned16(v);
  const dim3 grid((n + BM - 1) / BM, lanes * splits, (d + DC - 1) / DC);
  kern<<<grid, THREADS, smem, stream>>>(u, w, g, v, du, workspace, n, m, d, s,
                                        splits, lanes, vec_v);
  return reduce_splits(workspace, du, n, d, splits, lanes, stream);
}

template <int KIND>
cudaError_t launch_kind(const float* u, const float* w, const float* g,
                        const float* v, float* du, float* workspace, int n,
                        int m, int d, int s, int splits, int lanes,
                        cudaStream_t stream) {
  if (d > DC)
    return launch_wide<KIND>(u, w, g, v, du, workspace, n, m, d, s, splits,
                             lanes, stream);
  switch ((d + 15) / 16) {
    case 1: return launch<KIND, 1>(u, w, g, v, du, workspace, n, m, d, s, splits, lanes, stream);
    case 2: return launch<KIND, 2>(u, w, g, v, du, workspace, n, m, d, s, splits, lanes, stream);
    case 3: return launch<KIND, 3>(u, w, g, v, du, workspace, n, m, d, s, splits, lanes, stream);
    case 4: return launch<KIND, 4>(u, w, g, v, du, workspace, n, m, d, s, splits, lanes, stream);
    case 5: return launch<KIND, 5>(u, w, g, v, du, workspace, n, m, d, s, splits, lanes, stream);
    default: return launch<KIND, KQ_MAX>(u, w, g, v, du, workspace, n, m, d, s, splits, lanes, stream);
  }
}

}  // namespace

// Plain C interface (bound with ctypes). u, w, g, v and du hold `lanes`
// systems back to back, (lanes, n, d) etc.; `workspace` holds
// splits * lanes * n * d floats when splits > 1 and may be null otherwise.
// Any d; s as far as shared memory holds g's and v's tiles (the wrapper
// splits wider operands over launches). Returns 0 or a cudaError_t code; -1
// for an unknown kind, -2 for shapes, a lane count or a split count the
// kernel does not take (lanes * splits is the grid's y extent, at most
// 65535).
extern "C" int repro_kernel_mvm_bwd(const float* u, const float* w,
                                    const float* g, const float* v, float* du,
                                    float* workspace, int n, int m, int d,
                                    int s, int kind, int splits, int lanes,
                                    void* stream) {
  if (n <= 0 || m < 0 || d <= 0 || s <= 0 || lanes < 1) return -2;
  const int tiles = (m + BN - 1) / BN;
  if (splits < 1 || splits > 65535 / lanes || (splits > 1 && splits > tiles) ||
      (splits > 1 && workspace == nullptr))
    return -2;
  if (smem_bytes(d < DC ? d : DC, s, 1) > kMaxSmem) return -2;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kRbf:
      return launch_kind<kRbf>(u, w, g, v, du, workspace, n, m, d, s, splits,
                               lanes, st);
    case kMatern12:
      return launch_kind<kMatern12>(u, w, g, v, du, workspace, n, m, d, s,
                                    splits, lanes, st);
    case kMatern32:
      return launch_kind<kMatern32>(u, w, g, v, du, workspace, n, m, d, s,
                                    splits, lanes, st);
    case kMatern52:
      return launch_kind<kMatern52>(u, w, g, v, du, workspace, n, m, d, s,
                                    splits, lanes, st);
    default:
      return -1;
  }
}
