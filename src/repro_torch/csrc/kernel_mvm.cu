// Forward distance-tile kernel MVM for Hopper (sm_90a).
//
//   out[i, :] = sum_j kappa(||u_i - w_j||^2) v[j, :]
//
// u (n, d), w (m, d) are lengthscale-pre-scaled inputs, v (m, s); all fp32,
// row-major and contiguous. K is never materialised. This replaces the TPU
// kernel `kernel_mvm_pallas` (src/repro/kernels/tiled.py:98, body
// `_mvm_kernel`); the profiles and their floors are those of
// src/repro/kernels/registry.py.
//
// What bounds it on an H100. Per pair (i, j) it does 2*d operations for r2
// (a difference and a fused multiply-add per coordinate) and the profile on
// the fp32 CUDA cores (67 TFLOP/s), and the 2*s flops of kappa @ V on the
// TF32 tensor cores, three times for the 3xTF32 split (495 TFLOP/s dense).
// At the CG shape (n = m = 12150, d = 26, s = 65) the two bounds are even,
// ~0.117 ms of CUDA-core work against ~0.116 ms of tensor-core work; the
// ~9 MB of inputs take ~3 us. On the card the kernel's time is close to the
// sum of its parts rather than the larger: r2, the tile copies and the
// products each take a comparable share (tools/torch_kernel_ablation.py
// times variants with one part cut), and running the two column halves of
// a block half a tile apart, so that one multiplied while the other
// computed r2, gained nothing.
//
// Design, and what it does about that:
//  * Split over the column range. A block is (row tile of BM = 128 rows,
//    column split z, s-chunk); it walks only the column tiles (BN = 128 rows
//    of w and v) of its split, [z * T / splits, (z+1) * T / splits) of T
//    tiles. The wrapper plans `splits` from the shapes and the SM count
//    (kernels/tiled.py::split_plan): ~95 at the prediction shape, 4 at the
//    CG shape, where 95 row tiles alone would leave 37 SMs idle. With
//    splits > 1 each block writes its partial sum to a (splits, n, s) fp32
//    workspace that the wrapper allocates, and a second kernel here sums the
//    partials in split order 0, 1, 2, ...: no atomics, so two launches give
//    bitwise equal outputs. With one split the blocks write `out` and no
//    second pass runs.
//  * kappa @ V on the tensor cores in 3xTF32 with mma.sync.m16n8k8. Each of
//    the 8 warps owns 32 rows x 64 columns of the block's (128 x 128) tile;
//    its threads compute r2 and kappa for exactly the pairs that their mma
//    A fragments hold (rows g + 8a, columns t + 4b for lane = 4g + t), so
//    kappa goes from registers into the tensor cores with no round trip
//    through shared memory. mma.sync rather than wgmma: wgmma with A from
//    registers pins those registers and its accumulators until it
//    completes, and wants V in a K-major shared-memory layout split into
//    two arrays (big, small); with kappa (64 registers), the tile's sum (72)
//    and the operands in flight this does not fit the register file and
//    227 KB of shared memory beside two (w, v) buffers. Both operands are
//    split as x = big + small, big = cvt.rna.tf32(x), small =
//    cvt.rna.tf32(x - big), and small*big + big*small + big*big is summed:
//    fp32-level accuracy, where one TF32 product keeps ~3 decimal digits.
//    V's columns are padded to a multiple of 8 by masking (s = 65 -> 72,
//    one chunk).
//  * The tensor cores sum one tile at a time from 0; the tile's sum is then
//    added in fp32 (round to nearest) to the thread's running sum, which
//    lives in shared memory so that the registers hold kappa, the tile's sum
//    and the operands. (Summed on the tensor cores over the whole column
//    range, the error at the CG shape exceeded 1e-5 of the largest output:
//    their fp32 accumulation does not round to nearest.) The two warps that
//    share a row range add their sums in a fixed order at the end.
//  * r2 by direct differences sum_k (u_ik - w_jk)^2 in fp32 on the CUDA
//    cores (no expanded uu + ww - 2uw form): coincident points give an exact
//    0, which the Matérn-1/2 profile needs (its expanded form loses ~1e-3).
//    Rows of u and w sit in shared memory with a padded stride dp (d rounded
//    to 4, dp = 4 mod 8) and are read as float4: one u load and four w loads
//    per 4 coordinates feed 64 pairs per thread, free of bank conflicts.
//    The profile runs on the special-function units (see kappa below).
//  * Copies overlap compute: the next (w, v) column tile is staged with
//    4-byte cp.async (rows of w and v are not 16-byte aligned; zero-filled
//    past m) into the second of two buffers while the current one is
//    computed. For d > 52 two buffers do not fit; one is used and the copy
//    follows the compute.
//  * The range. Where u's row tile and one buffer do not fit beside the
//    running sums (d > 116 at s >= 72, d > 212 at s <= 8), a second kernel
//    (kernel_mvm_fwd_wide) streams u and w through shared memory 64
//    coordinates at a time per column tile, summing r2 in the same order,
//    with no copy overlapping compute: any d, for a range no paper dataset
//    reaches. s is covered by the s-chunks of the grid at any width.
//  * Ragged n, m, s and d are masked in the kernel: rows of w and v past m
//    stage as zeros (a zero row of v contributes nothing), coordinates past
//    d are zero in both u and w, and rows or columns past n or s are never
//    stored.
//  * Lanes. B independent systems (u, w, v stacked on a leading axis, as
//    `vmap` of the TPU kernel adds a grid axis) take one launch: the lane
//    is folded into the grid's y axis as blockIdx.y = lane * splits + z,
//    each block offsets its operands by its lane in 64 bits, and the
//    workspace is (splits, B, n, s), so the second pass adds B * n * s
//    elements in split order. The split planner counts B times the row
//    blocks, so more lanes take fewer splits; with B = 1 the launch is the
//    single-system one.
// Not done here (later work): a wgmma/TMA warp-specialised pipeline with V
// pre-split in device memory, and persistent blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROW_WARPS = 4;             // warps along the rows of a block
constexpr int BM = 32 * ROW_WARPS;       // rows of u per block
constexpr int BN = 128;                  // rows of (w, v) per column tile
constexpr int THREADS = 64 * ROW_WARPS;  // warps: (row part, column half)
constexpr int MAX_NT = 9;                // n8 tiles of s: s-chunk <= 72
constexpr int DC = 64;                   // coordinates per chunk, wide path

constexpr float kSqrt3 = 1.7320508075688772f;
constexpr float kSqrt5 = 2.23606797749979f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kR2Floor = 1e-30f;     // registry _R2_FLOOR
constexpr float kR2FloorM12 = 1e-12f;  // registry _R2_FLOOR_M12

enum Kind { kRbf = 0, kMatern12 = 1, kMatern32 = 2, kMatern52 = 3 };

// The registry profiles on the special-function units: r = x * rsqrt(x) and
// exp(-y) = 2^(-y log2 e), each within a few ulps, far inside the kernel's
// tolerance, where IEEE-rounded sqrtf and the full-range expf take several
// times the instructions per pair.
__device__ __forceinline__ float sqrt_fast(float x) { return x * rsqrtf(x); }
__device__ __forceinline__ float exp_neg(float y) {
  return exp2f(-kLog2e * y);
}

template <int KIND>
__device__ __forceinline__ float kappa(float r2) {
  if (KIND == kRbf) {
    return exp_neg(0.5f * r2);
  } else if (KIND == kMatern12) {
    return exp_neg(sqrt_fast(fmaxf(r2, kR2FloorM12)));
  } else if (KIND == kMatern32) {
    const float a = kSqrt3 * sqrt_fast(fmaxf(r2, kR2Floor));
    return (1.0f + a) * exp_neg(a);
  } else {
    const float r = sqrt_fast(fmaxf(r2, kR2Floor));
    return (1.0f + kSqrt5 * r + (5.0f / 3.0f) * r2) * exp_neg(kSqrt5 * r);
  }
}

// Row stride of u and w in shared memory: d rounded up to 4 (float4 reads),
// and 4 mod 8 so that the rows t, t+4, ... of a quarter warp hit distinct
// banks.
__host__ __device__ __forceinline__ int padded_d(int d) {
  const int dp = (d + 3) & ~3;
  return (dp & 7) ? dp : dp + 4;
}

// Row stride of v in shared memory: 8 or 24 mod 32, so that the B-fragment
// reads (rows t, columns g) of a warp hit 32 distinct banks.
__host__ __device__ constexpr int padded_s(int nt) { return 8 * (nt | 1); }

__host__ __device__ __forceinline__ int num_nt(int s) {
  const int nt = (s + 7) / 8;
  return nt < MAX_NT ? nt : MAX_NT;
}

// Dynamic shared memory: the running sums, u's row tile and `stages` (w, v)
// column-tile buffers.
__host__ __device__ __forceinline__ size_t smem_bytes(int d, int nt,
                                                      int stages) {
  const size_t dp = padded_d(d), sp = padded_s(nt);
  return sizeof(float) *
         (2 * nt * 4 * THREADS + BM * dp + stages * BN * (dp + sp));
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

// 4-byte asynchronous copy global -> shared; src_bytes = 0 zero-fills.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A thread's walk over a block of rows read as a run of `width` floats per
// row: element e = tid + THREADS * i lies in row j, column k, tracked
// without a division.
struct Walk {
  int j, k, dj, dk;
  __device__ __forceinline__ Walk(int tid, int width)
      : j(tid / width), k(tid % width), dj(THREADS / width),
        dk(THREADS % width) {}
};

// Copy `rows` rows of `width` floats (global row stride `src_stride`) into
// BN rows of shared memory (row stride `dst_stride`); the rows past `rows`
// are zero-filled.
__device__ __forceinline__ void copy_rows(float* dst, int dst_stride,
                                          const float* __restrict__ src,
                                          long long src_stride, int width,
                                          int rows, Walk walk) {
  const int count = rows * width;
  for (int e = threadIdx.x; e < BN * width; e += THREADS) {
    const bool ok = e < count;
    cp_async4(dst + walk.j * dst_stride + walk.k,
              ok ? src + walk.j * src_stride + walk.k : src, ok ? 4 : 0);
    walk.k += walk.dk;
    walk.j += walk.dj;
    if (walk.k >= width) {
      walk.k -= width;
      ++walk.j;
    }
  }
}

// Copy coordinates [0, width) of `rows` rows (global row stride
// `src_stride`) into ROWS rows of DC floats in shared memory (row stride
// `dst_stride`); coordinates [width, DC) and the rows past `rows` are
// zero-filled.
template <int ROWS>
__device__ __forceinline__ void copy_chunk(float* dst, int dst_stride,
                                           const float* __restrict__ src,
                                           int src_stride, int width,
                                           int rows) {
  for (int e = threadIdx.x; e < ROWS * DC; e += THREADS) {
    const int j = e / DC, k = e - (e / DC) * DC;
    const bool ok = j < rows && k < width;
    cp_async4(dst + j * dst_stride + k,
              ok ? src + static_cast<long long>(j) * src_stride + k : src,
              ok ? 4 : 0);
  }
}

// Per-block constants of the kernel.
struct Geometry {
  int dp;         // row stride of u and w in shared memory
  int dk;         // coordinates read: d rounded up to 4 (zeros past d)
  int width;      // columns of v in this block's s-chunk
  int stage_len;  // floats per buffer: [BN][dp] of w, then [BN][SP] of v
};

// kt[a][b] += sum over dk coordinates of (u - w)^2 for rows g + 8a and
// columns t + 4b of this warp's (32 x 64) part of the tile: the A-fragment
// layout of mma.m16n8k8.
__device__ __forceinline__ void tile_r2(float (&kt)[4][16], const float* urow,
                                        const float* wrow, int dp, int dk) {
#pragma unroll 1
  for (int k = 0; k < dk; k += 4) {
    float4 ua[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      ua[a] = *reinterpret_cast<const float4*>(urow + a * 8 * dp + k);
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      const float4 wb = *reinterpret_cast<const float4*>(wrow + b * 4 * dp + k);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float df = ua[a].x - wb.x;
        float r = fmaf(df, df, kt[a][b]);
        df = ua[a].y - wb.y;
        r = fmaf(df, df, r);
        df = ua[a].z - wb.z;
        r = fmaf(df, df, r);
        df = ua[a].w - wb.w;
        kt[a][b] = fmaf(df, df, r);
      }
    }
  }
}

__device__ __forceinline__ void zero_tile(float (&kt)[4][16]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 16; ++b) kt[a][b] = 0.0f;
}

template <int KIND>
__device__ __forceinline__ void apply_kappa(float (&kt)[4][16]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 16; ++b) kt[a][b] = kappa<KIND>(kt[a][b]);
}

// r2, then kappa, for the thread's pairs (the layout of tile_r2).
template <int KIND>
__device__ __forceinline__ void tile_kappa(float (&kt)[4][16],
                                           const float* urow,
                                           const float* wrow, int dp,
                                           int dk) {
  zero_tile(kt);
  tile_r2(kt, urow, wrow, dp, dk);
  apply_kappa<KIND>(kt);
}

// acc += kappa @ V for this warp's 32 rows: 8 k-steps of 8 columns, NT n8
// tiles of s, 2 m16 tiles, 3 products each. The tensor cores sum one tile
// into `part`, from 0, which is then added to the thread's running sum in
// shared memory (`acc`, stride THREADS) in fp32 with round to nearest: the
// tensor cores' own fp32 accumulation does not round to nearest, and over a
// whole column range its error grows with the sum. Within a k-step the
// products run in three rounds over all (nt, mt), so that the 2 * NT
// independent sums hide the latency of each mma.
template <int NT>
__device__ __forceinline__ void tile_mma(float* acc, const float (&kt)[4][16],
                                         const float* vb, int g, int t) {
  constexpr int SP = padded_s(NT);
  float part[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) part[mt][nt][c] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    uint32_t abig[2][4], asmall[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      split_tf32(kt[2 * mt][2 * kk], abig[mt][0], asmall[mt][0]);
      split_tf32(kt[2 * mt + 1][2 * kk], abig[mt][1], asmall[mt][1]);
      split_tf32(kt[2 * mt][2 * kk + 1], abig[mt][2], asmall[mt][2]);
      split_tf32(kt[2 * mt + 1][2 * kk + 1], abig[mt][3], asmall[mt][3]);
    }
    const float* vk = vb + (kk * 8 + t) * SP + g;
    uint32_t bbig[NT][2], bsmall[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      split_tf32(vk[nt * 8], bbig[nt][0], bsmall[nt][0]);
      split_tf32(vk[4 * SP + nt * 8], bbig[nt][1], bsmall[nt][1]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_tf32(part[mt][nt], asmall[mt], bbig[nt]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_tf32(part[mt][nt], abig[mt], bsmall[nt]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_tf32(part[mt][nt], abig[mt], bbig[nt]);
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[((mt * NT + nt) * 4 + c) * THREADS] += part[mt][nt][c];
}

// Store a jh = 0 thread's rows: each row's sum is the two column halves'
// (this thread's, then the jh = 1 thread's THREADS / 2 further on), added
// in that order. Rows row + 16 mt + 8 h, columns col + 8 nt + e, masked to
// (n, s); dst has row stride s.
template <int NT>
__device__ __forceinline__ void store_sums(const float* accs, float* dst,
                                           int row, int col, int n, int s) {
  const float* mine = accs + threadIdx.x;
  const float* other = mine + THREADS / 2;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + mt * 16 + h * 8;
      if (r >= n) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = ((mt * NT + nt) * 4 + 2 * h + e) * THREADS;
          const int c = col + nt * 8 + e;
          if (c < s) dst[static_cast<long long>(r) * s + c] = mine[i] + other[i];
        }
      }
    }
  }
}

// Blocks of THREADS threads: warp (rh, jh) owns rows 32 rh .. 32 rh + 31 of
// the block's BM rows and columns 64 jh .. 64 jh + 63 of each column tile.
// Each thread keeps its running sum in shared memory (2 * NT * 4 floats,
// THREADS apart), which leaves its registers to kappa, the tile's sum and
// the operands of the next mma. With `stages` = 2 the next column tile is
// copied while this one is computed; with 1 (when two buffers do not fit,
// d > 52) it is copied after.
template <int KIND, int NT>
__global__ void __launch_bounds__(THREADS, 4 / ROW_WARPS)
kernel_mvm_fwd(const float* __restrict__ u, const float* __restrict__ w,
               const float* __restrict__ v, float* __restrict__ out,
               float* __restrict__ workspace, int n, int m, int d, int s,
               int splits, int lanes, int stages) {
  constexpr int SC = 8 * NT, SP = padded_s(NT), ACC = 2 * NT * 4;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int tl = tid & 31, warp = tid >> 5;
  const int g = tl >> 2, t = tl & 3;
  const int rh = warp % ROW_WARPS, jh = warp / ROW_WARPS;
  const int row0 = blockIdx.x * BM;
  const int lane = blockIdx.y / splits;
  const int z = blockIdx.y - lane * splits;
  const int c0 = blockIdx.z * SC;
  u += static_cast<long long>(lane) * n * d;
  w += static_cast<long long>(lane) * m * d;
  v += static_cast<long long>(lane) * m * s;
  out += static_cast<long long>(lane) * n * s;
  Geometry geo;
  geo.dp = padded_d(d);
  geo.dk = (d + 3) & ~3;
  geo.width = s - c0 < SC ? s - c0 : SC;
  geo.stage_len = BN * (geo.dp + SP);
  float* accs = smem;                 // [ACC][THREADS] running sums
  float* us = accs + ACC * THREADS;   // [BM][dp]
  float* buf0 = us + BM * geo.dp;     // `stages` buffers of stage_len floats
  const int tiles = (m + BN - 1) / BN;
  const int t_lo = static_cast<int>(static_cast<long long>(z) * tiles / splits);
  const int t_hi =
      static_cast<int>(static_cast<long long>(z + 1) * tiles / splits);
  const Walk walk_w(tid, d), walk_v(tid, geo.width);

  auto load = [&](float* buf, int jt) {
    const int j0 = jt * BN;
    const int rows = m - j0 < BN ? m - j0 : BN;
    copy_rows(buf, geo.dp, w + static_cast<long long>(j0) * d, d, d, rows,
              walk_w);
    copy_rows(buf + BN * geo.dp, SP, v + static_cast<long long>(j0) * s + c0,
              s, geo.width, rows, walk_v);
  };

  if (t_lo < t_hi) load(buf0, t_lo);
  cp_async_commit();
  for (int i = 0; i < ACC; ++i) accs[i * THREADS + tid] = 0.0f;
  for (int idx = tid; idx < BM * geo.dp; idx += THREADS) {
    const int r = idx / geo.dp;
    const int k = idx - r * geo.dp;
    us[idx] = (row0 + r < n && k < d)
                  ? u[static_cast<long long>(row0 + r) * d + k] : 0.0f;
  }
  // Coordinates d..dp-1 of w and columns width..SC-1 of v stay zero in every
  // buffer (the copies write only the others).
  for (int r = tid; r < stages * BN; r += THREADS) {
    float* wr = buf0 + (r / BN) * geo.stage_len + (r % BN) * geo.dp;
    float* vr = buf0 + (r / BN) * geo.stage_len + BN * geo.dp + (r % BN) * SP;
    for (int k = d; k < geo.dp; ++k) wr[k] = 0.0f;
    for (int q = geo.width; q < SC; ++q) vr[q] = 0.0f;
  }

  const float* urow = us + (rh * 32 + g) * geo.dp;  // rows g + 8a, a < 4
  const int wofs = (jh * 64 + t) * geo.dp;          // columns t + 4b, b < 16
  const int vofs = BN * geo.dp + (jh * 64) * SP;
  float kt[4][16];
  for (int jt = t_lo; jt < t_hi; ++jt) {
    cp_async_wait_all();
    __syncthreads();  // tile jt has landed; every warp is done with jt - 1
    float* cur = buf0 + ((jt - t_lo) % stages) * geo.stage_len;
    if (stages == 2 && jt + 1 < t_hi) {
      load(cur == buf0 ? buf0 + geo.stage_len : buf0, jt + 1);
    }
    cp_async_commit();
    tile_kappa<KIND>(kt, urow, cur + wofs, geo.dp, geo.dk);
    tile_mma<NT>(accs + tid, kt, cur + vofs, g, t);
    if (stages == 1 && jt + 1 < t_hi) {
      __syncthreads();  // every warp is done with the only buffer
      load(buf0, jt + 1);
      cp_async_commit();
    }
  }
  __syncthreads();
  if (jh == 1) return;

  store_sums<NT>(accs, splits > 1
                            ? workspace + (static_cast<long long>(z) * lanes +
                                           lane) * n * s
                            : out,
                 row0 + rh * 32 + g, c0 + 2 * t, n, s);
}

// The path for d where u's row tile and a (w, v) buffer do not fit in
// shared memory beside the running sums (d > 116 at s >= 72): per column
// tile, r2 is summed over chunks of DC coordinates of u and w streamed
// through shared memory, then kappa @ V as above. One buffer, no copy
// overlaps compute, s-chunks of 72 columns: a path for a range no paper
// dataset reaches. The coordinates are summed in the same order as above.
template <int KIND>
__global__ void __launch_bounds__(THREADS, 4 / ROW_WARPS)
kernel_mvm_fwd_wide(const float* __restrict__ u, const float* __restrict__ w,
                    const float* __restrict__ v, float* __restrict__ out,
                    float* __restrict__ workspace, int n, int m, int d, int s,
                    int splits, int lanes) {
  constexpr int NT = MAX_NT;
  constexpr int SC = 8 * NT, SP = padded_s(NT), ACC = 2 * NT * 4;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int tl = tid & 31, warp = tid >> 5;
  const int g = tl >> 2, t = tl & 3;
  const int rh = warp % ROW_WARPS, jh = warp / ROW_WARPS;
  const int row0 = blockIdx.x * BM;
  const int lane = blockIdx.y / splits;
  const int z = blockIdx.y - lane * splits;
  const int c0 = blockIdx.z * SC;
  u += static_cast<long long>(lane) * n * d;
  w += static_cast<long long>(lane) * m * d;
  v += static_cast<long long>(lane) * m * s;
  out += static_cast<long long>(lane) * n * s;
  const int width = s - c0 < SC ? s - c0 : SC;
  const int dp = padded_d(DC);
  const int rows_u = n - row0 < BM ? n - row0 : BM;
  float* accs = smem;                // [ACC][THREADS] running sums
  float* us = accs + ACC * THREADS;  // [BM][dp]: a chunk of u's row tile
  float* ws = us + BM * dp;          // [BN][dp]: the chunk of w's tile
  float* vs = ws + BN * dp;          // [BN][SP]: the tile's rows of v
  const int tiles = (m + BN - 1) / BN;
  const int t_lo = static_cast<int>(static_cast<long long>(z) * tiles / splits);
  const int t_hi =
      static_cast<int>(static_cast<long long>(z + 1) * tiles / splits);
  const Walk walk_v(tid, width);

  for (int i = 0; i < ACC; ++i) accs[i * THREADS + tid] = 0.0f;
  // Columns width..SC-1 of v stay zero (the copies write only the others).
  for (int r = tid; r < BN; r += THREADS)
    for (int q = width; q < SC; ++q) vs[r * SP + q] = 0.0f;

  const float* urow = us + (rh * 32 + g) * dp;  // rows g + 8a, a < 4
  const float* wrow = ws + (jh * 64 + t) * dp;  // columns t + 4b, b < 16
  const float* vrow = vs + (jh * 64) * SP;
  float kt[4][16];
  for (int jt = t_lo; jt < t_hi; ++jt) {
    const int j0 = jt * BN;
    const int rows_w = m - j0 < BN ? m - j0 : BN;
    zero_tile(kt);
    for (int k0 = 0; k0 < d; k0 += DC) {
      const int dw = d - k0 < DC ? d - k0 : DC;
      __syncthreads();  // every warp is done with the buffers it overwrites
      copy_chunk<BM>(us, dp, u + static_cast<long long>(row0) * d + k0, d,
                     dw, rows_u);
      copy_chunk<BN>(ws, dp, w + static_cast<long long>(j0) * d + k0, d, dw,
                     rows_w);
      if (k0 == 0)
        copy_rows(vs, SP, v + static_cast<long long>(j0) * s + c0, s, width,
                  rows_w, walk_v);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();  // the chunk (and the v tile) has landed
      tile_r2(kt, urow, wrow, dp, (dw + 3) & ~3);
    }
    apply_kappa<KIND>(kt);
    tile_mma<NT>(accs + tid, kt, vrow, g, t);
  }
  __syncthreads();
  if (jh == 1) return;

  store_sums<NT>(accs, splits > 1
                            ? workspace + (static_cast<long long>(z) * lanes +
                                           lane) * n * s
                            : out,
                 row0 + rh * 32 + g, c0 + 2 * t, n, s);
}

// out[e] = sum over z of workspace[z][e], in split order z = 0, 1, ...;
// e runs over all lanes' outputs (B * n * s).
__global__ void __launch_bounds__(256)
kernel_mvm_fwd_reduce(const float* __restrict__ workspace,
                      float* __restrict__ out, long long ns, int splits) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < ns; e += stride) {
    float sum = workspace[e];
    for (int z = 1; z < splits; ++z) sum += workspace[z * ns + e];
    out[e] = sum;
  }
}

// After the main kernel: the launch's error, and with splits > 1 the
// second pass over the workspace.
cudaError_t reduce_splits(const float* workspace, float* out, int n, int s,
                          int splits, int lanes, cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long ns = static_cast<long long>(lanes) * n * s;
  long long blocks = (ns + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  kernel_mvm_fwd_reduce<<<static_cast<int>(blocks), 256, 0, stream>>>(
      workspace, out, ns, splits);
  return cudaGetLastError();
}

template <int KIND, int NT>
cudaError_t launch(const float* u, const float* w, const float* v, float* out,
                   float* workspace, int n, int m, int d, int s, int splits,
                   int lanes, cudaStream_t stream) {
  static size_t smem_set = 0;  // dynamic shared memory granted so far
  const int stages = smem_bytes(d, NT, 2) <= kMaxSmem ? 2 : 1;
  const size_t smem = smem_bytes(d, NT, stages);
  auto kern = kernel_mvm_fwd<KIND, NT>;
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
  const int sc = 8 * NT;
  const dim3 grid((n + BM - 1) / BM, lanes * splits, (s + sc - 1) / sc);
  kern<<<grid, THREADS, smem, stream>>>(u, w, v, out, workspace, n, m, d, s,
                                        splits, lanes, stages);
  return reduce_splits(workspace, out, n, s, splits, lanes, stream);
}

// Wide path: one (w, v) buffer, u and w staged DC coordinates at a time.
template <int KIND>
cudaError_t launch_wide(const float* u, const float* w, const float* v,
                        float* out, float* workspace, int n, int m, int d,
                        int s, int splits, int lanes, cudaStream_t stream) {
  static size_t smem_set = 0;  // dynamic shared memory granted so far
  const size_t smem = smem_bytes(DC, MAX_NT, 1);
  auto kern = kernel_mvm_fwd_wide<KIND>;
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
  const int sc = 8 * MAX_NT;
  const dim3 grid((n + BM - 1) / BM, lanes * splits, (s + sc - 1) / sc);
  kern<<<grid, THREADS, smem, stream>>>(u, w, v, out, workspace, n, m, d, s,
                                        splits, lanes);
  return reduce_splits(workspace, out, n, s, splits, lanes, stream);
}

template <int KIND>
cudaError_t launch_kind(const float* u, const float* w, const float* v,
                        float* out, float* workspace, int n, int m, int d,
                        int s, int splits, int lanes, cudaStream_t stream) {
#define REPRO_NT_CASE(NT)                                                  \
  case NT:                                                                 \
    return launch<KIND, NT>(u, w, v, out, workspace, n, m, d, s, splits, \
                            lanes, stream);
  if (smem_bytes(d, num_nt(s), 1) > kMaxSmem)
    return launch_wide<KIND>(u, w, v, out, workspace, n, m, d, s, splits,
                             lanes, stream);
  switch (num_nt(s)) {
    REPRO_NT_CASE(1)
    REPRO_NT_CASE(2)
    REPRO_NT_CASE(3)
    REPRO_NT_CASE(4)
    REPRO_NT_CASE(5)
    REPRO_NT_CASE(6)
    REPRO_NT_CASE(7)
    REPRO_NT_CASE(8)
    default:
      return launch<KIND, MAX_NT>(u, w, v, out, workspace, n, m, d, s, splits,
                                  lanes, stream);
  }
#undef REPRO_NT_CASE
}

}  // namespace

// Plain C interface (bound with ctypes). u, w, v and out hold `lanes`
// systems back to back, (lanes, n, d) etc.; `workspace` holds
// splits * lanes * n * s floats when splits > 1 and may be null otherwise.
// Any d and s. Returns 0 or a cudaError_t code; -1 for an unknown kind, -2
// for shapes, a lane count or a split count the kernel does not take
// (lanes * splits is the grid's y extent, at most 65535).
extern "C" int repro_kernel_mvm_fwd(const float* u, const float* w,
                                    const float* v, float* out,
                                    float* workspace, int n, int m, int d,
                                    int s, int kind, int splits, int lanes,
                                    void* stream) {
  if (n <= 0 || m < 0 || d <= 0 || s <= 0 || lanes < 1) return -2;
  const int tiles = (m + BN - 1) / BN;
  if (splits < 1 || splits > 65535 / lanes || (splits > 1 && splits > tiles) ||
      (splits > 1 && workspace == nullptr))
    return -2;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kRbf:
      return launch_kind<kRbf>(u, w, v, out, workspace, n, m, d, s, splits,
                               lanes, st);
    case kMatern12:
      return launch_kind<kMatern12>(u, w, v, out, workspace, n, m, d, s,
                                    splits, lanes, st);
    case kMatern32:
      return launch_kind<kMatern32>(u, w, v, out, workspace, n, m, d, s,
                                    splits, lanes, st);
    case kMatern52:
      return launch_kind<kMatern52>(u, w, v, out, workspace, n, m, d, s,
                                    splits, lanes, st);
    default:
      return -1;
  }
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
