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
// ~0.117 ms of CUDA-core work against ~0.116 ms of tensor-core work; at the
// benchmark's 3droad product (d = 3, s = 33) the tensor cores bound it. In
// practice neither peak is the limit: the instructions the CUDA cores issue
// per pair are. sm_90 has no single instruction for cvt.rna.tf32.f32
// (ptxas emits a guarded add and mask), rsqrtf and exp2f wrap their MUFU
// in subnormal fix-ups, and the first loop below issues ~61 instructions a
// pair at d = 3 (SASS: r2 8, the 4-byte tile copies ~7, the kappa and V
// splits, mma.sync 3.75, address arithmetic), with every warp doing every
// kind of work in turn, so copies, r2 and the products add up rather than
// overlap (tools/torch_kernel_ablation.py times variants with one part
// cut). The warp-specialised loop (kernel_mvm_fwd_ws, further down) is
// built against that: the wrapper gives it every call whose (d, s) lets its
// rings fit in shared memory (d <= 44 at s <= 40, d <= 20 at s > 40),
// whose u has at least 4 row tiles and whose blocks walk at least 6 column
// tiles (kernels/tiled.py::fwd_plan; below that the pre-split pass or the
// rings' fill and drain cost more than the loop saves), the first loop the
// rest.
//
// The warp-specialised loop, and what it does about that:
//  * V is split once per call. A pre-split pass (kernel_mvm_fwd_presplit)
//    writes, per 64-row column tile, w's rows at the padded stride and
//    V_big^T, V_small^T (cvt.rna, as before) in the K-major core-matrix
//    layout that wgmma reads, so a tile is two bulk copies (cp.async.bulk
//    on an mbarrier), not a per-thread 4-byte cp.async walk, and no warp
//    splits V again.
//  * Warps that do one kind of work. 16 kappa warps compute r2 (direct
//    differences over exactly d coordinates), the profile in flush-to-zero
//    MUFU form and the TF32 split of kappa (cvt.rna's rounding in integer
//    form, NaN and infinity kept), ~21 instructions a pair at d = 3, and store
//    big and small into a kappa ring; 2 product warpgroups run the three
//    products with wgmma, kappa and V both from shared memory, so no
//    product warp holds kappa in registers. The rings (kappa 2 stages, V 2,
//    w 3) hand tiles over on mbarriers; one product thread refills the w
//    and V rings as their readers release a stage. setmaxnreg moves
//    registers from the kappa warps (64) to the product warps (112).
//    (Kappa stored once in fp32 and split in the product warps' registers,
//    wgmma with A from registers, halves the ring's traffic but measured
//    6 % slower at the cells' shapes.)
//  * Same numbers: r2 in fp32 by direct differences, the profile on the
//    special-function units, the three TF32 products; each half tile's
//    (32 columns') tensor-core sum starts from 0 and is added to the fp32
//    running sum (round to nearest), and the column splits, summed in split
//    order, keep every running sum to 256 tiles
//    (kernels/tiled.py::ws_split_plan). wgmma's fp32 accumulation rounds
//    less well than that sum: summed over 64 columns, the error at AP's
//    1000-column slab exceeded the first loop's; over 32 it falls below.
//  * What bounds it then (the ablation): the kappa warps alone take ~3/4 of
//    its time at the cells' shapes, and the products' shared-memory reads
//    (A and B for each of three products) and the card's 700 W limit
//    (clocks fall from 1980 to ~1850 MHz) take most of the rest.
//
// The first loop's design, and what it does about that:
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
// Not done here (later work): persistent blocks, and r2 on the tensor
// cores.

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

// cvt.rna.tf32.f32's rounding of a finite x in two integer instructions,
// (bits + 0x1000) & ~0x1fff: sm_90 has no single instruction for the cvt,
// and ptxas wraps that arithmetic in a guard for infinities and NaNs.
__device__ __forceinline__ uint32_t tf32_rna_finite(float x) {
  return (__float_as_uint(x) + 0x1000u) & ~0x1fffu;
}

// cvt.rna's rounding of an x that is +0 or more, +inf or NaN: the integer
// form after one min, which maps every NaN (either sign) to the TF32 NaN
// 0x7fffe000 and leaves +0 .. +inf as they are, so a NaN or an infinity
// keeps its class where the form alone would carry the card's NaN,
// 0x7fffffff, into the sign bit and return -0.
__device__ __forceinline__ uint32_t tf32_rna_nonneg(float x) {
  return (min(__float_as_uint(x), 0x7fffe000u) + 0x1000u) & ~0x1fffu;
}

// split_tf32 of a profile value, bit for bit where it is finite. Every
// profile value is +0 or more, +inf or NaN (a NaN or infinite r2 gives
// NaN for the Matérn kinds, NaN or 0 for RBF), so big takes
// tf32_rna_nonneg and keeps a non-finite value non-finite; small,
// x - big, is finite wherever x is, and where x is not, big already
// carries the NaN or infinity into the products.
__device__ __forceinline__ void split_tf32_kappa(float x, uint32_t& big,
                                                 uint32_t& small) {
  big = tf32_rna_nonneg(x);
  small = tf32_rna_finite(x - __uint_as_float(big));
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

// ---------------------------------------------------------------------------
// The warp-specialised loop (kernel_mvm_fwd_ws): see the header.

constexpr int WS_BM = 128;      // rows of u per block: two wgmma m64 halves
constexpr int WS_BN = 64;       // rows of (w, v) per column tile
constexpr int WS_STAGES = 2;    // depth of the kappa ring and the V ring
constexpr int WS_WSTAGES = 3;   // depth of the w ring
constexpr int WS_KWARPS = 16;   // kappa warps: four warpgroups
constexpr int WS_PWARPS = 8;    // product warps: two warpgroups
constexpr int WS_THREADS = 32 * (WS_PWARPS + WS_KWARPS);
constexpr int WS_KROWS = 64 / WS_KWARPS;  // 8-row groups per kappa thread
// Registers a thread: at launch (the most that 6 warps on each of the SM's
// four 16K-register quarters allow), then the kappa warps give up
// WS_REGS - WS_REGS_KAPPA each and the product warps take them
// (setmaxnreg): the products hold two 4 NT sums, the kappa threads
// 4 WS_KROWS pairs. launch_ws checks that the kernel was built with
// WS_REGS, without which the exchange would not balance.
constexpr int WS_REGS = 80;
constexpr int WS_REGS_KAPPA = 64;
constexpr int WS_REGS_PRODUCT =
    WS_REGS + (WS_REGS - WS_REGS_KAPPA) * WS_KWARPS / WS_PWARPS;
constexpr int WS_KTILE = WS_BM * WS_BN;  // floats of one kappa array
constexpr int WS_CORE = 32;              // floats of a core matrix (8 x 4)
constexpr int WS_SUMK = 4;   // k-steps (of 8 columns) per tensor-core sum
constexpr int WS_SBO = WS_BN / 4 * WS_CORE;  // floats between 8-row groups

// n8 tiles of s per s-chunk: 5 (s <= 40) or 9 (chunks of 72 columns).
__host__ __device__ __forceinline__ int ws_nt(int s) { return s <= 40 ? 5 : 9; }

// Floats of one column tile in the pre-split workspace: w's BN rows at the
// padded stride, then per s-chunk V_big^T and V_small^T (8 NT x BN each).
__host__ __device__ __forceinline__ long long ws_tile_floats(int d, int s) {
  const int width = 8 * ws_nt(s);
  const int chunks = (s + width - 1) / width;
  return static_cast<long long>(WS_BN) * padded_d(d) +
         2LL * chunks * width * WS_BN;
}

// Dynamic shared memory: the kappa ring (big, small), the V ring (big,
// small), the w ring, u's row tile and two mbarriers per stage of each ring.
__host__ __device__ __forceinline__ size_t ws_smem_bytes(int d, int nt) {
  const size_t dp = padded_d(d);
  return sizeof(float) * (WS_STAGES * (2 * WS_KTILE + 2 * 8 * nt * WS_BN) +
                          WS_WSTAGES * WS_BN * dp + WS_BM * dp) +
         sizeof(uint64_t) * 2 * (2 * WS_STAGES + WS_WSTAGES);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Bulk asynchronous copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) global -> shared, completing on `bar`'s transaction count.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// wgmma descriptor of a K-major operand with no swizzle: core matrices of
// 8 rows x 16 bytes, WS_CORE floats apart along K (bits 16-29) and WS_SBO
// floats apart along the rows (bits 32-45); the operand's shared address
// over 16 in bits 0-13. desc_lo gives the low word, whose address field a
// k-step advances by adding 16 (two core matrices); kDescHi is the high.
constexpr uint32_t kDescHi = WS_SBO * 4 >> 4;
__device__ __forceinline__ uint32_t desc_lo(const float* p) {
  return ((smem_u32(p) & 0x3FFFF) >> 4) | ((WS_CORE * 4 >> 4) << 16);
}

__device__ __forceinline__ void wgmma_n40(float (&d)[20], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19}, %20, %21, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n72(float (&d)[36], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35}, %36, %37, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int NT>
__device__ __forceinline__ void wgmma_tf32(float (&d)[4 * NT], uint32_t a_lo,
                                           uint32_t b_lo, int scale_d) {
  const uint64_t da = (static_cast<uint64_t>(kDescHi) << 32) | a_lo;
  const uint64_t db = (static_cast<uint64_t>(kDescHi) << 32) | b_lo;
  if constexpr (NT == 5) {
    wgmma_n40(d, da, db, scale_d);
  } else {
    static_assert(NT == 9, "the loop takes s-chunks of 40 or 72 columns");
    wgmma_n72(d, da, db, scale_d);
  }
}

// Keep the compiler from moving reads or writes of the accumulators across
// the asynchronous products.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The profiles as the warp-specialised loop evaluates them: kappa's
// formulas with rsqrt and exp2 in their flush-to-zero forms, one MUFU
// instruction each without the IEEE forms' subnormal fix-up (r2 is floored
// at 1e-30 or more, never subnormal; a profile value below 2^-126 flushes
// to 0), and the scale factors folded into one multiply.
__device__ __forceinline__ float sqrt_ftz(float x) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return x * r;
}
__device__ __forceinline__ float ex2_ftz(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

template <int KIND>
__device__ __forceinline__ float kappa_ws(float r2) {
  if (KIND == kRbf) {
    return ex2_ftz(-0.5f * kLog2e * r2);
  } else if (KIND == kMatern12) {
    return ex2_ftz(-kLog2e * sqrt_ftz(fmaxf(r2, kR2FloorM12)));
  } else if (KIND == kMatern32) {
    const float r = sqrt_ftz(fmaxf(r2, kR2Floor));
    const float e = ex2_ftz(-kLog2e * kSqrt3 * r);
    return fmaf(kSqrt3 * r, e, e);
  } else {
    const float r = sqrt_ftz(fmaxf(r2, kR2Floor));
    const float e = ex2_ftz(-kLog2e * kSqrt5 * r);
    return (fmaf(kSqrt5, r, 1.0f) + (5.0f / 3.0f) * r2) * e;
  }
}

// kt[a][c] += sum over coordinates k .. k + W - 1 of (u - w)^2 for the
// kappa warps' rows (urow + 8 a dp) and columns (wrow + c dp), W <= 4, in
// coordinate order: a whole float4 chunk, or the last W coordinates of d.
template <int W>
__device__ __forceinline__ void ws_r2_chunk(float (&kt)[WS_KROWS][4],
                                            const float* urow,
                                            const float* wrow, int dp, int k) {
  float4 wc[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    wc[c] = *reinterpret_cast<const float4*>(wrow + c * dp + k);
#pragma unroll
  for (int a = 0; a < WS_KROWS; ++a) {
    const float4 ua = *reinterpret_cast<const float4*>(urow + a * 8 * dp + k);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float df = ua.x - wc[c].x;
      float q = fmaf(df, df, kt[a][c]);
      if (W > 1) {
        df = ua.y - wc[c].y;
        q = fmaf(df, df, q);
      }
      if (W > 2) {
        df = ua.z - wc[c].z;
        q = fmaf(df, df, q);
      }
      if (W > 3) {
        df = ua.w - wc[c].w;
        q = fmaf(df, df, q);
      }
      kt[a][c] = q;
    }
  }
}

// Pre-split pass: per lane and column tile (blockIdx.x, blockIdx.y = lane)
// write w's BN rows at the padded stride and, per s-chunk of 8 NT columns,
// V_big^T and V_small^T in the core-matrix layout the products read
// (element (c, j) at (c / 8) * WS_SBO + (j / 4) * WS_CORE + (c % 8) * 4 +
// j % 4); zeros past m, d and s.
__global__ void __launch_bounds__(256)
kernel_mvm_fwd_presplit(const float* __restrict__ w,
                        const float* __restrict__ v, float* __restrict__ packed,
                        int m, int d, int s) {
  const int width = 8 * ws_nt(s);
  const int dp = padded_d(d);
  const int chunks = (s + width - 1) / width;
  const int tiles = (m + WS_BN - 1) / WS_BN;
  const int lane = blockIdx.y, jt = blockIdx.x;
  const long long tile_floats = ws_tile_floats(d, s);
  w += static_cast<long long>(lane) * m * d;
  v += static_cast<long long>(lane) * m * s;
  float* dst = packed + (static_cast<long long>(lane) * tiles + jt) *
                            tile_floats;
  const int j0 = jt * WS_BN;
  for (int e = threadIdx.x; e < WS_BN * dp; e += blockDim.x) {
    const int jl = e / dp, k = e - jl * dp;
    const int j = j0 + jl;
    dst[e] = (j < m && k < d) ? w[static_cast<long long>(j) * d + k] : 0.0f;
  }
  dst += WS_BN * dp;
  const int chunk_len = width * WS_BN;
  for (int e = threadIdx.x; e < chunks * chunk_len; e += blockDim.x) {
    const int c = e / chunk_len, f = e - c * chunk_len;
    const int j = j0 + 4 * ((f >> 5) & (WS_BN / 4 - 1)) + (f & 3);
    const int col = c * width + 8 * (f / WS_SBO) + ((f >> 2) & 7);
    const float x =
        (j < m && col < s) ? v[static_cast<long long>(j) * s + col] : 0.0f;
    uint32_t big, small;
    split_tf32(x, big, small);
    dst[2 * c * chunk_len + f] = __uint_as_float(big);
    dst[(2 * c + 1) * chunk_len + f] = __uint_as_float(small);
  }
}

// A block is (row tile of WS_BM rows, lane and column split, s-chunk) as in
// kernel_mvm_fwd, with two kinds of warps that run side by side, each on
// its own ring of stages in shared memory:
//  * warps 8..23 compute r2 and kappa for a column tile from u's row tile
//    and the tile's rows of w (the w ring), split kappa into TF32 big and
//    small and store both into the kappa ring;
//  * warps 0..7, two warpgroups of 64 rows each, run the three products
//    small*big, big*small and big*big of the tile with wgmma from shared
//    memory (kappa's ring, and V_big^T, V_small^T from the V ring) into a
//    half tile's sum (from 0), then add it to the running sum in fp32,
//    both in registers. One of their threads keeps the w and V rings filled from
//    the pre-split workspace with bulk copies: a stage is refilled as soon
//    as its last reader has released it, the w ring three tiles ahead of
//    the products and the V ring two.
template <int KIND, int NT>
__global__ void __launch_bounds__(WS_THREADS, 1)
kernel_mvm_fwd_ws(const float* __restrict__ u, const float* __restrict__ packed,
                  float* __restrict__ out, float* __restrict__ workspace,
                  int n, int m, int d, int s, int splits, int lanes) {
  constexpr int SC = 8 * NT;
  constexpr int VT = SC * WS_BN;  // floats of V_big^T (or V_small^T)
  extern __shared__ __align__(128) float smem[];
  const int dp = padded_d(d);
  const int tiles = (m + WS_BN - 1) / WS_BN;
  const long long tile_floats = ws_tile_floats(d, s);
  float* kring = smem;                               // [stage][big, small]
  float* vring = kring + WS_STAGES * 2 * WS_KTILE;   // [stage][big, small]
  float* wring = vring + WS_STAGES * 2 * VT;         // [wstage][BN][dp]
  float* us = wring + WS_WSTAGES * WS_BN * dp;       // [BM][dp]
  uint64_t* full_k = reinterpret_cast<uint64_t*>(us + WS_BM * dp);
  uint64_t* empty_k = full_k + WS_STAGES;
  uint64_t* full_v = empty_k + WS_STAGES;
  uint64_t* empty_v = full_v + WS_STAGES;
  uint64_t* full_w = empty_v + WS_STAGES;
  uint64_t* empty_w = full_w + WS_WSTAGES;

  const int row0 = blockIdx.x * WS_BM;
  const int lane_ix = blockIdx.y / splits;
  const int z = blockIdx.y - lane_ix * splits;
  const int chunk = blockIdx.z;
  const int c0 = chunk * SC;
  u += static_cast<long long>(lane_ix) * n * d;
  out += static_cast<long long>(lane_ix) * n * s;
  packed += static_cast<long long>(lane_ix) * tiles * tile_floats;
  const int t_lo = static_cast<int>(static_cast<long long>(z) * tiles / splits);
  const int t_hi =
      static_cast<int>(static_cast<long long>(z + 1) * tiles / splits);
  const int count = t_hi - t_lo;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t wbytes = 4 * WS_BN * dp, vbytes = 4 * 2 * VT;
  // Copies of tile i's w rows into the w ring and its V chunk into the V
  // ring, completing on the stage's full barrier.
  auto load_w = [&](int i) {
    uint64_t* bar = &full_w[i % WS_WSTAGES];
    mbar_expect_tx(bar, wbytes);
    bulk_load(wring + (i % WS_WSTAGES) * WS_BN * dp,
              packed + (t_lo + i) * tile_floats, wbytes, bar);
  };
  auto load_v = [&](int i) {
    uint64_t* bar = &full_v[i % WS_STAGES];
    mbar_expect_tx(bar, vbytes);
    bulk_load(vring + (i % WS_STAGES) * 2 * VT,
              packed + (t_lo + i) * tile_floats + WS_BN * dp + chunk * 2LL * VT,
              vbytes, bar);
  };

  if (threadIdx.x == 0) {
    for (int st = 0; st < WS_STAGES; ++st) {
      mbar_init(&full_k[st], WS_KWARPS);
      mbar_init(&empty_k[st], WS_PWARPS);
      mbar_init(&full_v[st], 1);
      mbar_init(&empty_v[st], WS_PWARPS);
    }
    for (int st = 0; st < WS_WSTAGES; ++st) {
      mbar_init(&full_w[st], 1);
      mbar_init(&empty_w[st], WS_KWARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < WS_WSTAGES && i < count; ++i) load_w(i);
    for (int i = 0; i < WS_STAGES && i < count; ++i) load_v(i);
  }
  for (int idx = threadIdx.x; idx < WS_BM * dp; idx += WS_THREADS) {
    const int r = idx / dp, k = idx - r * dp;
    us[idx] = (row0 + r < n && k < d)
                  ? u[static_cast<long long>(row0 + r) * d + k] : 0.0f;
  }
  __syncthreads();  // the only block-wide barrier: the roles part here

  if (warp >= WS_PWARPS) {
    // Kappa warps: warp kw takes rows 8 A h + 8 a + r (a < A = WS_KROWS)
    // and columns 4 cg + c (c < 4) of the tile, h = kw / 4, r = lane % 8,
    // cg = 4 (kw % 4) + lane / 8: 4 A pairs a thread. A quarter warp
    // stores one core matrix's 8 rows (128 contiguous bytes) of kappa.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(WS_REGS_KAPPA));
    const int kw = warp - WS_PWARPS;
    const int r = lane & 7, cg = 4 * (kw & 3) + (lane >> 3), h = kw >> 2;
    const float* urow = us + (8 * WS_KROWS * h + r) * dp;
    const int d4 = d & ~3;
    const int kofs = WS_KROWS * h * WS_SBO + cg * WS_CORE + 4 * r;
    for (int i = 0; i < count; ++i) {
      const int st = i % WS_STAGES, sw = i % WS_WSTAGES;
      mbar_wait(&full_w[sw], (i / WS_WSTAGES) & 1);
      const float* wrow = wring + sw * WS_BN * dp + 4 * cg * dp;
      float kt[WS_KROWS][4];
#pragma unroll
      for (int a = 0; a < WS_KROWS; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) kt[a][c] = 0.0f;
#pragma unroll 1
      for (int k = 0; k < d4; k += 4) ws_r2_chunk<4>(kt, urow, wrow, dp, k);
      switch (d - d4) {
        case 1:
          ws_r2_chunk<1>(kt, urow, wrow, dp, d4);
          break;
        case 2:
          ws_r2_chunk<2>(kt, urow, wrow, dp, d4);
          break;
        case 3:
          ws_r2_chunk<3>(kt, urow, wrow, dp, d4);
          break;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty_w[sw]);  // done with this w
      mbar_wait(&empty_k[st], ((i / WS_STAGES) & 1) ^ 1);
      float* kb = kring + st * 2 * WS_KTILE + kofs;
#pragma unroll
      for (int a = 0; a < WS_KROWS; ++a) {
        uint32_t big[4], small[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          split_tf32_kappa(kappa_ws<KIND>(kt[a][c]), big[c], small[c]);
        *reinterpret_cast<uint4*>(kb + a * WS_SBO) =
            make_uint4(big[0], big[1], big[2], big[3]);
        *reinterpret_cast<uint4*>(kb + WS_KTILE + a * WS_SBO) =
            make_uint4(small[0], small[1], small[2], small[3]);
      }
      // Make the stores visible to the tensor cores' reads, then publish.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) mbar_arrive(&full_k[st]);
    }
    return;
  }

  // Product warpgroups: warpgroup g owns rows 64 g .. 64 g + 63; thread
  // (warp wq of the group, lane) holds rows 16 wq + lane / 4 + 8 e and
  // columns 8 j + 2 (lane % 4) + c of the chunk, e, c < 2 (wgmma's layout).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(WS_REGS_PRODUCT));
  const int g = warp >> 2, wq = warp & 3;
  float acc[4 * NT], part[4 * NT];
#pragma unroll
  for (int x = 0; x < 4 * NT; ++x) acc[x] = 0.0f;
  for (int i = 0; i < count; ++i) {
    const int st = i % WS_STAGES;
    const uint32_t ph = (i / WS_STAGES) & 1;
    mbar_wait(&full_k[st], ph);
    mbar_wait(&full_v[st], ph);
    __syncwarp();
    const uint32_t kb = desc_lo(kring + st * 2 * WS_KTILE + 8 * g * WS_SBO);
    const uint32_t ksm = kb + (WS_KTILE * 4 >> 4);
    const uint32_t vb = desc_lo(vring + st * 2 * VT);
    const uint32_t vsm = vb + (VT * 4 >> 4);
    fence_regs(part);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    // Each half tile (32 columns, 4 k-steps) is summed by the tensor cores
    // from 0 and then added to the running sum in fp32.
#pragma unroll
    for (int kk = 0; kk < WS_BN / 8; ++kk) {
      const uint32_t o = 2 * WS_CORE * 4 / 16 * kk;  // two core matrices
      wgmma_tf32<NT>(part, ksm + o, vb + o, kk % WS_SUMK > 0);
      wgmma_tf32<NT>(part, kb + o, vsm + o, 1);
      wgmma_tf32<NT>(part, kb + o, vb + o, 1);
      if (kk % WS_SUMK == WS_SUMK - 1) {
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_regs(part);
#pragma unroll
        for (int x = 0; x < 4 * NT; ++x) acc[x] += part[x];
        fence_regs(part);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      }
    }
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(&empty_k[st]);
      mbar_arrive(&empty_v[st]);
    }
    if (threadIdx.x == 0) {
      // Refill: V's stage with tile i + 2 once both warpgroups are done
      // with tile i; w's with tile i + 3, whose kappa warps released tile
      // i's rows before its products could start.
      if (i + WS_STAGES < count) {
        mbar_wait(&empty_v[st], ph);
        load_v(i + WS_STAGES);
      }
      if (i + WS_WSTAGES < count) {
        mbar_wait(&empty_w[i % WS_WSTAGES], (i / WS_WSTAGES) & 1);
        load_w(i + WS_WSTAGES);
      }
    }
  }

  float* dst = splits > 1 ? workspace + (static_cast<long long>(z) * lanes +
                                         lane_ix) * n * s
                          : out;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = row0 + 64 * g + 16 * wq + (lane >> 2) + 8 * e;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = c0 + 8 * j + 2 * (lane & 3) + c;
        if (col < s)
          dst[static_cast<long long>(row) * s + col] = acc[4 * j + 2 * e + c];
      }
    }
  }
}

template <int KIND, int NT>
cudaError_t launch_ws(const float* u, const float* w, const float* v,
                      float* out, float* workspace, float* packed, int n,
                      int m, int d, int s, int splits, int lanes,
                      cudaStream_t stream) {
  static size_t smem_set = 0;  // dynamic shared memory granted so far
  static int regs = 0;         // the kernel's registers a thread, as built
  const size_t smem = ws_smem_bytes(d, NT);
  auto kern = kernel_mvm_fwd_ws<KIND, NT>;
  if (regs == 0) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, kern);
    if (err != cudaSuccess) return err;
    regs = attr.numRegs;
  }
  // The warps' register exchange balances only at WS_REGS (else the
  // product warps would wait for registers forever): refuse the launch.
  if (regs != WS_REGS) return cudaErrorInvalidConfiguration;
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
  const int tiles = (m + WS_BN - 1) / WS_BN;
  if (tiles > 0) {
    kernel_mvm_fwd_presplit<<<dim3(tiles, lanes), 256, 0, stream>>>(
        w, v, packed, m, d, s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int sc = 8 * NT;
  const dim3 grid((n + WS_BM - 1) / WS_BM, lanes * splits, (s + sc - 1) / sc);
  kern<<<grid, WS_THREADS, smem, stream>>>(u, packed, out, workspace, n, m, d,
                                           s, splits, lanes);
  return reduce_splits(workspace, out, n, s, splits, lanes, stream);
}

template <int KIND>
cudaError_t launch_ws_kind(const float* u, const float* w, const float* v,
                           float* out, float* workspace, float* packed, int n,
                           int m, int d, int s, int splits, int lanes,
                           cudaStream_t stream) {
  if (ws_nt(s) == 5)
    return launch_ws<KIND, 5>(u, w, v, out, workspace, packed, n, m, d, s,
                              splits, lanes, stream);
  return launch_ws<KIND, 9>(u, w, v, out, workspace, packed, n, m, d, s,
                            splits, lanes, stream);
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

// The warp-specialised loop, for (d, s) whose rings fit in shared memory
// (ws_smem_bytes(d, ws_nt(s)) <= 232448: d <= 44 at s <= 40, d <= 20 at
// s > 40). `packed` holds lanes * ceil(m / 64) * ws_tile_floats(d, s)
// floats, which the call overwrites (the pre-split pass); `workspace` as
// above, for 64-row column tiles. Returns 0, a cudaError_t code, -1 for an
// unknown kind, -2 for arguments the loop does not take.
extern "C" int repro_kernel_mvm_fwd_ws(const float* u, const float* w,
                                       const float* v, float* out,
                                       float* workspace, float* packed, int n,
                                       int m, int d, int s, int kind,
                                       int splits, int lanes, void* stream) {
  if (n <= 0 || m < 0 || d <= 0 || s <= 0 || lanes < 1 || lanes > 65535)
    return -2;
  const int tiles = (m + WS_BN - 1) / WS_BN;
  if (splits < 1 || splits > 65535 / lanes || (splits > 1 && splits > tiles) ||
      (splits > 1 && workspace == nullptr) ||
      (tiles > 0 && packed == nullptr) ||
      ws_smem_bytes(d, ws_nt(s)) > kMaxSmem)
    return -2;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kRbf:
      return launch_ws_kind<kRbf>(u, w, v, out, workspace, packed, n, m, d, s,
                                  splits, lanes, st);
    case kMatern12:
      return launch_ws_kind<kMatern12>(u, w, v, out, workspace, packed, n, m,
                                       d, s, splits, lanes, st);
    case kMatern32:
      return launch_ws_kind<kMatern32>(u, w, v, out, workspace, packed, n, m,
                                       d, s, splits, lanes, st);
    case kMatern52:
      return launch_ws_kind<kMatern52>(u, w, v, out, workspace, packed, n, m,
                                       d, s, splits, lanes, st);
    default:
      return -1;
  }
}

// The pre-split pass alone (for the tests on the card): `packed` as for
// repro_kernel_mvm_fwd_ws.
extern "C" int repro_kernel_mvm_fwd_presplit(const float* w, const float* v,
                                             float* packed, int m, int d,
                                             int s, int lanes, void* stream) {
  if (m <= 0 || d <= 0 || s <= 0 || lanes < 1 || lanes > 65535) return -2;
  kernel_mvm_fwd_presplit<<<dim3((m + WS_BN - 1) / WS_BN, lanes), 256, 0,
                            static_cast<cudaStream_t>(stream)>>>(w, v, packed,
                                                                 m, d, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
