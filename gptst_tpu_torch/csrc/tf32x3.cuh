// A tile product in f32 on Hopper's tensor cores (3xTF32), shared by
// ring_spmm.cu and spmm_dvals.cu.
//
// Each f32 operand value v is split into two TF32 values,
//
//     hi = v rounded to TF32 (10 mantissa bits; to nearest, ties away)
//     lo = (v - hi) rounded to TF32          (v - hi is exact in f32)
//
// and a . b is taken as three tensor-core products summed in f32,
//
//     a_lo . b_hi + a_hi . b_lo + a_hi . b_hi
//
// (the small terms first). Each TF32 product is exact in f32, and the
// dropped a_lo . b_lo is below 2^-22 of |a . b|, so the sum is within a
// few f32 ulps of the f32 product. A bf16 operand is exact in TF32: its
// lo is zero and its correction product is skipped at compile time.
//
// Non-finite values. The dense f32 product gives 0 * Inf = NaN and
// c * Inf = +-Inf, and both kernels keep that. A naive split breaks it:
// lo(Inf) = Inf - Inf = NaN would turn every Inf output into NaN. So
//   * the main product a_hi . b_hi takes the rounded operands as they
//     are: Inf stays Inf, a NaN stays a NaN (its quiet bit is set, so a
//     NaN whose payload lay only in the 13 bits the tensor core ignores
//     does not read as Inf), and hi is 0 exactly where v is 0 (down to
//     2^-136; a smaller subnormal has hi = 0);
//   * the two correction products take operands zeroed wherever the
//     value is not finite: lo of a non-finite value is 0, and so is its
//     hi in the corrections (`hic`).
// The corrections are then always finite, and NaN and Inf land where
// the dense product puts them. A finite value in the top binade, which
// would round up to Inf, is truncated instead (its lo stays exact).
// The fast form of the split (`split_fast`: one add and one mask per
// part) holds for finite values below 0x7f7ff000; anything else takes
// the exact form (`split_exact`), which is rare.
//
// Accumulation. The tensor core adds into its f32 accumulator without
// rounding to nearest (the sum is cut, not rounded), which over F =
// 1,024 biased `spmm_dvals` by ~1e-3, ten times its tolerance, on the
// card. So each stage's products (32 terms per output) go into fresh
// accumulators, which ordinary f32 adds then fold into the running
// sums: the cut touches only sums of 32 terms.
//
// Two tile products:
//   * `wg`: a 128 x 128 tile by two warpgroups of wgmma.m64n128k8, both
//     operands f32, K-major, 16-byte aligned rows. The ring (always: it
//     lays out its own operands) and spmm_dvals at its main path's tile
//     (TB = 128, f32 g and x, F a multiple of 4) take it. Each value is
//     split once per CUDA block, in shared memory.
//   * `TileMma`: smaller tiles by mma.sync.m16n8k8 per warp, f32 or
//     bf16 operands, any row stride: spmm_dvals' other tiles, dtypes and
//     ragged widths. Each warp splits its fragments in registers.
#pragma once

#include <type_traits>

#include "spmm_tile.cuh"

namespace gptst {
namespace tf32x3 {

constexpr int kKT = 32;  // inner-dimension slice per shared-memory stage
// |v| at or above this (as f32 bits), and NaN, take the exact split
constexpr unsigned kTopBits = 0x7f7ff000u;
constexpr unsigned kMask = 0xffffe000u;  // the 19 bits a TF32 value keeps

__device__ __forceinline__ unsigned round_tf32(unsigned u) {
  return (u + 0x1000u) & kMask;
}

__device__ __forceinline__ bool needs_exact(float v) {
  return !(fabsf(v) < __uint_as_float(kTopBits));
}

// finite v below the top: hi and lo as TF32 bit patterns
__device__ __forceinline__ void split_fast(float v, unsigned& hi,
                                          unsigned& lo) {
  hi = round_tf32(__float_as_uint(v));
  lo = round_tf32(__float_as_uint(__fsub_rn(v, __uint_as_float(hi))));
}

// any v: hi for the main product, hic and lo for the corrections
__device__ __forceinline__ void split_exact(float v, unsigned& hi,
                                           unsigned& hic, unsigned& lo) {
  const unsigned u = __float_as_uint(v);
  const unsigned a = u & 0x7fffffffu;
  if (a >= 0x7f800000u) {  // Inf, or NaN with its quiet bit set
    hi = a > 0x7f800000u ? (u | 0x00400000u) : u;
    hic = lo = 0u;
  } else {
    hi = a >= kTopBits ? (u & kMask) : round_tf32(u);
    hic = hi;
    lo = round_tf32(__float_as_uint(__fsub_rn(v, __uint_as_float(hi))));
  }
}

// d += a (16 x 8, row) . b (8 x 8, col), TF32 in, f32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    const unsigned (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// raw bits of an element, to stage it without a conversion
template <typename T>
using Raw = std::conditional_t<sizeof(T) == 4, unsigned, unsigned short>;

// C (BM x BN, f32) = A (BM x K) . B^T by mma.sync, for spmm_dvals, from
// a ring of STAGES shared-memory stages of kKT columns of A and B, both
// K-major: rows of row-major arrays with row strides lda and ldb
// (elements), staged by cp.async 16-byte copies (plain loads where a row
// stride or a ragged width breaks their alignment). Each thread checks
// the values it staged, and the barrier that publishes a stage ORs the
// checks (__syncthreads_or): a stage holding a value that needs the
// exact split runs it for all its fragments.
// Warps tile C in (WM x WN) pieces, each MT x NT fragments of 16 x 8;
// fragment (i, j) of a warp holds rows wm0 + 16 i + g (+ 8) and columns
// wn0 + 8 j + 2 t (+ 1), with g = lane / 4 and t = lane % 4.
template <typename AT, typename BT, int BM, int BN, int WM, int WN,
          int STAGES>
struct TileMma {
  static_assert(BM % WM == 0 && BN % WN == 0, "warp tiles must fit");
  static_assert(WM % 16 == 0 && WN % 8 == 0, "fragments are 16 x 8");
  static constexpr int WARPS_N = BN / WN;
  static constexpr int WARPS = (BM / WM) * WARPS_N;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int MT = WM / 16;
  static constexpr int NT = WN / 8;
  static constexpr bool A_LO = sizeof(AT) == 4;  // bf16 has no lo part
  static constexpr bool B_LO = sizeof(BT) == 4;
  // row strides of the stages (elements): 16 bytes of padding keeps the
  // fragment loads free of bank conflicts and the rows 16-byte aligned
  static constexpr int A_LD = kKT + 16 / sizeof(AT);
  static constexpr int B_LD = kKT + 16 / sizeof(BT);
  static constexpr int A_ELEMS = BM * A_LD;
  static constexpr int B_ELEMS = BN * B_LD;
  static constexpr int STAGE_BYTES =
      A_ELEMS * sizeof(AT) + B_ELEMS * sizeof(BT);
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;
  static_assert((A_ELEMS * sizeof(AT)) % 16 == 0, "stage alignment");
  static_assert(STAGE_BYTES % 16 == 0, "stage alignment");

  using Acc = float[MT][NT][4];

  __device__ static AT* stage_a(char* smem, int s) {
    return reinterpret_cast<AT*>(smem + s * STAGE_BYTES);
  }
  __device__ static BT* stage_b(char* smem, int s) {
    return reinterpret_cast<BT*>(smem + s * STAGE_BYTES +
                                 A_ELEMS * sizeof(AT));
  }

  // rows [0, rows) x columns [k0, k0 + kKT) of a row-major (., K) array
  // t into dst[rows_max][ld]; rows past `rows` and columns past K as
  // zero. With vec (t and its row stride 16-byte aligned, K a multiple
  // of a 16-byte chunk) by cp.async, else by plain loads.
  template <typename T, int ROWS, int LD>
  __device__ static void load_k_major(T* dst, const T* __restrict__ t,
                                      size_t ld, int rows, int K, int k0,
                                      bool vec) {
    constexpr int CH = 16 / sizeof(T);
    constexpr int CPR = kKT / CH;
    if (vec) {
      for (int c = threadIdx.x; c < ROWS * CPR; c += THREADS) {
        const int r = c / CPR;
        const int k = k0 + (c % CPR) * CH;
        const bool in = r < rows && k < K;
        cp_async16(dst + r * LD + (c % CPR) * CH,
                   in ? t + (size_t)r * ld + k : t, in ? 16 : 0);
      }
    } else {
      const Raw<T>* src = reinterpret_cast<const Raw<T>*>(t);
      Raw<T>* d = reinterpret_cast<Raw<T>*>(dst);
      for (int e = threadIdx.x; e < ROWS * kKT; e += THREADS) {
        const int r = e / kKT;
        const int k = k0 + e % kKT;
        d[r * LD + e % kKT] =
            (r < rows && k < K) ? src[(size_t)r * ld + k] : Raw<T>(0);
      }
    }
  }

  __device__ static void load_stage(char* smem, int s, const AT* a,
                                    size_t lda, int a_rows, const BT* b,
                                    size_t ldb, int b_extent, int K, int k0,
                                    bool vec) {
    load_k_major<AT, BM, A_LD>(stage_a(smem, s), a, lda, a_rows, K, k0, vec);
    load_k_major<BT, BN, B_LD>(stage_b(smem, s), b, ldb, b_extent, K, k0,
                               vec);
  }

  // t += the 3xTF32 products of one k8 step on staged fragments: every
  // fragment's first correction, then every second correction, then
  // every main product, so that consecutive MMAs are independent
  template <bool EXACT>
  __device__ static void mma_step(Acc& t, const float (&ar)[MT][4],
                                  const float (&br)[NT][2]) {
    unsigned ah[MT][4], ac[MT][4], al[MT][4];
    unsigned bh[NT][2], bc[NT][2], bl[NT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (EXACT) {
          split_exact(ar[i][e], ah[i][e], ac[i][e], al[i][e]);
        } else {
          split_fast(ar[i][e], ah[i][e], al[i][e]);
          ac[i][e] = ah[i][e];
        }
      }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if constexpr (EXACT) {
          split_exact(br[j][e], bh[j][e], bc[j][e], bl[j][e]);
        } else {
          split_fast(br[j][e], bh[j][e], bl[j][e]);
          bc[j][e] = bh[j][e];
        }
      }
    if constexpr (A_LO) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma(t[i][j], al[i], bc[j]);
    }
    if constexpr (B_LO) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma(t[i][j], ac[i], bl[j]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma(t[i][j], ah[i], bh[j]);
  }

  // whether the elements this thread staged into a stage hold one that
  // needs the exact split (its own copies are visible to it after
  // cp.async.wait_group; the loader's mapping)
  template <typename T, int ROWS, int LD>
  __device__ static bool own_needs_exact(const T* s, bool vec) {
    constexpr int CH = 16 / sizeof(T);
    constexpr int COLS = kKT;
    constexpr int CPR = COLS / CH;
    bool bad = false;
    if (vec) {
      for (int c = threadIdx.x; c < ROWS * CPR; c += THREADS) {
        const uint4 u = *reinterpret_cast<const uint4*>(
            s + (c / CPR) * LD + (c % CPR) * CH);
        const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int q = 0; q < CH; ++q) bad |= needs_exact(to_f32(e[q]));
      }
    } else {
      for (int e = threadIdx.x; e < ROWS * COLS; e += THREADS)
        bad |= needs_exact(to_f32(s[(e / COLS) * LD + e % COLS]));
    }
    return bad;
  }

  __device__ static bool stage_needs_exact(char* smem, int st, bool vec) {
    return own_needs_exact<AT, BM, A_LD>(stage_a(smem, st), vec) |
           own_needs_exact<BT, BN, B_LD>(stage_b(smem, st), vec);
  }

  // every k8 step of one staged slice into a fresh sum t, which an f32
  // add then folds into acc
  template <bool EXACT>
  __device__ static void compute_stage(Acc& acc, const AT* sa, const BT* sb,
                                       int wm0, int wn0) {
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    Acc sum;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKT; kk += 8) {
      float ar[MT][4], br[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const AT* p = sa + (wm0 + 16 * i + g) * A_LD + kk + t;
        ar[i][0] = to_f32(p[0]);
        ar[i][1] = to_f32(p[8 * A_LD]);
        ar[i][2] = to_f32(p[4]);
        ar[i][3] = to_f32(p[8 * A_LD + 4]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = wn0 + 8 * j + g;
        br[j][0] = to_f32(sb[n * B_LD + kk + t]);
        br[j][1] = to_f32(sb[n * B_LD + kk + t + 4]);
      }
      mma_step<EXACT>(sum, ar, br);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += sum[i][j][e];
  }

  // acc = A . B^T over K. a, b: the block's first A and B rows; a_rows
  // and b_extent of their BM and BN rows are real. Called by
  // every thread of the CUDA block; smem holds SMEM_BYTES.
  __device__ static void run(Acc& acc, char* smem, const AT* a, size_t lda,
                             int a_rows, const BT* b, size_t ldb,
                             int b_extent, int K, bool vec) {
    const int warp = threadIdx.x / 32;
    const int wm0 = (warp / WARPS_N) * WM;
    const int wn0 = (warp % WARPS_N) * WN;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    const int ktiles = (K + kKT - 1) / kKT;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < ktiles)
        load_stage(smem, s, a, lda, a_rows, b, ldb, b_extent, K, s * kKT,
                   vec);
      cp_async_commit();
    }
    for (int kt = 0; kt < ktiles; ++kt) {
      const int st = kt % STAGES;
      cp_async_wait<STAGES - 2>();
      // stage kt landed and stage kt - 1 is free; whether any thread's
      // part of stage kt needs the exact split
      const bool exact = __syncthreads_or(stage_needs_exact(smem, st, vec));
      const int nk = kt + STAGES - 1;
      if (nk < ktiles)
        load_stage(smem, nk % STAGES, a, lda, a_rows, b, ldb, b_extent, K,
                   nk * kKT, vec);
      cp_async_commit();
      if (exact) {
        compute_stage<true>(acc, stage_a(smem, st), stage_b(smem, st), wm0,
                            wn0);
      } else {
        compute_stage<false>(acc, stage_a(smem, st), stage_b(smem, st),
                             wm0, wn0);
      }
    }
    cp_async_wait<0>();
  }
};

// ---------------------------------------------------------------------
// The warpgroup product (wgmma)
// ---------------------------------------------------------------------
//
// C (128 x 128, f32) = A (128 x K) . B^T, with A and B (128 x K) both
// K-major in device memory, by two warpgroups of
// wgmma.mma_async.m64n128k8 (TF32 in, f32 accumulate), operands read
// by the tensor cores straight from shared memory.
//
// Each stage holds 32 columns of K of A and B, one 128-byte row per
// tile row, in the 128-byte swizzled K-major layout that wgmma reads:
// the 16-byte chunk c of row r sits at chunk c ^ (r % 8) of its row,
// element (r, k) at r * 128 + ((k / 4) ^ (r % 8)) * 16 + (k % 4) * 4
// bytes (tiles 1024-byte aligned). Eight consecutive threads copy one
// row, whole 128-byte lines of device memory, into eight distinct bank
// groups (without the swizzle, the same copies took three times as long
// on the card).
// Three stages are filled by cp.async 16-byte copies. When a stage has
// landed, every thread splits the chunks it copied itself: hi over the
// raw values in place, lo into one of two lo buffers (and, in a stage
// that holds a value that is not finite, hic into the hic buffer), so
// each value is split once per CUDA block. The block's 256 threads then
// issue the stage's 12 wgmmas (4 k8 steps x 3 products) into fresh
// accumulators and, while the tensor cores run them, split the next
// stage into the other lo buffer; after the wait, f32 adds fold the
// fresh sums into the running ones.
namespace wg {

constexpr int kStages = 3;
constexpr int kTileBytes = 128 * kKT * 4;             // one operand
constexpr int kStageBytes = 2 * kTileBytes;           // A and B
// + two lo buffers, hic, and 1 KB to align the tiles to 1024 bytes
constexpr int kSmemBytes = (kStages + 3) * kStageBytes + 1024;
constexpr int kThreads = 256;
constexpr int kAccs = 64;  // f32 accumulators a thread, m64n128

// matrix descriptor: 128-byte swizzle, K-major, 1024 bytes between
// 8-row groups (the leading offset is unused for this layout)
__device__ __forceinline__ unsigned long long desc(const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  return (unsigned long long)((a & 0x3ffff) >> 4) |
         (1ull << 16) | ((unsigned long long)(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void fence_operands() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// shared-memory writes of this thread, visible to the tensor cores
__device__ __forceinline__ void fence_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (+)= A (64 x 8) . B (128 x 8)^T; scale_d = 0 overwrites d
__device__ __forceinline__ void mma(float (&d)[kAccs], unsigned long long a,
                                    unsigned long long b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// chunk q (of 16 bytes) of a 128 x kKT tile: its row, its column (in
// chunks) and its swizzled byte offset
struct Chunk {
  int row, col, off;
  __device__ __forceinline__ explicit Chunk(int q) {
    row = q / 8;
    col = q % 8;
    off = row * 128 + ((col ^ (row % 8)) * 16);
  }
};
constexpr int kChunksPerThread = 128 * (kKT / 4) / kThreads;  // per operand

// rows [0, rows) x columns [k0, k0 + kKT) of a K-major f32 array t
// (row stride ld, 16-byte aligned; K a multiple of 4) into a tile,
// rows past `rows` and columns past K as zero
__device__ __forceinline__ void load_tile(char* tile,
                                          const float* __restrict__ t,
                                          size_t ld, int rows, int K,
                                          int k0) {
#pragma unroll
  for (int i = 0; i < kChunksPerThread; ++i) {
    const Chunk c(threadIdx.x + i * kThreads);
    const int k = k0 + 4 * c.col;
    const bool in = c.row < rows && k < K;
    cp_async16(tile + c.off, in ? t + (size_t)c.row * ld + k : t,
               in ? 16 : 0);
  }
}

// split this thread's chunks of a landed tile: hi in place, lo into the
// lo tile; returns whether one of them is not finite
__device__ __forceinline__ bool split_tile(char* tile, char* lo) {
  bool nonfinite = false;
#pragma unroll
  for (int i = 0; i < kChunksPerThread; ++i) {
    const Chunk c(threadIdx.x + i * kThreads);
    float4* v = reinterpret_cast<float4*>(tile + c.off);
    const float x[4] = {v->x, v->y, v->z, v->w};
    unsigned h[4], hc[4], l[4];
    bool exact = false;
#pragma unroll
    for (int e = 0; e < 4; ++e) exact |= needs_exact(x[e]);
    if (exact) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        split_exact(x[e], h[e], hc[e], l[e]);
        nonfinite |= hc[e] != h[e];
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) split_fast(x[e], h[e], l[e]);
    }
    *reinterpret_cast<uint4*>(tile + c.off) = make_uint4(h[0], h[1], h[2],
                                                         h[3]);
    *reinterpret_cast<uint4*>(lo + c.off) = make_uint4(l[0], l[1], l[2],
                                                       l[3]);
  }
  return nonfinite;
}

// hic of this thread's chunks of a split tile: hi, zeroed where not
// finite
__device__ __forceinline__ void hic_tile(const char* tile, char* hic) {
#pragma unroll
  for (int i = 0; i < kChunksPerThread; ++i) {
    const Chunk c(threadIdx.x + i * kThreads);
    uint4 u = *reinterpret_cast<const uint4*>(tile + c.off);
    unsigned* w = reinterpret_cast<unsigned*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if ((w[e] & 0x7f800000u) == 0x7f800000u) w[e] = 0u;
    *reinterpret_cast<uint4*>(hic + c.off) = u;
  }
}

// acc = A . B^T over K for the CUDA block's 128 x 128 tile; warpgroup
// w holds rows 64 w .. 64 w + 63 (accumulator layout of m64n128). a, b:
// the tile's first rows; a_rows, b_rows of their 128 rows are real.
// Every thread calls it; smem holds kSmemBytes, 128-byte aligned.
__device__ __forceinline__ void run(float (&acc)[kAccs], char* smem,
                                    const float* a, size_t lda, int a_rows,
                                    const float* b, size_t ldb, int b_rows,
                                    int K) {
  smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem) + 1023) & ~uintptr_t(1023));
  char* lo = smem + kStages * kStageBytes;  // two lo buffers
  char* hic = lo + 2 * kStageBytes;
  const int wa = (threadIdx.x / 128) * 64 * 128;  // warpgroup's rows
  const int ktiles = (K + kKT - 1) / kKT;
  auto load = [&](int k) {
    if (k < ktiles) {
      char* st = smem + (k % kStages) * kStageBytes;
      load_tile(st, a, lda, a_rows, K, k * kKT);
      load_tile(st + kTileBytes, b, ldb, b_rows, K, k * kKT);
    }
    cp_async_commit();
  };
  // split stage k (landed) into its slot and lo buffer; then publish it
  // and return whether it needs hic (which the caller's barrier
  // publishes)
  auto split = [&](int k) {
    char* st = smem + (k % kStages) * kStageBytes;
    char* l = lo + (k % 2) * kStageBytes;
    bool nonfinite = split_tile(st, l);
    nonfinite |= split_tile(st + kTileBytes, l + kTileBytes);
    fence_proxy();
    return nonfinite;
  };
  auto publish = [&](int k, bool nonfinite) {
    const bool exact = __syncthreads_or(nonfinite);
    if (exact) {  // rare: the corrections take hic
      char* st = smem + (k % kStages) * kStageBytes;
      hic_tile(st, hic);
      hic_tile(st + kTileBytes, hic + kTileBytes);
      fence_proxy();
      __syncthreads();
    }
    return exact;
  };
#pragma unroll
  for (int i = 0; i < kAccs; ++i) acc[i] = 0.f;
  float sum[kAccs];
  for (int s = 0; s < kStages - 1; ++s) load(s);
  cp_async_wait<kStages - 2>();
  bool exact = publish(0, split(0));
  for (int kt = 0; kt < ktiles; ++kt) {
    // stage kt - 1's products are done and every thread has passed the
    // barrier after them: its slot is free
    load(kt + kStages - 1);
    char* st = smem + (kt % kStages) * kStageBytes;
    const char* l = lo + (kt % 2) * kStageBytes;
    const char* ca = exact ? hic : st;
    fence_operands();
#pragma unroll
    for (int s = 0; s < kKT / 8; ++s) {
      const int ka = wa + 32 * s;  // this warpgroup's A, k8 step s
      const int kb = 32 * s;       // all 128 rows of B
      mma(sum, desc(l + ka), desc(ca + kTileBytes + kb), s);
      mma(sum, desc(ca + ka), desc(l + kTileBytes + kb), 1);
      mma(sum, desc(st + ka), desc(st + kTileBytes + kb), 1);
    }
    commit();
    // while the tensor cores run: split the next stage
    bool nonfinite = false;
    if (kt + 1 < ktiles) {
      cp_async_wait<kStages - 2>();
      nonfinite = split(kt + 1);
    }
    wait_all();
#pragma unroll
    for (int i = 0; i < kAccs; ++i) {
      asm volatile("" : "+f"(sum[i])::"memory");  // after the wait
      acc[i] += sum[i];
    }
    exact = publish(kt + 1, nonfinite);
  }
  cp_async_wait<0>();
}

}  // namespace wg

}  // namespace tf32x3
}  // namespace gptst
