// Device code of the two graph-aggregation kernels, bsr_spmm and
// dia_spmm (block_spmm.cu): the entry gather below. Its constants, dtype helpers
// and `dispatch` also serve sddmm.cu and spmm_dvals.cu.
//
// The gather computes, for one row tile i of a block-CSR structure and
// one 64-wide feature tile,
//
//     Y[tile i] = sum over stored blocks b of row tile i of
//                 vals[b] . X[col tile of b]
//
// with the value of the dense block product, NaN and Inf included, but
// without multiplying the zeros of nearly empty blocks:
//
//   1. A value pass (`flag_block`, one CUDA block per stored block)
//      sets bad[b] when block b holds a value != 0 (NaN included) at a
//      slot outside its entry mask.
//   2. The main kernel (`gather_tile`, grid (row tile, feature tile),
//      the row index fastest so that one feature tile's x columns stay
//      in L2 while every row tile gathers from them) walks its row
//      tile's stored blocks in order. It stages each block's x tile (TB
//      rows x 64 features, x's dtype) in shared memory with cp.async,
//      kStages buffers deep, so that the next two blocks' tiles arrive
//      while one is summed, and ORs over the CUDA block whether the
//      staged tile, rounded to the value dtype, holds a non-finite
//      value. If the tile is clean and bad[b] is 0, each output row adds
//      only its entries of block b, in k order:
//          acc[r] += vals[b, r % TB, k] * xs[k, f].
//      Otherwise the block runs densely on the same staged tile, zeros
//      included, and one is added to the dense counter.
//
// For a clean block the skipped terms are 0 * finite = +-0, which leave
// the f32 sum unchanged except for the sign of a zero; entries are
// summed in the dense loop's order. A non-finite x or value sends its
// block, and only that block, down the dense path, so NaN and Inf land
// where the dense product puts them.
//
// Threads: kGatherWarps warps (8 for TB = 16); warp w owns the RPW =
// TB / warps consecutive rows w * RPW + m of the row tile, in pairs:
// half-warp h sums row 2p + h of pair p, lane l of the half features
// 4l .. 4l + 3. For each block, lane l of a half reads its row's l-th
// next entry and that entry's value before the block's barrier, so the
// loads overlap it. The entries are then broadcast with width-16
// shuffles, every pair of the warp stepping together (RPW / 2
// independent FMA chains, no branch: a half whose row is done adds
// 0 * a finite x). Lane m keeps row m's cursor into its entry list. One
// barrier per block publishes the staged tile and frees the buffer
// refilled next. At TB = 128 a CUDA block (512 threads, 64 registers
// each, 96 KB of staged tiles) shares its SM with one other.
// x is cast to the value dtype before the product, the sum is f32, and
// the output is written in x's dtype. Rows past n, features past F and
// x rows past n read as zero (and never make a tile non-finite); output
// rows past n are never written.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace gptst {

constexpr int kThreads = 256;
constexpr int kGatherWarps = 16;  // most warps per CUDA block of the gather
constexpr int kBN = 64;     // feature columns per CUDA block of the gather
constexpr int kStages = 3;  // staged x tiles per CUDA block of the gather
constexpr int kBK = 16;     // inner-dimension slice per shared-memory stage

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// x rounded to the value dtype (exact when the value dtype is f32)
template <typename VT>
__device__ __forceinline__ float as_vals_dtype(float v);
template <>
__device__ __forceinline__ float as_vals_dtype<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float as_vals_dtype<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int TB>
struct TileShape {
  static_assert(TB % 16 == 0, "tile must be a multiple of 16");
  static constexpr int BM = TB < 64 ? TB : 64;  // output rows per block
  static constexpr int SUB = TB / BM;           // row pieces per row tile
  static constexpr int TM = BM / 16;            // rows per thread
};

// ---------------------------------------------------------------------
// The entry gather
// ---------------------------------------------------------------------

constexpr int log2i(int v) { return v <= 1 ? 0 : 1 + log2i(v / 2); }

template <int TB>
struct GatherShape {
  static_assert(TB >= 16 && (TB & (TB - 1)) == 0,
                "tile must be a power of two, at least 16");
  static constexpr int WARPS = TB / 2 < kGatherWarps ? TB / 2 : kGatherWarps;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int RPW = TB / WARPS;        // rows per warp (pairs)
  static constexpr int WORDS = (TB + 31) / 32;  // mask words per block row
  static constexpr int LOG_TB = log2i(TB);
};

// 16-byte chunks of a staged x tile: CH elements each, CPR per tile row
template <typename XT>
struct Chunks {
  static constexpr int CH = 16 / sizeof(XT);
  static constexpr int CPR = kBN / CH;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x rows [xrow0, xrow0 + TB) x features [f0, f0 + kBN) into dst[TB][kBN]
// (x's dtype), rows past n and features past F as zero. With `vec` (x
// and out 16 bytes aligned, F a multiple of CH: a chunk lies wholly
// inside or wholly outside F) by cp.async; without, by plain loads.
template <typename XT, int TB>
__device__ __forceinline__ void stage_x(XT* dst, const XT* __restrict__ x,
                                        int n, int F, int xrow0, int f0,
                                        bool vec) {
  using C = Chunks<XT>;
  for (int c = threadIdx.x; c < TB * C::CPR; c += GatherShape<TB>::THREADS) {
    const int k = c / C::CPR;
    const int col = f0 + (c % C::CPR) * C::CH;
    const int row = xrow0 + k;
    XT* d = dst + k * kBN + (c % C::CPR) * C::CH;
    if (vec) {
      const bool in = row < n && col < F;
      cp_async16(d, in ? x + (size_t)row * F + col : x, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < C::CH; ++e) {
        const bool in = row < n && col + e < F;
        store(d + e, in ? to_f32(x[(size_t)row * F + col + e]) : 0.f);
      }
    }
  }
}

// whether the chunks this thread staged hold a value that is not finite
// once rounded to the value dtype (its own copies are visible to it
// after cp.async.wait_group)
template <typename VT, typename XT, int TB>
__device__ __forceinline__ bool staged_nonfinite(const XT* t) {
  using C = Chunks<XT>;
  bool bad = false;
  for (int c = threadIdx.x; c < TB * C::CPR; c += GatherShape<TB>::THREADS) {
    const uint4 u = *reinterpret_cast<const uint4*>(
        t + (c / C::CPR) * kBN + (c % C::CPR) * C::CH);
    const XT* e = reinterpret_cast<const XT*>(&u);
#pragma unroll
    for (int q = 0; q < C::CH; ++q) {
      const unsigned bits = __float_as_uint(as_vals_dtype<VT>(to_f32(e[q])));
      bad |= (bits & 0x7f800000u) == 0x7f800000u;
    }
  }
  return bad;
}

// features 4h .. 4h + 3 of a staged tile row, rounded to the value dtype
template <typename VT>
__device__ __forceinline__ float4 load4(const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  return make_float4(as_vals_dtype<VT>(v.x), as_vals_dtype<VT>(v.y),
                     as_vals_dtype<VT>(v.z), as_vals_dtype<VT>(v.w));
}
template <typename VT>
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(
      as_vals_dtype<VT>(__low2float(lo)), as_vals_dtype<VT>(__high2float(lo)),
      as_vals_dtype<VT>(__low2float(hi)), as_vals_dtype<VT>(__high2float(hi)));
}

__device__ __forceinline__ void fma4(float (&acc)[4], float a, float4 x) {
  acc[0] = fmaf(a, x.x, acc[0]);
  acc[1] = fmaf(a, x.y, acc[1]);
  acc[2] = fmaf(a, x.z, acc[2]);
  acc[3] = fmaf(a, x.w, acc[3]);
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                 *reinterpret_cast<const unsigned*>(&hi));
}

// The next (up to) 16 entries of each row pair's two rows, one per lane
// of the row's half-warp, from the cursors (lane m holds row m's), and
// the values of those in block b (0 for the others).
template <typename VT, int TB, int PAIRS>
__device__ __forceinline__ void load_windows(
    const int* __restrict__ eidx, const VT* __restrict__ blk, int b, int r0,
    int cur, int end, int (&ent)[PAIRS], float (&av)[PAIRS]) {
  constexpr int LOG_TB = GatherShape<TB>::LOG_TB;
  const int half = (threadIdx.x % 32) / 16;
  const int hl = threadIdx.x % 16;
#pragma unroll
  for (int p = 0; p < PAIRS; ++p) {
    const int row = 2 * p + half;
    const int j = __shfl_sync(0xffffffffu, cur, row) + hl;
    ent[p] = j < __shfl_sync(0xffffffffu, end, row) ? eidx[j] : -1;
  }
#pragma unroll
  for (int p = 0; p < PAIRS; ++p) {
    const bool hit = (ent[p] >> LOG_TB) == b;
    av[p] = hit ? to_f32(blk[(size_t)(r0 + 2 * p + half) * TB +
                             (ent[p] & (TB - 1))])
                : 0.f;
  }
}

template <typename VT, typename XT, int TB>
__device__ __forceinline__ void gather_tile(
    const int* __restrict__ ptr, const int* __restrict__ cols,
    const VT* __restrict__ vals, const int* __restrict__ eptr,
    const int* __restrict__ eidx, const int* __restrict__ bad,
    const XT* __restrict__ x, XT* __restrict__ out, int* dense_count, int n,
    int F, bool vec) {
  using G = GatherShape<TB>;
  constexpr int PAIRS = G::RPW / 2;
  constexpr int TILE = TB * kBN;  // elements of one staged x tile
  constexpr unsigned ALL = 0xffffffffu;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  XT* xs = reinterpret_cast<XT*>(smem_raw);
  const int i = blockIdx.x;
  const int f0 = blockIdx.y * kBN;
  const int lane = threadIdx.x % 32;
  const int half = lane / 16;  // the row of each pair this lane sums
  const int hl = lane % 16;    // its features: 4 hl .. 4 hl + 3
  const int r0 = (threadIdx.x / 32) * G::RPW;  // the warp's first row
  // lane m < RPW holds the cursor and end of row r0 + m's entries
  int cur = 0, end = 0;
  if (lane < G::RPW) {
    cur = eptr[i * TB + r0 + lane];
    end = eptr[i * TB + r0 + lane + 1];
  }
  float acc[PAIRS][4];
#pragma unroll
  for (int p = 0; p < PAIRS; ++p)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[p][c] = 0.f;

  const int start = ptr[i];
  const int stop = ptr[i + 1];
  // blocks start, start + 1 in flight; then, while block b is summed,
  // blocks b + 1 and b + 2
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (start + s < stop) {
      stage_x<XT, TB>(xs + s * TILE, x, n, F, cols[start + s] * TB, f0, vec);
    }
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();
  bool nonfinite = start < stop && staged_nonfinite<VT, XT, TB>(xs);
  for (int b = start; b < stop; ++b) {
    const int j = b - start;
    const XT* t = xs + (j % kStages) * TILE;
    const VT* blk = vals + (size_t)b * TB * TB;
    int ent[PAIRS];
    float av[PAIRS];
    load_windows<VT, TB, PAIRS>(eidx, blk, b, r0, cur, end, ent, av);
    // every thread has checked its chunks of block b's tile, and every
    // warp is done with the buffer refilled below (block b - 1's)
    const bool dense = __syncthreads_or(nonfinite) || bad[b] != 0;
    if (b + kStages - 1 < stop) {
      stage_x<XT, TB>(xs + ((j + kStages - 1) % kStages) * TILE, x, n, F,
                      cols[b + kStages - 1] * TB, f0, vec);
    }
    cp_async_commit();
    if (dense) {
      if (threadIdx.x == 0) atomicAdd(dense_count, 1);
      for (int k = 0; k < TB; ++k) {
        const float4 xv = load4<VT>(t + k * kBN + 4 * hl);
#pragma unroll
        for (int p = 0; p < PAIRS; ++p) {
          fma4(acc[p], to_f32(blk[(size_t)(r0 + 2 * p + half) * TB + k]), xv);
        }
      }
    }
    // block b's entries are a prefix of each window (a row's entries
    // are sorted by block); all row pairs step together (a branch per
    // pair costs more than it saves), a half-warp whose row is done
    // adding 0 * (a finite x)
    for (;;) {
      int most = 0;
      bool full = false;
#pragma unroll
      for (int p = 0; p < PAIRS; ++p) {
        const unsigned hits =
            __ballot_sync(ALL, (ent[p] >> G::LOG_TB) == b);
        const int c0 = __popc(hits & 0xffffu);
        const int c1 = __popc(hits >> 16);
        most = max(most, max(c0, c1));
        full |= c0 == 16 || c1 == 16;
        if (lane == 2 * p) cur += c0;
        if (lane == 2 * p + 1) cur += c1;
      }
      if (!dense) {
        for (int q = 0; q < most; ++q) {
#pragma unroll
          for (int p = 0; p < PAIRS; ++p) {
            const int k = __shfl_sync(ALL, ent[p] & (TB - 1), q, 16);
            const float a = __shfl_sync(ALL, av[p], q, 16);
            fma4(acc[p], a, load4<VT>(t + k * kBN + 4 * hl));
          }
        }
      }
      if (!full) break;  // a row with more: its next 16 entries
      load_windows<VT, TB, PAIRS>(eidx, blk, b, r0, cur, end, ent, av);
    }
    // check the next block's tile (this thread's chunks) once it lands
    cp_async_wait<kStages - 2>();
    nonfinite = b + 1 < stop &&
                staged_nonfinite<VT, XT, TB>(xs + ((j + 1) % kStages) * TILE);
  }

  const int col = f0 + 4 * hl;
#pragma unroll
  for (int p = 0; p < PAIRS; ++p) {
    const int row = i * TB + r0 + 2 * p + half;
    if (row >= n || col >= F) continue;
    XT* o = out + (size_t)row * F + col;
    if (vec) {  // F a multiple of 4: the four features in one store
      store4(o, acc[p]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (col + c < F) store(o + c, acc[p][c]);
      }
    }
  }
}

// bad[b] = whether block b holds a value != 0 (NaN included) outside its
// entry mask (TB rows of WORDS 32-bit words, bit k % 32 of word k / 32);
// four slots per thread and step
template <typename VT, int TB>
__device__ __forceinline__ void flag_block(const VT* __restrict__ vals,
                                           const unsigned* __restrict__ mask,
                                           int* __restrict__ bad) {
  constexpr int W = GatherShape<TB>::WORDS;
  const int b = blockIdx.x;
  const VT* blk = vals + (size_t)b * TB * TB;
  const unsigned* mb = mask + (size_t)b * TB * W;
  bool hit = false;
#pragma unroll
  for (int s = 4 * threadIdx.x; s < TB * TB; s += 4 * kThreads) {
    const int r = s / TB;
    const int k = s % TB;
    const unsigned bits = mb[r * W + k / 32] >> (k % 32);
    const float4 v = load4<float>(blk + s);
    hit |= (!(bits & 1u) && v.x != 0.f) || (!(bits & 2u) && v.y != 0.f) ||
           (!(bits & 4u) && v.z != 0.f) || (!(bits & 8u) && v.w != 0.f);
  }
  hit = __syncthreads_or(hit);
  if (threadIdx.x == 0) bad[b] = hit;
}

// Arguments of the C entry points bsr_spmm and dia_spmm (block_spmm.cu)
struct GatherArgs {
  const void* ptr;
  const void* cols;
  const void* vals;
  const void* eptr;
  const void* eidx;
  const void* mask;
  void* bad;
  void* dense_count;
  const void* x;
  void* out;
  int n, F, row_tiles, nblocks;
  cudaStream_t stream;
};

// The value pass `flag` over every block, then the main kernel `gather`
template <typename VT, typename XT, int TB, typename Flag, typename Gather>
cudaError_t launch_gather(const GatherArgs& a, Flag flag, Gather gather) {
  flag<<<a.nblocks, kThreads, 0, a.stream>>>(
      static_cast<const VT*>(a.vals), static_cast<const unsigned*>(a.mask),
      static_cast<int*>(a.bad));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem = kStages * TB * kBN * sizeof(XT);  // staged x tiles
  err = cudaFuncSetAttribute(
      gather, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int vec = a.F % Chunks<XT>::CH == 0 &&
                  reinterpret_cast<uintptr_t>(a.x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(a.out) % 16 == 0;
  dim3 grid(a.row_tiles, (a.F + kBN - 1) / kBN);
  gather<<<grid, GatherShape<TB>::THREADS, smem, a.stream>>>(
      static_cast<const int*>(a.ptr), static_cast<const int*>(a.cols),
      static_cast<const VT*>(a.vals), static_cast<const int*>(a.eptr),
      static_cast<const int*>(a.eidx), static_cast<const int*>(a.bad),
      static_cast<const XT*>(a.x), static_cast<XT*>(a.out),
      static_cast<int*>(a.dense_count), a.n, a.F, vec);
  return cudaGetLastError();
}

// Calls body.template operator()<VT, XT, TB>() for the runtime dtype
// codes (0 = f32, 1 = bf16) and tile; returns cudaErrorInvalidValue for
// a combination the kernels are not built for.
template <typename Body>
cudaError_t dispatch(int vals_bf16, int x_bf16, int tile, Body body) {
#define GPTST_TILE(VT, XT)                                         \
  switch (tile) {                                                  \
    case 16: return body.template operator()<VT, XT, 16>();        \
    case 32: return body.template operator()<VT, XT, 32>();        \
    case 64: return body.template operator()<VT, XT, 64>();        \
    case 128: return body.template operator()<VT, XT, 128>();      \
    default: return cudaErrorInvalidValue;                         \
  }
  if (!vals_bf16 && !x_bf16) { GPTST_TILE(float, float) }
  if (!vals_bf16 && x_bf16) { GPTST_TILE(float, __nv_bfloat16) }
  if (vals_bf16 && !x_bf16) { GPTST_TILE(__nv_bfloat16, float) }
  GPTST_TILE(__nv_bfloat16, __nv_bfloat16)
#undef GPTST_TILE
}

}  // namespace gptst
