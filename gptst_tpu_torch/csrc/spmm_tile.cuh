// Shared tile loop of the two graph-aggregation kernels (bsr_spmm.cu,
// dia_spmm.cu): one CUDA block owns a (BM rows x BN features) piece of
// an output row tile and accumulates, block by block of the adjacency,
//
//     acc += vals_block[r0:r0+BM, :] . X[col_tile*TB : col_tile*TB+TB, f0:f0+BN]
//
// in FP32 FMAs from shared-memory tiles (no tensor cores, so no TF32:
// f32 inputs keep full f32 products, as the reference's 'highest'
// precision does). x is cast to the value dtype before the product,
// the sum is f32, and the output is written in x's dtype.
//
// Thread layout: 256 threads as 16 x 16; thread (ty, tx) owns rows
// ty + 16*m (m < BM/16) and features tx + 16*q (q < 4). Rows past the
// node count and features past F are masked: they read as zero and
// are never written, so callers pass unpadded (n, F) operands.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace gptst {

constexpr int kThreads = 256;
constexpr int kBN = 64;  // feature columns per CUDA block
constexpr int kBK = 16;  // inner-dimension slice per shared-memory stage

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

template <int BM>
struct SharedTiles {
  float a[kBK][BM + 1];  // block slice, k-major; +1 breaks bank conflicts
  float x[kBK][kBN];
};

// acc += blk[r0:r0+BM, :] . X[xrow0 : xrow0+TB, f0:f0+kBN]
template <typename VT, typename XT, int TB>
__device__ __forceinline__ void accumulate_block(
    const VT* __restrict__ blk, const XT* __restrict__ x, int n, int F,
    int xrow0, int r0, int f0, float (&acc)[TileShape<TB>::TM][4],
    SharedTiles<TileShape<TB>::BM>& sm) {
  constexpr int BM = TileShape<TB>::BM;
  constexpr int TM = TileShape<TB>::TM;
  const int t = threadIdx.x;
  const int ty = t / 16;
  const int tx = t % 16;
  for (int k0 = 0; k0 < TB; k0 += kBK) {
#pragma unroll
    for (int j = 0; j < BM * kBK / kThreads; ++j) {
      const int idx = t + j * kThreads;
      const int r = idx / kBK;
      const int kk = idx % kBK;
      sm.a[kk][r] = to_f32(blk[(size_t)(r0 + r) * TB + k0 + kk]);
    }
#pragma unroll
    for (int j = 0; j < kBK * kBN / kThreads; ++j) {
      const int idx = t + j * kThreads;
      const int kk = idx / kBN;
      const int c = idx % kBN;
      const int row = xrow0 + k0 + kk;
      const int col = f0 + c;
      float v = 0.f;
      if (row < n && col < F) {
        v = as_vals_dtype<VT>(to_f32(x[(size_t)row * F + col]));
      }
      sm.x[kk][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM];
      float b[4];
#pragma unroll
      for (int m = 0; m < TM; ++m) a[m] = sm.a[kk][ty + 16 * m];
#pragma unroll
      for (int q = 0; q < 4; ++q) b[q] = sm.x[kk][tx + 16 * q];
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][q] = fmaf(a[m], b[q], acc[m][q]);
    }
    __syncthreads();
  }
}

template <typename XT, int TB>
__device__ __forceinline__ void store_tile(
    XT* __restrict__ out, int n, int F, int row0, int f0,
    const float (&acc)[TileShape<TB>::TM][4]) {
  constexpr int TM = TileShape<TB>::TM;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int row = row0 + ty + 16 * m;
    if (row >= n) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = f0 + tx + 16 * q;
      if (col < F) store(out + (size_t)row * F + col, acc[m][q]);
    }
  }
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
