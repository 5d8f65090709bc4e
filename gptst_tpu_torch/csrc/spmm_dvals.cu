// Gradient of the learned block values of the block-CSR SpMM, for
// Hopper (sm_90a):
//
//     dvals[b] = G[row tile of b] . X[col tile of b]^T      (TB x TB, f32)
//
// summed over the F feature columns, with the 8 pad blocks
// (b >= ptr[row_tiles]) written as zeros.
//
// Replaces gptst_tpu/kernels/spmm.py:_dvals_kernel (through
// _spmm_dvals). The TPU kernel carries the sum over feature tiles across
// sequential grid steps (pl.when(j == 0) / +=). Blocks of a CUDA grid
// run in no order, so here each CUDA block owns one (BM x BN) piece of
// one stored block's output and loops over all of F itself: no atomics,
// no second pass, and the result is the same on every run. The row tile
// of block b is found by a binary search of ptr in the block, so the
// wrapper needs no searchsorted and no host sync.
//
// What bounds it: the function computes every slot of each stored
// block, 2 * nnzb * TB^2 * F FLOPs: 4.29 GFLOP for the CLI graph's
// 128-block pattern at TB = 128, F = 1,024. As 3xTF32 on the tensor
// cores that is 0.026 ms at 495 TFLOP/s; its bytes (g and x, 2 x 16,384
// x 1,024 x 4 B, and ~8.9 MB of blocks out) take ~0.043 ms at 3.35
// TB/s. It is bound by bytes (0.064 ms on the FP32 pipe, which bound
// the earlier FP32-FMA design).
//
// Design: the f32 product on the tensor cores as 3xTF32 (tf32x3.cuh),
// both operands K-major straight from device memory (G rows and X rows
// are contiguous in F), each CUDA block looping over all of F:
//   * the main path's case (TB = 128, f32 g and x, F a multiple of 4,
//     16-byte aligned): one stored block per CUDA block, 128 x 128 by
//     two warpgroups of wgmma (tf32x3.cuh `wg`, as ring_spmm), slices
//     of 32 features through 3 swizzled shared-memory stages; the CLI
//     pattern's 128 blocks are one wave on the 132 SMs;
//   * every other tile, dtype or width: a 64 x 64 piece per CUDA block
//     (TB x TB for smaller tiles) of 32 x 32 warp tiles by mma.sync
//     (`TileMma`), 4 stages filled by cp.async 16-byte copies (plain
//     loads for a ragged F or an unaligned row). A bf16 operand is
//     exact in TF32, so its correction product is skipped: a bf16/bf16
//     launch runs one product.
//
// Non-finite values: every slot is summed, zeros included; the main
// product g_hi . x_hi carries Inf and NaN as the dense f32 product does
// (0 * Inf = NaN, c * Inf = +-Inf), and the two correction products
// take the operands zeroed where they are not finite (tf32x3.cuh).
#include "tf32x3.cuh"

namespace {

using namespace gptst;

template <typename GT, typename XT, int TB>
struct Dvals {
  static_assert(TB % 16 == 0, "tile must be a multiple of 16");
  static constexpr int BM = TB < 64 ? TB : 64;  // piece rows and columns
  static constexpr int PIECES_N = TB / BM;      // pieces per block row
  static constexpr int PIECES = PIECES_N * PIECES_N;
  static constexpr int WM = BM / 2 < 16 ? 16 : BM / 2;  // warp tile side
  using Tile = tf32x3::TileMma<GT, XT, BM, BM, WM, WM, 4>;
};

// the row tile i with ptr[i] <= b < ptr[i + 1], for a real block b
__device__ __forceinline__ int row_of_block(const int* __restrict__ ptr,
                                            int row_tiles, int b) {
  int lo = 0, hi = row_tiles;  // ptr[lo] <= b < ptr[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (ptr[mid] <= b) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <typename GT, typename XT, int TB>
__global__ void __launch_bounds__(Dvals<GT, XT, TB>::Tile::THREADS)
spmm_dvals_kernel(const int* __restrict__ ptr, const int* __restrict__ cols,
                  const GT* __restrict__ g, const XT* __restrict__ x,
                  float* __restrict__ out, int n, int F, int row_tiles,
                  int vec) {
  using D = Dvals<GT, XT, TB>;
  using Tile = typename D::Tile;
  extern __shared__ __align__(16) char smem[];
  const int b = blockIdx.x;
  const int r0 = (blockIdx.y / D::PIECES_N) * D::BM;
  const int c0 = (blockIdx.y % D::PIECES_N) * D::BM;
  typename Tile::Acc acc;
  if (b < ptr[row_tiles]) {  // a real block; pad blocks stay zero
    const int grow0 = row_of_block(ptr, row_tiles, b) * TB + r0;
    const int xrow0 = cols[b] * TB + c0;
    Tile::run(acc, smem, g + (size_t)grow0 * F, (size_t)F, n - grow0,
              x + (size_t)xrow0 * F, (size_t)F, n - xrow0, F, vec != 0);
  } else {
#pragma unroll
    for (int i = 0; i < Tile::MT; ++i)
#pragma unroll
      for (int j = 0; j < Tile::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm0 = r0 + (warp / Tile::WARPS_N) * D::WM;
  const int wn0 = c0 + (warp % Tile::WARPS_N) * D::WM;
  float* blk = out + (size_t)b * TB * TB;
#pragma unroll
  for (int i = 0; i < Tile::MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < Tile::NT; ++j) {
        const int row = wm0 + 16 * i + lane / 4 + 8 * h;
        const int col = wn0 + 8 * j + 2 * (lane % 4);
        *reinterpret_cast<float2*>(blk + (size_t)row * TB + col) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
}

// The main path's case (TB = 128, f32 g and x, F a multiple of 4,
// 16-byte aligned rows): a stored block per CUDA block, by the
// warpgroup product of tf32x3.cuh (`wg`, as ring_spmm): C = G[row tile]
// . X[col tile]^T, both K-major.
namespace wg = tf32x3::wg;

__global__ void __launch_bounds__(wg::kThreads, 1)
spmm_dvals_kernel_wgmma(const int* __restrict__ ptr,
                        const int* __restrict__ cols,
                        const float* __restrict__ g,
                        const float* __restrict__ x,
                        float* __restrict__ out, int n, int F,
                        int row_tiles) {
  extern __shared__ __align__(1024) char smem[];
  const int b = blockIdx.x;
  float c[wg::kAccs];
  if (b < ptr[row_tiles]) {  // a real block; pad blocks stay zero
    const int r0 = row_of_block(ptr, row_tiles, b) * 128;
    const int x0 = cols[b] * 128;
    wg::run(c, smem, g + (size_t)r0 * F, (size_t)F, n - r0,
            x + (size_t)x0 * F, (size_t)F, n - x0, F);
  } else {
#pragma unroll
    for (int i = 0; i < wg::kAccs; ++i) c[i] = 0.f;
  }
  // the m64n128 accumulator layout (see ring_spmm.cu)
  const int lane = threadIdx.x % 32;
  const int r = 16 * (threadIdx.x / 32) + lane / 4;
  float* blk = out + (size_t)b * 128 * 128;
#pragma unroll
  for (int j = 0; j < wg::kAccs / 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(blk + (size_t)(r + 8 * h) * 128 + 8 * j +
                                 2 * (lane % 4)) =
          make_float2(c[4 * j + 2 * h], c[4 * j + 2 * h + 1]);
}

struct Launch {
  const void* ptr;
  const void* cols;
  const void* g;
  const void* x;
  void* out;
  int n, F, row_tiles, nnzb;
  cudaStream_t stream;

  template <typename GT, typename XT, int TB>
  cudaError_t operator()() const {
    if constexpr (TB == 128 && sizeof(GT) == 4 && sizeof(XT) == 4) {
      if (F % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(x) % 16 == 0) {
        cudaError_t err = cudaFuncSetAttribute(
            spmm_dvals_kernel_wgmma,
            cudaFuncAttributeMaxDynamicSharedMemorySize, wg::kSmemBytes);
        if (err != cudaSuccess) return err;
        spmm_dvals_kernel_wgmma<<<nnzb, wg::kThreads, wg::kSmemBytes,
                                  stream>>>(
            static_cast<const int*>(ptr), static_cast<const int*>(cols),
            static_cast<const float*>(g), static_cast<const float*>(x),
            static_cast<float*>(out), n, F, row_tiles);
        return cudaGetLastError();
      }
    }
    using D = Dvals<GT, XT, TB>;
    using Tile = typename D::Tile;
    const auto kernel = spmm_dvals_kernel<GT, XT, TB>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Tile::SMEM_BYTES);
    if (err != cudaSuccess) return err;
    // 16-byte copies need 16-byte rows in both dtypes
    const int vec = F % (16 / sizeof(GT)) == 0 &&
                    F % (16 / sizeof(XT)) == 0 &&
                    reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
    dim3 grid(nnzb, D::PIECES);
    kernel<<<grid, Tile::THREADS, Tile::SMEM_BYTES, stream>>>(
        static_cast<const int*>(ptr), static_cast<const int*>(cols),
        static_cast<const GT*>(g), static_cast<const XT*>(x),
        static_cast<float*>(out), n, F, row_tiles, vec);
    return cudaGetLastError();
  }
};

}  // namespace

// out (nnzb, tile, tile) f32: out[b] = g[row tile of b] . x[cols[b]]^T
// over the F columns of g, x (n, F), for b < ptr[row_tiles]; zero for the
// pad blocks after them. ptr (row_tiles + 1,) int32, cols (nnzb,) int32.
// Dtype codes: 0 = f32, 1 = bf16. Returns the launch's cudaError_t.
extern "C" int spmm_dvals(const void* ptr, const void* cols, const void* g,
                          const void* x, void* out, int n, int F,
                          int row_tiles, int nnzb, int tile, int g_bf16,
                          int x_bf16, void* stream) {
  if (n <= 0 || F <= 0 || row_tiles <= 0 || nnzb <= 0)
    return cudaErrorInvalidValue;
  Launch l{ptr, cols, g, x, out, n, F, row_tiles, nnzb,
           static_cast<cudaStream_t>(stream)};
  return dispatch(g_bf16, x_bf16, tile, l);
}
