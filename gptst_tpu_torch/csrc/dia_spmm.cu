// Tile-diagonal band SpMM, Y = A . X, for Hopper (sm_90a).
//
// Replaces gptst_tpu/kernels/spmm.py:_dia_kernel and its opt-in
// ring-buffered twin _dia_kernel_ring: both compute, for row tile i,
//
//     Y[tile i] = sum_{d < 2w+1} vals[i, d] . X[tile clamp(i + d - w, 0, rt - 1)]
//
// and differ only in how the TPU kept the x window in VMEM. Here the
// grid is (row tile x row piece, feature tile) and each CUDA block sums
// its 2w+1 products. The clamp-and-multiply is kept: an edge row tile
// multiplies its structurally zero band blocks with the clamped x tile,
// so a non-finite x behaves as it does in the JAX package.
//
// What bounds it: on the road graph at 16,384 nodes (w = 1, vals
// (128, 3, 128, 128)) and F = 1,600 the band holds ~0.25M nonzeros
// (4% of its slots), ~0.8 GFLOP, so the product's least time is the
// ~235 MB of band, x and out at 3.35 TB/s, ~0.070 ms. This design
// multiplies whole band blocks, 2 * 128 * 3 * 128^2 * 1600 = 20.1 GFLOP,
// ~85 FLOP per byte, above the FP32 ridge of ~20 FLOP/B: the FP32 FMA
// rate bounds the design at ~0.30 ms. It is the design of bsr_spmm.cu
// (FP32 FMAs from shared-memory tiles, no TF32); the band needs no
// index loads at all.
#include "spmm_tile.cuh"

namespace {

using namespace gptst;

template <typename VT, typename XT, int TB>
__global__ void __launch_bounds__(kThreads)
dia_spmm_kernel(const VT* __restrict__ vals, const XT* __restrict__ x,
                XT* __restrict__ out, int n, int F, int row_tiles, int w) {
  using S = TileShape<TB>;
  __shared__ SharedTiles<S::BM> sm;
  const int i = blockIdx.x / S::SUB;
  const int r0 = (blockIdx.x % S::SUB) * S::BM;
  const int f0 = blockIdx.y * kBN;
  const int ndiag = 2 * w + 1;
  float acc[S::TM][4];
#pragma unroll
  for (int m = 0; m < S::TM; ++m)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[m][q] = 0.f;
  for (int d = 0; d < ndiag; ++d) {
    const int c = min(max(i + d - w, 0), row_tiles - 1);
    accumulate_block<VT, XT, TB>(vals + ((size_t)i * ndiag + d) * TB * TB,
                                 x, n, F, c * TB, r0, f0, acc, sm);
  }
  store_tile<XT, TB>(out, n, F, i * TB + r0, f0, acc);
}

struct Launch {
  const void* vals;
  const void* x;
  void* out;
  int n, F, row_tiles, w;
  cudaStream_t stream;

  template <typename VT, typename XT, int TB>
  cudaError_t operator()() const {
    dim3 grid(row_tiles * TileShape<TB>::SUB, (F + kBN - 1) / kBN);
    dia_spmm_kernel<VT, XT, TB><<<grid, kThreads, 0, stream>>>(
        static_cast<const VT*>(vals), static_cast<const XT*>(x),
        static_cast<XT*>(out), n, F, row_tiles, w);
    return cudaGetLastError();
  }
};

}  // namespace

// out (n, F) = A . x (n, F); A is a band of half-width w tiles stored
// as vals (row_tiles, 2w+1, tile, tile). Dtype codes: 0 = f32,
// 1 = bf16; out has x's dtype. Returns the launch's cudaError_t.
extern "C" int dia_spmm(const void* vals, const void* x, void* out, int n,
                        int F, int row_tiles, int w, int tile, int vals_bf16,
                        int x_bf16, void* stream) {
  if (n <= 0 || F <= 0 || row_tiles <= 0 || w < 0) {
    return cudaErrorInvalidValue;
  }
  Launch l{vals, x, out, n, F, row_tiles, w,
           static_cast<cudaStream_t>(stream)};
  return dispatch(vals_bf16, x_bf16, tile, l);
}
