// Block-CSR SpMM, Y = A . X, for Hopper (sm_90a).
//
// Replaces the three block-CSR Pallas kernels of the JAX package,
// gptst_tpu/kernels/spmm.py:_spmm_kernel, _spmm_kernel_stream and
// _spmm_kernel_panel. Those are three VMEM strategies for one
// computation (x stripe resident, x tiles streamed per block, x in
// column panels); on Hopper the sequential TPU grid becomes a parallel
// grid with a loop inside the block, and one kernel serves all three.
//
// Grid: (row tile x row piece, feature tile). Each CUDA block reads its
// own [ptr[i], ptr[i+1]) range and loops over exactly those blocks, so
// the zero pad blocks the builders append are never read: there is no
// chunk overrun to select away, and a NaN or Inf in a real block
// reaches the output.
//
// What bounds it: at the slice's shapes (16,384 nodes, 462 stored
// 128 x 128 blocks, F = 1,600) the product itself needs little: the
// blocks hold ~49k nonzeros (0.65% of their slots), ~0.16 GFLOP, so its
// least time is the ~240 MB of stored values, x and out at 3.35 TB/s,
// ~0.072 ms. This design multiplies whole blocks, 2 * 462 * 128^2 * 1600
// = 24.2 GFLOP, ~100 FLOP per byte, above the FP32 ridge (67 TFLOP/s
// over 3.35 TB/s = 20 FLOP/B): the FP32 FMA rate bounds the design at
// ~0.36 ms, five times the product's own bound. It keeps every product
// in FP32 FMAs from shared-memory tiles (16 FMAs per 8 shared loads per
// thread), with enough CUDA blocks (row tiles x 2 x 25 at that width)
// in flight to hide the loads. Skipping the zeros of nearly empty
// blocks, tensor cores (wgmma, 3xTF32) and TMA are later work.
#include "spmm_tile.cuh"

namespace {

using namespace gptst;

template <typename VT, typename XT, int TB>
__global__ void __launch_bounds__(kThreads)
bsr_spmm_kernel(const int* __restrict__ ptr, const int* __restrict__ cols,
                const VT* __restrict__ vals, const XT* __restrict__ x,
                XT* __restrict__ out, int n, int F) {
  using S = TileShape<TB>;
  __shared__ SharedTiles<S::BM> sm;
  const int i = blockIdx.x / S::SUB;
  const int r0 = (blockIdx.x % S::SUB) * S::BM;
  const int f0 = blockIdx.y * kBN;
  float acc[S::TM][4];
#pragma unroll
  for (int m = 0; m < S::TM; ++m)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[m][q] = 0.f;
  const int start = ptr[i];
  const int end = ptr[i + 1];
  for (int b = start; b < end; ++b) {
    accumulate_block<VT, XT, TB>(vals + (size_t)b * TB * TB, x, n, F,
                                 cols[b] * TB, r0, f0, acc, sm);
  }
  store_tile<XT, TB>(out, n, F, i * TB + r0, f0, acc);
}

struct Launch {
  const void* ptr;
  const void* cols;
  const void* vals;
  const void* x;
  void* out;
  int n, F, row_tiles;
  cudaStream_t stream;

  template <typename VT, typename XT, int TB>
  cudaError_t operator()() const {
    dim3 grid(row_tiles * TileShape<TB>::SUB, (F + kBN - 1) / kBN);
    bsr_spmm_kernel<VT, XT, TB><<<grid, kThreads, 0, stream>>>(
        static_cast<const int*>(ptr), static_cast<const int*>(cols),
        static_cast<const VT*>(vals), static_cast<const XT*>(x),
        static_cast<XT*>(out), n, F);
    return cudaGetLastError();
  }
};

}  // namespace

// out (n, F) = A . x (n, F); A is block-CSR with `row_tiles` row tiles
// of `tile` rows: ptr (row_tiles + 1,) int32, cols (>= ptr[-1],) int32,
// vals (>= ptr[-1], tile, tile). Dtype codes: 0 = f32, 1 = bf16; out
// has x's dtype. Returns the launch's cudaError_t (0 on success).
extern "C" int bsr_spmm(const void* ptr, const void* cols, const void* vals,
                        const void* x, void* out, int n, int F,
                        int row_tiles, int tile, int vals_bf16, int x_bf16,
                        void* stream) {
  if (n <= 0 || F <= 0 || row_tiles <= 0) return cudaErrorInvalidValue;
  Launch l{ptr, cols, vals, x, out, n, F, row_tiles,
           static_cast<cudaStream_t>(stream)};
  return dispatch(vals_bf16, x_bf16, tile, l);
}
