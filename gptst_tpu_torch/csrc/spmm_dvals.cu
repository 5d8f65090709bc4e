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
// block, 2 * nnzb * TB^2 * F FLOPs (12.8 GFLOP for the 382-block road
// pattern at F = 1024), against ~0.16 GB of g, x and out: ~80 FLOP per
// byte, above the FP32 ridge (67 TFLOP/s over 3.35 TB/s = 20 FLOP/B),
// so the FP32 FMA rate bounds it (~0.19 ms). The design keeps every
// product in FP32 FMAs from shared-memory slices of g and x (16 FMAs per
// 8 shared loads per thread), with nnzb x 4 CUDA blocks in flight at
// TB = 128. Tensor cores (3xTF32 or bf16 wgmma), TMA, and computing only
// the pattern's slots (the softmax mask zeroes ~96% of them downstream)
// are later work.
#include "spmm_tile.cuh"

namespace {

using namespace gptst;

template <int TB>
struct DvalsShape {
  static_assert(TB % 16 == 0, "tile must be a multiple of 16");
  static constexpr int BM = TB < 64 ? TB : 64;  // output rows per block
  static constexpr int BN = BM;                 // output columns per block
  static constexpr int PIECES = TB / BN;        // column pieces per row
  static constexpr int TM = BM / 16;            // rows per thread
  static constexpr int TN = BN / 16;            // columns per thread
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

// rows [row0, row0 + ROWS) x features [f0, f0 + kBK) of t (n, F) into
// s[k][row], reading rows past n and features past F as zero
template <int ROWS, typename T>
__device__ __forceinline__ void load_slice(const T* __restrict__ t, int n,
                                           int F, int row0, int f0,
                                           float (&s)[kBK][ROWS + 1]) {
#pragma unroll
  for (int j = 0; j < ROWS * kBK / kThreads; ++j) {
    const int idx = threadIdx.x + j * kThreads;
    const int r = idx / kBK;
    const int kk = idx % kBK;
    const int row = row0 + r;
    const int f = f0 + kk;
    s[kk][r] = (row < n && f < F) ? to_f32(t[(size_t)row * F + f]) : 0.f;
  }
}

template <typename GT, typename XT, int TB>
__global__ void __launch_bounds__(kThreads)
spmm_dvals_kernel(const int* __restrict__ ptr, const int* __restrict__ cols,
                  const GT* __restrict__ g, const XT* __restrict__ x,
                  float* __restrict__ out, int n, int F, int row_tiles) {
  using S = DvalsShape<TB>;
  __shared__ float sg[kBK][S::BM + 1];
  __shared__ float sx[kBK][S::BN + 1];
  const int b = blockIdx.x;
  const int r0 = (blockIdx.y / S::PIECES) * S::BM;
  const int c0 = (blockIdx.y % S::PIECES) * S::BN;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  float* blk = out + (size_t)b * TB * TB;
  float acc[S::TM][S::TN];
#pragma unroll
  for (int m = 0; m < S::TM; ++m)
#pragma unroll
    for (int q = 0; q < S::TN; ++q) acc[m][q] = 0.f;

  if (b < ptr[row_tiles]) {  // a real block; pad blocks stay zero
    const int grow0 = row_of_block(ptr, row_tiles, b) * TB + r0;
    const int xrow0 = cols[b] * TB + c0;
    for (int f0 = 0; f0 < F; f0 += kBK) {
      load_slice<S::BM>(g, n, F, grow0, f0, sg);
      load_slice<S::BN>(x, n, F, xrow0, f0, sx);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float a[S::TM];
        float c[S::TN];
#pragma unroll
        for (int m = 0; m < S::TM; ++m) a[m] = sg[kk][ty + 16 * m];
#pragma unroll
        for (int q = 0; q < S::TN; ++q) c[q] = sx[kk][tx + 16 * q];
#pragma unroll
        for (int m = 0; m < S::TM; ++m)
#pragma unroll
          for (int q = 0; q < S::TN; ++q) acc[m][q] = fmaf(a[m], c[q], acc[m][q]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int m = 0; m < S::TM; ++m)
#pragma unroll
    for (int q = 0; q < S::TN; ++q)
      blk[(size_t)(r0 + ty + 16 * m) * TB + c0 + tx + 16 * q] = acc[m][q];
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
    using S = DvalsShape<TB>;
    dim3 grid(nnzb, (TB / S::BM) * S::PIECES);
    spmm_dvals_kernel<GT, XT, TB><<<grid, kThreads, 0, stream>>>(
        static_cast<const int*>(ptr), static_cast<const int*>(cols),
        static_cast<const GT*>(g), static_cast<const XT*>(x),
        static_cast<float*>(out), n, F, row_tiles);
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
