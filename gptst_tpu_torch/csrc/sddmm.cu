// Block-sparse SDDMM, the sampled product E1 . E2 on a fixed block
// pattern, for Hopper (sm_90a):
//
//     out[b] = (E1[row tile of b] . E2[:, col tile of b]) * mask[b]
//
// with E1 (n, d), E2 (d, n), out and mask (nnzb, TB, TB) f32.
//
// Replaces gptst_tpu/kernels/sddmm.py:_sddmm_kernel (through
// _sddmm_fwd_impl and sddmm), which runs one MXU matmul per stored block
// with the rank padded to 128; the mask multiply is XLA there and is
// fused here. The rank is read unpadded (d = 10 for MSDR): the zero
// padding adds nothing to the sum. The product is multiplied by the mask,
// not selected with it, so a NaN in E1 or E2 survives at masked slots
// exactly as in the reference. Pad blocks carry row tile 0 and column
// tile 0 and are masked to zero.
//
// What bounds it: per stored block 2 * TB^2 * d FLOPs against TB^2 * 4 B
// of mask read and TB^2 * 4 B of output written, 2.5 FLOP per byte at
// d = 10, far below the FP32 ridge (20 FLOP/B): memory bounds it, ~51 MB
// for the 382-block road pattern, ~0.015 ms at 3.35 TB/s. The design
// reads each operand once into shared memory (BM rows of E1, TB columns
// of E2), keeps the products in registers, and streams mask and output
// once, coalesced, with one CUDA block per 64-row piece of a stored
// block.
#include "spmm_tile.cuh"

namespace {

using namespace gptst;

constexpr int kDK = 16;  // rank slice per shared-memory stage

template <typename T1, typename T2, int TB>
__global__ void __launch_bounds__(kThreads)
sddmm_kernel(const int* __restrict__ rids, const int* __restrict__ cols,
             const T1* __restrict__ e1, const T2* __restrict__ e2,
             const float* __restrict__ mask, float* __restrict__ out, int n,
             int d) {
  using S = TileShape<TB>;
  constexpr int TN = TB / 16;  // columns per thread
  __shared__ float s1[kDK][S::BM + 1];
  __shared__ float s2[kDK][TB];
  const int b = blockIdx.x;
  const int r0 = blockIdx.y * S::BM;
  const int row0 = rids[b] * TB + r0;
  const int col0 = cols[b] * TB;
  const int t = threadIdx.x;
  const int ty = t / 16;
  const int tx = t % 16;
  float acc[S::TM][TN];
#pragma unroll
  for (int m = 0; m < S::TM; ++m)
#pragma unroll
    for (int q = 0; q < TN; ++q) acc[m][q] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kDK) {
#pragma unroll
    for (int j = 0; j < S::BM * kDK / kThreads; ++j) {
      const int idx = t + j * kThreads;
      const int r = idx / kDK;
      const int kk = idx % kDK;
      const int row = row0 + r;
      const int k = k0 + kk;
      s1[kk][r] = (row < n && k < d) ? to_f32(e1[(size_t)row * d + k]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kDK * TB / kThreads; ++j) {
      const int idx = t + j * kThreads;
      const int kk = idx / TB;
      const int c = idx % TB;
      const int col = col0 + c;
      const int k = k0 + kk;
      s2[kk][c] = (col < n && k < d) ? to_f32(e2[(size_t)k * n + col]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDK; ++kk) {
      float a[S::TM];
      float c[TN];
#pragma unroll
      for (int m = 0; m < S::TM; ++m) a[m] = s1[kk][ty + 16 * m];
#pragma unroll
      for (int q = 0; q < TN; ++q) c[q] = s2[kk][tx + 16 * q];
#pragma unroll
      for (int m = 0; m < S::TM; ++m)
#pragma unroll
        for (int q = 0; q < TN; ++q) acc[m][q] = fmaf(a[m], c[q], acc[m][q]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int m = 0; m < S::TM; ++m) {
    const size_t row = (size_t)b * TB * TB + (size_t)(r0 + ty + 16 * m) * TB;
#pragma unroll
    for (int q = 0; q < TN; ++q) {
      const size_t i = row + tx + 16 * q;
      out[i] = acc[m][q] * mask[i];
    }
  }
}

struct Launch {
  const void* rids;
  const void* cols;
  const void* e1;
  const void* e2;
  const void* mask;
  void* out;
  int n, d, nnzb;
  cudaStream_t stream;

  template <typename T1, typename T2, int TB>
  cudaError_t operator()() const {
    dim3 grid(nnzb, TileShape<TB>::SUB);
    sddmm_kernel<T1, T2, TB><<<grid, kThreads, 0, stream>>>(
        static_cast<const int*>(rids), static_cast<const int*>(cols),
        static_cast<const T1*>(e1), static_cast<const T2*>(e2),
        static_cast<const float*>(mask), static_cast<float*>(out), n, d);
    return cudaGetLastError();
  }
};

}  // namespace

// out (nnzb, tile, tile) f32 = (e1[rids[b]] . e2[:, cols[b]]) * mask[b]
// for e1 (n, d), e2 (d, n); rids, cols (nnzb,) int32 tile indices; mask
// (nnzb, tile, tile) f32. Dtype codes: 0 = f32, 1 = bf16. Returns the
// launch's cudaError_t (0 on success).
extern "C" int sddmm(const void* rids, const void* cols, const void* e1,
                     const void* e2, const void* mask, void* out, int n,
                     int d, int nnzb, int tile, int e1_bf16, int e2_bf16,
                     void* stream) {
  if (n <= 0 || d <= 0 || nnzb <= 0) return cudaErrorInvalidValue;
  Launch l{rids, cols, e1, e2, mask, out, n, d, nnzb,
           static_cast<cudaStream_t>(stream)};
  return dispatch(e1_bf16, e2_bf16, tile, l);
}
