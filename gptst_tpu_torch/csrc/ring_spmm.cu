// One step of the fused ring SpMM, for Hopper (sm_90a), and the copy
// that passes an x shard to the left neighbour rank.
//
// Replaces the TPU kernel gptst_tpu/kernels/halo_spmm.py:_ring_kernel.
// There, one Pallas kernel per device runs the whole ring: at step s it
// starts the RDMA of its resident x shard to the left neighbour and
// multiplies the matching block column of its ring-ordered adjacency,
//
//     acc += A_rot[p][:, s] . buf[s % 2]        (n_loc x n_loc) . (n_loc x F)
//
// with a double buffer and send/recv/free semaphores. On Hopper the
// RDMA becomes a peer copy on a copy stream outside the kernel
// (`ring_copy`: cudaMemcpyPeerAsync between cards, a device-to-device
// copy on one card), the semaphores become CUDA events, and this kernel
// is the block product of one (rank, step): the wrapper in
// kernels/halo_spmm.py launches it P times per rank, P^2 per call, and
// orders it against the copies.
//
// The block is a strided view of the rank's (n_loc, P, n_loc) array:
// row stride lda = P * n_loc, column offset s * n_loc, so nothing is
// copied. Step 0 writes acc, later steps add to it, and the last step
// writes out in x's dtype (f32 or bf16) instead, as the TPU kernel's
// `out_ref[:] = acc.astype(...)`. The buffer is f32 (the TPU kernel's
// f32 VMEM buffer), so the products are f32 for any x dtype.
//
// What bounds it: at the card shape (16,384 nodes over P = 4 ranks,
// F = 1,616) a call multiplies dense blocks, 2 * 16384^2 * 1616 =
// 867.6 GFLOP, 12.95 ms at the 67 TFLOP/s of FP32 outside the tensor
// cores; its bytes (the blocks, x, out and the shard copies, ~1.9 GB)
// take ~0.57 ms at 3.35 TB/s. It is bound by operations. This design
// keeps every product in FP32 FMAs (no tensor cores, so no TF32): a
// 128 x 128 output tile per CUDA block of 256 threads, 8 x 8 outputs
// per thread (64 FMAs per 16 shared-memory loads), the inputs staged
// through shared memory 8 columns of A at a time. It multiplies every
// block, zeros included, as the TPU kernel does: a NaN or Inf in any x
// row reaches every output row of its column on every rank. Rows past
// n_loc and features past F are masked. Tensor cores (wgmma, 3xTF32),
// TMA, and a kernel that stores into a peer's memory itself are later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kBM = 128;       // output rows per CUDA block
constexpr int kBN = 128;       // output features per CUDA block
constexpr int kBK = 8;         // inner-dimension slice per stage
constexpr int kTM = kBM / 16;  // rows per thread
constexpr int kTN = kBN / 16;  // features per thread

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// acc (n, F) f32 (+)= a (n x n, row stride lda) . x (n, F); with `out`
// set, the result goes to out (in OT) instead of acc.
template <typename OT>
__global__ void __launch_bounds__(kThreads, 2)
ring_spmm_kernel(const float* __restrict__ a, size_t lda,
                 const float* __restrict__ x, float* __restrict__ acc,
                 OT* __restrict__ out, int n, int F, int accumulate) {
  // a slice k-major, padded so that the transposing stores hit 32 banks
  __shared__ float as[kBK][kBM + 4];
  __shared__ float xs[kBK][kBN];
  const int t = threadIdx.x;
  const int ty = t / 16;
  const int tx = t % 16;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  float c[kTM][kTN];
#pragma unroll
  for (int m = 0; m < kTM; ++m)
#pragma unroll
    for (int q = 0; q < kTN; ++q) c[m][q] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kBK) {
#pragma unroll
    for (int j = 0; j < kBM * kBK / kThreads; ++j) {
      const int idx = t + j * kThreads;
      const int r = idx / kBK;
      const int kk = idx % kBK;
      const int row = row0 + r;
      const int k = k0 + kk;
      as[kk][r] = (row < n && k < n) ? a[(size_t)row * lda + k] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kBK * kBN / kThreads; ++j) {
      const int idx = t + j * kThreads;
      const int kk = idx / kBN;
      const int cc = idx % kBN;
      const int k = k0 + kk;
      const int col = col0 + cc;
      xs[kk][cc] = (k < n && col < F) ? x[(size_t)k * F + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[kTM];
      float xv[kTN];
#pragma unroll
      for (int m = 0; m < kTM; ++m) av[m] = as[kk][ty + 16 * m];
#pragma unroll
      for (int q = 0; q < kTN; ++q) xv[q] = xs[kk][tx + 16 * q];
#pragma unroll
      for (int m = 0; m < kTM; ++m)
#pragma unroll
        for (int q = 0; q < kTN; ++q) c[m][q] = fmaf(av[m], xv[q], c[m][q]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < kTM; ++m) {
    const int row = row0 + ty + 16 * m;
    if (row >= n) continue;
#pragma unroll
    for (int q = 0; q < kTN; ++q) {
      const int col = col0 + tx + 16 * q;
      if (col >= F) continue;
      const size_t i = (size_t)row * F + col;
      const float v = accumulate ? acc[i] + c[m][q] : c[m][q];
      if (out != nullptr) {
        store(out + i, v);
      } else {
        acc[i] = v;
      }
    }
  }
}

}  // namespace

// One ring step of one rank: acc (n_loc, F) f32 (+)= a . x, where a is
// the (n_loc x n_loc) block at `a` with row stride `lda` (elements), x
// is (n_loc, F) f32. accumulate = 0 writes, 1 adds to acc. With `out`
// non-null (the last step) the sum goes to out instead, in f32
// (out_bf16 = 0) or bf16 (1), and acc is only read. Launches on
// `stream`; returns the launch's cudaError_t (0 on success).
extern "C" int ring_spmm(const void* a, long long lda, const void* x,
                         void* acc, void* out, int n_loc, int F,
                         int accumulate, int out_bf16, void* stream) {
  if (n_loc <= 0 || F <= 0 || lda < n_loc) return cudaErrorInvalidValue;
  if (accumulate && acc == nullptr) return cudaErrorInvalidValue;
  if (out == nullptr && acc == nullptr) return cudaErrorInvalidValue;
  dim3 grid((F + kBN - 1) / kBN, (n_loc + kBM - 1) / kBM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ap = static_cast<const float*>(a);
  const float* xp = static_cast<const float*>(x);
  float* accp = static_cast<float*>(acc);
  if (out_bf16) {
    ring_spmm_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        ap, (size_t)lda, xp, accp, static_cast<__nv_bfloat16*>(out), n_loc,
        F, accumulate);
  } else {
    ring_spmm_kernel<float><<<grid, kThreads, 0, s>>>(
        ap, (size_t)lda, xp, accp, static_cast<float*>(out), n_loc, F,
        accumulate);
  }
  return cudaGetLastError();
}

// Copy `bytes` from src on card src_dev to dst on card dst_dev, ordered
// on `stream`: cudaMemcpyPeerAsync between cards (over NVLink where the
// cards have it), a device-to-device copy within one card. Returns its
// cudaError_t.
extern "C" int ring_copy(void* dst, int dst_dev, const void* src,
                         int src_dev, size_t bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dst_dev == src_dev) {
    return cudaMemcpyAsync(dst, src, bytes, cudaMemcpyDeviceToDevice, s);
  }
  return cudaMemcpyPeerAsync(dst, dst_dev, src, src_dev, bytes, s);
}
