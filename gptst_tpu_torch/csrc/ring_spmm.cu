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
// 867.6 GFLOP. As 3xTF32 on the tensor cores that is 3 x 867.6 GFLOP
// at 495 TFLOP/s = 5.26 ms (12.95 ms on the FP32 pipe at 67 TFLOP/s);
// its bytes (the blocks, x, out and the shard copies, ~1.9 GB) take
// ~0.57 ms at 3.35 TB/s. It is bound by operations.
//
// Design: the f32 product on the tensor cores as 3xTF32 (tf32x3.cuh,
// `wg`): a 128 x 128 output tile per CUDA block of two warpgroups, each
// 64 x 128 by wgmma.mma_async.m64n128k8, both operands K-major in
// shared memory. wgmma takes a TF32 B operand only K-major, so the ring
// holds x transposed: its double buffer is (2, F, K), K = n_loc rounded
// up to 4 with zero columns, written once per rank and call by the copy
// of the shard into buffer 0 (the peer copies move x^T shards as they
// are), and the rotated blocks are stored (n_loc, P, K) with zero
// columns past n_loc, so every row is 16-byte aligned. Slices of 32
// columns of A and of x^T go through 3 shared-memory stages filled by
// cp.async 16-byte copies; when a stage lands, each thread splits the
// values it copied (hi in place, lo beside it), and the 8 warps issue
// the stage's 12 wgmmas into fresh accumulators, splitting the next
// stage while they run; f32 adds fold the fresh sums into the running
// ones. One CUDA block (193 KB of shared memory) per SM.
//
// Non-finite values: every block is multiplied, zeros included, as the
// TPU kernel does, so a NaN or Inf in any x row reaches every output
// row of its column on every rank. The main product a_hi . x_hi carries
// Inf and NaN as the dense f32 product does (0 * Inf = NaN,
// c * Inf = +-Inf), and the two correction products take the operands
// zeroed where they are not finite (tf32x3.cuh). Rows past n_loc and
// features past F are masked.
#include "tf32x3.cuh"

namespace {

using namespace gptst;
namespace wg = tf32x3::wg;

constexpr int kRingBM = 128;  // output rows per CUDA block
constexpr int kRingBN = 128;  // output features per CUDA block

// acc (n, F) f32 (+)= a (n x K, row stride lda) . xt (F x K)^T, K = n
// rounded up to 4 (a's and xt's columns past n are zero); with `out`
// set, the result goes to out (in OT) instead of acc.
template <typename OT>
__global__ void __launch_bounds__(wg::kThreads, 1)
ring_spmm_kernel(const float* __restrict__ a, size_t lda,
                 const float* __restrict__ xt, float* __restrict__ acc,
                 OT* __restrict__ out, int n, int F, int K, int accumulate) {
  extern __shared__ __align__(1024) char smem[];
  const int row0 = blockIdx.y * kRingBM;
  const int col0 = blockIdx.x * kRingBN;
  float c[wg::kAccs];
  wg::run(c, smem, a + (size_t)row0 * lda, lda, n - row0,
          xt + (size_t)col0 * K, (size_t)K, F - col0, K);

  // the m64n128 accumulator layout: warp w of warpgroup h holds rows
  // 64 h + 16 w + g (+ 8), columns 8 j + 2 t (+ 1), g = lane / 4,
  // t = lane % 4, in c[4 j .. 4 j + 3]
  const int lane = threadIdx.x % 32;
  const int r = row0 + 16 * (threadIdx.x / 32) + lane / 4;
#pragma unroll
  for (int j = 0; j < wg::kAccs / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r + 8 * (e / 2);
      const int col = col0 + 8 * j + 2 * (lane % 4) + e % 2;
      if (row >= n || col >= F) continue;
      const size_t idx = (size_t)row * F + col;
      const float v = accumulate ? acc[idx] + c[4 * j + e] : c[4 * j + e];
      if (out != nullptr) {
        store(out + idx, v);
      } else {
        acc[idx] = v;
      }
    }
}

template <typename OT>
cudaError_t launch(const float* a, size_t lda, const float* xt, float* acc,
                   OT* out, int n, int F, int accumulate, cudaStream_t s) {
  const int K = (n + 3) / 4 * 4;
  // 16-byte copies: rows and the block's first column 16-byte aligned
  if (lda % 4 != 0 || reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(xt) % 16 != 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ring_spmm_kernel<OT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      wg::kSmemBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((F + kRingBN - 1) / kRingBN, (n + kRingBM - 1) / kRingBM);
  ring_spmm_kernel<OT><<<grid, wg::kThreads, wg::kSmemBytes, s>>>(
      a, lda, xt, acc, out, n, F, K, accumulate);
  return cudaGetLastError();
}

}  // namespace

// One ring step of one rank: acc (n_loc, F) f32 (+)= a . x, where a is
// the (n_loc x n_loc) block at `a` with row stride `lda` (elements) and
// x is given transposed: `xt` (F, K) f32 with K = n_loc rounded up to
// 4; a's columns and xt's columns past n_loc (up to K) must be zero,
// and a, xt and lda 16-byte aligned. accumulate = 0 writes, 1 adds to
// acc. With `out` non-null (the last step) the sum goes to out instead,
// in f32 (out_bf16 = 0) or bf16 (1), and acc is only read. Launches on
// `stream`; returns the launch's cudaError_t (0 on success).
extern "C" int ring_spmm(const void* a, long long lda, const void* xt,
                         void* acc, void* out, int n_loc, int F,
                         int accumulate, int out_bf16, void* stream) {
  if (n_loc <= 0 || F <= 0 || lda < n_loc) return cudaErrorInvalidValue;
  if (accumulate && acc == nullptr) return cudaErrorInvalidValue;
  if (out == nullptr && acc == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ap = static_cast<const float*>(a);
  const float* xp = static_cast<const float*>(xt);
  float* accp = static_cast<float*>(acc);
  if (out_bf16) {
    return launch(ap, (size_t)lda, xp, accp,
                  static_cast<__nv_bfloat16*>(out), n_loc, F, accumulate, s);
  }
  return launch(ap, (size_t)lda, xp, accp, static_cast<float*>(out), n_loc,
                F, accumulate, s);
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
