// Block-CSR and tile-diagonal band SpMM, Y = A . X, for Hopper (sm_90a):
// the entry points bsr_spmm and dia_spmm.
//
// bsr_spmm replaces the three block-CSR Pallas kernels of the JAX
// package, gptst_tpu/kernels/spmm.py:_spmm_kernel, _spmm_kernel_stream
// and _spmm_kernel_panel. Those are three VMEM strategies for one
// computation (x stripe resident, x tiles streamed per block, x in
// column panels), each a dense product of the stored 128 x 128 blocks;
// here one kernel serves all three. Each CUDA block reads its own row
// tile's [ptr[i], ptr[i+1]) range, so the zero pad blocks the builders
// append are never multiplied.
//
// dia_spmm replaces _dia_kernel and its opt-in ring-buffered twin
// _dia_kernel_ring: both compute, for row tile i,
//
//     Y[tile i] = sum_{d < 2w+1} vals[i, d] . X[tile clamp(i + d - w, 0, rt - 1)]
//
// and differ only in how the TPU kept the x window in VMEM. Here the
// band is read through its block-CSR view (ptr = i * (2w + 1), cols the
// clamped column tiles, vals viewed as (rt * (2w + 1), TB, TB) without a
// copy). The clamped, structurally zero blocks at the ends of the band
// stay in the view as stored blocks with no entries: a non-finite value
// in their x tile sends them down the dense path, so the JAX package's
// clamp-and-multiply edge is kept.
//
// Design (spmm_tile.cuh): the stored blocks are nearly empty, so both
// kernels sum only their entries (the slots that may hold a nonzero,
// listed once per structure on the host) out of x tiles staged in
// shared memory, and multiply a whole block only where a non-finite x
// or a nonzero value outside its entries needs it. The result is the
// dense block product's, NaN and Inf included. A value pass
// (*_value_pass) flags the blocks with values outside their entries;
// the main kernel (*_kernel) then gathers. The two entry points run the
// same device code and keep their own kernel names, so that profiles
// and launch counts tell them apart.
//
// What bounds them: the function reads the stored values, the block
// structure, x and out, each once.
//   - CLI graph, 16,384 nodes, 462 stored 128 x 128 blocks holding ~49k
//     entries, F = 1,600: ~0.16 GFLOP against ~240 MB, bound by bytes,
//     ~0.072 ms at 3.35 TB/s. The dense design this replaces spent 24.2
//     GFLOP on the zeros (~0.36 ms at the FP32 rate).
//   - Road band, w = 1, 384 band blocks holding ~0.25M entries (4% of
//     their slots): ~0.8 GFLOP against ~235 MB, ~0.070 ms. The dense
//     design spent 20.1 GFLOP (~0.30 ms).
// The design also reads its entry lists (~0.4 MB on the CLI graph, ~1 MB
// on the band) and reads the values twice (value pass, then the entries'
// values). One feature tile's x columns (4 MB) stay in L2 while all row
// tiles gather from them, so HBM sees x about once; L2-to-SM traffic is
// one staged x tile per (stored block, feature tile), ~0.38 GB (CLI) and
// ~0.32 GB (band), computed from the shapes. The gathers are
// shared-memory reads. Tensor cores are no help: the waste was the
// zeros, not the FMA rate.
#include "spmm_tile.cuh"

namespace {

using namespace gptst;

template <typename VT, int TB>
__global__ void __launch_bounds__(kThreads)
bsr_spmm_value_pass(const VT* __restrict__ vals,
                    const unsigned* __restrict__ mask, int* __restrict__ bad) {
  flag_block<VT, TB>(vals, mask, bad);
}

template <typename VT, typename XT, int TB>
__global__ void __launch_bounds__(GatherShape<TB>::THREADS, 2)
bsr_spmm_kernel(const int* __restrict__ ptr, const int* __restrict__ cols,
                const VT* __restrict__ vals, const int* __restrict__ eptr,
                const int* __restrict__ eidx, const int* __restrict__ bad,
                const XT* __restrict__ x, XT* __restrict__ out,
                int* dense_count, int n, int F, int vec) {
  gather_tile<VT, XT, TB>(ptr, cols, vals, eptr, eidx, bad, x, out,
                          dense_count, n, F, vec != 0);
}

template <typename VT, int TB>
__global__ void __launch_bounds__(kThreads)
dia_spmm_value_pass(const VT* __restrict__ vals,
                    const unsigned* __restrict__ mask, int* __restrict__ bad) {
  flag_block<VT, TB>(vals, mask, bad);
}

template <typename VT, typename XT, int TB>
__global__ void __launch_bounds__(GatherShape<TB>::THREADS, 2)
dia_spmm_kernel(const int* __restrict__ ptr, const int* __restrict__ cols,
                const VT* __restrict__ vals, const int* __restrict__ eptr,
                const int* __restrict__ eidx, const int* __restrict__ bad,
                const XT* __restrict__ x, XT* __restrict__ out,
                int* dense_count, int n, int F, int vec) {
  gather_tile<VT, XT, TB>(ptr, cols, vals, eptr, eidx, bad, x, out,
                          dense_count, n, F, vec != 0);
}

template <bool kDia>
struct Launch {
  GatherArgs a;

  template <typename VT, typename XT, int TB>
  cudaError_t operator()() const {
    if constexpr (kDia) {
      return launch_gather<VT, XT, TB>(a, dia_spmm_value_pass<VT, TB>,
                                       dia_spmm_kernel<VT, XT, TB>);
    } else {
      return launch_gather<VT, XT, TB>(a, bsr_spmm_value_pass<VT, TB>,
                                       bsr_spmm_kernel<VT, XT, TB>);
    }
  }
};

template <bool kDia>
int run(const void* ptr, const void* cols, const void* vals, const void* eptr,
        const void* eidx, const void* mask, void* bad, void* dense_count,
        const void* x, void* out, int n, int F, int row_tiles, int nblocks,
        int tile, int vals_bf16, int x_bf16, void* stream) {
  if (n <= 0 || F <= 0 || row_tiles <= 0 || nblocks <= 0) {
    return cudaErrorInvalidValue;
  }
  Launch<kDia> l{{ptr, cols, vals, eptr, eidx, mask, bad, dense_count, x, out,
                  n, F, row_tiles, nblocks, static_cast<cudaStream_t>(stream)}};
  return dispatch(vals_bf16, x_bf16, tile, l);
}

}  // namespace

// out (n, F) = A . x (n, F); A is block-CSR with `row_tiles` row tiles
// of `tile` rows: ptr (row_tiles + 1,) int32, cols (nblocks,) int32,
// vals (nblocks, tile, tile), 16-byte aligned; its entry lists eptr
// (row_tiles * tile + 1,) int32, eidx int32 (b * tile + k) and mask
// (nblocks, tile, ceil(tile / 32)) 32-bit words. bad (nblocks,) int32
// is scratch; dense_count (1,) int32 gains one per (CUDA block, stored
// block) run densely. Dtype codes: 0 = f32, 1 = bf16; out has x's dtype.
// Returns the launches' cudaError_t (0 on success).
extern "C" int bsr_spmm(const void* ptr, const void* cols, const void* vals,
                        const void* eptr, const void* eidx, const void* mask,
                        void* bad, void* dense_count, const void* x, void* out,
                        int n, int F, int row_tiles, int nblocks, int tile,
                        int vals_bf16, int x_bf16, void* stream) {
  return run<false>(ptr, cols, vals, eptr, eidx, mask, bad, dense_count, x,
                    out, n, F, row_tiles, nblocks, tile, vals_bf16, x_bf16,
                    stream);
}

// The same for a band of `row_tiles` row tiles, given as its block-CSR
// view with nblocks = row_tiles * (2w + 1).
extern "C" int dia_spmm(const void* ptr, const void* cols, const void* vals,
                        const void* eptr, const void* eidx, const void* mask,
                        void* bad, void* dense_count, const void* x, void* out,
                        int n, int F, int row_tiles, int nblocks, int tile,
                        int vals_bf16, int x_bf16, void* stream) {
  return run<true>(ptr, cols, vals, eptr, eidx, mask, bad, dense_count, x,
                   out, n, F, row_tiles, nblocks, tile, vals_bf16, x_bf16,
                   stream);
}
