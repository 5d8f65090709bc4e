// Banded all-pairs DTW — native graph-artifact tool.
//
// The reference computes DTW node-similarity graphs in per-pair Python
// loops at config-parse time (STFGNN `model/STFGNN/args.py:31-57`,
// O(N^2 T^2) python; STGODE via fastdtw). This is the C++ hot path for
// that artifact build: all node pairs, Sakoe-Chiba band, L1 day-summed
// local costs, OpenMP over pairs. Exact same recurrence as
// gptst_tpu_torch/graph/dtw.py::banded_dtw_all_pairs (the numpy fallback).
//
// Build (done lazily by gptst_tpu_torch.native, into gptst_tpu_torch/_build/):
//   g++ -O3 -fopenmp -shared -fPIC dtw.cpp -o ../_build/libdtw.so

#include <cmath>
#include <cstdint>
#include <vector>

static const double BIG = 1e18;

extern "C" void banded_dtw_pairs(
    const float* x,       // (days, T, N) — normalized series
    int64_t days, int64_t T, int64_t N,
    const int32_t* ii,    // pair first-node indices
    const int32_t* jj,    // pair second-node indices
    int64_t npairs,
    int64_t radius,
    int64_t order,        // cost exponent (reference order=1)
    double* out)          // (npairs,) alignment costs
{
#pragma omp parallel
    {
        std::vector<double> prev(T), cur(T);
        std::vector<double> cost(T);
#pragma omp for schedule(dynamic, 16)
        for (int64_t p = 0; p < npairs; ++p) {
            const int64_t a = ii[p], b = jj[p];
            for (int64_t t = 0; t < T; ++t) prev[t] = BIG;
            for (int64_t i = 0; i < T; ++i) {
                const int64_t jlo = i - radius < 0 ? 0 : i - radius;
                const int64_t jhi = i + radius + 1 > T ? T : i + radius + 1;
                // local costs d[i, j] = sum_d |x[d, j, a] - x[d, i, b]|
                for (int64_t j = jlo; j < jhi; ++j) {
                    double c = 0.0;
                    for (int64_t d = 0; d < days; ++d) {
                        const float* xd = x + d * T * N;
                        c += std::fabs((double)xd[j * N + a]
                                       - (double)xd[i * N + b]);
                    }
                    cost[j] = (order == 1) ? c : std::pow(c, (double)order);
                }
                for (int64_t t = 0; t < T; ++t) cur[t] = BIG;
                for (int64_t j = jlo; j < jhi; ++j) {
                    double best;
                    if (i == 0 && j == 0) {
                        best = 0.0;
                    } else {
                        best = BIG;
                        if (i > 0) {
                            if (prev[j] < best) best = prev[j];
                            if (j > 0 && prev[j - 1] < best)
                                best = prev[j - 1];
                        }
                        if (j > 0 && cur[j - 1] < best) best = cur[j - 1];
                    }
                    cur[j] = cost[j] + best;
                }
                prev.swap(cur);
            }
            const double r = prev[T - 1];
            out[p] = (order == 1) ? r : std::pow(r, 1.0 / (double)order);
        }
    }
}
