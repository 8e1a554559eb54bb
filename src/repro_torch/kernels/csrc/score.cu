// Fused min-distance + argmin + outlier score for Hopper (sm_90a): kernel C.
//
// Replaces the TPU kernel src/repro/kernels/score/kernel.py:score_pallas
// (_l2_score_kernel, _l1_score_kernel): kernel A's (dist, idx) plus the
// epilogue score = dist / max(threshold, 1e-30), for l2sq / l2 / l1.
//
// Bound on this card.  The serving read scores micro-batches of 256 queries
// against k centers (k = 3 or 100, d = 34 or 5): at most 2*256*100*34 ~ 1.7e6
// FLOP and ~50 KB of bytes per call, far below a microsecond of either
// roofline, so a call is bound by launch latency.
//
// What the design does about it: one launch does the whole read (pdist,
// argmin and divide), with no intermediate in device memory.  The threshold
// is read from a device pointer, so the host never synchronises to pass it.
// The distance loop is kernel A's (pdist_common.cuh) with the same tiles, and
// the divide is IEEE (__fdiv_rn), so the fused result equals kernel A plus a
// torch divide bit for bit.
#include "pdist_common.cuh"

namespace rt {

template <int DP, int METRIC, typename T>
__global__ void __launch_bounds__(Tile<DP>::NT)
score_kernel(const T* __restrict__ x, const T* __restrict__ c,
             const float* __restrict__ thr, float* __restrict__ dist,
             int* __restrict__ idx, float* __restrict__ score, int n, int m,
             int d) {
  const long long row = (long long)blockIdx.x * Tile<DP>::NT + threadIdx.x;
  RowScan<DP, METRIC, T> rs;
  rs.run(x, c, row, n, m, d);
  if (row < n) {
    dist[row] = rs.best;
    idx[row] = rs.bidx;
    score[row] = __fdiv_rn(rs.best, fmaxf(thr[0], 1e-30f));
  }
}

}  // namespace rt

extern "C" int rt_score(const void* x, const void* c, const void* thr,
                        void* dist, void* idx, void* score, int n, int m, int d,
                        int metric, int dtype, void* stream) {
  if (n > 0) {
    rt::dispatch_dtype(dtype, [&](auto tv) {
      using T = decltype(tv);
      rt::dispatch_metric(metric, [&](auto mv) {
        constexpr int METRIC = decltype(mv)::value;
        rt::dispatch_dp(d, [&](auto dv) {
          constexpr int DP = decltype(dv)::value;
          constexpr int NT = rt::Tile<DP>::NT;
          const int blocks = (n + NT - 1) / NT;
          rt::score_kernel<DP, METRIC, T>
              <<<blocks, NT, 0, (cudaStream_t)stream>>>(
                  (const T*)x, (const T*)c, (const float*)thr, (float*)dist,
                  (int*)idx, (float*)score, n, m, d);
        });
      });
    });
  }
  return (int)cudaGetLastError();
}
