// Fused min-distance + argmin for Hopper (sm_90a): kernel A of the port.
//
// Replaces the TPU kernel src/repro/kernels/pdist/kernel.py:min_argmin_pallas
// (_l2_kernel, _l1_kernel): for every row of x (n, d), the distance to the
// nearest row of c (m, d) and that row's index, for l2sq / l2 / l1, f32 or
// bf16 inputs (upcast to f32 on load), f32 distances and int32 indices.
//
// Bound on this card.  The largest call on the main path is Alg. 2's
// reassignment (core/augmented.py), per site n ~ 244,922 rows x m = 36,537
// centers x d = 34: 2*n*m*d ~ 6.1e11 FLOP, ~9 ms at the H100's 67 TFLOP/s
// fp32 CUDA-core rate.  It is compute-bound, and it stays on the CUDA cores:
// TF32 tensor cores would break parity with the f32 reference (argmins flip
// at ~3 decimal digits).  Alg. 1's rounds (m = 26) and the losses (m = 3)
// do ~n*d*m FLOP on n*d*4 bytes: they are bound by reading x once, or by
// launch latency at small n.
//
// What the design does about it (pdist_common.cuh): one row per thread with
// the row in registers, centers staged through shared memory and read as
// broadcasts, four independent FMA chains per thread, so the inner loop is
// FMAs fed by 16-byte shared loads; x is read exactly once.  No tensor
// cores, no atomics, nothing allocated, no synchronisation with the host.
#include "pdist_common.cuh"

namespace rt {

template <int DP, int METRIC, typename T>
__global__ void __launch_bounds__(Tile<DP>::NT)
min_argmin_kernel(const T* __restrict__ x, const T* __restrict__ c,
                  float* __restrict__ dist, int* __restrict__ idx, int n,
                  int m, int d) {
  const long long row = (long long)blockIdx.x * Tile<DP>::NT + threadIdx.x;
  RowScan<DP, METRIC, T> rs;
  rs.run(x, c, row, n, m, d);
  if (row < n) {
    dist[row] = rs.best;
    idx[row] = rs.bidx;
  }
}

}  // namespace rt

extern "C" int rt_min_argmin(const void* x, const void* c, void* dist,
                             void* idx, int n, int m, int d, int metric,
                             int dtype, void* stream) {
  if (n > 0) {
    rt::dispatch_dtype(dtype, [&](auto tv) {
      using T = decltype(tv);
      rt::dispatch_metric(metric, [&](auto mv) {
        constexpr int METRIC = decltype(mv)::value;
        rt::dispatch_dp(d, [&](auto dv) {
          constexpr int DP = decltype(dv)::value;
          constexpr int NT = rt::Tile<DP>::NT;
          const int blocks = (n + NT - 1) / NT;
          rt::min_argmin_kernel<DP, METRIC, T>
              <<<blocks, NT, 0, (cudaStream_t)stream>>>(
                  (const T*)x, (const T*)c, (float*)dist, (int*)idx, n, m, d);
        });
      });
    });
  }
  return (int)cudaGetLastError();
}
