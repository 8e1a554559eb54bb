// Fused Lloyd step for Hopper (sm_90a): kernel B of the port.
//
// Replaces the TPU kernel src/repro/kernels/lloyd/kernel.py:lloyd_step_pallas
// (_kernel): for points x (n, d), weights w (n,) and centers c (k, d), the
// nearest-center assignment and distance of every point (l2sq / l2) and the
// weighted per-center sums (k, d) and counts (k,).  The l1 metric is not
// served here: for l1 the port's `blocked` Lloyd step assigns through the
// dispatched min_argmin, which on the card is kernel A (csrc/pdist.cu).
//
// Bound on this card.  k-means-- at the coordinator calls this 25 times per
// fit on the gathered summaries: n_rec ~ 1e5 - 1.5e6 records, k = 3 (kdd) or
// 100 (gauss), d = 34 or 5.  Per call that is 2*n*k*d <= 1.5e9 FLOP over
// n*(d+1)*4 <= 2e8 bytes read: ~0.06 ms of bytes at 3.35 TB/s against
// ~0.02 ms of fp32 FMA, so it is bound by reading x once.
//
// What the design does about it.  The assignment is kernel A's loop
// (pdist_common.cuh), so it reads x once.  The accumulation must be
// deterministic, so there are no float atomics:
//   1. each CTA owns a fixed, contiguous range of rows (the split depends on
//      n only) and accumulates its rows in row order into its own partial
//      (k, d+1) block -- in shared memory when it fits in 96 KB, otherwise in
//      its own slice of the global scratch; thread f owns column f, so no two
//      threads ever touch one word;
//   2. a second kernel adds the partials in block order.
// The same inputs give the same sums bit for bit on every run.  k is tiled
// through shared memory like any center set, so k = 2048 x d = 130 works,
// which would not fit Hopper's 227 KB of shared memory as one block (the
// TPU kernel keeps all k in one VMEM block).
#include "pdist_common.cuh"

namespace rt {

constexpr int kSmemAccFloats = 24576;  // 96 KB partial block in shared memory

template <int DP, int METRIC, typename T>
__global__ void __launch_bounds__(Tile<DP>::NT)
lloyd_assign_kernel(const T* __restrict__ x, const float* __restrict__ w,
                    const T* __restrict__ c, int* __restrict__ assign,
                    float* __restrict__ dist, float* __restrict__ part, int n,
                    int k, int d, int rows_per_cta, int acc_in_smem) {
  constexpr int NT = Tile<DP>::NT;
  extern __shared__ float acc_smem[];
  __shared__ int a_s[NT];
  __shared__ float w_s[NT];

  const int K1 = k * (d + 1);  // [j * (d + 1) + f]; f == d holds the count
  float* acc = acc_in_smem ? acc_smem : part + (long long)blockIdx.x * K1;
  for (int e = threadIdx.x; e < K1; e += NT) acc[e] = 0.0f;
  __syncthreads();

  const long long r0 = (long long)blockIdx.x * rows_per_cta;
  const long long r_end = min((long long)n, r0 + rows_per_cta);
  for (long long t0 = r0; t0 < r_end; t0 += NT) {
    const long long row = t0 + threadIdx.x;
    const bool live = row < r_end;
    RowScan<DP, METRIC, T> rs;
    rs.run(x, c, live ? row : (long long)n, n, k, d);
    if (live) {
      assign[row] = rs.bidx;
      dist[row] = rs.best;
    }
    a_s[threadIdx.x] = rs.bidx;
    w_s[threadIdx.x] = live ? w[row] : 0.0f;
    __syncthreads();
    const int nr = (int)min((long long)NT, r_end - t0);
    for (int f = threadIdx.x; f <= d; f += NT) {
      for (int r = 0; r < nr; ++r) {
        const float wr = w_s[r];
        const float v =
            f < d ? __fmul_rn(wr, load_f(x, (t0 + r) * d + f)) : wr;
        float* p = acc + a_s[r] * (d + 1) + f;
        *p = __fadd_rn(*p, v);
      }
    }
    __syncthreads();
  }
  if (acc_in_smem) {
    for (int e = threadIdx.x; e < K1; e += NT)
      part[(long long)blockIdx.x * K1 + e] = acc[e];
  }
}

__global__ void lloyd_reduce_kernel(const float* __restrict__ part,
                                    float* __restrict__ sums,
                                    float* __restrict__ counts, int G, int k,
                                    int d) {
  const int K1 = k * (d + 1);
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= K1) return;
  float s = 0.0f;
  for (int g = 0; g < G; ++g) s = __fadd_rn(s, part[(long long)g * K1 + e]);
  const int j = e / (d + 1), f = e - j * (d + 1);
  if (f < d)
    sums[j * d + f] = s;
  else
    counts[j] = s;
}

}  // namespace rt

// The CTA count the wrapper sizes the scratch with: depends on n only.
extern "C" int rt_lloyd_blocks(int n, int d) {
  int nt = 256;
  rt::dispatch_dp(d, [&](auto dv) { nt = rt::Tile<decltype(dv)::value>::NT; });
  const int tiles = (n + nt - 1) / nt;
  const int g = tiles < 256 ? tiles : 256;
  const int rows = (n + g - 1) / g;
  return (n + rows - 1) / rows;
}

extern "C" int rt_lloyd_step(const void* x, const void* w, const void* c,
                             void* sums, void* counts, void* assign,
                             void* dist, void* part, int n, int k, int d,
                             int G, int metric, int dtype, void* stream) {
  if (n > 0 && G > 0) {
    const int rows_per_cta = (n + G - 1) / G;
    const int K1 = k * (d + 1);
    const int acc_in_smem = K1 <= rt::kSmemAccFloats;
    const size_t smem = acc_in_smem ? (size_t)K1 * sizeof(float) : 0;
    cudaStream_t st = (cudaStream_t)stream;
    rt::dispatch_dtype(dtype, [&](auto tv) {
      using T = decltype(tv);
      auto go = [&](auto mv) {
        constexpr int METRIC = decltype(mv)::value;
        rt::dispatch_dp(d, [&](auto dv) {
          constexpr int DP = decltype(dv)::value;
          auto kernel = rt::lloyd_assign_kernel<DP, METRIC, T>;
          // the partial block plus the static tiles may pass 48 KB
          cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
          kernel<<<G, rt::Tile<DP>::NT, smem, st>>>(
              (const T*)x, (const float*)w, (const T*)c, (int*)assign,
              (float*)dist, (float*)part, n, k, d, rows_per_cta, acc_in_smem);
        });
      };
      if (metric == rt::L2)
        go(std::integral_constant<int, rt::L2>{});
      else
        go(std::integral_constant<int, rt::L2SQ>{});
    });
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    rt::lloyd_reduce_kernel<<<(K1 + 255) / 256, 256, 0, st>>>(
        (const float*)part, (float*)sums, (float*)counts, G, k, d);
  }
  return (int)cudaGetLastError();
}
