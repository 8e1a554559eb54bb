// Fused min-distance + argmin + outlier score for Hopper (sm_90a): kernel C.
//
// Replaces the TPU kernel src/repro/kernels/score/kernel.py:score_pallas
// (_l2_score_kernel, _l1_score_kernel): kernel A's (dist, idx) plus the
// epilogue score = dist / max(threshold, 1e-30), for l2sq / l2 / l1.
//
// Bound on this card.  The serving read scores micro-batches of 256 queries
// against k centers (kdd: k = 3, d = 34; gauss: k = 100, d = 5): ~52 k FMAs
// and ~35 KB at 256 x 3 x 34, an 11 ns roofline.  So a call is bound by the
// launch: the host's work to issue it (21-38 us through the wrapper on the
// H100 machine's host), then the kernel's launch and its chain of dependent
// steps: load x and the centers, barrier, norms, barrier, scan, store,
// ~3.6 us per launch at kdd's shape and ~5.9 us at gauss's, where a thread
// scans 100 centers in order (PERF.md).  That chain, not the SMs, sets the
// device time: this design measured within 3% of the one-CTA RowScan kernel
// it replaced at both shapes, and the call's time went down on the host
// side (kernel.py).
//
// What this design does about it:
//   * rows per CTA follow n (kernel.py: launch_plan): min(NT, max(32, n / 132
//     rounded up to a warp)), so a 256-row micro-batch runs as 8 CTAs of 32
//     rows on 8 SMs instead of one CTA of 256 on one SM, and a bulk call
//     keeps NT-row CTAs;
//   * the CTA's rows of x, one contiguous block in device memory, are staged
//     through shared memory with coalesced loads (consecutive threads read
//     consecutive words; 16-byte cp.async where the rows are 16-byte pieces:
//     f32, d % 4 == 0, x aligned), at a pitch P = DP + 4 words; a thread
//     then reads its row as 16-byte pieces, which hit distinct banks within
//     each quarter warp because P / 4 is odd.  The staging buffer is then
//     reused for the centers (dynamic shared memory, sized by the wrapper);
//   * centers and their squared norms are staged once per CTA, TM at a time,
//     only the live ones (k = 3 stages 3 rows, not TM), a thread's share of
//     a tile loaded all at once, the first tile's with x's loads;
//   * one output buffer of 3n words (dist, idx, score), one launch, and the
//     threshold read from a device pointer: the host never synchronises.
//
// Bits.  Per pair the arithmetic is RowScan's (pdist_common.cuh): one
// __fmaf_rn chain over f from 0 to DP (the zero padding adds exact zeros),
// x2 and c2 by the same chains, finish_l2, then a strict `<` in index order.
// So the fused result equals min_argmin (either route) plus an IEEE divide
// (__fdiv_rn) by max(thr, 1e-30), bit for bit.  The generic width (d > 256)
// keeps RowScan's per-thread loads.
#include "pdist_common.cuh"

namespace rt {

// A tile of centers j0 .. j0 + jn - 1 on its way into cs (TM x DP, zero
// past d).  load() puts a thread's first CB words of the tile (at
// e = threadIdx.x + u * rows) in flight into registers: the first tile's
// travel with x's loads, a later tile's all at once (a 32-row CTA holds a
// 64 x 8 tile in 16 words a thread); store() writes them to shared memory
// and reads the rest, if any (few rows against a wide tile), eight loads in
// flight at a time.  The CB loads are predicated, not skipped by a branch:
// on the H100 a uniform `break` per word took the gauss micro-batch from 5.8
// to 9.4 us per launch (PERF.md).
template <int DP, typename T>
struct CenterTile {
  static constexpr int CB = DP <= 64 ? 16 : 8;
  float v[CB];

  __device__ __forceinline__ float word(const T* __restrict__ c, int e,
                                        int cnt, int j0, int d) const {
    const int jj = e / DP, f = e - jj * DP;
    return (e < cnt && f < d) ? load_f(c, (long long)(j0 + jj) * d + f)
                              : 0.0f;
  }

  __device__ __forceinline__ void load(const T* __restrict__ c, int j0,
                                       int jn, int d) {
    const int rows = blockDim.x, cnt = jn * DP;
#pragma unroll
    for (int u = 0; u < CB; ++u) {
      v[u] = word(c, threadIdx.x + u * rows, cnt, j0, d);
    }
  }

  __device__ __forceinline__ void store(const T* __restrict__ c, float* cs,
                                        int j0, int jn, int d) const {
    const int rows = blockDim.x, cnt = jn * DP;
#pragma unroll
    for (int u = 0; u < CB; ++u) {
      if (threadIdx.x + u * rows < cnt) cs[threadIdx.x + u * rows] = v[u];
    }
    for (int e0 = threadIdx.x + CB * rows; e0 < cnt; e0 += 8 * rows) {
      float w[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) w[u] = word(c, e0 + u * rows, cnt, j0, d);
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (e0 + u * rows < cnt) cs[e0 + u * rows] = w[u];
    }
  }
};

template <int DP, int METRIC, typename T>
__global__ void __launch_bounds__(Tile<DP>::NT)
score_kernel(const T* __restrict__ x, const T* __restrict__ c,
             const float* __restrict__ thr, float* __restrict__ out, int n,
             int m, int d) {
  constexpr int TM = Tile<DP>::TM;
  constexpr int P = StagePitch<DP>::P;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;            // rows x P, then reused:
  float* cs = smem;            // TM x DP centers
  float* c2s = smem + TM * DP;  // TM squared norms

  const int rows = blockDim.x;
  const long long row0 = (long long)blockIdx.x * rows;
  const long long row = row0 + threadIdx.x;
  const bool live = row < n;
  CenterTile<DP, T> tile;
  tile.load(c, 0, min(TM, m), d);  // in flight with x's loads
  stage_rows<DP, T>(x, xs, row0, (int)min((long long)rows, n - row0), d);
  __syncthreads();

  float xr[DP];
#pragma unroll
  for (int f = 0; f < DP; f += 4) {
    const float4 v =
        *reinterpret_cast<const float4*>(xs + threadIdx.x * P + f);
    xr[f] = (live && f < d) ? v.x : 0.0f;
    xr[f + 1] = (live && f + 1 < d) ? v.y : 0.0f;
    xr[f + 2] = (live && f + 2 < d) ? v.z : 0.0f;
    xr[f + 3] = (live && f + 3 < d) ? v.w : 0.0f;
  }
  float x2 = 0.0f;
#pragma unroll
  for (int f = 0; f < DP; ++f) x2 = __fmaf_rn(xr[f], xr[f], x2);
  float best = inf_f();
  int bidx = 0;

  for (int j0 = 0; j0 < m; j0 += TM) {
    // only the tile's jn live centers are staged (k = 3: 3 of TM rows)
    const int jn = min(TM, m - j0);
    if (j0 > 0) tile.load(c, j0, jn, d);
    __syncthreads();  // x staging, or the previous tile, fully consumed
    tile.store(c, cs, j0, jn, d);
    __syncthreads();
    if (METRIC != L1) {
      for (int jj = threadIdx.x; jj < jn; jj += rows) {
        float s = 0.0f;
#pragma unroll
        for (int f = 0; f < DP; ++f)
          s = __fmaf_rn(cs[jj * DP + f], cs[jj * DP + f], s);
        c2s[jj] = s;
      }
    }
    __syncthreads();
    scan_tile<DP, METRIC>(xr, x2, cs, c2s, j0, jn, best, bidx);
  }
  if (live) {
    out[row] = best;
    reinterpret_cast<int*>(out + n)[row] = bidx;
    out[2LL * n + row] = __fdiv_rn(best, fmaxf(thr[0], 1e-30f));
  }
}

// d > 256: RowScan's generic path, per-thread loads from global memory.
template <int METRIC, typename T>
__global__ void __launch_bounds__(Tile<0>::NT)
score_generic_kernel(const T* __restrict__ x, const T* __restrict__ c,
                     const float* __restrict__ thr, float* __restrict__ out,
                     int n, int m, int d) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  RowScan<0, METRIC, T> rs;
  rs.run(x, c, row, n, m, d);
  if (row < n) {
    out[row] = rs.best;
    reinterpret_cast<int*>(out + n)[row] = rs.bidx;
    out[2LL * n + row] = __fdiv_rn(rs.best, fmaxf(thr[0], 1e-30f));
  }
}

// Shared-memory bytes the staged kernel needs for CTAs of `rows` rows.
template <int DP>
constexpr long long score_smem_bytes(int rows) {
  return 4LL * (rows * StagePitch<DP>::P > Tile<DP>::TM * (DP + 1)
                    ? rows * StagePitch<DP>::P
                    : Tile<DP>::TM * (DP + 1));
}

}  // namespace rt

// out: 3n words, dist (f32) | idx (int32) | score (f32).  rows: CTA size, a
// multiple of 32 up to Tile<DP>::NT; smem: dynamic shared-memory bytes, at
// least what the staged kernel needs (both from kernel.py: launch_plan).
extern "C" int rt_score(const void* x, const void* c, const void* thr,
                        void* out, int n, int m, int d, int metric, int dtype,
                        int rows, int smem, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  int err = 0;
  rt::dispatch_dtype(dtype, [&](auto tv) {
    using T = decltype(tv);
    rt::dispatch_metric(metric, [&](auto mv) {
      constexpr int METRIC = decltype(mv)::value;
      rt::dispatch_dp(d, [&](auto dv) {
        constexpr int DP = decltype(dv)::value;
        constexpr int NT = rt::Tile<DP>::NT;
        if (rows < 32 || rows > NT || rows % 32 != 0) {
          err = (int)cudaErrorInvalidValue;
          return;
        }
        const int blocks = (int)((n + (long long)rows - 1) / rows);
        if constexpr (DP == 0) {
          rt::score_generic_kernel<METRIC, T>
              <<<blocks, rows, 0, (cudaStream_t)stream>>>(
                  (const T*)x, (const T*)c, (const float*)thr, (float*)out, n,
                  m, d);
        } else {
          if (smem < rt::score_smem_bytes<DP>(rows)) {
            err = (int)cudaErrorInvalidValue;
            return;
          }
          auto kern = rt::score_kernel<DP, METRIC, T>;
          static int opened = 48 * 1024;  // dynamic limit set so far
          if (smem > opened) {
            const cudaError_t e = cudaFuncSetAttribute(
                kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
            if (e != cudaSuccess) { err = (int)e; return; }
            opened = smem;
          }
          kern<<<blocks, rows, smem, (cudaStream_t)stream>>>(
              (const T*)x, (const T*)c, (const float*)thr, (float*)out, n, m,
              d);
        }
      });
    });
  });
  if (err) return err;
  return (int)cudaGetLastError();
}
