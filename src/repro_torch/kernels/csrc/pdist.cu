// Fused min-distance + argmin for Hopper (sm_90a): kernel A of the port.
//
// Replaces the TPU kernel src/repro/kernels/pdist/kernel.py:min_argmin_pallas
// (_l2_kernel, _l1_kernel): for every row of x (n, d), the distance to the
// nearest row of c (m, d) and that row's index, for l2sq / l2 / l1, f32 or
// bf16 inputs (upcast to f32 on load), f32 distances and int32 indices.
//
// Bound on this card.  The largest call on the main path is Alg. 2's
// reassignment (core/augmented.py), per site n ~ 244,922 rows x m = 36,537
// centers x d = 34: 2*n*m*d ~ 6.1e11 FLOP, ~9.6 ms at the H100's 67 TFLOP/s
// fp32 CUDA-core rate.  It is compute-bound, and it stays on the CUDA cores:
// TF32 tensor cores would break parity with the f32 reference (argmins flip
// at ~3 decimal digits).  Alg. 1's rounds (m = 26) and the losses (m = 3)
// do ~n*d*m FLOP on n*d*4 bytes: they are bound by reading x once, or by
// launch latency at small n.
//
// Two routes, picked by the wrapper from (n, m, d) (kernel.py: route):
//
// * rt_min_argmin, few centers: RowScan (pdist_common.cuh), one row per
//   thread with the row in registers, centers staged through shared memory
//   and read as broadcasts.  x is read exactly once, so the byte-bound
//   calls stay at one pass over x.  At large m it pays ~58 issue slots per
//   pair (40 FMAs over d padded to 40, ~10 shared loads, c2, epilogue) for
//   the 36 the bound counts, three barriers per 64 centers, and c2 computed
//   by 64 of 256 threads while the rest wait.
//
// * rt_min_argmin_tiled, many centers: the SIMT-GEMM shape with a fused
//   min/argmin epilogue.  A CTA of 256 threads owns 128 rows; each thread
//   owns an 8 x 4 register tile of (rows x centers).  x and each tile of 64
//   centers are staged d-major in shared memory, d padded only to a
//   multiple of 4 (the loop stops at d), so one step along d is three
//   16-byte shared loads feeding 32 FMAs.  c2 is computed once per center
//   by a small first pass (center_norms_kernel), x2 once per row into
//   shared memory, not by every thread of a row.  The next center tile is
//   read into registers while the current one is scored, and stored into
//   the other buffer after: one barrier per tile.  Three CTAs fit an SM
//   (24 warps).  Each thread keeps a running (best, idx) for its rows over
//   its columns (in increasing index order, strict `<`); at the end the 16
//   threads that share a row reduce by the lexicographic (dist, idx)
//   minimum, which for non-NaN distances is exactly the sequential
//   strict-`<` scan: the smallest index wins a tie, a NaN never wins, and
//   a row whose every distance is +inf keeps index 0.  m is not split
//   across CTAs: no atomics, no second pass.  What it still pays per pair
//   beyond the 34 FMAs the bound counts: the ~7-instruction epilogue
//   (x2 + c2, 2 dot, subtract, max, compare, two selects) that the bitwise
//   contract below fixes, and a few shared loads.
//
// Both routes do the same per-pair arithmetic, bit for bit: x2, c2 and the
// dot are each one __fmaf_rn chain over f = 0..d-1 from 0 (a zero pad past
// d adds exact zeros), then max((x2 + c2) - 2 dot, 0) with the _rn
// intrinsics (finish_l2), __fsqrt_rn for l2; l1 is the |x - c| chain.  So
// score.cu (which keeps RowScan) equals this kernel plus a divide bitwise
// at any m.  A center row at 1e30 (Alg. 2's invalid slots) has c2 = +inf,
// hence distance +inf, and never wins.
//
// Left for later: a 3xTF32 wgmma route for l2sq as an opt-in backend with
// measured error (the default must keep f32 argmins: no TF32 or bf16 math
// on the default path); cp.async/TMA for the center tiles.
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

namespace rt {

// ---- large-m route: register-tiled rows x centers ----------------------
constexpr int TL_NT = 256;          // threads per CTA
constexpr int TL_R = 8;             // rows per thread
constexpr int TL_C = 4;             // centers per thread per tile
constexpr int TL_TX = 16;           // threads along centers
constexpr int TL_BM = TL_R * (TL_NT / TL_TX);   // 128 rows per CTA
constexpr int TL_BN = TL_C * TL_TX;             // 64 centers per tile
constexpr int TL_XS = TL_BM + 4;    // padded strides of the d-major tiles
constexpr int TL_CS = TL_BN + 4;    // (16-byte aligned, fewer conflicts)
constexpr int TL_MAX_D = 64;        // widest d the route takes
static_assert(TL_NT == 4 * TL_BN && TL_NT == 2 * TL_BM,
              "four threads stage each center, two each row");

__host__ __device__ constexpr int tl_dp4(int d) { return (d + 3) & ~3; }
__host__ __device__ constexpr int tl_smem_floats(int d) {
  return tl_dp4(d) * (TL_XS + 2 * TL_CS) + 2 * TL_BN + TL_BM;
}

template <typename F>
void dispatch_dq(int d, F&& f) {
  if (d <= 16) f(std::integral_constant<int, 4>{});
  else if (d <= 36) f(std::integral_constant<int, 9>{});
  else f(std::integral_constant<int, 16>{});
}

// c2[j] = one fma chain over f = 0..d-1 from 0: RowScan's c2 bits.
template <typename T>
__global__ void center_norms_kernel(const T* __restrict__ c,
                                    float* __restrict__ c2, int m, int d) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  float s = 0.0f;
  for (int f = 0; f < d; ++f) {
    const float v = load_f(c, (long long)j * d + f);
    s = __fmaf_rn(v, v, s);
  }
  c2[j] = s;
}

// Lexicographic (dist, idx) minimum: the smaller distance, and on equal
// distances the smaller index.  A NaN never compares below anything, so it
// never wins, as under the sequential strict `<`.
__device__ __forceinline__ void lex_min(float& b, int& i, float ob, int oi) {
  if (ob < b || (ob == b && oi < i)) { b = ob; i = oi; }
}

// One CTA: TL_BM rows against all m centers.  Thread (ty, tx) owns rows
// ty*TL_R .. +TL_R-1 and, of every tile of TL_BN centers, the columns
// tx*TL_C .. +TL_C-1, so its own columns come in increasing index order and
// a strict `<` keeps its smallest index on a tie.  Centers past m are staged
// so that their distance is +inf (c2 = +inf for l2, coordinates +inf for
// l1) and never win.  The next tile is read into registers while the
// current one is scored, then stored into the other shared buffer: one
// barrier per tile.
// DQ: coordinates a thread stages per center, ceil(d / 4) rounded up to
// the instantiated widths (d <= 16, 36, 64).
template <int METRIC, typename T, int DQ>
__global__ void __launch_bounds__(TL_NT, 3)
min_argmin_tiled_kernel(const T* __restrict__ x, const T* __restrict__ c,
                        const float* __restrict__ c2g,
                        float* __restrict__ dist, int* __restrict__ idx,
                        int n, int m, int d) {
  extern __shared__ __align__(16) float sm[];
  const int dp = tl_dp4(d);
  float* xs = sm;                          // [dp][TL_XS]
  float* cs0 = xs + dp * TL_XS;            // [2][dp][TL_CS]
  float* c2s = cs0 + 2 * dp * TL_CS;       // [2][TL_BN]
  float* x2s = c2s + 2 * TL_BN;            // [TL_BM]

  const int tid = threadIdx.x;
  const int tx = tid % TL_TX, ty = tid / TL_TX;
  const long long r0 = (long long)blockIdx.x * TL_BM;
  const int nr = (int)min((long long)TL_BM, (long long)n - r0);

  // x tile, d-major; rows past n and columns past d are zero
  for (int e = tid; e < dp * TL_BM; e += TL_NT) xs[(e / TL_BM) * TL_XS + e % TL_BM] = 0.0f;
  for (int e = tid; e < 2 * dp * TL_CS; e += TL_NT) cs0[e] = 0.0f;
  __syncthreads();
  {  // thread (row, half) = (tid / 2, tid % 2) reads f = half, half + 2, ...
    const int rr = tid >> 1;
    if (rr < nr)
      for (int f = tid & 1; f < d; f += 2)
        xs[f * TL_XS + rr] = load_f(x, (r0 + rr) * d + f);
  }

  // stage center tile j0 into buffer b: thread (jj, p) = (tid / 4, tid % 4)
  // reads coordinates f = p, p + 4, ... < d of center j0 + jj (only f < d
  // is ever written; the zero pad stays)
  float pre[DQ];
  const int sj = tid >> 2, sp = tid & 3;
  auto fetch = [&](int j0) {
    const bool live = j0 + sj < m;
    const long long base = (long long)(j0 + sj) * d;
#pragma unroll
    for (int q = 0; q < DQ; ++q) {
      const int f = sp + 4 * q;
      if (f < d)
        pre[q] = live ? load_f(c, base + f) : (METRIC == L1 ? inf_f() : 0.0f);
    }
  };
  auto store = [&](int j0, int b) {
    float* cs = cs0 + b * dp * TL_CS;
#pragma unroll
    for (int q = 0; q < DQ; ++q) {
      const int f = sp + 4 * q;
      if (f < d) cs[f * TL_CS + sj] = pre[q];
    }
    if (METRIC != L1 && tid < TL_BN)
      c2s[b * TL_BN + tid] = j0 + tid < m ? c2g[j0 + tid] : inf_f();
  };

  __syncthreads();                         // x staged
  if (METRIC != L1 && tid < TL_BM) {       // x2 of each row, once
    float s2 = 0.0f;
    for (int f = 0; f < d; ++f) s2 = __fmaf_rn(xs[f * TL_XS + tid], xs[f * TL_XS + tid], s2);
    x2s[tid] = s2;
  }
  fetch(0);
  store(0, 0);
  __syncthreads();

  float xa[TL_R];
  float best[TL_R];
  int bidx[TL_R];
#pragma unroll
  for (int r = 0; r < TL_R; ++r) {
    best[r] = inf_f();
    bidx[r] = 0x7fffffff;
  }

  const int ntiles = (m + TL_BN - 1) / TL_BN;
  for (int t = 0; t < ntiles; ++t) {
    const int b = t & 1;
    const int j0 = t * TL_BN;
    if (t + 1 < ntiles) fetch(j0 + TL_BN);
    const float* cs = cs0 + b * dp * TL_CS;
    float acc[TL_R][TL_C];
#pragma unroll
    for (int r = 0; r < TL_R; ++r)
#pragma unroll
      for (int q = 0; q < TL_C; ++q) acc[r][q] = 0.0f;
#pragma unroll 4
    for (int f = 0; f < d; ++f) {           // the zero pad adds nothing
      const float4 xa0 = *reinterpret_cast<const float4*>(xs + f * TL_XS + ty * TL_R);
      const float4 xa1 = *reinterpret_cast<const float4*>(xs + f * TL_XS + ty * TL_R + 4);
      const float4 cv = *reinterpret_cast<const float4*>(cs + f * TL_CS + tx * TL_C);
      xa[0] = xa0.x; xa[1] = xa0.y; xa[2] = xa0.z; xa[3] = xa0.w;
      xa[4] = xa1.x; xa[5] = xa1.y; xa[6] = xa1.z; xa[7] = xa1.w;
      const float cb[TL_C] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
      for (int r = 0; r < TL_R; ++r)
#pragma unroll
        for (int q = 0; q < TL_C; ++q) {
          if (METRIC == L1)
            acc[r][q] = __fadd_rn(acc[r][q], fabsf(__fsub_rn(xa[r], cb[q])));
          else
            acc[r][q] = __fmaf_rn(xa[r], cb[q], acc[r][q]);
        }
    }
    float c2v[TL_C], x2[TL_R];
#pragma unroll
    for (int q = 0; q < TL_C; ++q)
      c2v[q] = METRIC == L1 ? 0.0f : c2s[b * TL_BN + tx * TL_C + q];
#pragma unroll
    for (int r = 0; r < TL_R; ++r)
      x2[r] = METRIC == L1 ? 0.0f : x2s[ty * TL_R + r];
#pragma unroll
    for (int q = 0; q < TL_C; ++q) {
      const int j = j0 + tx * TL_C + q;
#pragma unroll
      for (int r = 0; r < TL_R; ++r) {
        float v = acc[r][q];
        if (METRIC != L1) v = finish_l2<METRIC>(x2[r], c2v[q], v);
        if (v < best[r]) { best[r] = v; bidx[r] = j; }
      }
    }
    if (t + 1 < ntiles) store(j0 + TL_BN, b ^ 1);
    __syncthreads();
  }

  // the TL_TX threads of a row group are TL_TX consecutive lanes
#pragma unroll
  for (int r = 0; r < TL_R; ++r) {
#pragma unroll
    for (int sh = TL_TX / 2; sh > 0; sh >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[r], sh);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx[r], sh);
      lex_min(best[r], bidx[r], ob, oi);
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int r = 0; r < TL_R; ++r) {
      const int rr = ty * TL_R + r;
      if (rr < nr) {
        dist[r0 + rr] = best[r];
        idx[r0 + rr] = bidx[r] == 0x7fffffff ? 0 : bidx[r];
      }
    }
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

// The large-m route.  c2 is scratch of m floats from the wrapper (unused by
// l1); d <= TL_MAX_D.  Two launches on the stream: the center norms, then
// the tiles.  Returns cudaGetLastError() after them.
extern "C" int rt_min_argmin_tiled(const void* x, const void* c, void* c2,
                                   void* dist, void* idx, int n, int m,
                                   int d, int metric, int dtype,
                                   void* stream) {
  if (d < 1 || d > rt::TL_MAX_D || m < 1) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  int err = 0;
  rt::dispatch_dtype(dtype, [&](auto tv) {
    using T = decltype(tv);
    if (metric != rt::L1)
      rt::center_norms_kernel<T><<<(m + 255) / 256, 256, 0, s>>>(
          (const T*)c, (float*)c2, m, d);
    rt::dispatch_metric(metric, [&](auto mv) {
      constexpr int METRIC = decltype(mv)::value;
      rt::dispatch_dq(d, [&](auto qv) {
        auto kern = rt::min_argmin_tiled_kernel<METRIC, T, decltype(qv)::value>;
        const int bytes = rt::tl_smem_floats(d) * (int)sizeof(float);
        cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (e != cudaSuccess) { err = (int)e; return; }
        const int blocks = (n + rt::TL_BM - 1) / rt::TL_BM;
        kern<<<blocks, rt::TL_NT, bytes, s>>>((const T*)x, (const T*)c,
                                              (const float*)c2, (float*)dist,
                                              (int*)idx, n, m, d);
      });
    });
  });
  if (err) return err;
  return (int)cudaGetLastError();
}

// Resident CTAs per SM of the tiled kernel at width d, for the reports.
extern "C" int rt_min_argmin_tiled_blocks_per_sm(int d, int metric,
                                                 int dtype) {
  int n = -1;
  rt::dispatch_dtype(dtype, [&](auto tv) {
    using T = decltype(tv);
    rt::dispatch_metric(metric, [&](auto mv) {
      constexpr int METRIC = decltype(mv)::value;
      rt::dispatch_dq(d, [&](auto qv) {
        auto kern = rt::min_argmin_tiled_kernel<METRIC, T, decltype(qv)::value>;
        const int bytes = rt::tl_smem_floats(d) * (int)sizeof(float);
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, rt::TL_NT,
                                                      bytes);
      });
    });
  });
  return n;
}
