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
// 100 (gauss), d = 34 or 5.  At kdd (874,751 x 3 x 34) a call must read
// 119 MB of x: 0.0386 ms at 3.35 TB/s, against ~0.01 ms of fp32 FMA, so it
// is bound by reading x once.  At gauss (180,040 x 100 x 5) it is bound by
// the scan of 100 centers per row (0.0038 ms of fp32 operations).
//
// Design (the warp route: every padded width whose blocks fit in shared
// memory; kernel.py: lloyd_plan):
//   * a CTA owns a fixed range of whole NT-row tiles: ceil(tiles / 264)
//     each, so the split depends on n and d only, never on occupancy or the
//     device, and the kdd and gauss second levels run as one wave of two
//     CTAs per SM.  A tile's rows and weights travel by cp.async into one of
//     two shared-memory buffers while the CTA computes on the other (f32;
//     bf16 rows are converted on the way by plain loads);
//   * each thread reads its row back into registers and scans the centers
//     with scan_tile: RowScan's arithmetic, so assign and dist equal
//     min_argmin's bit for bit.  All k centers and their norms are staged
//     once per CTA;
//   * the accumulation runs on every lane, from the staged rows, into one
//     partial block per warp (per half-warp by row), in a fixed order, with
//     no float atomics.  By center (few centers: kernel.py's FEW_CENTERS):
//     the warp takes the centers present among its 32 rows one at a time
//     (ballot on the lowest remaining lane's center), row groups sum their
//     rows of it in row order in registers and a fixed butterfly adds the
//     groups.  By row (more centers): each half-warp adds its 16 rows in
//     order straight into its partial, lane l owning columns l, l + 16, ...
//     (no round per center when a warp's rows hold many).  The first design
//     walked a tile's 256 rows one by one on the d + 1 threads f <= d (35
//     of 256 at d = 34);
//   * at the end the CTA adds its partial blocks in order and writes one
//     partial per CTA, word-major, and a second kernel adds each word's
//     partials with a warp: lane l takes partials l, l + 32, ... in order,
//     then a fixed butterfly.
// The same inputs give the same sums bit for bit on every run.
//
// The serial route (the first design) keeps blocks that do not fit in
// shared memory at d <= 160 (two tiles of rows plus the partials: k (d + 1)
// large, e.g. k = 2048 x d = 130 or k = 100 x d = 34, where chip_smoke.py's
// Lloyd ladder read the serial route faster than by center); there the d + 1
// threads f <= d accumulate a tile's rows in row order into the CTA's
// partial, in shared memory when it fits in 96 KB, else in global memory.
//
// The chunked route, d > 160 (kernel.py: lloyd_plan): the assignment is
// pdist.cu's chunked tile (pdist_common.cuh: chunked_tile; a row per thread
// held in registers, as the serial route's RowScan does, does not fit past
// these widths, and the generic width re-read each row from global memory
// for every center), 128 rows at a time, after center_norms_kernel; then the
// serial route's accumulation of those rows, in row order (SerialAcc, one
// body for both routes).  Its split of rows over CTAs is the serial route's,
// so its sums are the serial route's bit for bit.
#include "pdist_common.cuh"

namespace rt {

// kernel.py: ROUTES.  CENTERS and ROWS are the warp route's two ways to
// accumulate (lloyd_warp_kernel).
enum LloydRoute { CENTERS = 0, ROWS = 1, SERIAL = 2, CHUNKED = 3 };

constexpr int kSmemAccFloats = 24576;  // serial route: 96 KB partial block

// Floats of dynamic shared memory of the warp route (kernel.py: lloyd_plan):
// two buffers of rows xs (NT x P) and weights ws (NT) | cs (k x DP) |
// c2s (k) | acc: one (k, d + 1) partial per warp, per half-warp by row.
template <int DP>
__host__ __device__ constexpr long long lloyd_smem_floats(int k, int d,
                                                          bool by_row) {
  return 2LL * Tile<DP>::NT * (StagePitch<DP>::P + 1) +
         (long long)k * (DP + 1) +
         (long long)(Tile<DP>::NT / 32) * (by_row ? 2 : 1) * k * (d + 1);
}

// Row groups of the by-center accumulation at width DP: as many as keep a
// lane at most 8 columns (CPL below).
template <int DP>
struct LloydGroups {
  static constexpr int RG = DP <= 48 ? 4 : (DP <= 96 ? 2 : 1);
};

// Rows t0 .. t0 + live - 1 of x into xs at pitch P by cp.async in pieces
// of E = S / 4 words; d % E == 0, so a piece never crosses a row.  A thread
// takes pieces threadIdx.x, + NT, ...: consecutive threads, consecutive
// addresses.
template <int DP, int S>
__device__ __forceinline__ void copy_rows(const float* __restrict__ x,
                                          float* xs, long long t0, int live,
                                          int d) {
  constexpr int P = StagePitch<DP>::P, E = S / 4, NT = Tile<DP>::NT;
  const int cnt = live * d, step = NT * E;
  const int sr = step / d, sf = step - sr * d;
  int e = threadIdx.x * E, r = e / d, f = e - r * d;
  const float* src = x + t0 * d;
  for (; e < cnt; e += step) {
    cp_async<S>(xs + r * P + f, src + e);
    r += sr;
    f += sf;
    if (f >= d) {
      f -= d;
      ++r;
    }
  }
}

// Start a tile's rows and weights on their way into one buffer, as one
// cp.async group: f32 rows in the widest pieces d and x's alignment allow.
// bf16 rows are converted on the way (stage_rows' loads, done by the time
// it returns) and close an empty group.
template <int DP, typename T>
__device__ __forceinline__ void start_tile(const T* __restrict__ x,
                                           const float* __restrict__ w,
                                           float* xs, float* ws, long long t0,
                                           int live, int d) {
  if constexpr (std::is_same<T, float>::value) {
    const size_t a = reinterpret_cast<size_t>(x);
    if (d % 4 == 0 && (a & 15) == 0)
      copy_rows<DP, 16>(x, xs, t0, live, d);
    else if (d % 2 == 0 && (a & 7) == 0)
      copy_rows<DP, 8>(x, xs, t0, live, d);
    else
      copy_rows<DP, 4>(x, xs, t0, live, d);
    if (threadIdx.x < live) cp_async<4>(ws + threadIdx.x, w + t0 + threadIdx.x);
  } else {
    stage_rows<DP, T>(x, xs, t0, live, d);
    if (threadIdx.x < live) ws[threadIdx.x] = w[t0 + threadIdx.x];
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int DP, int METRIC, typename T>
__global__ void __launch_bounds__(Tile<DP>::NT)
lloyd_warp_kernel(const T* __restrict__ x, const float* __restrict__ w,
                  const T* __restrict__ c, int* __restrict__ assign,
                  float* __restrict__ dist, float* __restrict__ part, int n,
                  int k, int d, int rows_per_cta, bool by_row) {
  constexpr int NT = Tile<DP>::NT;
  constexpr int NW = NT / 32;
  constexpr int P = StagePitch<DP>::P;
  constexpr unsigned FULL = 0xffffffffu;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                 // two buffers of NT x P
  float* ws = xs + 2 * NT * P;      // two buffers of NT
  float* cs = ws + 2 * NT;
  float* c2s = cs + k * DP;
  float* acc = c2s + k;
  const int K1 = k * (d + 1);  // [j * (d + 1) + f]; f == d holds the count
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int parts = NW * (by_row ? 2 : 1);  // partial blocks, in order
  float* acc_w = acc + warp * (parts / NW) * K1;
  for (int e = threadIdx.x; e < parts * K1; e += NT) acc[e] = 0.0f;
  // the centers, zero past d, and their norms: one fma chain over f = 0..DP
  // each, RowScan's c2 bits
  for (int e = threadIdx.x; e < k * DP; e += NT) {
    const int j = e / DP, f = e - j * DP;
    cs[e] = f < d ? load_f(c, (long long)j * d + f) : 0.0f;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += NT) {
    float s = 0.0f;
#pragma unroll
    for (int f = 0; f < DP; ++f)
      s = __fmaf_rn(cs[j * DP + f], cs[j * DP + f], s);
    c2s[j] = s;
  }

  const long long r0 = (long long)blockIdx.x * rows_per_cta;
  const long long r_end = min((long long)n, r0 + rows_per_cta);
  const int tiles = (int)((r_end - r0 + NT - 1) / NT);
  start_tile<DP, T>(x, w, xs, ws, r0, (int)min((long long)NT, r_end - r0), d);
  for (int i = 0; i < tiles; ++i) {
    const long long t0 = r0 + (long long)i * NT;
    const int live_rows = (int)min((long long)NT, r_end - t0);
    const float* xb = xs + (i & 1) * NT * P;
    const float* wb = ws + (i & 1) * NT;
    if (i + 1 < tiles) {  // the next tile travels while this one computes
      const long long t1 = t0 + NT;
      start_tile<DP, T>(x, w, xs + ((i + 1) & 1) * NT * P,
                        ws + ((i + 1) & 1) * NT, t1,
                        (int)min((long long)NT, r_end - t1), d);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // this tile's rows (the first tile: norms, acc too)
    const bool live = threadIdx.x < live_rows;
    const long long row = t0 + threadIdx.x;

    float xr[DP];
#pragma unroll
    for (int f = 0; f < DP; f += 4) {
      const float4 v =
          *reinterpret_cast<const float4*>(xb + threadIdx.x * P + f);
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
    scan_tile<DP, METRIC>(xr, x2, cs, c2s, 0, k, best, bidx);
    if (live) {
      assign[row] = bidx;
      dist[row] = best;
    }
    const float* xw = xb + warp * 32 * P;
    const float* ww = wb + warp * 32;
    if (!by_row) {
      // by center: the warp takes the centers present among its rows one
      // at a time; RG row groups of L lanes each sum their rows (r % RG)
      // of that center in row order in registers, lane l of a group owning
      // columns l, l + L, ...; a fixed butterfly adds the groups; group 0
      // adds the sum into the warp's partial
      constexpr int RG = LloydGroups<DP>::RG, L = 32 / RG;
      constexpr int CPL = (DP + L) / L;  // columns per lane: d + 1 <= DP + 1
      const int grp = lane / L, gl = lane - grp * L;
      const unsigned mine =
          (RG == 1 ? FULL : (RG == 2 ? 0x55555555u : 0x11111111u)) << grp;
      unsigned rem = __ballot_sync(FULL, live);
      while (rem) {
        const int j = __shfl_sync(FULL, bidx, __ffs(rem) - 1);
        const unsigned mj = __ballot_sync(FULL, live && bidx == j);
        rem &= ~mj;
        float s[CPL];
#pragma unroll
        for (int u = 0; u < CPL; ++u) s[u] = 0.0f;
        for (unsigned m = mj & mine; m; m &= m - 1) {
          const int r = __ffs(m) - 1;
          const float wr = ww[r];
#pragma unroll
          for (int u = 0; u < CPL; ++u) {
            const int f = gl + L * u;
            // f < d: the weighted coordinate; f == d: the weight itself
            s[u] = __fmaf_rn(wr, f < d ? xw[r * P + f] : 1.0f, s[u]);
          }
        }
#pragma unroll
        for (int o = L; o < 32; o <<= 1)
#pragma unroll
          for (int u = 0; u < CPL; ++u)
            s[u] = __fadd_rn(s[u], __shfl_xor_sync(FULL, s[u], o));
        if (grp == 0) {
          float* a = acc_w + j * (d + 1);
#pragma unroll
          for (int u = 0; u < CPL; ++u) {
            const int f = gl + L * u;
            if (f <= d) a[f] = __fadd_rn(a[f], s[u]);
          }
        }
      }
    } else {
      // by row: each half-warp walks its 16 rows in order, lane l owning
      // columns l, l + 16, ..., adding each row into the half-warp's own
      // partial (no ballot round per center: many centers per warp)
      constexpr int CPL = (DP + 16) / 16;
      const int h = lane >> 4, gl = lane & 15;
      float* a_h = acc_w + h * K1;
      for (int q = 0; q < 16; ++q) {
        const int r = h * 16 + q;
        const int j = __shfl_sync(FULL, bidx, r);
        if (__shfl_sync(FULL, (int)live, r)) {
          const float wr = ww[r];
          float* a = a_h + j * (d + 1);
#pragma unroll
          for (int u = 0; u < CPL; ++u) {
            const int f = gl + 16 * u;
            if (f <= d)
              a[f] = __fmaf_rn(wr, f < d ? xw[r * P + f] : 1.0f, a[f]);
          }
        }
      }
    }
    __syncthreads();  // this buffer free for the tile after next
  }
  // the CTA's partial: its warps' blocks in warp order, word-major
  for (int e = threadIdx.x; e < K1; e += NT) {
    float s = acc[e];
    for (int q = 1; q < parts; ++q) s = __fadd_rn(s, acc[q * K1 + e]);
    part[(long long)e * gridDim.x + blockIdx.x] = s;
  }
}

// The serial accumulation, one body for the serial and chunked routes: the
// CTA's partial of K1 = k (d + 1) words [j * (d + 1) + f] (f == d holds the
// count), summed in shared memory (smem) when acc_in_smem, else in place at
// part + blockIdx.x * K1.  The threads f <= d add a tile's nr rows (their
// centers a_s, weights w_s) in row order; finish() copies a shared partial
// out.  So the same rows split over CTAs alike give the same sums bit for
// bit, whichever route assigned them.
template <int NT>
struct SerialAcc {
  float* part;  // the CTA's partial in global memory
  float* acc;   // where it is summed: smem, or part itself
  int K1, d;

  __device__ SerialAcc(float* smem, float* part_all, int k, int d_,
                       int acc_in_smem)
      : K1(k * (d_ + 1)), d(d_) {
    part = part_all + (long long)blockIdx.x * K1;
    acc = acc_in_smem ? smem : part;
    for (int e = threadIdx.x; e < K1; e += NT) acc[e] = 0.0f;
    __syncthreads();
  }

  template <typename T>
  __device__ __forceinline__ void add_rows(const T* __restrict__ x,
                                           long long t0, int nr,
                                           const int* a_s, const float* w_s) {
    for (int f = threadIdx.x; f <= d; f += NT) {
      for (int r = 0; r < nr; ++r) {
        const float wr = w_s[r];
        const float v =
            f < d ? __fmul_rn(wr, load_f(x, (t0 + r) * d + f)) : wr;
        float* p = acc + a_s[r] * (d + 1) + f;
        *p = __fadd_rn(*p, v);
      }
    }
  }

  __device__ __forceinline__ void finish() {
    if (acc != part)
      for (int e = threadIdx.x; e < K1; e += NT) part[e] = acc[e];
  }
};

template <int DP, int METRIC, typename T>
__global__ void __launch_bounds__(Tile<DP>::NT)
lloyd_serial_kernel(const T* __restrict__ x, const float* __restrict__ w,
                    const T* __restrict__ c, int* __restrict__ assign,
                    float* __restrict__ dist, float* __restrict__ part, int n,
                    int k, int d, int rows_per_cta, int acc_in_smem) {
  constexpr int NT = Tile<DP>::NT;
  extern __shared__ float acc_smem[];
  __shared__ int a_s[NT];
  __shared__ float w_s[NT];
  SerialAcc<NT> acc(acc_smem, part, k, d, acc_in_smem);

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
    acc.add_rows(x, t0, (int)min((long long)NT, r_end - t0), a_s, w_s);
    __syncthreads();
  }
  acc.finish();
}

// The chunked route: each 128-row tile of the CTA's rows assigned by the
// chunked tile (c2g: the centers' norms), then added by SerialAcc, as the
// serial route adds its rows: the partial in shared memory past the tile's
// buffers when acc_in_smem.
template <int METRIC, typename T>
__global__ void __launch_bounds__(ChunkTile::NT, 2)
lloyd_chunked_kernel(const T* __restrict__ x, const float* __restrict__ w,
                     const T* __restrict__ c, const float* __restrict__ c2g,
                     int* __restrict__ assign, float* __restrict__ dist,
                     float* __restrict__ part, int n, int k, int d,
                     int rows_per_cta, int acc_in_smem) {
  using K = ChunkTile;
  extern __shared__ __align__(16) float sm[];
  __shared__ int a_s[K::BM];
  __shared__ float w_s[K::BM];
  SerialAcc<K::NT> acc(sm + K::FLOATS, part, k, d, acc_in_smem);

  const long long r0 = (long long)blockIdx.x * rows_per_cta;
  const long long r_end = min((long long)n, r0 + rows_per_cta);
  for (long long t0 = r0; t0 < r_end; t0 += K::BM) {
    const int nr = (int)min((long long)K::BM, r_end - t0);
    float best[K::R];
    int bidx[K::R];
    chunked_tile<METRIC, T>(x, c, c2g, t0, nr, k, d, sm, best, bidx);
    if (threadIdx.x % K::TX == 0) {
      const int ty = threadIdx.x / K::TX;
#pragma unroll
      for (int r = 0; r < K::R; ++r) {
        const int rr = ty * K::R + r;
        if (rr < nr) {
          assign[t0 + rr] = bidx[r];
          dist[t0 + rr] = best[r];
          a_s[rr] = bidx[r];
          w_s[rr] = w[t0 + rr];
        }
      }
    }
    __syncthreads();
    acc.add_rows(x, t0, nr, a_s, w_s);
    __syncthreads();
  }
  acc.finish();
}

// Each word's G partials (word e of CTA g at part[g * sg + e * se]) in a
// fixed order: one warp per word, lane l adds partials l, l + 32, ... in
// order, then a butterfly of fixed shape (after each step the two lanes of a
// pair hold the same bits, so every lane ends with the same sum).
__global__ void lloyd_reduce_kernel(const float* __restrict__ part,
                                    float* __restrict__ sums,
                                    float* __restrict__ counts, int G, int k,
                                    int d, long long sg, long long se) {
  const long long K1 = (long long)k * (d + 1);
  const long long e = (long long)blockIdx.x * (blockDim.x / 32) +
                      threadIdx.x / 32;
  if (e >= K1) return;  // a whole warp
  const int lane = threadIdx.x & 31;
  float s = 0.0f;
#pragma unroll 8
  for (int g = lane; g < G; g += 32) s = __fadd_rn(s, part[g * sg + e * se]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  if (lane == 0) {
    const int j = (int)(e / (d + 1)), f = (int)(e - (long long)j * (d + 1));
    if (f < d)
      sums[(long long)j * d + f] = s;
    else
      counts[j] = s;
  }
}

}  // namespace rt

// One Lloyd step on `stream`.  route, rows_per_cta and smem come from
// kernel.py: lloyd_plan; part holds ceil(n / rows_per_cta) * k * (d + 1)
// floats of scratch, and k more on the chunked route (the centers' norms).
// Returns cudaGetLastError() (cudaErrorInvalidValue for a plan the kernels
// do not take).
extern "C" int rt_lloyd_step(const void* x, const void* w, const void* c,
                             void* sums, void* counts, void* assign,
                             void* dist, void* part, int n, int k, int d,
                             int metric, int dtype, int route,
                             int rows_per_cta, int smem, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (rows_per_cta < 1 || k < 1 || route < rt::CENTERS ||
      route > rt::CHUNKED)
    return (int)cudaErrorInvalidValue;
  const int G = (int)((n + (long long)rows_per_cta - 1) / rows_per_cta);
  const int K1 = k * (d + 1);
  cudaStream_t st = (cudaStream_t)stream;
  int err = 0;
  rt::dispatch_dtype(dtype, [&](auto tv) {
    using T = decltype(tv);
    auto go = [&](auto mv) {
      constexpr int METRIC = decltype(mv)::value;
      if (route == rt::CHUNKED) {
        using K = rt::ChunkTile;
        const bool in_smem = smem > 4 * K::FLOATS;
        if (rows_per_cta % K::BM != 0 || smem < 4 * K::FLOATS ||
            (in_smem && (K1 > rt::kSmemAccFloats ||
                         smem < 4LL * (K::FLOATS + K1)))) {
          err = (int)cudaErrorInvalidValue;
          return;
        }
        float* c2 = (float*)part + (long long)G * K1;
        rt::center_norms_kernel<T><<<(k + 255) / 256, 256, 0, st>>>(
            (const T*)c, c2, k, d);
        auto kern = rt::lloyd_chunked_kernel<METRIC, T>;
        static int opened = 48 * 1024;
        if (smem > opened) {
          const cudaError_t e = cudaFuncSetAttribute(
              kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
          if (e != cudaSuccess) { err = (int)e; return; }
          opened = smem;
        }
        kern<<<G, K::NT, smem, st>>>(
            (const T*)x, (const float*)w, (const T*)c, c2, (int*)assign,
            (float*)dist, (float*)part, n, k, d, rows_per_cta, in_smem);
        return;
      }
      rt::dispatch_dp(d, [&](auto dv) {
        constexpr int DP = decltype(dv)::value;
        constexpr int NT = rt::Tile<DP>::NT;
        // the dynamic limit set so far, per kernel instantiation
        auto open = [&](auto kern, int& opened) {
          if (smem > opened) {
            const cudaError_t e = cudaFuncSetAttribute(
                kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
            if (e != cudaSuccess) return (int)e;
            opened = smem;
          }
          return 0;
        };
        if (route != rt::SERIAL) {
          const bool by_row = route == rt::ROWS;
          if constexpr (DP == 0) {
            err = (int)cudaErrorInvalidValue;
          } else {
            if (smem < 4 * rt::lloyd_smem_floats<DP>(k, d, by_row)) {
              err = (int)cudaErrorInvalidValue;
              return;
            }
            auto kern = rt::lloyd_warp_kernel<DP, METRIC, T>;
            static int opened = 48 * 1024;
            if ((err = open(kern, opened))) return;
            kern<<<G, NT, smem, st>>>(
                (const T*)x, (const float*)w, (const T*)c, (int*)assign,
                (float*)dist, (float*)part, n, k, d, rows_per_cta, by_row);
          }
        } else {
          const bool in_smem = smem > 0;
          if (in_smem && (K1 > rt::kSmemAccFloats || smem < 4LL * K1)) {
            err = (int)cudaErrorInvalidValue;
            return;
          }
          auto kern = rt::lloyd_serial_kernel<DP, METRIC, T>;
          static int opened = 48 * 1024;
          if ((err = open(kern, opened))) return;
          kern<<<G, NT, smem, st>>>(
              (const T*)x, (const float*)w, (const T*)c, (int*)assign,
              (float*)dist, (float*)part, n, k, d, rows_per_cta, in_smem);
        }
      });
    };
    if (metric == rt::L2)
      go(std::integral_constant<int, rt::L2>{});
    else
      go(std::integral_constant<int, rt::L2SQ>{});
  });
  if (err) return err;
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const bool by_cta = route == rt::SERIAL || route == rt::CHUNKED;
  const long long sg = by_cta ? K1 : 1;
  const long long se = by_cta ? 1 : G;
  rt::lloyd_reduce_kernel<<<(K1 + 7) / 8, 256, 0, st>>>(
      (const float*)part, (float*)sums, (float*)counts, G, k, d, sg, se);
  return (int)cudaGetLastError();
}
