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
// Three routes, picked by the wrapper from (n, m, d) (kernel.py: route, with
// TILED_MIN_M and CHUNKED_MIN_M from chip_smoke.py's route ladders):
//
// * rt_min_argmin, few centers (min_argmin_rows_kernel): Alg. 1's rounds,
//   the losses, the stream's assignments and merges.  A call is bound by
//   reading x once (kdd's round: 33 MB, 0.0105 ms) or by the scan's
//   instructions (~DP + 7 a pair: DP FMAs, the bit-exact epilogue, the
//   strict-`<` compare), and small calls by their launch.  The design:
//   - persistent CTAs: kernel.py's launch_plan sizes a tile's rows from n
//     (the busiest SM within 4% of the best split) and launches as many
//     CTAs as the SMs hold at once, each walking tiles blockIdx.x, + grid;
//   - every center and its norm staged once per CTA (one barrier, not
//     three per 64 centers), at a pitch whose 16-byte pieces fall in
//     distinct banks for the norms' sums; the scan reads them as
//     broadcasts.  Below the tiled threshold they always fit (d > 64 with
//     many centers stages them in chunks);
//   - a tile's rows, one contiguous block of x, arrive by Hopper's bulk
//     copy on an mbarrier (one copy per row at pitch P where rows are
//     16-byte pieces, else one copy of the block's aligned span at pitch d
//     with its ragged ends by plain loads: d = 5 and 34 too), while the
//     CTA scans the previous tile; two buffers for few centers (a short
//     scan cannot hide the next copy), one otherwise (more CTAs an SM);
//   - two rows a thread (d <= 64): a 16-byte warp load of a center takes
//     four of the SM's shared-memory clocks (128 bytes a clock), so with
//     one row a thread the scan waited on those loads: each center word
//     now feeds two rows' FMAs.  Four rows a thread measured no faster;
//   - at d = 5 and d = 34 the chains stop at d, not at the padded DP.
//   On the H100 this took kdd's round from 33.8 to 20.5 us a launch and
//   its losses from 315 to 253 us (PERF.md); the small calls stay bound by
//   the host's ~20-40 us a call.
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
// * rt_min_argmin_chunked, d > 64 (every m past 256, many centers below):
//   the tiled route's SIMT tile at 128 x 128 (8 x 8 a thread) and its
//   epilogue, with d streamed through shared memory in chunks by 4-byte
//   cp.async (pdist_common.cuh: chunked_tile), since the tiled route stages
//   all of d (823 KB at the d = 768 of LM document embeddings).  Its bound
//   at the curation cell's reassignment (62,500 rows x 10,801 center slots
//   x 768 a site, 16.6 ms at 67 TFLOP/s) is the FMAs as well: a CTA reads
//   its rows again for every 128 centers, 64 operations a byte, ~1 TB/s of
//   HBM at the fp32 rate.  On the H100 it reached 49% of that rate (31.3
//   ms), where an 8 x 4 tile reached 41% and the same with its chunks
//   staged through registers (128 of them, spilled) 32% (PERF.md).
//
// All routes do the same per-pair arithmetic, bit for bit: x2, c2 and the
// dot are each one __fmaf_rn chain over f = 0..d-1 from 0 (a zero pad past
// d adds exact zeros), then max((x2 + c2) - 2 dot, 0) with the _rn
// intrinsics (finish_l2), __fsqrt_rn for l2; l1 is the |x - c| chain.  So
// score.cu (which keeps RowScan) equals this kernel plus a divide bitwise
// at any m.  A center row at 1e30 (Alg. 2's invalid slots) has c2 = +inf,
// hence distance +inf, and never wins.
//
// Left for later: a 3xTF32 wgmma route for l2sq as an opt-in backend with
// measured error (the default must keep f32 argmins: no TF32 or bf16 math
// on the default path); TMA for the tiled route's center tiles.
#include "pdist_common.cuh"

namespace rt {

// ---- small-m route: persistent CTAs, centers staged once ------------------

// Center pitch in shared memory: DP + 4 words, P / 4 odd (StagePitch), so
// the threads that sum the centers' norms, one center each, read 16-byte
// pieces from distinct banks; the scan reads them as broadcasts.
template <int DP>
struct CenterPitch {
  static constexpr int CP = StagePitch<DP>::P;
};

// Row buffers a CTA cycles through, one or two (kernel.py: launch_plan's
// `buffers`): a tile's rows are in registers before its scan starts, so the
// copy of tile i + B into the buffer tile i used overlaps the scan of tiles
// i .. i + B - 1.  The layout always holds two mbarriers.
constexpr int kMaxRowBuffers = 2;

// Dynamic shared memory of min_argmin_rows_kernel, in bytes (kernel.py:
// launch_plan computes the same): two mbarriers (16) | mc centers at pitch
// CP | their norms, mc rounded up to 4 | nbuf row buffers.  A buffer holds
// a
// tile at pitch P where its rows may come by row (d % 4 == 0), else at
// pitch d plus 16 bytes for the block's alignment shift (which also bounds
// bf16 rows, at half the bytes).
__host__ __device__ constexpr long long rs_buf_bytes(int rows, int d, int p) {
  return d % 4 == 0 ? 4LL * rows * p : 4LL * rows * d + 16;
}
template <int DP>
__host__ __device__ constexpr long long rs_smem_bytes(int rows, int mc, int d,
                                                      int nbuf) {
  return 16 + 4LL * mc * CenterPitch<DP>::CP + 4LL * ((mc + 3) & ~3) +
         nbuf * rs_buf_bytes(rows, d, StagePitch<DP>::P);
}

// Rows per thread of the small-m route at width DP (kernel.py: RPT).  Each
// center word read from shared memory feeds R rows' FMAs: a 16-byte warp
// load takes 4 of the SM's shared-memory clocks (128 bytes a clock), so
// with one row a thread the scan waits on those loads, not on its FMAs.
template <int DP>
struct RowsPerThread {
  static constexpr int R = DP <= 64 ? 2 : 1;
};

// scan_tile's scan (pdist_common.cuh) for R rows a thread, over centers at
// pitch CP, G centers at a time: every (row, center) is one chain over f in
// order; each row then compares its centers in increasing index order with
// a strict `<`.  The chains stop at DX <= DP: DX = d at the widths that
// have their own instantiation (dispatch_dx), where the zero padding past
// d would add only exact zeros, so the bits are those of the chain over DP
// (and of the tiled route, whose loops stop at d).
template <int DP, int DX, int R, int METRIC>
__device__ __forceinline__ void scan_centers(const float (&xr)[R][DP],
                                             const float (&x2)[R],
                                             const float* cs,
                                             const float* c2s, int j0,
                                             int jn, float (&best)[R],
                                             int (&bidx)[R]) {
  constexpr int CP = CenterPitch<DP>::CP;
  constexpr int G = 4;
  int jj = 0;
  for (; jj + G <= jn; jj += G) {
    float a[G][R];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int r = 0; r < R; ++r) a[g][r] = 0.0f;
    const float* p = cs + jj * CP;
#pragma unroll
    for (int f = 0; f < DX; ++f) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float cv = p[g * CP + f];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (METRIC == L1)
            a[g][r] = __fadd_rn(a[g][r], fabsf(__fsub_rn(xr[r][f], cv)));
          else
            a[g][r] = __fmaf_rn(xr[r][f], cv, a[g][r]);
        }
      }
    }
    float c2[G] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (METRIC != L1) {
      const float4 v = *reinterpret_cast<const float4*>(c2s + jj);
      c2[0] = v.x; c2[1] = v.y; c2[2] = v.z; c2[3] = v.w;
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float v = a[g][r];
        if (METRIC != L1) v = finish_l2<METRIC>(x2[r], c2[g], v);
        if (v < best[r]) { best[r] = v; bidx[r] = j0 + jj + g; }
      }
  }
  for (; jj < jn; ++jj) {
    float a[R];
#pragma unroll
    for (int r = 0; r < R; ++r) a[r] = 0.0f;
    const float* p = cs + jj * CP;
#pragma unroll
    for (int f = 0; f < DX; ++f) {
      const float cv = p[f];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (METRIC == L1)
          a[r] = __fadd_rn(a[r], fabsf(__fsub_rn(xr[r][f], cv)));
        else
          a[r] = __fmaf_rn(xr[r][f], cv, a[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float v = a[r];
      if (METRIC != L1) v = finish_l2<METRIC>(x2[r], c2s[jj], v);
      if (v < best[r]) { best[r] = v; bidx[r] = j0 + jj; }
    }
  }
}

// The split of a tile's block of cnt elements at src for the block
// layout: elements [h, t) by one bulk copy (16-byte aligned at both ends,
// a multiple of 16 bytes), the ragged ends [0, h) and [t, cnt), under 16
// bytes each, loaded by the threads that read them.  The block sits in its
// buffer `shift` bytes in, so its aligned span lands aligned.
template <typename T>
struct BlockSpan {
  int shift, h, t, cnt;
  __device__ __forceinline__ BlockSpan(const T* src, int n_elems) {
    const int es = (int)sizeof(T), bytes = n_elems * es;
    shift = (int)(reinterpret_cast<size_t>(src) & 15);
    const int head = min(bytes, (16 - shift) & 15);
    const int body = (bytes - head) & ~15;
    h = head / es;
    t = (head + body) / es;
    cnt = n_elems;
  }
};

// A CTA of `rows` / R threads walks tiles blockIdx.x, blockIdx.x +
// gridDim.x, ... of `rows` rows; thread t owns rows t, t + rows / R, ...
// of a tile.  Centers j0 .. j0 + mc - 1 and their norms are staged once per
// CTA when mc >= m (the small-m route's case: kernel.py's plan stages every
// center below the tiled route's threshold), else chunk by chunk for each
// tile.  Each tile's rows, one contiguous block of x, come into one of two
// buffers by bulk copy while the CTA scans the previous tile: f32 rows in
// 16-byte pieces (d % 4 == 0, x 16-byte aligned) one copy per row at pitch
// P, read back as 16-byte pieces; otherwise one copy of the block's
// 16-byte-aligned span at pitch d, its ragged head and tail (< 16 bytes
// each) read from global memory by the threads that need them (no thread
// stores into a buffer another reads: with one buffer no barrier lies
// between this tile's copy and its readers), and bf16 upcast as read.
// out: dist (n floats) | idx (n int32).
template <int DP, int DX, int METRIC, typename T>
__global__ void __launch_bounds__(Tile<DP>::NT)
min_argmin_rows_kernel(const T* __restrict__ x, const T* __restrict__ c,
                       float* __restrict__ out, int n, int m, int d, int mc,
                       int nbuf) {
  constexpr int P = StagePitch<DP>::P;
  constexpr int CP = CenterPitch<DP>::CP;
  constexpr int R = RowsPerThread<DP>::R;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem);
  float* cs = reinterpret_cast<float*>(smem + 16);
  float* c2s = cs + mc * CP;
  unsigned char* xb = reinterpret_cast<unsigned char*>(c2s + ((mc + 3) & ~3));
  const int nth = blockDim.x, rows = nth * R;
  const int tid = threadIdx.x, lane = tid & 31;
  const long long buf = rs_buf_bytes(rows, d, P);
  const int tiles = (int)((n + (long long)rows - 1) / rows);
  bool by_row = false;
  if constexpr (std::is_same<T, float>::value)
    by_row = d % 4 == 0 && (reinterpret_cast<size_t>(x) & 15) == 0;

  // Start tile t's rows into buffer b: every lane of warp 0 calls it.  In
  // the block layout only the block's 16-byte-aligned span comes by bulk
  // copy; the readers load its ragged ends themselves (BlockSpan).
  auto issue = [&](int t, int b) {
    unsigned char* dst = xb + b * buf;
    const long long row0 = (long long)t * rows;
    const int live = (int)min((long long)rows, n - row0);
    if (by_row) {
      if (lane == 0) mbar_arrive_expect_tx(&bar[b], (unsigned)(live * d * 4));
      __syncwarp();
      for (int r = lane; r < live; r += 32)
        bulk_copy_g2s(dst + 4LL * r * P, x + (row0 + r) * d, d * 4, &bar[b]);
      return;
    }
    if (lane == 0) {
      const T* src = x + row0 * d;
      const BlockSpan<T> sp(src, live * d);
      const unsigned bytes = (unsigned)((sp.t - sp.h) * sizeof(T));
      mbar_arrive_expect_tx(&bar[b], bytes);
      if (bytes)
        bulk_copy_g2s(dst + sp.shift + sp.h * sizeof(T), src + sp.h, bytes,
                      &bar[b]);
    }
  };

  // centers j0 .. j0 + jn - 1, zero past d, then (after a barrier) their
  // norms: one fma chain over f = 0..DP each, RowScan's c2 bits
  auto stage_centers = [&](int j0, int jn) {
    for (int e = tid; e < jn * DP; e += nth) {
      const int j = e / DP, f = e - j * DP;
      cs[j * CP + f] = f < d ? load_f(c, (long long)(j0 + j) * d + f) : 0.0f;
    }
  };
  auto center_norms = [&](int jn) {
    if (METRIC == L1) return;
    for (int j = tid; j < jn; j += nth) {
      float s = 0.0f;
#pragma unroll
      for (int f = 0; f < DP; f += 4) {
        const float4 v = *reinterpret_cast<const float4*>(cs + j * CP + f);
        s = __fmaf_rn(v.x, v.x, s);
        s = __fmaf_rn(v.y, v.y, s);
        s = __fmaf_rn(v.z, v.z, s);
        s = __fmaf_rn(v.w, v.w, s);
      }
      c2s[j] = s;
    }
  };

  if (tid < 32) {
    if (tid == 0) {
      for (int b = 0; b < kMaxRowBuffers; ++b) mbar_init(&bar[b], 1);
      mbar_init_fence();
    }
    __syncwarp();
    for (int b = 0; b < nbuf; ++b)
      if (blockIdx.x + b * gridDim.x < tiles)
        issue(blockIdx.x + b * gridDim.x, b);
  }
  const bool once = mc >= m;
  if (once) stage_centers(0, m);
  __syncthreads();                 // barriers ready, centers staged
  if (once) center_norms(m);       // published by the first tile's barrier

  int i = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
    const int b = nbuf == 1 ? 0 : i & 1;
    const long long row0 = (long long)t * rows;
    mbar_wait(&bar[b], (unsigned)((nbuf == 1 ? i : i >> 1) & 1));
    float xr[R][DP];
    bool live[R];
    const T* src = x + row0 * d;
    const BlockSpan<T> sp(src, (int)min((long long)rows, n - row0) * d);
    const bool ragged = !by_row && (sp.h > 0 || sp.t < sp.cnt);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int rr = tid + r * nth;
      live[r] = row0 + rr < n;
      if (by_row) {
        const float* xs = reinterpret_cast<const float*>(xb + b * buf) + rr * P;
#pragma unroll
        for (int f = 0; f < DP; f += 4) {
          const float4 v = *reinterpret_cast<const float4*>(xs + f);
          xr[r][f] = (live[r] && f < d) ? v.x : 0.0f;
          xr[r][f + 1] = (live[r] && f + 1 < d) ? v.y : 0.0f;
          xr[r][f + 2] = (live[r] && f + 2 < d) ? v.z : 0.0f;
          xr[r][f + 3] = (live[r] && f + 3 < d) ? v.w : 0.0f;
        }
      } else {
        const T* xt = reinterpret_cast<const T*>(xb + b * buf + sp.shift);
        const int e0 = rr * d;
        if (!ragged) {
#pragma unroll
          for (int f = 0; f < DP; ++f)
            xr[r][f] = (live[r] && f < d) ? load_f(xt, e0 + f) : 0.0f;
        } else {  // the block's ends (< 16 bytes each) from global memory
#pragma unroll
          for (int f = 0; f < DP; ++f) {
            const int e = e0 + f;
            const bool end = e < sp.h || e >= sp.t;
            xr[r][f] = (live[r] && f < d)
                           ? (end ? load_f(src, e) : load_f(xt, e)) : 0.0f;
          }
        }
      }
    }
    __syncthreads();  // buffer b read by every thread (first tile: norms)
    if (tid < 32 && t + nbuf * gridDim.x < tiles) {
      fence_proxy_async_shared();
      issue(t + nbuf * gridDim.x, b);
    }
    float x2[R], best[R];
    int bidx[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      x2[r] = 0.0f;
#pragma unroll
      for (int f = 0; f < DX; ++f) x2[r] = __fmaf_rn(xr[r][f], xr[r][f], x2[r]);
      best[r] = inf_f();
      bidx[r] = 0;
    }
    if (once) {
      scan_centers<DP, DX, R, METRIC>(xr, x2, cs, c2s, 0, m, best, bidx);
    } else {
      for (int j0 = 0; j0 < m; j0 += mc) {
        const int jn = min(mc, m - j0);
        __syncthreads();  // the previous chunk fully scanned
        stage_centers(j0, jn);
        __syncthreads();
        center_norms(jn);
        __syncthreads();
        scan_centers<DP, DX, R, METRIC>(xr, x2, cs, c2s, j0, jn, best, bidx);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (live[r]) {
        const long long row = row0 + tid + r * nth;
        out[row] = best[r];
        reinterpret_cast<int*>(out + n)[row] = bidx[r];
      }
    }
  }
}

// The small-m kernel's dynamic shared-memory limit, raised (never lowered)
// to `smem` the first time a launch or an occupancy query needs more than
// the 48 KB every kernel gets.
template <int DP, int DX, int METRIC, typename T>
cudaError_t open_rows_smem(int smem) {
  static int opened = 48 * 1024;
  if (smem <= opened) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      min_argmin_rows_kernel<DP, DX, METRIC, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) opened = smem;
  return e;
}

// The chains' length DX at width d and padded width DP: d itself at the
// main path's widths (d = 5: gauss and the stream; d = 34: kdd), else DP.
template <int DP, typename F>
void dispatch_dx(int d, F&& f) {
  if constexpr (DP == 8) {
    if (d == 5) return f(std::integral_constant<int, 5>{});
  } else if constexpr (DP == 40) {
    if (d == 34) return f(std::integral_constant<int, 34>{});
  }
  f(std::integral_constant<int, DP>{});
}

// d > 256: RowScan's generic path, per-thread loads from global memory
// (kernel.py takes it only when the small-m route is named).
template <int METRIC, typename T>
__global__ void __launch_bounds__(Tile<0>::NT)
min_argmin_generic_kernel(const T* __restrict__ x, const T* __restrict__ c,
                          float* __restrict__ out, int n, int m, int d) {
  const long long row = (long long)blockIdx.x * Tile<0>::NT + threadIdx.x;
  RowScan<0, METRIC, T> rs;
  rs.run(x, c, row, n, m, d);
  if (row < n) {
    out[row] = rs.best;
    reinterpret_cast<int*>(out + n)[row] = rs.bidx;
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

// ---- wide route: the d-chunked tile (pdist_common.cuh: chunked_tile) -----
// One CTA a tile of ChunkTile::BM rows against all m centers.  Two CTAs fit
// an SM (16 warps; 68,096 bytes of shared memory each).
template <int METRIC, typename T>
__global__ void __launch_bounds__(ChunkTile::NT, 2)
min_argmin_chunked_kernel(const T* __restrict__ x, const T* __restrict__ c,
                          const float* __restrict__ c2g,
                          float* __restrict__ dist, int* __restrict__ idx,
                          int n, int m, int d) {
  using K = ChunkTile;
  extern __shared__ __align__(16) float sm[];
  const long long r0 = (long long)blockIdx.x * K::BM;
  const int nr = (int)min((long long)K::BM, (long long)n - r0);
  float best[K::R];
  int bidx[K::R];
  chunked_tile<METRIC, T>(x, c, c2g, r0, nr, m, d, sm, best, bidx);
  if (threadIdx.x % K::TX == 0) {
    const int ty = threadIdx.x / K::TX;
#pragma unroll
    for (int r = 0; r < K::R; ++r) {
      const int rr = ty * K::R + r;
      if (rr < nr) {
        dist[r0 + rr] = best[r];
        idx[r0 + rr] = bidx[r];
      }
    }
  }
}

}  // namespace rt

// The small-m route.  out: 2n words, dist (f32) | idx (int32).  a: ten
// ints (kernel.py: _rowscan_args, one array per call shape, so a launch
// passes five arguments): n, m, d, the metric and dtype codes, then the
// plan (kernel.py: launch_plan): rows per tile, a multiple of 32 R, R =
// RowsPerThread<DP>::R rows a thread, at most Tile<DP>::NT threads; grid,
// CTAs each walking tiles blockIdx.x, + grid, ...; smem, dynamic
// shared-memory bytes, at least rs_smem_bytes; mc, centers staged at once
// (m: all of them); nbuf, the row buffers (1 or 2).  The generic width
// (d > 256: the wrapper sends such calls to the chunked route, and only a
// named route reaches it) ignores the plan: one row per thread, 256-row
// CTAs.
extern "C" int rt_min_argmin(const void* x, const void* c, void* out,
                             const int* a, void* stream) {
  const int n = a[0], m = a[1], d = a[2], metric = a[3], dtype = a[4];
  const int rows = a[5], grid = a[6], smem = a[7], mc = a[8], nbuf = a[9];
  if (n <= 0) return (int)cudaGetLastError();
  if (m < 1 || d < 1) return (int)cudaErrorInvalidValue;
  int err = 0;
  cudaStream_t s = (cudaStream_t)stream;
  rt::dispatch_dtype(dtype, [&](auto tv) {
    using T = decltype(tv);
    rt::dispatch_metric(metric, [&](auto mv) {
      constexpr int METRIC = decltype(mv)::value;
      rt::dispatch_dp(d, [&](auto dv) {
        constexpr int DP = decltype(dv)::value;
        if constexpr (DP == 0) {
          constexpr int NT = rt::Tile<0>::NT;
          rt::min_argmin_generic_kernel<METRIC, T>
              <<<(int)((n + (long long)NT - 1) / NT), NT, 0, s>>>(
                  (const T*)x, (const T*)c, (float*)out, n, m, d);
        } else {
          constexpr int R = rt::RowsPerThread<DP>::R;
          if (rows % (32 * R) != 0 || rows < 32 * R ||
              rows / R > rt::Tile<DP>::NT || grid < 1 || mc < 1 || mc > m ||
              nbuf < 1 || nbuf > rt::kMaxRowBuffers ||
              smem < rt::rs_smem_bytes<DP>(rows, mc, d, nbuf) ||
              smem > 232448) {
            err = (int)cudaErrorInvalidValue;
            return;
          }
          rt::dispatch_dx<DP>(d, [&](auto xv) {
            constexpr int DX = decltype(xv)::value;
            const cudaError_t e = rt::open_rows_smem<DP, DX, METRIC, T>(smem);
            if (e != cudaSuccess) { err = (int)e; return; }
            rt::min_argmin_rows_kernel<DP, DX, METRIC, T>
                <<<grid, rows / R, smem, s>>>((const T*)x, (const T*)c,
                                              (float*)out, n, m, d, mc, nbuf);
          });
        }
      });
    });
  });
  if (err) return err;
  return (int)cudaGetLastError();
}

// Resident CTAs per SM of the small-m kernel at a plan's (rows, smem), for
// the reports (-1: the generic width, which has no plan).
extern "C" int rt_min_argmin_rows_blocks_per_sm(int d, int metric, int dtype,
                                                int rows, int smem) {
  int n = -1;
  rt::dispatch_dtype(dtype, [&](auto tv) {
    using T = decltype(tv);
    rt::dispatch_metric(metric, [&](auto mv) {
      constexpr int METRIC = decltype(mv)::value;
      rt::dispatch_dp(d, [&](auto dv) {
        constexpr int DP = decltype(dv)::value;
        if constexpr (DP != 0) {
          rt::dispatch_dx<DP>(d, [&](auto xv) {
            constexpr int DX = decltype(xv)::value;
            if (rt::open_rows_smem<DP, DX, METRIC, T>(smem) != cudaSuccess)
              return;
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, rt::min_argmin_rows_kernel<DP, DX, METRIC, T>,
                rows / rt::RowsPerThread<DP>::R, smem);
          });
        }
      });
    });
  });
  return n;
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

// The wide route (any d >= 1; kernel.py routes d > 64 to it).  Arguments and
// launches as rt_min_argmin_tiled's: the center norms into the scratch c2
// (not for l1), then the chunked tiles.
extern "C" int rt_min_argmin_chunked(const void* x, const void* c, void* c2,
                                     void* dist, void* idx, int n, int m,
                                     int d, int metric, int dtype,
                                     void* stream) {
  if (d < 1 || m < 1) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  int err = 0;
  rt::dispatch_dtype(dtype, [&](auto tv) {
    using T = decltype(tv);
    if (metric != rt::L1)
      rt::center_norms_kernel<T><<<(m + 255) / 256, 256, 0, s>>>(
          (const T*)c, (float*)c2, m, d);
    rt::dispatch_metric(metric, [&](auto mv) {
      auto kern = rt::min_argmin_chunked_kernel<decltype(mv)::value, T>;
      constexpr int bytes = rt::ChunkTile::FLOATS * (int)sizeof(float);
      static bool opened = false;
      if (!opened) {
        const cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (e != cudaSuccess) { err = (int)e; return; }
        opened = true;
      }
      const int blocks = (int)((n + (long long)rt::ChunkTile::BM - 1) /
                               rt::ChunkTile::BM);
      kern<<<blocks, rt::ChunkTile::NT, bytes, s>>>(
          (const T*)x, (const T*)c, (const float*)c2, (float*)dist,
          (int*)idx, n, m, d);
    });
  });
  if (err) return err;
  return (int)cudaGetLastError();
}

// Resident CTAs per SM of the chunked kernel, for the reports.
extern "C" int rt_min_argmin_chunked_blocks_per_sm(int metric, int dtype) {
  int n = -1;
  rt::dispatch_dtype(dtype, [&](auto tv) {
    using T = decltype(tv);
    rt::dispatch_metric(metric, [&](auto mv) {
      auto kern = rt::min_argmin_chunked_kernel<decltype(mv)::value, T>;
      constexpr int bytes = rt::ChunkTile::FLOATS * (int)sizeof(float);
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern,
                                                    rt::ChunkTile::NT, bytes);
    });
  });
  return n;
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
