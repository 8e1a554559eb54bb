// Shared core of the pdist, score and lloyd kernels: one thread owns one row
// of x and keeps a running (min, argmin) over every center.
//
// Design (see pdist.cu for the bound this is written against):
//   * a CTA of NT threads owns NT consecutive rows, one row per thread, the
//     row held in registers (DP floats, zero-padded past d);
//   * centers are staged TM at a time into shared memory with their squared
//     norms; every thread of a warp reads the same center word at the same
//     time, so the shared-memory reads are broadcasts;
//   * four centers are scored at once (four independent FMA chains) and then
//     compared in index order with a strict `<`, so ties keep the smallest
//     index exactly as the reference's argmin does;
//   * columns >= m are never scored (the loop stops at m) instead of being
//     padded with a far-away sentinel.
//
// All arithmetic goes through the *_rn intrinsics, so the compiler cannot
// contract or reorder it: pdist, score and lloyd produce bitwise-identical
// distances for the same inputs (the fused score must equal the composed
// min_argmin + divide bitwise).  l2sq/l2 use the reference's expansion
// max((x2 + c2) - 2 x.c, 0), not sum((x - c)^2); l2 takes the sqrt of each
// distance before the comparison, as the reference kernel does.  A center
// row at 1e30 (Alg. 2's invalid slots) has c2 = +inf, hence distance +inf,
// and is never selected.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace rt {

enum Metric { L2SQ = 0, L2 = 1, L1 = 2 };
enum DType { F32 = 0, BF16 = 1 };

__device__ __forceinline__ float load_f(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// Tile shape per padded width DP (DP == 0: the generic path for any d).
template <int DP>
struct Tile {
  static constexpr int NT = DP > 128 ? 128 : 256;                 // rows/CTA
  static constexpr int TM = DP <= 64 ? 64 : (DP <= 128 ? 32 : 16);  // centers
};

// Distance epilogue shared by every path.
template <int METRIC>
__device__ __forceinline__ float finish_l2(float x2, float c2, float dot) {
  float v = __fsub_rn(__fadd_rn(x2, c2), __fmul_rn(2.0f, dot));
  v = fmaxf(v, 0.0f);
  if (METRIC == L2) v = __fsqrt_rn(v);
  return v;
}

// Staging of a CTA's rows of x through shared memory (score.cu, lloyd.cu).
// x's staging pitch in words at padded width DP: a multiple of 4 with P / 4
// odd (DP is a multiple of 8), so a thread's 16-byte reads of its own row hit
// distinct banks within each quarter warp.
template <int DP>
struct StagePitch {
  static constexpr int P = DP + 4;
};

// cp.async of S bytes (4, 8 or 16) from global to shared memory.
template <int S>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if constexpr (S == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(gmem), "n"(S));
}

// Hopper's 1-D bulk copy (pdist.cu's small-m route): a contiguous span of
// global memory into shared memory by the copy engine, its completion
// counted in bytes on an mbarrier.  The span is a multiple of 16 bytes and
// both ends are 16-byte aligned; a thread spends one instruction on it.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes mbar_init visible to the copy engine (before any copy names it).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` more bytes before the phase ends.
__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned long long* bar,
                                                      unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  const unsigned a = smem_addr(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// Orders this thread's earlier generic-proxy accesses of shared memory (and,
// after a barrier, the CTA's) before its later bulk copies into it.
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src,
                                              unsigned bytes,
                                              unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Copy the CTA's block of x (rows row0 .. row0 + live - 1, contiguous) into
// xs at pitch P, as floats.  A thread copies at most d <= DP words, at
// e = threadIdx.x + i * rows: loops of constant trip count, so up to 32 of a
// thread's loads are in flight before the first store waits on one.
template <int DP, typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ x, float* xs,
                                           long long row0, int live, int d) {
  constexpr int P = StagePitch<DP>::P;
  const int rows = blockDim.x;
  const int cnt = live * d;
  const long long base = row0 * d;
  bool vec = false;
  if constexpr (std::is_same<T, float>::value)
    vec = (d % 4 == 0) && ((reinterpret_cast<size_t>(x) & 15) == 0);
  if (vec) {  // 16-byte pieces, each inside one row
    for (int q = threadIdx.x; q < cnt / 4; q += rows) {
      const int e = 4 * q, r = e / d, f = e - r * d;
      cp_async<16>(xs + r * P + f, x + base + e);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    return;
  }
  // (r, f) of e, stepped by rows = sr * d + sf words
  const int sr = rows / d, sf = rows - sr * d;
  int r = threadIdx.x / d, f = threadIdx.x - r * d;
  constexpr int CH = DP < 32 ? DP : 32;  // loads in flight (registers)
#pragma unroll
  for (int i0 = 0; i0 < DP; i0 += CH) {
    float v[CH];
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int e = threadIdx.x + (i0 + i) * rows;
      v[i] = (i0 + i < DP && e < cnt) ? load_f(x, base + e) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      if (i0 + i < DP && threadIdx.x + (i0 + i) * rows < cnt)
        xs[r * P + f] = v[i];
      r += sr;
      f += sf;
      if (f >= d) {
        f -= d;
        ++r;
      }
    }
  }
}

// The scan of one staged tile of jn centers (cs: jn x DP, zero past d;
// c2s: their squared norms) for a row held in registers (xr, zero past d;
// x2 its squared norm), folded into the running (best, bidx): four
// centers at a time as four independent chains over f from 0 to DP, then
// compared in index order with a strict `<`, so ties keep the smallest
// index.  j0 is the tile's first center.  score.cu and lloyd.cu scan with
// it; RowScan runs the same arithmetic.
template <int DP, int METRIC>
__device__ __forceinline__ void scan_tile(const float (&xr)[DP], float x2,
                                          const float* cs, const float* c2s,
                                          int j0, int jn, float& best,
                                          int& bidx) {
  int jj = 0;
  for (; jj + 4 <= jn; jj += 4) {
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    const float* p = cs + jj * DP;
#pragma unroll
    for (int f = 0; f < DP; ++f) {
      if (METRIC == L1) {
        a0 = __fadd_rn(a0, fabsf(__fsub_rn(xr[f], p[f])));
        a1 = __fadd_rn(a1, fabsf(__fsub_rn(xr[f], p[DP + f])));
        a2 = __fadd_rn(a2, fabsf(__fsub_rn(xr[f], p[2 * DP + f])));
        a3 = __fadd_rn(a3, fabsf(__fsub_rn(xr[f], p[3 * DP + f])));
      } else {
        a0 = __fmaf_rn(xr[f], p[f], a0);
        a1 = __fmaf_rn(xr[f], p[DP + f], a1);
        a2 = __fmaf_rn(xr[f], p[2 * DP + f], a2);
        a3 = __fmaf_rn(xr[f], p[3 * DP + f], a3);
      }
    }
    if (METRIC != L1) {
      a0 = finish_l2<METRIC>(x2, c2s[jj], a0);
      a1 = finish_l2<METRIC>(x2, c2s[jj + 1], a1);
      a2 = finish_l2<METRIC>(x2, c2s[jj + 2], a2);
      a3 = finish_l2<METRIC>(x2, c2s[jj + 3], a3);
    }
    if (a0 < best) { best = a0; bidx = j0 + jj; }
    if (a1 < best) { best = a1; bidx = j0 + jj + 1; }
    if (a2 < best) { best = a2; bidx = j0 + jj + 2; }
    if (a3 < best) { best = a3; bidx = j0 + jj + 3; }
  }
  for (; jj < jn; ++jj) {
    float a = 0.f;
    const float* p = cs + jj * DP;
#pragma unroll
    for (int f = 0; f < DP; ++f) {
      if (METRIC == L1)
        a = __fadd_rn(a, fabsf(__fsub_rn(xr[f], p[f])));
      else
        a = __fmaf_rn(xr[f], p[f], a);
    }
    if (METRIC != L1) a = finish_l2<METRIC>(x2, c2s[jj], a);
    if (a < best) { best = a; bidx = j0 + jj; }
  }
}

// One row's running (min, argmin) against all m centers.  Every thread of
// the CTA must call this (it synchronises while staging centers), live row
// or not.
template <int DP, int METRIC, typename T>
struct RowScan {
  float xr[DP > 0 ? DP : 1];
  float x2;
  float best;
  int bidx;

  __device__ __forceinline__ void run(const T* __restrict__ x,
                                      const T* __restrict__ c, long long row,
                                      int n, int m, int d) {
    constexpr int NT = Tile<DP>::NT;
    constexpr int TM = Tile<DP>::TM;
    __shared__ __align__(16) float cs[TM * DP];
    __shared__ float c2s[TM];

    const bool live = row < n;
#pragma unroll
    for (int f = 0; f < DP; ++f)
      xr[f] = (live && f < d) ? load_f(x, row * d + f) : 0.0f;
    x2 = 0.0f;
#pragma unroll
    for (int f = 0; f < DP; ++f) x2 = __fmaf_rn(xr[f], xr[f], x2);
    best = inf_f();
    bidx = 0;

    for (int j0 = 0; j0 < m; j0 += TM) {
      __syncthreads();  // previous tile fully consumed
      for (int e = threadIdx.x; e < TM * DP; e += NT) {
        const int jj = e / DP, f = e - jj * DP, j = j0 + jj;
        cs[e] = (j < m && f < d) ? load_f(c, (long long)j * d + f) : 0.0f;
      }
      __syncthreads();
      if (METRIC != L1 && threadIdx.x < TM) {
        float s = 0.0f;
#pragma unroll
        for (int f = 0; f < DP; ++f)
          s = __fmaf_rn(cs[threadIdx.x * DP + f], cs[threadIdx.x * DP + f], s);
        c2s[threadIdx.x] = s;
      }
      __syncthreads();
      const int jn = min(TM, m - j0);
      int jj = 0;
      for (; jj + 4 <= jn; jj += 4) {
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        const float* p = cs + jj * DP;
#pragma unroll
        for (int f = 0; f < DP; ++f) {
          if (METRIC == L1) {
            a0 = __fadd_rn(a0, fabsf(__fsub_rn(xr[f], p[f])));
            a1 = __fadd_rn(a1, fabsf(__fsub_rn(xr[f], p[DP + f])));
            a2 = __fadd_rn(a2, fabsf(__fsub_rn(xr[f], p[2 * DP + f])));
            a3 = __fadd_rn(a3, fabsf(__fsub_rn(xr[f], p[3 * DP + f])));
          } else {
            a0 = __fmaf_rn(xr[f], p[f], a0);
            a1 = __fmaf_rn(xr[f], p[DP + f], a1);
            a2 = __fmaf_rn(xr[f], p[2 * DP + f], a2);
            a3 = __fmaf_rn(xr[f], p[3 * DP + f], a3);
          }
        }
        if (METRIC != L1) {
          a0 = finish_l2<METRIC>(x2, c2s[jj], a0);
          a1 = finish_l2<METRIC>(x2, c2s[jj + 1], a1);
          a2 = finish_l2<METRIC>(x2, c2s[jj + 2], a2);
          a3 = finish_l2<METRIC>(x2, c2s[jj + 3], a3);
        }
        if (a0 < best) { best = a0; bidx = j0 + jj; }
        if (a1 < best) { best = a1; bidx = j0 + jj + 1; }
        if (a2 < best) { best = a2; bidx = j0 + jj + 2; }
        if (a3 < best) { best = a3; bidx = j0 + jj + 3; }
      }
      for (; jj < jn; ++jj) {
        float a = 0.f;
        const float* p = cs + jj * DP;
#pragma unroll
        for (int f = 0; f < DP; ++f) {
          if (METRIC == L1)
            a = __fadd_rn(a, fabsf(__fsub_rn(xr[f], p[f])));
          else
            a = __fmaf_rn(xr[f], p[f], a);
        }
        if (METRIC != L1) a = finish_l2<METRIC>(x2, c2s[jj], a);
        if (a < best) { best = a; bidx = j0 + jj; }
      }
    }
  }
};

// Generic path for d above the widest register tile: the row and the centers
// are read from global memory (through L1) in the same order the staged path
// sums them, so both paths give the same bits for the same d.
template <int METRIC, typename T>
struct RowScan<0, METRIC, T> {
  float xr[1];
  float x2;
  float best;
  int bidx;

  __device__ __forceinline__ void run(const T* __restrict__ x,
                                      const T* __restrict__ c, long long row,
                                      int n, int m, int d) {
    best = inf_f();
    bidx = 0;
    if (row >= n) return;
    const long long xo = row * d;
    x2 = 0.0f;
    for (int f = 0; f < d; ++f) {
      const float v = load_f(x, xo + f);
      x2 = __fmaf_rn(v, v, x2);
    }
    for (int j = 0; j < m; ++j) {
      const long long co = (long long)j * d;
      float a = 0.f, c2 = 0.f;
      for (int f = 0; f < d; ++f) {
        const float xv = load_f(x, xo + f), cv = load_f(c, co + f);
        if (METRIC == L1) {
          a = __fadd_rn(a, fabsf(__fsub_rn(xv, cv)));
        } else {
          a = __fmaf_rn(xv, cv, a);
          c2 = __fmaf_rn(cv, cv, c2);
        }
      }
      if (METRIC != L1) a = finish_l2<METRIC>(x2, c2, a);
      if (a < best) { best = a; bidx = j; }
    }
  }
};

// c2[j] = one fma chain over f = 0..d-1 from 0: RowScan's c2 bits.  The
// tiled and chunked routes' first launch (pdist.cu, lloyd.cu).
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

// ---- the d-chunked tile: pdist.cu's chunked route, lloyd.cu's chunked
// assignment (d past the widths whose tiles hold all of d) ----------------
//
// A CTA of NT = 256 threads owns BM = 128 rows; thread (ty, tx) = (tid / 16,
// tid % 16) owns rows ty * 8 .. + 7 and, of every tile of BN = 128 centers,
// the columns tx * 4 .. + 3 and 64 + tx * 4 .. + 3: the tiled route's SIMT
// tile with twice its columns, 8 x 8 a thread (on an H100, 49% of the fp32
// roofline at the curation cell's reassignment against 41% for the tiled
// route's 8 x 4: each 16-byte shared load feeds 16 FMAs, not 10.7, and a
// CTA reads its rows half as often).  Where the tiled route stages all of d
// (128 x 64 x d words: 823 KB at d = 768), this one streams d through
// shared memory in chunks of KC coordinates, x's chunk and the centers'
// both d-major, in two buffers: the next chunk travels while this one is
// scored, one barrier a chunk.  f32 chunks come by 4-byte cp.async, each
// word straight to its d-major place (no staging registers: staged through
// registers, as the tiled route stages, the tile spilled and reached 32%);
// bf16 ones through registers, upcast, stored after the scores.  The 64
// dot products stay in registers across a tile's chunks, so each is
// one fma chain over f = 0..d-1 in order, and each row's x2 too (summed by
// one thread a row from the first tile's chunks into shared memory): the
// bits of RowScan's and the tiled route's chains.  c2 comes from
// center_norms_kernel.  The epilogue and the tie rule are the tiled
// route's: max((x2 + c2) - 2 dot, 0), a strict `<` over a thread's columns
// in index order, then the lexicographic (dist, idx) minimum over the 16
// threads of a row; a tile's epilogue runs after the barrier that follows
// its last chunk (where the first tile's x2 is complete).
struct ChunkTile {
  static constexpr int NT = 256;               // threads per CTA
  static constexpr int R = 8;                  // rows per thread
  static constexpr int C = 8;                  // centers per thread a tile
  static constexpr int TX = 16;                // threads along centers
  static constexpr int BM = R * (NT / TX);     // 128 rows per CTA
  static constexpr int BN = C * TX;            // 128 centers per tile
  static constexpr int KC = 32;                // coordinates per chunk
  static constexpr int XP = BM + 4;            // pitches of the d-major
  static constexpr int CP = BN + 4;            // chunks (16-byte aligned)
  static constexpr int NW = NT / 32;           // warps
  static constexpr int FB = KC / 8;            // 8-coordinate blocks a chunk
  static constexpr int XL = BM * KC / NT;      // x words a thread stages
  static constexpr int CL = BN * KC / NT;      // center words a thread stages
  static constexpr int RS = 4 * NW / FB;       // rows between them
  // dynamic shared memory: two buffers of both chunks, the rows' x2
  static constexpr int FLOATS = 2 * KC * (XP + CP) + BM;
};
static_assert(ChunkTile::KC % 8 == 0 && ChunkTile::NW % ChunkTile::FB == 0 &&
                  ChunkTile::RS * ChunkTile::XL == ChunkTile::BM &&
                  ChunkTile::RS * ChunkTile::CL == ChunkTile::BN &&
                  ChunkTile::R == 8 && ChunkTile::C % 4 == 0,
              "8-coordinate staging blocks, whole rows a warp; float4 reads "
              "of the rows and of each group of 4 columns");

// Rows r0 .. r0 + nr - 1 of x against all m centers (c2g: their norms, unused
// by l1; sm: ChunkTile::FLOATS floats of shared memory).  Every thread of the
// CTA calls it; on return thread (ty, 0) holds in best / bidx the (min,
// argmin) of rows ty * 8 .. + 7 (a row whose every distance is +inf or NaN
// keeps index 0), and the shared memory is free again.  Centers past m read
// +inf (c2 = +inf for l2, coordinates +inf for l1) and never win.
template <int METRIC, typename T>
__device__ __forceinline__ void chunked_tile(const T* __restrict__ x,
                                             const T* __restrict__ c,
                                             const float* __restrict__ c2g,
                                             long long r0, int nr, int m,
                                             int d, float* sm,
                                             float (&best)[ChunkTile::R],
                                             int (&bidx)[ChunkTile::R]) {
  using K = ChunkTile;
  constexpr bool ASYNC = std::is_same<T, float>::value;
  float* xs0 = sm;                          // [2][KC][XP]
  float* cs0 = sm + 2 * K::KC * K::XP;      // [2][KC][CP]
  float* x2s = cs0 + 2 * K::KC * K::CP;     // [BM]
  const int tid = threadIdx.x, tx = tid % K::TX, ty = tid / K::TX;
  // staging: lane (fl, rl) of warp w stages coordinate f0 + fc, fc = (w %
  // FB) * 8 + fl, of rows (or centers) (w / FB) * 4 + rl + RS i: a warp reads
  // 32-byte runs of four rows, and its shared words fall in 32 distinct banks
  // (both pitches are 4 mod 32)
  const int warp = tid >> 5, fl = tid & 7, rl = (tid >> 3) & 3;
  const int fc = (warp % K::FB) * 8 + fl, rc = (warp / K::FB) * 4 + rl;
  const int nch = (d + K::KC - 1) / K::KC;
  const int steps = ((m + K::BN - 1) / K::BN) * nch;
  float px[ASYNC ? 1 : K::XL], pc[ASYNC ? 1 : K::CL];
  // step s: center tile s / nch, coordinates (s % nch) * KC .. + KC - 1;
  // ASYNC: its words start into buffer b; else into registers
  auto fetch = [&](int s, int b) {
    const int tile = s / nch, f = (s - tile * nch) * K::KC + fc;
    const bool fin = f < d;
    const T* xg = x + (r0 + rc) * d + f;
    const T* cg = c + (long long)(tile * K::BN + rc) * d + f;
    float* xs = xs0 + b * K::KC * K::XP + fc * K::XP + rc;
    float* cs = cs0 + b * K::KC * K::CP + fc * K::CP + rc;
    const int jn = m - tile * K::BN;   // centers left from this tile on
#pragma unroll
    for (int i = 0; i < K::XL; ++i) {
      const bool in = fin && rc + K::RS * i < nr;
      if constexpr (ASYNC) {
        if (in)
          cp_async<4>(xs + K::RS * i, xg + (long long)K::RS * i * d);
        else
          xs[K::RS * i] = 0.0f;
      } else {
        px[i] = in ? load_f(xg, (long long)K::RS * i * d) : 0.0f;
      }
    }
    const float pad = fin && METRIC == L1 ? inf_f() : 0.0f;
#pragma unroll
    for (int i = 0; i < K::CL; ++i) {
      const bool in = fin && rc + K::RS * i < jn;
      if constexpr (ASYNC) {
        if (in)
          cp_async<4>(cs + K::RS * i, cg + (long long)K::RS * i * d);
        else
          cs[K::RS * i] = pad;
      } else {
        pc[i] = in ? load_f(cg, (long long)K::RS * i * d) : pad;
      }
    }
    if constexpr (ASYNC) asm volatile("cp.async.commit_group;\n" ::);
  };
  auto store = [&](int b) {  // the register path's words into buffer b
    if constexpr (!ASYNC) {
      float* xs = xs0 + b * K::KC * K::XP + fc * K::XP + rc;
      float* cs = cs0 + b * K::KC * K::CP + fc * K::CP + rc;
#pragma unroll
      for (int i = 0; i < K::XL; ++i) xs[K::RS * i] = px[i];
#pragma unroll
      for (int i = 0; i < K::CL; ++i) cs[K::RS * i] = pc[i];
    }
  };

  float acc[K::R][K::C], c2v[K::C], x2 = 0.0f;
#pragma unroll
  for (int r = 0; r < K::R; ++r) {
    best[r] = inf_f();
    bidx[r] = 0x7fffffff;
  }
  // column q of the thread's C in a tile: groups of 4, TX * 4 apart, so
  // that a warp's float4 reads of a group are 16 consecutive ones
  auto col = [&](int q) { return (q / 4) * (K::TX * 4) + tx * 4 + q % 4; };
  // the distances of tile `tile` from acc, folded into (best, bidx)
  auto epilogue = [&](int tile) {
#pragma unroll
    for (int q = 0; q < K::C; ++q) {
      const int j = tile * K::BN + col(q);
#pragma unroll
      for (int r = 0; r < K::R; ++r) {
        float v = acc[r][q];
        if (METRIC != L1) v = finish_l2<METRIC>(x2s[ty * K::R + r], c2v[q], v);
        if (v < best[r]) { best[r] = v; bidx[r] = j; }
      }
    }
  };
  fetch(0, 0);
  store(0);
  if constexpr (ASYNC) asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  int tile = 0, ch = 0;
  for (int s = 0; s < steps; ++s) {
    const int b = s & 1;
    if (s + 1 < steps) fetch(s + 1, b ^ 1);
    if (ch == 0) {
      if (tile > 0) epilogue(tile - 1);
#pragma unroll
      for (int r = 0; r < K::R; ++r)
#pragma unroll
        for (int q = 0; q < K::C; ++q) acc[r][q] = 0.0f;
#pragma unroll
      for (int q = 0; q < K::C; ++q) {
        const int j = tile * K::BN + col(q);
        c2v[q] = METRIC == L1 ? 0.0f : (j < m ? c2g[j] : inf_f());
      }
    }
    const float* xs = xs0 + b * K::KC * K::XP;
    const float* cs = cs0 + b * K::KC * K::CP;
    const int kn = min(K::KC, d - ch * K::KC);
    if (METRIC != L1 && tile == 0 && tid < K::BM) {  // row tid's x2
      for (int f = 0; f < kn; ++f)
        x2 = __fmaf_rn(xs[f * K::XP + tid], xs[f * K::XP + tid], x2);
      if (ch == nch - 1) x2s[tid] = x2;
    }
#pragma unroll 4
    for (int f = 0; f < kn; ++f) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(xs + f * K::XP + ty * K::R);
      const float4 a1 =
          *reinterpret_cast<const float4*>(xs + f * K::XP + ty * K::R + 4);
      const float xa[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float cb[K::C];
#pragma unroll
      for (int g = 0; g < K::C / 4; ++g) {
        const float4 cv = *reinterpret_cast<const float4*>(
            cs + f * K::CP + g * (K::TX * 4) + tx * 4);
        cb[4 * g] = cv.x;
        cb[4 * g + 1] = cv.y;
        cb[4 * g + 2] = cv.z;
        cb[4 * g + 3] = cv.w;
      }
#pragma unroll
      for (int r = 0; r < K::R; ++r)
#pragma unroll
        for (int q = 0; q < K::C; ++q) {
          if (METRIC == L1)
            acc[r][q] = __fadd_rn(acc[r][q], fabsf(__fsub_rn(xa[r], cb[q])));
          else
            acc[r][q] = __fmaf_rn(xa[r], cb[q], acc[r][q]);
        }
    }
    if (++ch == nch) {
      ch = 0;
      ++tile;
    }
    if (s + 1 < steps) store(b ^ 1);
    if constexpr (ASYNC) asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
  }
  epilogue(tile - 1);
  // the TX threads of a row group are TX consecutive lanes
#pragma unroll
  for (int r = 0; r < K::R; ++r) {
#pragma unroll
    for (int sh = K::TX / 2; sh > 0; sh >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[r], sh);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx[r], sh);
      lex_min(best[r], bidx[r], ob, oi);
    }
    if (bidx[r] == 0x7fffffff) bidx[r] = 0;
  }
  __syncthreads();  // x2s read by every row group: free for the next call
}

// Compile-time dispatch over the padded width, metric and input type.
template <typename F>
void dispatch_dp(int d, F&& f) {
  if (d <= 8) f(std::integral_constant<int, 8>{});
  else if (d <= 16) f(std::integral_constant<int, 16>{});
  else if (d <= 24) f(std::integral_constant<int, 24>{});
  else if (d <= 32) f(std::integral_constant<int, 32>{});
  else if (d <= 40) f(std::integral_constant<int, 40>{});
  else if (d <= 48) f(std::integral_constant<int, 48>{});
  else if (d <= 64) f(std::integral_constant<int, 64>{});
  else if (d <= 96) f(std::integral_constant<int, 96>{});
  else if (d <= 128) f(std::integral_constant<int, 128>{});
  else if (d <= 160) f(std::integral_constant<int, 160>{});
  else if (d <= 256) f(std::integral_constant<int, 256>{});
  else f(std::integral_constant<int, 0>{});
}

template <typename F>
void dispatch_metric(int metric, F&& f) {
  if (metric == L2SQ) f(std::integral_constant<int, L2SQ>{});
  else if (metric == L2) f(std::integral_constant<int, L2>{});
  else f(std::integral_constant<int, L1>{});
}

template <typename F>
void dispatch_dtype(int dtype, F&& f) {
  if (dtype == BF16) f(__nv_bfloat16{});
  else f(float{});
}

}  // namespace rt
