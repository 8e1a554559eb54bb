// Chunked RWKV6 WKV forward for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/wkv/kernel.py:_kernel /
// wkv_forward_pallas.  Per (batch * head) row b it sweeps the chunks of c
// tokens in order and, for each chunk, with lin = cumsum(lw) and
// lprev = lin - lw inside the chunk:
//   w_ts[t,tau] = sum_i r[t,i] exp(lprev[t,i] - lin[tau,i]) k[tau,i]  (tau < t)
//   o  = w_ts v + (sum_i r u k) v + (r exp(lprev)) S
//   S <- exp(lin[-1]) S + (k exp(lin[-1] - lin))^T v
// and writes o (in r's dtype) and, after the last chunk, sT (f32).
//
// Bound on this card.  At the serving path's shape (BH = 256, T = 4096,
// K = V = 64, c = 16, bf16 r/k/v, f32 lw) the call moves ~0.81 GB (0.24 ms
// at 3.35 TB/s) and does ~2.2e10 f32 operations, dominated by the two
// K x V x c products per chunk (0.32 ms at 67 TFLOP/s on the CUDA cores):
// it is bound by operations.  The math stays in f32 (no TF32, no bf16
// tensor cores), as the reference's kernel computes in f32.
//
// What the design does about it.  The first version (one CTA per row, S in
// shared memory, five barriers and no prefetch per chunk, the cumsum a
// serial loop) was bound by latency: 256 CTAs for 132 SMs, 64 at B = 1.
// This one:
//   * splits V: the columns of S and o are independent, so the chunk sweep
//     runs as (V / 16, BH) CTAs of 128 threads, the V-slices of one row
//     adjacent in the grid (r, k and lw of a row come from L2 after the
//     first slice reads them): 1,024 CTAs at the prefill, 256 at B = 1;
//   * moves w = w_ts + bonus (it depends on r, k, lw and u, not on S or V)
//     to a fully parallel first pass over every (row, chunk) that writes it
//     to scratch (BH * nc * c^2 floats, 67 MB at the prefill), so its
//     120 x K exponentials are not evaluated once per V-slice (recomputing
//     w in every slice was measured slower on an H100 at every shape timed:
//     PERF.md);
//   * at c = 16, K = 64 (the serving path) takes the decays as products of
//     d = exp(lw) in registers, every factor <= 1: the first pass carries
//     exp(lprev[t] - lin[tau]) along t (16 K exps per chunk, not 120 K),
//     and in the chunk sweep each lane owns two rows of the slice of S and
//     forms r exp(lprev) and k exp(lin[-1] - lin) for them by a forward and
//     a backward product, with no cumsum and one barrier per chunk; a warp
//     sums its lanes' shares of o by a transposing butterfly of shuffles;
//   * elsewhere (any 1 <= c <= 64, K in {16, 32, 64}) the generic sweep
//     takes the cumsum as a warp-level scan (128 / K threads per column,
//     joined by __shfl_up_sync), exp(lin[-1]) once per column and chunk,
//     and w from the first pass;
//   * double-buffers the next chunk's r, k, lw, v (and w) with cp.async
//     behind the current chunk's math.
// Only the tau < t exponents are evaluated and each is <= 0, so no exp
// overflows and nothing is multiplied by a mask (|lin| reaches ~770 at
// c = 64 with strong decays; no factorisation through a reference point
// is used).  The sums run in other orders than the plain version's, which
// the tolerances of chip_smoke.py cover unchanged.
//
// Left for later: wgmma with 3xTF32 for the two K x V x c products as an
// opt-in backend with measured error (the default stays fp32 on the CUDA
// cores); TMA for the staging; a strided interface so the model need not
// copy r, k, v, lw into (BH, T, K) around the call.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace rt {

constexpr int WKV_NT = 128;                 // threads per CTA
constexpr int WKV_VB = 16;                  // V columns per CTA
constexpr int WKV_IG = WKV_NT / WKV_VB;     // row groups of S per column
constexpr int WKV_MAX_CHUNK = 64;
constexpr float WKV_LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float wkv_load(const float* p) { return *p; }
__device__ __forceinline__ float wkv_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void wkv_store(float* p, float x) { *p = x; }
__device__ __forceinline__ void wkv_store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// a if c else b, as one selp: a plain `c ? x[i] : x[j]` on a register
// array may become a computed index and push the array to local memory.
__device__ __forceinline__ float selp(float a, float b, bool c) {
  float r;
  asm("{.reg .pred p; setp.ne.u32 p, %3, 0; selp.f32 %0, %1, %2, p;}"
      : "=f"(r) : "f"(a), "f"(b), "r"((unsigned)c));
  return r;
}

// 2^x by the SFU alone (ex2.approx.ftz: ~2 ulp; a result below 2^-126
// becomes 0).  Used for the per-token decays d = exp(lw) of the c = 16
// kernels, where every exponent is <= 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__host__ __device__ constexpr int wkv_al16(int bytes) {
  return (bytes + 15) & ~15;
}
// w per chunk, padded so that each chunk's block is 16-byte aligned
__host__ __device__ constexpr int wkv_cw(int c) { return (c * c + 3) & ~3; }
// row stride of the partial products of o (conflict-free stores)
__host__ __device__ constexpr int wkv_pst(int c) { return c * WKV_VB + 4; }

// Byte offsets of the slice kernel's shared memory: two staging buffers
// (r, k in their dtype, lw f32, the V-slice of v, and w from the first
// pass), then work arrays (r exp(lprev), k exp(lin[-1] - lin),
// exp(lin[-1]), partial products of o).
struct WkvLayout {
  int r, k, lw, v, w, stage;
  int rr, kk, dec, P, total;
};

__host__ __device__ inline WkvLayout wkv_layout(int K, int c, int es) {
  WkvLayout L{};
  int o = 0;
  L.r = o;  o += wkv_al16(c * K * es);
  L.k = o;  o += wkv_al16(c * K * es);
  L.lw = o; o += wkv_al16(c * K * 4);
  L.v = o;  o += wkv_al16(c * WKV_VB * es);
  L.w = o;  o += wkv_al16(wkv_cw(c) * 4);
  L.stage = o;
  o *= 2;
  L.rr = o;  o += wkv_al16(c * K * 4);
  L.kk = o;  o += wkv_al16(c * K * 4);
  L.dec = o; o += wkv_al16(K * 4);
  L.P = o;   o += wkv_al16(WKV_IG * wkv_pst(c) * 4);
  L.total = o;
  return L;
}

// Cumulative log2-decays of one staged chunk: lin[t][i] = sum_{s<=t}
// lw[s][i] log2(e); lw is overwritten by lprev = lin - lw * log2(e).  A
// warp-level scan: WKV_NT / K adjacent threads per column, each a serial
// run over its segment of t in registers, joined by an exclusive
// __shfl_up_sync scan of the segment totals.  Every thread must call it.
template <int K>
__device__ __forceinline__ void chunk_scan(float* lw, float* lin, int c,
                                           int tid) {
  constexpr int PC = WKV_NT / K;           // 2, 4 or 8 lanes per column
  const int i = tid / PC, sg = tid % PC;
  const int len = (c + PC - 1) / PC;
  const int t0 = min(c, sg * len), t1 = min(c, t0 + len);
  float run = 0.f;
  for (int t = t0; t < t1; ++t) run += lw[t * K + i] * WKV_LOG2E;
  float incl = run;
#pragma unroll
  for (int off = 1; off < PC; off <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, incl, off, PC);
    if (sg >= off) incl += y;
  }
  const float up = __shfl_up_sync(0xffffffffu, incl, 1, PC);
  float acc = sg == 0 ? 0.f : up;
  for (int t = t0; t < t1; ++t) {
    const float l2 = lw[t * K + i] * WKV_LOG2E;
    acc += l2;
    lin[t * K + i] = acc;
    lw[t * K + i] = acc - l2;
  }
}

// w[t][tau] for tau <= t of one chunk from its staged r, k, lprev, lin
// (log2 units) and u: the tau < t sums over i, and the bonus sum_i r u k on
// the diagonal.  One (t, tau) pair per thread; lanes start their sweep over
// i at their lane index, so the pairs of a warp read distinct banks.
template <int K, typename E>
__device__ __forceinline__ void chunk_w(const E* rs, const E* ks,
                                        const float* lprev, const float* lin,
                                        const float* us, float* w, int wst,
                                        int c, int tid, int nt) {
  const int np = c * (c + 1) / 2;
  const int lane = tid & 31;
  for (int p = tid; p < np; p += nt) {
    int t = (int)((sqrtf(8.f * p + 1.f) - 1.f) * 0.5f);
    while (t * (t + 1) / 2 > p) --t;
    while ((t + 1) * (t + 2) / 2 <= p) ++t;
    const int tau = p - t * (t + 1) / 2;
    float a0 = 0.f, a1 = 0.f;
    if (tau < t) {
#pragma unroll 8
      for (int q = 0; q < K; q += 2) {
        const int i0 = (q + lane) & (K - 1), i1 = (q + 1 + lane) & (K - 1);
        a0 += wkv_load(rs + t * K + i0) *
              exp2f(lprev[t * K + i0] - lin[tau * K + i0]) *
              wkv_load(ks + tau * K + i0);
        a1 += wkv_load(rs + t * K + i1) *
              exp2f(lprev[t * K + i1] - lin[tau * K + i1]) *
              wkv_load(ks + tau * K + i1);
      }
    } else {
#pragma unroll 8
      for (int q = 0; q < K; q += 2) {
        const int i0 = (q + lane) & (K - 1), i1 = (q + 1 + lane) & (K - 1);
        a0 += wkv_load(rs + t * K + i0) * us[i0] * wkv_load(ks + t * K + i0);
        a1 += wkv_load(rs + t * K + i1) * us[i1] * wkv_load(ks + t * K + i1);
      }
    }
    w[t * wst + tau] = a0 + a1;
  }
}

// First pass at c = 16, K >= 32 (the serving path's shape): one warp per
// (row, chunk), lane l owning Q = K / 32 columns with r, k and exp(lw) of
// its 16 tokens in registers.  exp(lprev[t] - lin[tau]) is the product of
// exp(lw[s]) over tau < s < t, carried along t for each tau: each factor is
// <= 1, so nothing overflows, and a chunk needs 16 K exps instead of 120 K.
// Each lane writes its columns' share of every pair to shared memory, and
// lane l then sums pairs l, l + 32, ... over the 32 lanes: in two rounds of
// 68 pairs, so that a warp needs 9 KB.
constexpr int W16_C = 16;
constexpr int W16_PAIRS = W16_C * (W16_C - 1) / 2;   // below the diagonal
constexpr int W16_NP = W16_PAIRS + W16_C;            // and on it
constexpr int W16_HALF = W16_NP / 2;                 // pairs per round
constexpr int W16_PST = 33;                          // padded row of shares
constexpr int W16_SMEM = (WKV_NT / 32) * W16_HALF * W16_PST * 4;

// (t, tau) of pair p: below the diagonal tau-major (tau = 0: t = 1..15,
// then tau = 1: t = 2..15, ...), then the diagonal (p >= 120: t = tau).
__device__ __forceinline__ void w16_pair(int p, int& t, int& tau) {
  if (p >= W16_PAIRS) { t = tau = p - W16_PAIRS; return; }
  tau = 0;
  while (p >= W16_C - 1 - tau) { p -= W16_C - 1 - tau; ++tau; }
  t = tau + 1 + p;
}

template <int K, typename E>
__global__ void __launch_bounds__(WKV_NT)
wkv_w16_kernel(const E* __restrict__ r, const E* __restrict__ k,
               const float* __restrict__ lw, const float* __restrict__ u,
               float* __restrict__ wout, int T, int u_per_row,
               long long chunks) {
  constexpr int C = W16_C, Q = K / 32;
  extern __shared__ float w16_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* part = w16_smem + warp * W16_HALF * W16_PST;
  const long long ch = (long long)blockIdx.x * (WKV_NT / 32) + warp;
  if (ch >= chunks) return;                // whole warps; no block barrier
  const long long b = ch / (T / C);
  const long long off = ch * C * K;        // (b * T + j * C) * K
  float rv[C][Q], kv[C][Q], dv[C][Q], uv[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int i = lane * Q + q;
    uv[q] = u[u_per_row ? b * K + i : i];
#pragma unroll
    for (int t = 0; t < C; ++t) {
      rv[t][q] = wkv_load(r + off + t * K + i);
      kv[t][q] = wkv_load(k + off + t * K + i);
      dv[t][q] = ex2(lw[off + t * K + i] * WKV_LOG2E);
    }
  }
  float* wo = wout + ch * wkv_cw(C);
  // sums the round's shares (pairs base .. base + 67) over the lanes
  auto flush = [&](int base) {
    __syncwarp();
    for (int p = lane; p < W16_HALF; p += 32) {
      const float* row = part + p * W16_PST;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
      for (int l = 0; l < 32; l += 4) {
        s0 += row[l];
        s1 += row[l + 1];
        s2 += row[l + 2];
        s3 += row[l + 3];
      }
      int t, tau;
      w16_pair(base + p, t, tau);
      wo[t * C + tau] = (s0 + s1) + (s2 + s3);
    }
    __syncwarp();
  };
#pragma unroll
  for (int tau = 0; tau < C; ++tau) {
    float P[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) P[q] = 1.f;
#pragma unroll
    for (int t = 0; t < C; ++t) {
      if (t > tau) {
        const int p = tau * (C - 1) - tau * (tau - 1) / 2 + (t - tau - 1);
        float a = 0.f;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          a = fmaf(rv[t][q] * kv[tau][q], P[q], a);
          P[q] *= dv[t][q];
        }
        part[(p % W16_HALF) * W16_PST + lane] = a;
        if (p == W16_HALF - 1) flush(0);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < C; ++t) {
    float a = 0.f;
#pragma unroll
    for (int q = 0; q < Q; ++q) a = fmaf(rv[t][q] * uv[q], kv[t][q], a);
    part[(W16_PAIRS + t - W16_HALF) * W16_PST + lane] = a;
  }
  flush(W16_HALF);
}

// First pass: w of every (row, chunk), into wout[(b * nc + j) * cw + t * c
// + tau] (tau <= t; the rest of each block is never read).
template <int K, typename E>
__global__ void __launch_bounds__(WKV_NT)
wkv_w_kernel(const E* __restrict__ r, const E* __restrict__ k,
             const float* __restrict__ lw, const float* __restrict__ u,
             float* __restrict__ wout, int T, int c, int u_per_row) {
  extern __shared__ __align__(16) unsigned char smem_w[];
  const int tid = threadIdx.x;
  const int nc = T / c;
  const long long b = blockIdx.x / nc;
  const int j = blockIdx.x - (int)(b * nc);
  const int ck = c * K;
  E* rs = reinterpret_cast<E*>(smem_w);
  E* ks = rs + ck;
  float* lws = reinterpret_cast<float*>(smem_w + wkv_al16(2 * ck * (int)sizeof(E)));
  float* lin = lws + ck;
  float* us = lin + ck;
  const long long off = (b * T + (long long)j * c) * K;
  for (int e = tid; e < ck; e += WKV_NT) {
    rs[e] = r[off + e];
    ks[e] = k[off + e];
    lws[e] = lw[off + e];
  }
  for (int i = tid; i < K; i += WKV_NT) us[i] = u[u_per_row ? b * K + i : i];
  __syncthreads();
  chunk_scan<K>(lws, lin, c, tid);
  __syncthreads();
  chunk_w<K, E>(rs, ks, lws, lin, us,
                wout + (b * nc + j) * (long long)wkv_cw(c), c, c, tid,
                WKV_NT);
}

template <int K, typename E>
__host__ __device__ constexpr int wkv_w_smem(int c) {
  return wkv_al16(2 * c * K * (int)sizeof(E)) + (2 * c * K + K) * 4;
}

// Fused scan and decays of one staged chunk, for the slice kernel: the
// scan of chunk_scan, and in the same sweep rr[t][i] = r exp(lprev),
// kk[t][i] = k exp(lin[-1] - lin) and dec[i] = exp(lin[-1]), every
// exponent <= 0 (lin[-1] is the column total, broadcast from the lane of
// the last segment).  Every thread must call it.
template <int K, typename E>
__device__ __forceinline__ void chunk_decay(const E* rs, const E* ks,
                                            const float* lw, float* rr,
                                            float* kk, float* dec, int c,
                                            int tid) {
  constexpr int PC = WKV_NT / K;
  const int i = tid / PC, sg = tid % PC;
  const int len = (c + PC - 1) / PC;
  const int t0 = min(c, sg * len), t1 = min(c, t0 + len);
  float run = 0.f;
  for (int t = t0; t < t1; ++t) run += lw[t * K + i] * WKV_LOG2E;
  float incl = run;
#pragma unroll
  for (int off = 1; off < PC; off <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, incl, off, PC);
    if (sg >= off) incl += y;
  }
  const float up = __shfl_up_sync(0xffffffffu, incl, 1, PC);
  const float total = __shfl_sync(0xffffffffu, incl, PC - 1, PC);
  float acc = sg == 0 ? 0.f : up;
  for (int t = t0; t < t1; ++t) {
    const int e = t * K + i;
    const float l2 = lw[e] * WKV_LOG2E;
    const float lp = acc;
    acc += l2;
    rr[e] = wkv_load(rs + e) * exp2f(lp);
    kk[e] = wkv_load(ks + e) * exp2f(fminf(total - acc, 0.f));
  }
  if (sg == 0) dec[i] = exp2f(total);
}

// SI consecutive floats from shared memory in 16- or 8-byte loads.
template <int SI>
__device__ __forceinline__ void lds_row(const float* p, float (&o)[SI]) {
  if constexpr (SI % 4 == 0) {
#pragma unroll
    for (int q = 0; q < SI; q += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + q);
      o[q] = v.x; o[q + 1] = v.y; o[q + 2] = v.z; o[q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < SI; q += 2) {
      const float2 v = *reinterpret_cast<const float2*>(p + q);
      o[q] = v.x; o[q + 1] = v.y;
    }
  }
}

// The chunk sweep of one (V-slice, row).  Thread (xl, ig) owns column
// x0 + xl and rows i0 .. i0 + SI - 1 of the slice of S.
template <int K, typename E>
__global__ void __launch_bounds__(WKV_NT)
wkv_slice_kernel(const E* __restrict__ r, const E* __restrict__ k,
                 const E* __restrict__ v, const float* __restrict__ lw,
                 const float* __restrict__ s0, const float* __restrict__ wpre,
                 E* __restrict__ o, float* __restrict__ sT, int T, int c) {
  constexpr int SI = K / WKV_IG;           // S rows per thread: 8, 4 or 2
  constexpr int ES = (int)sizeof(E);
  extern __shared__ __align__(16) unsigned char smem[];
  const WkvLayout L = wkv_layout(K, c, ES);
  const int tid = threadIdx.x;
  const int xl = tid / WKV_IG, ig = tid % WKV_IG, i0 = ig * SI;
  const int x0 = blockIdx.x * WKV_VB;
  const long long b = blockIdx.y;
  const int nc = T / c;
  const int ck = c * K;
  const int cw = wkv_cw(c), pst = wkv_pst(c);
  float* rr = reinterpret_cast<float*>(smem + L.rr);
  float* kk = reinterpret_cast<float*>(smem + L.kk);
  float* dec = reinterpret_cast<float*>(smem + L.dec);
  float* P = reinterpret_cast<float*>(smem + L.P);

  float S[SI];
#pragma unroll
  for (int s = 0; s < SI; ++s) S[s] = s0[(b * K + i0 + s) * K + x0 + xl];

  // cp.async of chunk j into staging buffer q (16-byte pieces)
  auto stage = [&](int j, int q) {
    unsigned char* base = smem + q * L.stage;
    const long long off = (b * T + (long long)j * c) * K;
    const int nrk = ck * ES / 16, nlw = ck * 4 / 16;
    const char* rg = reinterpret_cast<const char*>(r + off);
    const char* kg = reinterpret_cast<const char*>(k + off);
    const char* lg = reinterpret_cast<const char*>(lw + off);
    for (int e = tid; e < nrk; e += WKV_NT) {
      cp_async16(base + L.r + 16 * e, rg + 16 * e);
      cp_async16(base + L.k + 16 * e, kg + 16 * e);
    }
    for (int e = tid; e < nlw; e += WKV_NT)
      cp_async16(base + L.lw + 16 * e, lg + 16 * e);
    constexpr int VP = WKV_VB * ES / 16;   // pieces per row of the slice
    for (int e = tid; e < c * VP; e += WKV_NT) {
      const int t = e / VP, pc = e - t * VP;
      cp_async16(base + L.v + t * WKV_VB * ES + 16 * pc,
                 reinterpret_cast<const char*>(v + off + (long long)t * K +
                                               x0) + 16 * pc);
    }
    const char* wg = reinterpret_cast<const char*>(
        wpre + (b * nc + j) * (long long)cw);
    for (int e = tid; e < cw / 4; e += WKV_NT)
      cp_async16(base + L.w + 16 * e, wg + 16 * e);
  };

  stage(0, 0);
  cp_async_commit();
  for (int j = 0; j < nc; ++j) {
    cp_async_wait_all();
    __syncthreads();                       // chunk j staged; j - 1 consumed
    if (j + 1 < nc) stage(j + 1, (j + 1) & 1);
    cp_async_commit();
    unsigned char* cur = smem + (j & 1) * L.stage;
    const E* rs = reinterpret_cast<const E*>(cur + L.r);
    const E* ks = reinterpret_cast<const E*>(cur + L.k);
    const float* lws = reinterpret_cast<const float*>(cur + L.lw);
    const E* vs = reinterpret_cast<const E*>(cur + L.v);
    const float* ws = reinterpret_cast<const float*>(cur + L.w);

    // 1. decays
    chunk_decay<K, E>(rs, ks, lws, rr, kk, dec, c, tid);
    __syncthreads();

    // 2. partial products of o over this thread's rows of S (old S), then
    //    the S update in registers
    for (int t = 0; t < c; ++t) {
      float rv[SI];
      lds_row<SI>(rr + t * K + i0, rv);
      float a = 0.f;
#pragma unroll
      for (int s = 0; s < SI; ++s) a = fmaf(rv[s], S[s], a);
      P[ig * pst + t * WKV_VB + xl] = a;
    }
    float acc[SI], dv[SI];
    lds_row<SI>(dec + i0, dv);
#pragma unroll
    for (int s = 0; s < SI; ++s) acc[s] = dv[s] * S[s];
    for (int tau = 0; tau < c; ++tau) {
      const float vv = wkv_load(vs + tau * WKV_VB + xl);
      float kv[SI];
      lds_row<SI>(kk + tau * K + i0, kv);
#pragma unroll
      for (int s = 0; s < SI; ++s) acc[s] = fmaf(kv[s], vv, acc[s]);
    }
#pragma unroll
    for (int s = 0; s < SI; ++s) S[s] = acc[s];
    __syncthreads();

    // 3. o[t][x] = sum over row groups of the partials + sum_{tau <= t}
    //    w[t][tau] v[tau][x]
    const long long ob = (b * T + (long long)j * c) * K + x0;
    for (int e = tid; e < c * WKV_VB; e += WKV_NT) {
      const int t = e / WKV_VB, xo = e - t * WKV_VB;
      float a = 0.f, a2 = 0.f;
#pragma unroll
      for (int g = 0; g < WKV_IG; ++g) a += P[g * pst + e];
      int tau = 0;
      for (; tau + 1 <= t; tau += 2) {
        a2 = fmaf(ws[t * c + tau], wkv_load(vs + tau * WKV_VB + xo), a2);
        a = fmaf(ws[t * c + tau + 1], wkv_load(vs + (tau + 1) * WKV_VB + xo),
                 a);
      }
      if (tau == t)
        a2 = fmaf(ws[t * c + tau], wkv_load(vs + tau * WKV_VB + xo), a2);
      wkv_store(o + ob + (long long)t * K + xo, a + a2);
    }
  }
#pragma unroll
  for (int s = 0; s < SI; ++s) sT[(b * K + i0 + s) * K + x0 + xl] = S[s];
}

// ---- the chunk sweep at c = 16, K = 64 (the serving path), w from the
// first pass.  Lane l of warp g owns rows 2l, 2l + 1 and columns 4g .. 4g + 3
// of the CTA's K x 16 slice of S: a 2 x 4 register tile.  It computes the
// decays of its two rows itself, in registers, as products of d = exp(lw)
// (each factor <= 1): k exp(lin[-1] - lin) by a backward sweep (which also
// accumulates (k exp(lin[-1] - lin))^T v for the S update), r exp(lprev) by
// a forward sweep that forms the lane's share of o = (r exp(lprev)) S + w v
// for eight tokens x four columns at a time; the warp sums the 32 lanes'
// shares by a transposing butterfly (31 shuffles), after which lane l holds
// o for token l / 4, column l % 4.  One barrier per chunk; no cumsum.
template <typename E>
struct Slice16 {                 // shared-memory layout, in bytes
  static constexpr int C = 16, K = 64, ES = (int)sizeof(E);
  static constexpr int R = 0;
  static constexpr int KO = R + C * K * ES;
  static constexpr int LW = KO + C * K * ES;
  static constexpr int V = LW + C * K * 4;
  static constexpr int W = V + C * WKV_VB * ES;
  static constexpr int STAGE = W + C * C * 4;
  static constexpr int TOTAL = 2 * STAGE;
  static_assert(STAGE % 16 == 0 && W % 16 == 0 && V % 16 == 0, "align");
};

__device__ __forceinline__ void ld2(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x; b = v.y;
}
__device__ __forceinline__ void ld2(const __nv_bfloat16* p, float& a,
                                    float& b) {
  const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  a = v.x; b = v.y;
}
__device__ __forceinline__ void ld4(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* p, float (&o)[4]) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(q[0]), b = __bfloat1622float2(q[1]);
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

// One level of the transposing butterfly: lanes whose bit O is clear keep
// vals[0..O) and send vals[O..2O), the others the reverse; each adds what
// its partner across bit O sent.  A template, so that every loop has a
// constant trip count and vals stays in registers.
template <int O>
__device__ __forceinline__ void butterfly_level(float (&vals)[32], int lane) {
  const bool up = lane & O;
#pragma unroll
  for (int q = 0; q < O; ++q) {
    const float send = selp(vals[q], vals[q + O], up);
    const float keep = selp(vals[q + O], vals[q], up);
    vals[q] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// Sums vals[0..31] over the 32 lanes; afterwards vals[0] of lane l holds
// the sum of every lane's vals[l].
__device__ __forceinline__ void butterfly32(float (&vals)[32], int lane) {
  butterfly_level<16>(vals, lane);
  butterfly_level<8>(vals, lane);
  butterfly_level<4>(vals, lane);
  butterfly_level<2>(vals, lane);
  butterfly_level<1>(vals, lane);
}

template <typename E>
__global__ void __launch_bounds__(WKV_NT)
wkv_slice16_kernel(const E* __restrict__ r, const E* __restrict__ k,
                   const E* __restrict__ v, const float* __restrict__ lw,
                   const float* __restrict__ s0,
                   const float* __restrict__ wpre, E* __restrict__ o,
                   float* __restrict__ sT, int T) {
  using L = Slice16<E>;
  constexpr int C = L::C, K = L::K, ES = L::ES;
  constexpr int CW = WKV_VB / (WKV_NT / 32);   // columns per warp: 4
  constexpr int NTH = WKV_NT;
  constexpr int TPB = 32 / CW;             // tokens per butterfly: 8
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i0 = 2 * lane, cx = CW * warp;
  const int x0 = blockIdx.x * WKV_VB;
  const long long b = blockIdx.y;
  const int nc = T / C;

  float S[2][CW];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int c = 0; c < CW; ++c)
      S[q][c] = s0[(b * K + i0 + q) * K + x0 + cx + c];

  auto stage = [&](int j, int buf) {
    unsigned char* base = smem + buf * L::STAGE;
    const long long off = (b * T + (long long)j * C) * K;
    const char* rg = reinterpret_cast<const char*>(r + off);
    const char* kg = reinterpret_cast<const char*>(k + off);
    const char* lg = reinterpret_cast<const char*>(lw + off);
    for (int e = tid; e < C * K * ES / 16; e += NTH) {
      cp_async16(base + L::R + 16 * e, rg + 16 * e);
      cp_async16(base + L::KO + 16 * e, kg + 16 * e);
    }
    for (int e = tid; e < C * K * 4 / 16; e += NTH)
      cp_async16(base + L::LW + 16 * e, lg + 16 * e);
    constexpr int VP = WKV_VB * ES / 16;
    for (int e = tid; e < C * VP; e += NTH) {
      const int t = e / VP, pc = e - t * VP;
      cp_async16(base + L::V + t * WKV_VB * ES + 16 * pc,
                 reinterpret_cast<const char*>(v + off + (long long)t * K +
                                               x0) + 16 * pc);
    }
    const char* wg = reinterpret_cast<const char*>(
        wpre + (b * nc + j) * (long long)wkv_cw(C));
    for (int e = tid; e < C * C / 4; e += NTH)
      cp_async16(base + L::W + 16 * e, wg + 16 * e);
  };

  stage(0, 0);
  cp_async_commit();
  for (int j = 0; j < nc; ++j) {
    cp_async_wait_all();
    __syncthreads();                       // chunk j staged; j - 1 consumed
    if (j + 1 < nc) stage(j + 1, (j + 1) & 1);
    cp_async_commit();
    const unsigned char* cur = smem + (j & 1) * L::STAGE;
    const E* rs = reinterpret_cast<const E*>(cur + L::R);
    const E* ks = reinterpret_cast<const E*>(cur + L::KO);
    const float* lws = reinterpret_cast<const float*>(cur + L::LW);
    const E* vs = reinterpret_cast<const E*>(cur + L::V);
    const float* ws = reinterpret_cast<const float*>(cur + L::W);

    float d[C][2];
#pragma unroll
    for (int t = 0; t < C; ++t) {
      float a, bb;
      ld2(lws + t * K + i0, a, bb);
      d[t][0] = ex2(a * WKV_LOG2E);
      d[t][1] = ex2(bb * WKV_LOG2E);
    }
    // backward: k exp(lin[-1] - lin) and the S update's sum over tokens;
    // afterwards suf = exp(lin[-1])
    float upd[2][CW];
#pragma unroll
    for (int c = 0; c < CW; ++c) upd[0][c] = upd[1][c] = 0.f;
    float suf0 = 1.f, suf1 = 1.f;
#pragma unroll
    for (int tb = 0; tb < C; ++tb) {
      const int t = C - 1 - tb;
      float ka, kb, vv[CW];
      ld2(ks + t * K + i0, ka, kb);
#pragma unroll
      for (int c = 0; c < CW; c += 4) {
        float q4[4];
        ld4(vs + t * WKV_VB + cx + c, q4);
        vv[c] = q4[0]; vv[c + 1] = q4[1]; vv[c + 2] = q4[2]; vv[c + 3] = q4[3];
      }
      ka *= suf0;
      kb *= suf1;
      suf0 *= d[t][0];
      suf1 *= d[t][1];
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        upd[0][c] = fmaf(ka, vv[c], upd[0][c]);
        upd[1][c] = fmaf(kb, vv[c], upd[1][c]);
      }
    }
    // w v: lane tau < 16 adds w[t][tau] v[tau] for t >= tau
    float vo[CW];
#pragma unroll
    for (int c = 0; c < CW; ++c) vo[c] = 0.f;
    if (lane < C) {
#pragma unroll
      for (int c = 0; c < CW; c += 4) {
        float q4[4];
        ld4(vs + lane * WKV_VB + cx + c, q4);
        vo[c] = q4[0]; vo[c + 1] = q4[1]; vo[c + 2] = q4[2]; vo[c + 3] = q4[3];
      }
    }
    // forward: r exp(lprev) and the shares of o, TPB tokens at a time
    float pre0 = 1.f, pre1 = 1.f;
    const long long ob = (b * T + (long long)j * C) * K + x0 + cx;
#pragma unroll
    for (int h = 0; h < C / TPB; ++h) {
      float pt[32];
#pragma unroll
      for (int tt = 0; tt < TPB; ++tt) {
        const int t = TPB * h + tt;
        float ra, rb;
        ld2(rs + t * K + i0, ra, rb);
        ra *= pre0;
        rb *= pre1;
        pre0 *= d[t][0];
        pre1 *= d[t][1];
        float wt = 0.f;
        if (lane <= t) wt = ws[t * C + lane];
#pragma unroll
        for (int c = 0; c < CW; ++c)
          pt[CW * tt + c] = fmaf(wt, vo[c], fmaf(rb, S[1][c], ra * S[0][c]));
      }
      butterfly32(pt, lane);
      wkv_store(o + ob + (long long)(TPB * h + lane / CW) * K + lane % CW,
                pt[0]);
    }
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      S[0][c] = fmaf(suf0, S[0][c], upd[0][c]);
      S[1][c] = fmaf(suf1, S[1][c], upd[1][c]);
    }
  }
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int c = 0; c < CW; ++c)
      sT[(b * K + i0 + q) * K + x0 + cx + c] = S[q][c];
}

// The first pass alone: w of every (row, chunk) into wbuf.
template <int K, typename E>
int launch_w_pass(const void* r, const void* k, const void* lw, const void* u,
                  void* wbuf, int BH, int T, int c, int u_per_row,
                  cudaStream_t stream) {
  if constexpr (K >= 32) {
    if (c == 16) {
      const long long chunks = (long long)BH * (T / 16);
      const int per = WKV_NT / 32;
      cudaError_t e = cudaFuncSetAttribute(
          wkv_w16_kernel<K, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          W16_SMEM);
      if (e != cudaSuccess) return (int)e;
      wkv_w16_kernel<K, E><<<(unsigned)((chunks + per - 1) / per), WKV_NT,
                             W16_SMEM, stream>>>(
          (const E*)r, (const E*)k, (const float*)lw, (const float*)u,
          (float*)wbuf, T, u_per_row, chunks);
      return (int)cudaGetLastError();
    }
  }
  const int wb = wkv_w_smem<K, E>(c);
  auto wk = wkv_w_kernel<K, E>;
  cudaError_t err = cudaFuncSetAttribute(
      wk, cudaFuncAttributeMaxDynamicSharedMemorySize, wb);
  if (err != cudaSuccess) return (int)err;
  wk<<<BH * (T / c), WKV_NT, wb, stream>>>(
      (const E*)r, (const E*)k, (const float*)lw, (const float*)u,
      (float*)wbuf, T, c, u_per_row);
  return (int)cudaGetLastError();
}

template <int K, typename E>
int launch_wkv(const void* r, const void* k, const void* v, const void* lw,
               const void* u, const void* s0, void* wbuf, void* o, void* sT,
               int BH, int T, int c, int u_per_row, cudaStream_t stream) {
  cudaError_t err = (cudaError_t)launch_w_pass<K, E>(r, k, lw, u, wbuf, BH,
                                                     T, c, u_per_row, stream);
  if (err != cudaSuccess) return (int)err;
  if constexpr (K == 64) {
    if (c == 16) {
      auto k16 = wkv_slice16_kernel<E>;
      err = cudaFuncSetAttribute(
          k16, cudaFuncAttributeMaxDynamicSharedMemorySize, Slice16<E>::TOTAL);
      if (err != cudaSuccess) return (int)err;
      k16<<<dim3(K / WKV_VB, BH), WKV_NT, Slice16<E>::TOTAL, stream>>>(
          (const E*)r, (const E*)k, (const E*)v, (const float*)lw,
          (const float*)s0, (const float*)wbuf, (E*)o, (float*)sT, T);
      return (int)cudaGetLastError();
    }
  }
  const int bytes = wkv_layout(K, c, (int)sizeof(E)).total;
  auto kern = wkv_slice_kernel<K, E>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(K / WKV_VB, BH);
  kern<<<grid, WKV_NT, bytes, stream>>>(
      (const E*)r, (const E*)k, (const E*)v, (const float*)lw,
      (const float*)s0, (const float*)wbuf, (E*)o, (float*)sT, T, c);
  return (int)cudaGetLastError();
}

template <typename E>
int dispatch_k(int K, const void* r, const void* k, const void* v,
               const void* lw, const void* u, const void* s0, void* wbuf,
               void* o, void* sT, int BH, int T, int c, int u_per_row,
               cudaStream_t stream) {
  switch (K) {
    case 16:
      return launch_wkv<16, E>(r, k, v, lw, u, s0, wbuf, o, sT, BH, T, c,
                               u_per_row, stream);
    case 32:
      return launch_wkv<32, E>(r, k, v, lw, u, s0, wbuf, o, sT, BH, T, c,
                               u_per_row, stream);
    case 64:
      return launch_wkv<64, E>(r, k, v, lw, u, s0, wbuf, o, sT, BH, T, c,
                               u_per_row, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace rt

// r, k, v: (BH, T, K) in dtype (0 = f32, 1 = bf16); lw: (BH, T, K) f32;
// u: (K,) or, with u_per_row, (BH, K) f32; s0: (BH, K, K) f32 -> o (BH, T, K)
// in dtype, sT (BH, K, K) f32.  All contiguous and 16-byte aligned;
// T % c == 0, 1 <= c <= 64, BH <= 65535.  A first pass computes w into
// wbuf (BH * (T / c) * wkv_cw(c) floats), then the chunk sweep runs.
// Returns cudaGetLastError() after the launches.
extern "C" int rt_wkv_forward(const void* r, const void* k, const void* v,
                              const void* lw, const void* u, const void* s0,
                              void* wbuf, void* o, void* sT, int BH, int T,
                              int K, int c, int u_per_row, int dtype,
                              void* stream) {
  if (c < 1 || c > rt::WKV_MAX_CHUNK || T % c != 0 || BH > 65535)
    return (int)cudaErrorInvalidValue;
  if (BH == 0 || T == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return rt::dispatch_k<float>(K, r, k, v, lw, u, s0, wbuf, o, sT, BH, T,
                                 c, u_per_row, s);
  if (dtype == 1)
    return rt::dispatch_k<__nv_bfloat16>(K, r, k, v, lw, u, s0, wbuf, o, sT,
                                         BH, T, c, u_per_row, s);
  return (int)cudaErrorInvalidValue;
}

// The first pass alone, for checking it against its plain version: w of
// every (row, chunk) of (BH, T, K) r, k, lw into wbuf (as rt_wkv_forward's;
// the entries above each diagonal are left as they are).
extern "C" int rt_wkv_w_pass(const void* r, const void* k, const void* lw,
                             const void* u, void* wbuf, int BH, int T, int K,
                             int c, int u_per_row, int dtype, void* stream) {
  if (c < 1 || c > rt::WKV_MAX_CHUNK || T % c != 0)
    return (int)cudaErrorInvalidValue;
  if (BH == 0 || T == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  auto go = [&](auto ev) -> int {
    using E = decltype(ev);
    switch (K) {
      case 16: return rt::launch_w_pass<16, E>(r, k, lw, u, wbuf, BH, T, c, u_per_row, s);
      case 32: return rt::launch_w_pass<32, E>(r, k, lw, u, wbuf, BH, T, c, u_per_row, s);
      case 64: return rt::launch_w_pass<64, E>(r, k, lw, u, wbuf, BH, T, c, u_per_row, s);
      default: return (int)cudaErrorInvalidValue;
    }
  };
  if (dtype == 0) return go(float{});
  if (dtype == 1) return go(__nv_bfloat16{});
  return (int)cudaErrorInvalidValue;
}

// Resident CTAs per SM of the chunk sweep for (K, c, dtype), for the
// reports (cudaOccupancyMaxActiveBlocksPerMultiprocessor); -1 on error.
extern "C" int rt_wkv_blocks_per_sm(int K, int c, int dtype) {
  int n = -1;
  auto go = [&](auto kv, auto ev) {
    constexpr int KK = decltype(kv)::value;
    using E = decltype(ev);
    if (KK == 64 && c == 16) {
      cudaFuncSetAttribute(rt::wkv_slice16_kernel<E>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           rt::Slice16<E>::TOTAL);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, rt::wkv_slice16_kernel<E>, rt::WKV_NT, rt::Slice16<E>::TOTAL);
    } else {
      const int bytes = rt::wkv_layout(KK, c, (int)sizeof(E)).total;
      auto kern = rt::wkv_slice_kernel<KK, E>;
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, rt::WKV_NT,
                                                    bytes);
    }
  };
  auto byk = [&](auto ev) {
    if (K == 16) go(std::integral_constant<int, 16>{}, ev);
    else if (K == 32) go(std::integral_constant<int, 32>{}, ev);
    else if (K == 64) go(std::integral_constant<int, 64>{}, ev);
  };
  if (dtype == 0) byk(float{});
  else byk(__nv_bfloat16{});
  return n;
}
