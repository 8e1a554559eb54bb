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
// What the design does about it.  The TPU carries S across its sequential
// grid axis in VMEM scratch; Hopper's blocks run in no order, so one CTA
// owns one row and loops over the chunks itself, with S (K x V f32, 16 KB
// at K = 64) resident in shared memory for the whole sweep.  Each chunk is
// staged once into shared memory (upcast to f32), and every product reads
// it from there: the kernel touches device memory once per input and output
// element.  Only the tau < t exponents are evaluated, each <= 0, so no
// exp overflows and nothing is multiplied by a mask (the reference takes
// exp of the whole c x c x K tensor and masks after; inf * 0 would be NaN
// here).  The bonus term sits on the diagonal of w_ts.  Any 1 <= c <= 64
// works (the sweeps are strided loops, not power-of-two tiles).
//
// Left for later: the columns of S and o along V are independent, so a grid
// of (BH, V / vb) CTAs would fill the card at B = 1 (64 rows for 132 SMs);
// wgmma for the two K x V x c products, and TMA double-buffering of the
// next chunk behind the current one's math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rt {

constexpr int WKV_NT = 256;
constexpr int WKV_WARPS = WKV_NT / 32;
constexpr int WKV_MAX_CHUNK = 64;

__device__ __forceinline__ float wkv_load(const float* p) { return *p; }
__device__ __forceinline__ float wkv_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void wkv_store(float* p, float x) { *p = x; }
__device__ __forceinline__ void wkv_store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Shared memory, in floats: S[K*K] | r[c*K] | k[c*K] | v[c*K] | lin[c*K] |
// lprev[c*K] | w[c*c] | u[K].
__host__ __device__ constexpr int wkv_smem_floats(int K, int c) {
  return K * K + 5 * c * K + c * c + K;
}

template <int K, typename E>
__global__ void __launch_bounds__(WKV_NT)
wkv_forward_kernel(const E* __restrict__ r, const E* __restrict__ k,
                   const E* __restrict__ v, const float* __restrict__ lw,
                   const float* __restrict__ u, const float* __restrict__ s0,
                   E* __restrict__ o, float* __restrict__ sT, int T, int c,
                   int u_per_row) {
  extern __shared__ float smem[];
  float* S = smem;
  float* rs = S + K * K;
  float* ks = rs + c * K;
  float* vs = ks + c * K;
  float* lin = vs + c * K;
  float* lprev = lin + c * K;
  float* w = lprev + c * K;
  float* us = w + c * c;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long b = blockIdx.x;
  const long long row = b * (long long)T * K;
  const int ck = c * K;

  for (int e = tid; e < K * K; e += WKV_NT) S[e] = s0[b * K * K + e];
  for (int i = tid; i < K; i += WKV_NT) us[i] = u[u_per_row ? b * K + i : i];

  const int nc = T / c;
  for (int j = 0; j < nc; ++j) {
    const long long off = row + (long long)j * ck;
    // a. stage the chunk in f32, then the cumulative log-decays per column
    for (int e = tid; e < ck; e += WKV_NT) {
      rs[e] = wkv_load(r + off + e);
      ks[e] = wkv_load(k + off + e);
      vs[e] = wkv_load(v + off + e);
      lin[e] = lw[off + e];
    }
    __syncthreads();
    if (tid < K) {
      float acc = 0.f;
      for (int t = 0; t < c; ++t) {
        const float l = lin[t * K + tid];
        acc += l;
        lin[t * K + tid] = acc;
        lprev[t * K + tid] = acc - l;
      }
    }
    __syncthreads();

    // b. w[t][tau] for tau < t, and the bonus sum_i r u k on the diagonal;
    //    one warp per (t, tau), its lanes over i
    for (int p = warp; p < c * c; p += WKV_WARPS) {
      const int t = p / c, tau = p - t * c;
      if (tau > t) continue;                       // uniform per warp
      float acc = 0.f;
      if (tau < t) {
        for (int i = lane; i < K; i += 32)
          acc += rs[t * K + i] * expf(lprev[t * K + i] - lin[tau * K + i]) *
                 ks[tau * K + i];
      } else {
        for (int i = lane; i < K; i += 32)
          acc += rs[t * K + i] * us[i] * ks[t * K + i];
      }
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, sh);
      if (lane == 0) w[t * c + tau] = acc;
    }
    __syncthreads();

    // c. r <- r exp(lprev) and k <- k exp(lin[-1] - lin), in place (w no
    //    longer needs the raw r and k); both exponents are <= 0
    for (int e = tid; e < ck; e += WKV_NT) {
      const int i = e % K;
      rs[e] *= expf(lprev[e]);
      ks[e] *= expf(lin[(c - 1) * K + i] - lin[e]);
    }
    __syncthreads();

    // d. o[t][x] = sum_{tau <= t} w[t][tau] v[tau][x] + sum_i r[t][i] S[i][x]
    for (int e = tid; e < ck; e += WKV_NT) {
      const int t = e / K, x = e % K;
      float acc = 0.f;
      for (int tau = 0; tau <= t; ++tau) acc += w[t * c + tau] * vs[tau * K + x];
#pragma unroll 8
      for (int i = 0; i < K; ++i) acc += rs[t * K + i] * S[i * K + x];
      wkv_store(o + off + e, acc);
    }
    __syncthreads();

    // e. S[i][x] <- exp(lin[-1][i]) S[i][x] + sum_tau k[tau][i] v[tau][x]
    for (int e = tid; e < K * K; e += WKV_NT) {
      const int i = e / K, x = e % K;
      float acc = expf(lin[(c - 1) * K + i]) * S[e];
      for (int tau = 0; tau < c; ++tau) acc += ks[tau * K + i] * vs[tau * K + x];
      S[e] = acc;
    }
    __syncthreads();
  }
  for (int e = tid; e < K * K; e += WKV_NT) sT[b * K * K + e] = S[e];
}

template <int K, typename E>
int launch_wkv(const void* r, const void* k, const void* v, const void* lw,
               const void* u, const void* s0, void* o, void* sT, int BH,
               int T, int c, int u_per_row, cudaStream_t stream) {
  const int bytes = wkv_smem_floats(K, c) * (int)sizeof(float);
  auto kern = wkv_forward_kernel<K, E>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<BH, WKV_NT, bytes, stream>>>(
      (const E*)r, (const E*)k, (const E*)v, (const float*)lw,
      (const float*)u, (const float*)s0, (E*)o, (float*)sT, T, c, u_per_row);
  return (int)cudaGetLastError();
}

template <typename E>
int dispatch_k(int K, const void* r, const void* k, const void* v,
               const void* lw, const void* u, const void* s0, void* o,
               void* sT, int BH, int T, int c, int u_per_row,
               cudaStream_t stream) {
  switch (K) {
    case 16:
      return launch_wkv<16, E>(r, k, v, lw, u, s0, o, sT, BH, T, c, u_per_row,
                               stream);
    case 32:
      return launch_wkv<32, E>(r, k, v, lw, u, s0, o, sT, BH, T, c, u_per_row,
                               stream);
    case 64:
      return launch_wkv<64, E>(r, k, v, lw, u, s0, o, sT, BH, T, c, u_per_row,
                               stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace rt

// r, k, v: (BH, T, K) in dtype (0 = f32, 1 = bf16); lw: (BH, T, K) f32;
// u: (K,) or, with u_per_row, (BH, K) f32; s0: (BH, K, K) f32 -> o (BH, T, K)
// in dtype, sT (BH, K, K) f32.  All contiguous; T % c == 0, 1 <= c <= 64.
// Returns cudaGetLastError() after the launch.
extern "C" int rt_wkv_forward(const void* r, const void* k, const void* v,
                              const void* lw, const void* u, const void* s0,
                              void* o, void* sT, int BH, int T, int K, int c,
                              int u_per_row, int dtype, void* stream) {
  if (c < 1 || c > rt::WKV_MAX_CHUNK || T % c != 0)
    return (int)cudaErrorInvalidValue;
  if (BH == 0 || T == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return rt::dispatch_k<float>(K, r, k, v, lw, u, s0, o, sT, BH, T, c,
                                 u_per_row, s);
  if (dtype == 1)
    return rt::dispatch_k<__nv_bfloat16>(K, r, k, v, lw, u, s0, o, sT, BH, T,
                                         c, u_per_row, s);
  return (int)cudaErrorInvalidValue;
}
