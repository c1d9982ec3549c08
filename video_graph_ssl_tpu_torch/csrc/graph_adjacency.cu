// Temporal-graph adjacency for Hopper (sm_90a), one block per clip b:
//
//     sim = q[b] k[b]^T                       (T x T, contracted over D)
//     S   = softmax_j(sim)  (optionally band-masked: |i - j| < nei_size)
//     p   = S * theta                         (static hop-decay weights)
//     adj = sigmoid((logit(p_c) + logit(u)) / tau)   if sample, else p
//
// with p_c = clip(p, eps, 1 - eps) and u ~ U(eps, 1 - eps) either given
// (u_in) or drawn in the kernel by Philox4x32-10 keyed by the 64-bit seed
// with counter (element, b).  adj, S and p are fp32, as in the JAX package;
// the drawn u can be written to u_out for checking.
//
// Replaces the TPU kernel video_graph_ssl_tpu/ops/pallas/graph_kernel.py
// (_adjacency_fwd_pallas -> _adjacency_kernel).  The backward stays in
// torch ops on the small (B, T, T) tensors, as the JAX package keeps it in
// XLA.
//
// What bounds it on the H100: bytes.  The T x T product does 2*T FLOPs per
// element of q and k it reads (T <= 32), so the floor is one read of q and
// k (at the first S3D aug point in bf16: 2 x 9.6 MB); the (B, T, T)
// outputs are tiny.  Design: the block stages q[b] and k[b] through shared
// memory in chunks of kDChunk along D (coalesced row reads), each thread
// accumulates up to four (i, j) pairs (or, for small T, one pair over a
// strided part of the chunk, summed through shared memory at the end),
// and one warp per row does the softmax, the reweighting and the sampling
// with shuffles -- T <= 32 fits a row in a warp.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxT = 32;
constexpr int kDChunk = 128;
constexpr int kMaxPairsPerThread = kMaxT * kMaxT / kThreads;  // 4
constexpr float kEps = 1e-6f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// Philox4x32-10 (Salmon et al., SC'11); returns the first 32-bit word.
__device__ __forceinline__ uint32_t philox_u32(uint32_t c0, uint32_t c1,
                                               uint32_t k0, uint32_t k1) {
  uint32_t c2 = 0u, c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c1 = lo1;
    c3 = lo0;
    c0 = n0;
    c2 = n2;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
adjacency_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const float* __restrict__ theta, const float* __restrict__ u_in,
                 float* __restrict__ adj, float* __restrict__ s_out,
                 float* __restrict__ p_out, float* __restrict__ u_out, int nt,
                 long long D, unsigned long long seed, float temperature,
                 int sample, int nei_size) {
  __shared__ float q_s[kMaxT][kDChunk + 1];
  __shared__ float k_s[kMaxT][kDChunk + 1];
  __shared__ float part[kThreads];
  __shared__ float sim_s[kMaxT * kMaxT];

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int npairs = nt * nt;
  const int nsplit = npairs >= kThreads ? 1 : kThreads / npairs;
  const int split = t / npairs;   // 0 whenever npairs > kThreads
  const int pair0 = t % npairs;
  const T* qb = q + (long long)b * nt * D;
  const T* kb = k + (long long)b * nt * D;

  float acc[kMaxPairsPerThread] = {0.f, 0.f, 0.f, 0.f};
  for (long long d0 = 0; d0 < D; d0 += kDChunk) {
    const long long rem = D - d0;
    const int len = rem < kDChunk ? (int)rem : kDChunk;
    for (int e = t; e < nt * kDChunk; e += kThreads) {
      const int i = e / kDChunk, c = e - i * kDChunk;
      const bool in = c < len;
      q_s[i][c] = in ? to_f(qb[(long long)i * D + d0 + c]) : 0.f;
      k_s[i][c] = in ? to_f(kb[(long long)i * D + d0 + c]) : 0.f;
    }
    __syncthreads();
    if (split < nsplit) {
#pragma unroll
      for (int r = 0; r < kMaxPairsPerThread; ++r) {
        const int pr = pair0 + r * kThreads;
        if (pr < npairs) {
          const int i = pr / nt, j = pr - i * nt;
          float a = acc[r];
          for (int c = split; c < len; c += nsplit) a = fmaf(q_s[i][c], k_s[j][c], a);
          acc[r] = a;
        }
      }
    }
    __syncthreads();
  }

  if (npairs >= kThreads) {
#pragma unroll
    for (int r = 0; r < kMaxPairsPerThread; ++r) {
      const int pr = pair0 + r * kThreads;
      if (pr < npairs) sim_s[pr] = acc[r];
    }
  } else {
    part[t] = split < nsplit ? acc[0] : 0.f;
    __syncthreads();
    if (t < npairs) {
      float s = 0.f;
      for (int sp = 0; sp < nsplit; ++sp) s += part[sp * npairs + t];
      sim_s[t] = s;
    }
  }
  __syncthreads();

  const int warp = t >> 5, lane = t & 31;
  for (int i = warp; i < nt; i += kThreads / 32) {
    const int j = lane;
    const bool in = j < nt;
    float v = in ? sim_s[i * nt + j] : -INFINITY;
    if (in && nei_size > 0 && abs(i - j) >= nei_size) v = -INFINITY;
    float m = v;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float e = in ? expf(v - m) : 0.f;
    float sum = e;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (!in) continue;
    const long long idx = (long long)b * npairs + i * nt + j;
    const float s = e / sum;
    const float p = s * theta[i * nt + j];
    s_out[idx] = s;
    p_out[idx] = p;
    if (!sample) {
      adj[idx] = p;
      continue;
    }
    float u;
    if (u_in != nullptr) {
      u = u_in[idx];
    } else {
      const uint32_t bits = philox_u32((uint32_t)(i * nt + j), (uint32_t)b,
                                       (uint32_t)seed, (uint32_t)(seed >> 32));
      u = (float)(bits >> 8) * 5.9604644775390625e-08f + 2.98023223876953125e-08f;
      u = fminf(fmaxf(u, kEps), 1.f - kEps);
      if (u_out != nullptr) u_out[idx] = u;
    }
    const float pc = fminf(fmaxf(p, kEps), 1.f - kEps);
    const float logits = logf(pc) - log1pf(-pc) + logf(u) - log1pf(-u);
    adj[idx] = 1.f / (1.f + expf(-(logits / temperature)));
  }
}

}  // namespace

// q, k (B, T, D) of one dtype; theta (T, T) fp32; u_in, u_out (B, T, T) fp32
// or null; adj, s, p (B, T, T) fp32.  All contiguous; T <= 32.
extern "C" int vgs_graph_adjacency(const void* q, const void* k,
                                   const void* theta, const void* u_in,
                                   void* adj, void* s, void* p, void* u_out,
                                   int B, int T, long long D, int is_bf16,
                                   unsigned long long seed, float temperature,
                                   int sample, int nei_size, void* stream) {
  if (T < 1 || T > kMaxT) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* th = static_cast<const float*>(theta);
  const float* ui = static_cast<const float*>(u_in);
  float* a = static_cast<float*>(adj);
  float* so = static_cast<float*>(s);
  float* po = static_cast<float*>(p);
  float* uo = static_cast<float*>(u_out);
  if (is_bf16)
    adjacency_kernel<__nv_bfloat16><<<B, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        th, ui, a, so, po, uo, T, D, seed, temperature, sample, nei_size);
  else
    adjacency_kernel<float><<<B, kThreads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), th, ui, a,
        so, po, uo, T, D, seed, temperature, sample, nei_size);
  return (int)cudaGetLastError();
}
