// Temporal-graph adjacency for Hopper (sm_90a):
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
// k (at the first S3D aug point in bf16: 2 x 9.6 MB, 5.8 us); the (B, T, T)
// outputs are tiny.  One block per clip would give 128 blocks at bs 128,
// each with a few KB of loads in flight, far from that rate, so:
//
//   sim_partial_kernel: a block per (clip, split of D), the splits chosen
//     by the wrapper's plan (ops/graph_kernel.py:adjacency_plan) to fill the
//     132 SMs several times.  A thread owns a tile of TI x TI pairs (i, j)
//     and walks its split's 16-byte vectors of D (8 bf16 or 4 fp32; single
//     elements where D * size is not a multiple of 16), issuing the 2 * TI
//     row loads of a vector before any FMA: 256 B in flight per thread at
//     T = 8.  Each q and k element is read from device memory once (for T
//     above 8 a vector is read by the T/8 threads of its row tiles, the
//     repeats served by L1).  The tile is summed over the block's lanes by a
//     halving shuffle tree (each step keeps half the values, 62 shuffles
//     for 64 pairs instead of 320) and then over its warps in a fixed
//     order, and written as the split's partial T x T sim, fp32, to a
//     scratch the wrapper allocates.
//   adjacency_epilogue_kernel: a warp per row (b, i) -- T <= 32 fits a row
//     in a warp -- sums the row's partials in split order, then does the
//     softmax, the reweighting and the sampling with shuffles.
//
// No atomics: two calls with the same inputs and seed give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;          // sim_partial_kernel
constexpr int kWarps = kThreads / 32;
constexpr int kEpiThreads = 256;       // adjacency_epilogue_kernel: a warp per row
constexpr int kMaxT = 32;
constexpr float kEps = 1e-6f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

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

// Sums v[0, N) over the lanes of a warp that differ only in the bits O,
// O / 2, ..., OMIN.  While a lane holds two or more values, each step sends
// half of them to its partner and keeps the sums of the other half; the
// kept values are the tile entries [base, base + N'), N' = max(1, N >> steps).
template <int N, int O, int OMIN>
__device__ __forceinline__ void halve_sum(float* v, int& base) {
  if constexpr (O >= OMIN) {
    const bool up = (threadIdx.x & O) != 0;
    if constexpr (N >= 2) {
      constexpr int H = N / 2;
#pragma unroll
      for (int e = 0; e < H; ++e) {
        const float send = up ? v[e] : v[e + H];
        const float keep = up ? v[e + H] : v[e];
        v[e] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      if (up) base += H;
      halve_sum<H, O / 2, OMIN>(v, base);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      halve_sum<1, O / 2, OMIN>(v, base);
    }
  }
}

__host__ __device__ constexpr int ilog2(int n) { return n <= 1 ? 0 : 1 + ilog2(n / 2); }

// Block (b, sp) of the grid (B * splits): the partial sim of clip b over the
// vectors [sp * per_split, (sp + 1) * per_split) of D.  Thread t owns tile
// t % kTiles (row tile / kNtj, column tile % kNtj, TI x TI pairs) and walks
// the split's vectors t / kTiles, t / kTiles + kLanes, ...
template <typename T, int VEC, int TI, int LOG_TILES>
__global__ void __launch_bounds__(kThreads)
sim_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   float* __restrict__ part, int nt, long long D, int splits,
                   int per_split, int nvec) {
  constexpr int kTiles = 1 << LOG_TILES;
  constexpr int kNtj = 1 << (LOG_TILES / 2);
  constexpr int kLanes = kThreads / kTiles;
  constexpr int N = TI * TI;
  __shared__ float red[kWarps][kTiles * N];

  const int b = blockIdx.x / splits, sp = blockIdx.x - b * splits;
  const int tile = threadIdx.x % kTiles, lane = threadIdx.x / kTiles;
  const int i0 = (tile / kNtj) * TI, j0 = (tile % kNtj) * TI;
  const int v0 = sp * per_split, v1 = min(nvec, v0 + per_split);
  const T* qb = q + (long long)b * nt * D;
  const T* kb = k + (long long)b * nt * D;

  float acc[N];
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] = 0.f;
  for (int v = v0 + lane; v < v1; v += kLanes) {
    Pack<T, VEC> qv[TI], kv[TI];
#pragma unroll
    for (int r = 0; r < TI; ++r) {
      if (i0 + r < nt)
        qv[r] = *reinterpret_cast<const Pack<T, VEC>*>(qb + (long long)(i0 + r) * D +
                                                        (long long)v * VEC);
      if (j0 + r < nt)
        kv[r] = *reinterpret_cast<const Pack<T, VEC>*>(kb + (long long)(j0 + r) * D +
                                                        (long long)v * VEC);
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float qf[TI], kf[TI];
#pragma unroll
      for (int r = 0; r < TI; ++r) {
        qf[r] = i0 + r < nt ? to_f(qv[r].v[e]) : 0.f;
        kf[r] = j0 + r < nt ? to_f(kv[r].v[e]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < TI; ++r)
#pragma unroll
        for (int c = 0; c < TI; ++c) acc[r * TI + c] = fmaf(qf[r], kf[c], acc[r * TI + c]);
    }
  }

  // over the warp's lanes of the same tile (lane bits 16 .. kTiles), then
  // over the warps in order
  int base = 0;
  halve_sum<N, 16, kTiles>(acc, base);
  constexpr int kSteps = 5 - LOG_TILES;
  constexpr int kHalving = ilog2(N) < kSteps ? ilog2(N) : kSteps;
  constexpr int kKept = N >> kHalving;
  // lanes that differ only in the bits of the steps past the halving hold
  // the same sums: the one with those bits 0 writes them
  constexpr int kDupMask = kTiles * ((1 << (kSteps - kHalving)) - 1);
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & kDupMask) == 0) {
#pragma unroll
    for (int e = 0; e < kKept; ++e) red[warp][tile * N + base + e] = acc[e];
  }
  __syncthreads();
  // partials as [split][clip][T][T]
  float* out = part + ((long long)sp * (gridDim.x / splits) + b) * nt * nt;
  for (int pr = threadIdx.x; pr < kTiles * N; pr += kThreads) {
    const int tl = pr / N, e = pr - tl * N;
    const int i = (tl / kNtj) * TI + e / TI, j = (tl % kNtj) * TI + e % TI;
    if (i >= nt || j >= nt) continue;
    float s = red[0][pr];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[w][pr];
    out[i * nt + j] = s;
  }
}

// A warp per row (b, i): sim from the partials (split order), then the
// softmax, the reweighting and the sampling; lane j is column j.
__global__ void __launch_bounds__(kEpiThreads)
adjacency_epilogue_kernel(const float* __restrict__ part, const float* __restrict__ theta,
                          const float* __restrict__ u_in, float* __restrict__ adj,
                          float* __restrict__ s_out, float* __restrict__ p_out,
                          float* __restrict__ u_out, int B, int nt, int splits,
                          unsigned long long seed, float temperature, int sample,
                          int nei_size) {
  const int row = blockIdx.x * (kEpiThreads / 32) + threadIdx.x / 32;
  if (row >= B * nt) return;
  const int b = row / nt, i = row - b * nt, j = threadIdx.x & 31;
  const int npairs = nt * nt;
  const bool in = j < nt;
  float v = -INFINITY;
  if (in) {
    const float* pp = part + (long long)b * npairs + i * nt + j;
    v = pp[0];
    for (int sp = 1; sp < splits; ++sp) v += pp[(long long)sp * B * npairs];
    if (nei_size > 0 && abs(i - j) >= nei_size) v = -INFINITY;
  }
  float m = v;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const float e = in ? expf(v - m) : 0.f;
  float sum = e;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (!in) return;
  const long long idx = (long long)b * npairs + i * nt + j;
  const float s = e / sum;
  const float p = s * theta[i * nt + j];
  s_out[idx] = s;
  p_out[idx] = p;
  if (!sample) {
    adj[idx] = p;
    return;
  }
  float u;
  if (u_in != nullptr) {
    u = u_in[idx];
  } else {
    const uint32_t bits = philox_u32((uint32_t)(i * nt + j), (uint32_t)b, (uint32_t)seed,
                                     (uint32_t)(seed >> 32));
    u = (float)(bits >> 8) * 5.9604644775390625e-08f + 2.98023223876953125e-08f;
    u = fminf(fmaxf(u, kEps), 1.f - kEps);
    if (u_out != nullptr) u_out[idx] = u;
  }
  const float pc = fminf(fmaxf(p, kEps), 1.f - kEps);
  const float logits = logf(pc) - log1pf(-pc) + logf(u) - log1pf(-u);
  adj[idx] = 1.f / (1.f + expf(-(logits / temperature)));
}

template <typename T, int VEC>
int launch_sim(const void* q, const void* k, float* part, int B, int nt, long long D,
               int tile, int splits, int per_split, cudaStream_t st) {
  const long long nvec = D / VEC;
  const unsigned blocks = (unsigned)((long long)B * splits);
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  if (tile == 2 && nt <= 2)
    sim_partial_kernel<T, VEC, 2, 0><<<blocks, kThreads, 0, st>>>(qq, kk, part, nt, D, splits,
                                                                  per_split, (int)nvec);
  else if (tile == 4 && nt <= 4)
    sim_partial_kernel<T, VEC, 4, 0><<<blocks, kThreads, 0, st>>>(qq, kk, part, nt, D, splits,
                                                                  per_split, (int)nvec);
  else if (tile == 8 && nt <= 8)
    sim_partial_kernel<T, VEC, 8, 0><<<blocks, kThreads, 0, st>>>(qq, kk, part, nt, D, splits,
                                                                  per_split, (int)nvec);
  else if (tile == 8 && nt <= 16)
    sim_partial_kernel<T, VEC, 8, 2><<<blocks, kThreads, 0, st>>>(qq, kk, part, nt, D, splits,
                                                                  per_split, (int)nvec);
  else if (tile == 8 && nt <= 32)
    sim_partial_kernel<T, VEC, 8, 4><<<blocks, kThreads, 0, st>>>(qq, kk, part, nt, D, splits,
                                                                  per_split, (int)nvec);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// q, k (B, T, D) of one dtype; theta (T, T) fp32; u_in, u_out (B, T, T) fp32
// or null; adj, s, p (B, T, T) fp32; part (splits, B, T, T) fp32 scratch.
// All contiguous; T <= 32.  vec (elements per load: 16 bytes, or 1), tile
// (2, 4 or 8), splits and per_split (vectors of D per split) come from the
// wrapper's plan (ops/graph_kernel.py:adjacency_plan).  Two launches.
extern "C" int vgs_graph_adjacency(const void* q, const void* k, const void* theta,
                                   const void* u_in, void* adj, void* s, void* p,
                                   void* u_out, void* part, int B, int T, long long D,
                                   int is_bf16, unsigned long long seed, float temperature,
                                   int sample, int nei_size, int vec, int tile, int splits,
                                   int per_split, void* stream) {
  const int esize = is_bf16 ? 2 : 4;
  if (T < 1 || T > kMaxT || B < 1 || D < 1 || splits < 1 || per_split < 1 ||
      (vec != 1 && (vec * esize != 16 || D % vec || !aligned16(q) || !aligned16(k))) ||
      (long long)splits * per_split < D / vec || (long long)B * splits > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(part);
  int code;
  if (is_bf16)
    code = vec == 8 ? launch_sim<__nv_bfloat16, 8>(q, k, pt, B, T, D, tile, splits, per_split, st)
                    : launch_sim<__nv_bfloat16, 1>(q, k, pt, B, T, D, tile, splits, per_split, st);
  else
    code = vec == 4 ? launch_sim<float, 4>(q, k, pt, B, T, D, tile, splits, per_split, st)
                    : launch_sim<float, 1>(q, k, pt, B, T, D, tile, splits, per_split, st);
  if (code != 0) return code;
  const int rows_per_block = kEpiThreads / 32;
  adjacency_epilogue_kernel<<<(B * T + rows_per_block - 1) / rows_per_block, kEpiThreads, 0,
                              st>>>(pt, static_cast<const float*>(theta),
                                    static_cast<const float*>(u_in), static_cast<float*>(adj),
                                    static_cast<float*>(s), static_cast<float*>(p),
                                    static_cast<float*>(u_out), B, T, splits, seed, temperature,
                                    sample, nei_size);
  return (int)cudaGetLastError();
}
