// Backward of the train-mode SepConv pair for Hopper (sm_90a):
//
//     y1 = conv_s(x, Ws) (1x3x3, pad 1) -> BN1 (batch stats) -> ReLU -> a
//     y2 = conv_t(a, Wt) (3x1x1, pad 1) -> BN2 (batch stats) -> ReLU -> out
//
// Given x, the cotangent g of out, the weights and the forward's batch
// statistics, it returns dx, dWs, dWt and the BN sums (dgamma = S_gx,
// dbeta = S_g of each BN), with the cast points of the plain version
// (video_graph_ssl_tpu_torch/ops/fused_sepconv.py: bwd_reference): y1, y2,
// da and the conv outputs are rounded to the compute dtype, a, dy2 and dy1
// are cast to it before the products, dz1 is kept in it, and every sum
// runs in fp32.
//
// Replaces the TPU kernels K5, video_graph_ssl_tpu/ops/pallas/sepconv_bwd.py
// (sepconv_bwd_pallas -> _k1_bn2_sums, _k2_mid, _k3_input_grads) and K6,
// ops/pallas/sepconv_bwd_grid.py (sepconv_bwd_pallas_grid -> _k1g, _k2g,
// _k3g).  Their split was the size of the TPU's VMEM; here one family
// covers every shape (k = 3, stride 1, pad 1).
//
// Design.  The BN train backward needs the batch sums of the cotangent
// before any per-element gradient, which forces three sweeps, in order on
// one stream:
//   1. conv_s(x) -> y1, a; conv_t(a) -> y2 and per-tile BN2 sums;
//   2. dy2 (elementwise); da = conv_t^T(dy2) -> dz1 and per-tile BN1 sums;
//      dWt = sum a (x) dy2 over rows and temporal taps;
//   3. dy1 (elementwise); dx = conv_s^T(dy1); dWs = sum x (x) dy1.
// The TPU kernels recomputed y1, a and y2 in every sweep to keep them out
// of HBM.  On the H100 the intermediates go to device memory in the compute
// dtype instead (y1, a, y2 -> dy2 in place, dz1 -> dy1 in place): storing
// them costs a few activation passes at 3.35 TB/s, recomputing them would
// cost four more conv passes.  Rounding a stored value to the compute dtype
// is exactly the rounding the recompute applies, so the outputs are the same.
//
// Every product is one hand-written tap-shifted implicit GEMM
// (conv_taps_kernel): output rows are the (b, t, h, w) positions, each tap
// reads the input rows shifted by its (dt, dh, dw) offset (zero outside the
// clip, which is the conv padding), and the sum over taps and channels
// runs in fp32 on 64x64 tiles staged in shared memory.  The weight
// gradients are the same product contracted over rows (wgrad_taps_kernel).
//
// Cross-block sums.  Blocks run in no order, so nothing accumulates across
// them: each tile writes its own fp32 partial (BN sums per 64-row tile,
// weight gradients per row split) and a reduction kernel adds the partials
// in a fixed order.  The result is deterministic, and bounded in memory:
// the weight-gradient splits are chosen by the caller (a few tens).
//
// What bounds it on the H100: operations.  Six conv-sized products
// (2 * rows * taps * Cin * Cout each) against a few activation passes of
// bytes; the bound is the FLOP count over the bf16 dense tensor-core rate:
// for the 18 fused SepConvs of a bs-128 S3D pass, 1.1 TFLOP, 1.12 ms at
// 989 TFLOP/s.  This first version runs the products on the CUDA cores in
// fp32 FMA, far from that bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int BM = 64;   // rows (or input channels, for wgrad) per tile
constexpr int BN = 64;   // output channels per tile
constexpr int BK = 16;   // reduction step staged in shared memory
constexpr int kMaxTaps = 9;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// round to the compute dtype and back
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

struct Rows {      // the (b, t, h, w) positions of the clip tensor
  int nt, nh, nw;
  int m;           // B * nt * nh * nw
};

struct Taps {      // row offsets of the taps of one conv
  int n;
  int dt[kMaxTaps], dh[kMaxTaps], dw[kMaxTaps];
};

// BN constants, each [N]: mu, rsqrt(var + eps), gamma, beta.  The
// normalisation is written with explicit roundings so the compiler does
// not contract it into FMAs the plain version does not have.
__device__ __forceinline__ float bn_xhat(float y, const float* bn, int N, int n) {
  return __fmul_rn(__fsub_rn(y, bn[n]), bn[N + n]);
}
__device__ __forceinline__ float bn_z(float xhat, const float* bn, int N, int n) {
  return __fadd_rn(__fmul_rn(xhat, bn[2 * N + n]), bn[3 * N + n]);
}

enum Epilogue {
  kY1 = 0,   // out0 = y1, out1 = a = relu(bn1(y1))
  kY2 = 1,   // out0 = y2; BN2 sums of dz2 = [z2 > 0] g (aux = g)
  kDA = 2,   // out0 = dz1 = [z1 > 0] da; BN1 sums (aux = y1)
  kDX = 3,   // out0 = dx
};

// out[r, n] = sum_j sum_k A[shift_j(r), k] * Wk[j, k, n], then the epilogue.
// Grid (ceil(M / BM), ceil(N / BN)); partial is [gridDim.x][2][N].
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
conv_taps_kernel(const T* __restrict__ A, const T* __restrict__ Wk, int K, int N,
                 Rows rows, Taps taps, const float* __restrict__ bn,
                 const T* __restrict__ aux, T* __restrict__ out0,
                 T* __restrict__ out1, float* __restrict__ partial) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];
  __shared__ float red[2][16][BN];

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int n_base = blockIdx.y * BN;

  // the row this thread stages for the A tile
  const int lr = tid / 4, lk = (tid % 4) * 4;
  const int r_load = blockIdx.x * BM + lr;
  const bool row_ok = r_load < rows.m;
  int lt = 0, lh = 0, lw = 0, lb = 0;
  if (row_ok) {
    int q = r_load;
    lw = q % rows.nw; q /= rows.nw;
    lh = q % rows.nh; q /= rows.nh;
    lt = q % rows.nt; lb = q / rows.nt;
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int j = 0; j < taps.n; ++j) {
    const int t2 = lt + taps.dt[j], h2 = lh + taps.dh[j], w2 = lw + taps.dw[j];
    const bool ok = row_ok && t2 >= 0 && t2 < rows.nt && h2 >= 0 && h2 < rows.nh &&
                    w2 >= 0 && w2 < rows.nw;
    const long long src = ok
        ? (((long long)lb * rows.nt + t2) * rows.nh + h2) * (long long)rows.nw + w2
        : 0;
    const T* arow = A + src * K;
    const T* wj = Wk + (long long)j * K * N;
    for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int kk = lk + q;
        As[kk][lr] = (ok && k0 + kk < K) ? to_f(arow[k0 + kk]) : 0.f;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int kb = tid / 16, nb = (tid % 16) * 4 + q;
        const int gk = k0 + kb, gn = n_base + nb;
        Bs[kb][nb] = (gk < K && gn < N) ? to_f(wj[(long long)gk * N + gn]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = Bs[kk][tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
      }
      __syncthreads();
    }
  }

  float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = blockIdx.x * BM + ty + 16 * i;
    if (r >= rows.m) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n_base + tx + 16 * c;
      if (n >= N) continue;
      const long long o = (long long)r * N + n;
      if constexpr (MODE == kY1) {
        const float y = rnd<T>(acc[i][c]);
        const float z = bn_z(bn_xhat(y, bn, N, n), bn, N, n);
        out0[o] = from_f<T>(y);
        out1[o] = from_f<T>(fmaxf(z, 0.f));
      } else if constexpr (MODE == kY2) {
        const float y = rnd<T>(acc[i][c]);
        const float xhat = bn_xhat(y, bn, N, n);
        const float dz = bn_z(xhat, bn, N, n) > 0.f ? to_f(aux[o]) : 0.f;
        out0[o] = from_f<T>(y);
        s0[c] += dz;
        s1[c] = fmaf(dz, xhat, s1[c]);
      } else if constexpr (MODE == kDA) {
        const float da = rnd<T>(acc[i][c]);
        const float xhat = bn_xhat(to_f(aux[o]), bn, N, n);
        const float dz = bn_z(xhat, bn, N, n) > 0.f ? da : 0.f;
        out0[o] = from_f<T>(dz);
        s0[c] += dz;
        s1[c] = fmaf(dz, xhat, s1[c]);
      } else {
        out0[o] = from_f<T>(acc[i][c]);
      }
    }
  }
  if constexpr (MODE == kY2 || MODE == kDA) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      red[0][ty][tx + 16 * c] = s0[c];
      red[1][ty][tx + 16 * c] = s1[c];
    }
    __syncthreads();
    if (tid < 2 * BN) {
      const int s = tid / BN, col = tid % BN, n = n_base + col;
      if (n < N) {
        float tot = 0.f;
        for (int q = 0; q < 16; ++q) tot += red[s][q][col];
        partial[((long long)blockIdx.x * 2 + s) * N + n] = tot;
      }
    }
  }
}

// sums[s * N + n] = sum over tiles of partial[tile][s][n], in a fixed order;
// means = sums / count.  Grid 2 * N blocks.
__global__ void __launch_bounds__(kThreads)
bn_sums_kernel(const float* __restrict__ partial, int tiles, int N, float count,
               float* __restrict__ sums, float* __restrict__ means) {
  __shared__ float buf[kThreads];
  const int idx = blockIdx.x, s = idx / N, n = idx % N;
  float tot = 0.f;
  for (int t = threadIdx.x; t < tiles; t += kThreads)
    tot += partial[((long long)t * 2 + s) * N + n];
  buf[threadIdx.x] = tot;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w /= 2) {
    if (threadIdx.x < w) buf[threadIdx.x] += buf[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    sums[idx] = buf[0];
    means[idx] = buf[0] / count;
  }
}

// The BN train backward, elementwise over (rows, N):
//   dz = MASK ? [z > 0] src : src,   z, xhat from y and the BN constants,
//   out = (gamma * rs) * (dz - mean(S_g) - xhat * mean(S_gx)), rounded.
// out may alias y (sweep 2) or src (sweep 3): each element is read, then
// written, by one thread.
template <typename T, bool MASK>
__global__ void __launch_bounds__(kThreads)
bn_bwd_kernel(const T* y, const T* src, const float* __restrict__ bn,
              const float* __restrict__ means, int N, long long total, T* out) {
  const long long o = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (o >= total) return;
  const int n = (int)(o % N);
  const float xhat = bn_xhat(to_f(y[o]), bn, N, n);
  float dz = to_f(src[o]);
  if (MASK && !(bn_z(xhat, bn, N, n) > 0.f)) dz = 0.f;
  const float alpha = __fmul_rn(bn[2 * N + n], bn[N + n]);
  const float d = __fsub_rn(__fsub_rn(dz, means[n]), __fmul_rn(xhat, means[N + n]));
  out[o] = from_f<T>(__fmul_rn(alpha, d));
}

// partial[split][j][k][n] = sum over the split's rows r of
//   A[shift_j(r), k] * D[r, n].
// Grid (ceil(K / BM), ceil(N / BN), taps * splits).
template <typename T>
__global__ void __launch_bounds__(kThreads)
wgrad_taps_kernel(const T* __restrict__ A, int K, const T* __restrict__ D, int N,
                  Rows rows, Taps taps, int splits, int rows_per_split,
                  float* __restrict__ partial) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Ds[BK][BN + 4];
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int j = blockIdx.z / splits, split = blockIdx.z % splits;
  const int k_base = blockIdx.x * BM, n_base = blockIdx.y * BN;
  const int r_begin = split * rows_per_split;
  const int r_end = min(rows.m, r_begin + rows_per_split);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  const int lrow = tid / 16, lcol = (tid % 16) * 4;
  for (int r0 = r_begin; r0 < r_end; r0 += BK) {
    const int r = r0 + lrow;
    bool ok = r < r_end;
    long long src = 0;
    if (ok) {
      int q = r;
      const int w = q % rows.nw; q /= rows.nw;
      const int h = q % rows.nh; q /= rows.nh;
      const int t = q % rows.nt, b = q / rows.nt;
      const int t2 = t + taps.dt[j], h2 = h + taps.dh[j], w2 = w + taps.dw[j];
      ok = t2 >= 0 && t2 < rows.nt && h2 >= 0 && h2 < rows.nh && w2 >= 0 && w2 < rows.nw;
      src = (((long long)b * rows.nt + t2) * rows.nh + h2) * (long long)rows.nw + w2;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int gk = k_base + lcol + q, gn = n_base + lcol + q;
      As[lrow][lcol + q] = (ok && gk < K) ? to_f(A[src * K + gk]) : 0.f;
      Ds[lrow][lcol + q] = (r < r_end && gn < N) ? to_f(D[(long long)r * N + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < BK; ++rr) {
      float av[4], dv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[rr][ty + 16 * i];
#pragma unroll
      for (int c = 0; c < 4; ++c) dv[c] = Ds[rr][tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(av[i], dv[c], acc[i][c]);
    }
    __syncthreads();
  }
  float* out = partial + ((long long)split * taps.n + j) * K * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k_base + ty + 16 * i;
    if (k >= K) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n_base + tx + 16 * c;
      if (n < N) out[(long long)k * N + n] = acc[i][c];
    }
  }
}

// out[e] = sum over splits of partial[split][e], in order.
__global__ void __launch_bounds__(kThreads)
split_sum_kernel(const float* __restrict__ partial, int splits, long long size,
                 float* __restrict__ out) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= size) return;
  float tot = 0.f;
  for (int s = 0; s < splits; ++s) tot += partial[(long long)s * size + e];
  out[e] = tot;
}

unsigned blocks_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

Taps spatial_taps(int sign) {   // (0, sign*(kh-1), sign*(kw-1)), j = kh*3 + kw
  Taps t{};
  t.n = 9;
  for (int kh = 0; kh < 3; ++kh)
    for (int kw = 0; kw < 3; ++kw) {
      const int j = kh * 3 + kw;
      t.dt[j] = 0;
      t.dh[j] = sign * (kh - 1);
      t.dw[j] = sign * (kw - 1);
    }
  return t;
}

Taps temporal_taps(int sign) {  // (sign*(k-1), 0, 0), j = k
  Taps t{};
  t.n = 3;
  for (int k = 0; k < 3; ++k) {
    t.dt[k] = sign * (k - 1);
    t.dh[k] = 0;
    t.dw[k] = 0;
  }
  return t;
}

#define VGS_CHECK()                                  \
  do {                                               \
    cudaError_t e_ = cudaGetLastError();             \
    if (e_ != cudaSuccess) return (int)e_;           \
  } while (0)

template <typename T>
int run(const void* x_, const void* g_, const void* w1_, const void* w2_,
        const void* w3_, const void* w4_, const float* bn1, const float* bn2,
        void* y1_, void* a_, void* y2_, void* dz1_, float* bn_part, float* wpart,
        float* s1, float* m1, float* s2, float* m2, void* dx_, float* dws,
        float* dwt, int B, int nt, int nh, int nw, int C, int F, int splits_s,
        int splits_t, cudaStream_t st) {
  const T* x = static_cast<const T*>(x_);
  const T* g = static_cast<const T*>(g_);
  const T* w1 = static_cast<const T*>(w1_);   // [9][C][F]: conv_s
  const T* w2 = static_cast<const T*>(w2_);   // [3][F][F]: conv_t
  const T* w3 = static_cast<const T*>(w3_);   // [3][F][F]: conv_t^T
  const T* w4 = static_cast<const T*>(w4_);   // [9][F][C]: conv_s^T
  T* y1 = static_cast<T*>(y1_);
  T* a = static_cast<T*>(a_);
  T* y2 = static_cast<T*>(y2_);     // y2, then dy2 in place
  T* dz1 = static_cast<T*>(dz1_);   // dz1, then dy1 in place
  T* dx = static_cast<T*>(dx_);

  const Rows rows{nt, nh, nw, B * nt * nh * nw};
  const long long elems = (long long)rows.m * F;
  const float count = (float)rows.m;
  const int mtiles = (rows.m + BM - 1) / BM;
  const dim3 grid_f(mtiles, (F + BN - 1) / BN);
  const dim3 grid_c(mtiles, (C + BN - 1) / BN);

  // sweep 1
  conv_taps_kernel<T, kY1><<<grid_f, kThreads, 0, st>>>(
      x, w1, C, F, rows, spatial_taps(1), bn1, nullptr, y1, a, nullptr);
  VGS_CHECK();
  conv_taps_kernel<T, kY2><<<grid_f, kThreads, 0, st>>>(
      a, w2, F, F, rows, temporal_taps(1), bn2, g, y2, nullptr, bn_part);
  VGS_CHECK();
  bn_sums_kernel<<<2 * F, kThreads, 0, st>>>(bn_part, mtiles, F, count, s2, m2);
  VGS_CHECK();
  // sweep 2
  bn_bwd_kernel<T, true><<<blocks_for(elems), kThreads, 0, st>>>(
      y2, g, bn2, m2, F, elems, y2);
  VGS_CHECK();
  conv_taps_kernel<T, kDA><<<grid_f, kThreads, 0, st>>>(
      y2, w3, F, F, rows, temporal_taps(-1), bn1, y1, dz1, nullptr, bn_part);
  VGS_CHECK();
  bn_sums_kernel<<<2 * F, kThreads, 0, st>>>(bn_part, mtiles, F, count, s1, m1);
  VGS_CHECK();
  {
    const int rps = ((rows.m + splits_t - 1) / splits_t + BK - 1) / BK * BK;
    const dim3 grid((F + BM - 1) / BM, (F + BN - 1) / BN, 3 * splits_t);
    wgrad_taps_kernel<T><<<grid, kThreads, 0, st>>>(
        a, F, y2, F, rows, temporal_taps(1), splits_t, rps, wpart);
    VGS_CHECK();
    const long long size = 3LL * F * F;
    split_sum_kernel<<<blocks_for(size), kThreads, 0, st>>>(wpart, splits_t, size, dwt);
    VGS_CHECK();
  }
  // sweep 3
  bn_bwd_kernel<T, false><<<blocks_for(elems), kThreads, 0, st>>>(
      y1, dz1, bn1, m1, F, elems, dz1);
  VGS_CHECK();
  conv_taps_kernel<T, kDX><<<grid_c, kThreads, 0, st>>>(
      dz1, w4, F, C, rows, spatial_taps(-1), nullptr, nullptr, dx, nullptr, nullptr);
  VGS_CHECK();
  {
    const int rps = ((rows.m + splits_s - 1) / splits_s + BK - 1) / BK * BK;
    const dim3 grid((C + BM - 1) / BM, (F + BN - 1) / BN, 9 * splits_s);
    wgrad_taps_kernel<T><<<grid, kThreads, 0, st>>>(
        x, C, dz1, F, rows, spatial_taps(1), splits_s, rps, wpart);
    VGS_CHECK();
    const long long size = 9LL * C * F;
    split_sum_kernel<<<blocks_for(size), kThreads, 0, st>>>(wpart, splits_s, size, dws);
    VGS_CHECK();
  }
  return 0;
}

}  // namespace

// x (B, T, H, W, C) and g (B, T, H, W, F) channels-last in the compute
// dtype; w1 [9][C][F], w2 and w3 [3][F][F], w4 [9][F][C] in the compute
// dtype; bn1, bn2 [4][F] fp32 (mu, rsqrt(var + eps), gamma, beta).
// Scratch: y1, a, y2, dz1 (B, T, H, W, F) compute dtype; bn_part
// [ceil(rows / 64)][2][F] and wpart [max(splits_t * 3 * F * F,
// splits_s * 9 * C * F)] fp32.  Out: s1, m1, s2, m2 [2][F] (sums of dz and
// dz * xhat, and their means); dx (B, T, H, W, C) compute dtype; dws
// [9][C][F] and dwt [3][F][F] fp32.
extern "C" int vgs_sepconv_bwd(const void* x, const void* g, const void* w1,
                               const void* w2, const void* w3, const void* w4,
                               const void* bn1, const void* bn2, void* y1, void* a,
                               void* y2, void* dz1, void* bn_part, void* wpart,
                               void* s1, void* m1, void* s2, void* m2, void* dx,
                               void* dws, void* dwt, int B, int T, int H, int W,
                               int C, int F, int splits_s, int splits_t,
                               int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto fm = [](void* p) { return static_cast<float*>(p); };
  if (is_bf16)
    return run<__nv_bfloat16>(x, g, w1, w2, w3, w4, f(bn1), f(bn2), y1, a, y2, dz1,
                              fm(bn_part), fm(wpart), fm(s1), fm(m1), fm(s2), fm(m2),
                              dx, fm(dws), fm(dwt), B, T, H, W, C, F, splits_s,
                              splits_t, st);
  return run<float>(x, g, w1, w2, w3, w4, f(bn1), f(bn2), y1, a, y2, dz1,
                    fm(bn_part), fm(wpart), fm(s1), fm(m1), fm(s2), fm(m2), dx,
                    fm(dws), fm(dwt), B, T, H, W, C, F, splits_s, splits_t, st);
}
