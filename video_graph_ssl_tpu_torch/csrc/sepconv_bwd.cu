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
// A prep launch first lays the weights out for the products (w1..w4 in
// the compute dtype) and builds the BN constants.  Each sweep is a stage
// with its own C entry (vgs_sepconv_bwd_stage1..3; vgs_sepconv_bwd runs
// all three): ranks that each hold rows of one batch sum each stage's two
// BN sums over the ranks between the stages, and stages 2 and 3 then
// start from the means of the global batch (bn_means_kernel).  The TPU kernels
// recomputed y1, a and y2 in every sweep to keep them out of HBM.  On the
// H100 the intermediates go to device memory in the compute dtype instead
// (y1, a, y2 -> dy2 in place, dz1 -> dy1 in place): rounding a stored
// value to the compute dtype is exactly the rounding the recompute
// applies, so the outputs are the same.
//
// Every product is a tap-shifted implicit GEMM: output rows are the
// (b, t, h, w) positions, each tap reads the input rows shifted by its
// (dt, dh, dw) offset (zero outside the clip, which is the conv padding).
// The weight gradients are the same product contracted over rows.
//
// Two routes, chosen by the caller from the shape (ops/sepconv_bwd.py:
// plan), both deterministic:
//   tc    bf16 with C and F multiples of 8 (every S3D SepConv): the six
//         products on the tensor cores, mma.sync bf16 with fp32
//         accumulators fed by a cp.async ring (sepconv_bwd_tc.cuh), and
//         16-byte elementwise passes;
//   simt  fp32, or channels that are not multiples of 8: the products in
//         fp32 FMA on the CUDA cores on 64x64 tiles (conv_taps_kernel,
//         wgrad_taps_kernel).
//
// Cross-block sums.  Blocks run in no order, so nothing accumulates across
// them: each tile writes its own fp32 partial (BN sums per row tile,
// weight gradients per row split) and a reduction kernel adds the partials
// in a fixed order.  No atomics: two calls give the same bits.
//
// What bounds it on the H100: operations, then its own intermediates.  Six
// conv-sized products (2 * rows * taps * Cin * Cout each); for the 18
// fused SepConvs of a bs-128 S3D pass, 1.11 TFLOP, 1.12 ms at the 989
// TFLOP/s bf16 dense tensor-core rate.  The stored intermediates (y1, a,
// y2/dy2, dz1/dy1, each written and read again) move about 4.7 GB per
// pass, 1.41 ms at 3.35 TB/s: that is the floor of this design until the
// BN-backward passes are fused into the GEMM prologues.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <type_traits>

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

// n / d for 0 <= n < 2^31 and d >= 1 by a multiply and a shift
struct FastDiv {
  unsigned m, s;
  __device__ __forceinline__ int div(int n) const {
    return (int)((__umulhi((unsigned)n, m) + (unsigned)n) >> s);
  }
};

FastDiv make_div(int d) {
  unsigned s = 0;
  while ((1ull << s) < (unsigned long long)d) ++s;
  return {(unsigned)(((1ull << 32) * ((1ull << s) - d)) / d + 1), s};
}

// Where row r = (b, t, h, w), channel n of the cotangent g lies: at
// b * sb + t * st + h * sh + w * sw + n * cs.  The cotangent reaches a
// branch SepConv as a channel slice of its Inception concat's gradient, of
// whatever layout the layers above gave it (channels_last_3d from the next
// block's convolutions; (B, T, C, H, W) from the head's mean at Mixed_5c),
// and is read in place.  vec: contiguous channels and 16-byte aligned rows
// (vector loads).
struct GView {
  long long sb, st, sh, sw, cs;
  int vec, thw, hw, nw;
  FastDiv d_thw, d_hw, d_w;
  __device__ __forceinline__ long long row(int r) const {
    const int b = d_thw.div(r);
    int rem = r - b * thw;
    const int t = d_hw.div(rem);
    rem -= t * hw;
    const int h = d_w.div(rem);
    return (long long)b * sb + (long long)t * st + (long long)h * sh +
           (long long)(rem - h * nw) * sw;
  }
};

GView make_view(int nt, int nh, int nw, long long sb, long long st, long long sh,
                long long sw, long long cs, int vec) {
  GView v;
  v.sb = sb;
  v.st = st;
  v.sh = sh;
  v.sw = sw;
  v.cs = cs;
  v.vec = vec;
  v.thw = nt * nh * nw;
  v.hw = nh * nw;
  v.nw = nw;
  v.d_thw = make_div(v.thw);
  v.d_hw = make_div(v.hw);
  v.d_w = make_div(nw);
  return v;
}

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
                 const T* __restrict__ aux, GView gv, T* __restrict__ out0,
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
        const float dz = bn_z(xhat, bn, N, n) > 0.f
            ? to_f(aux[gv.row(r) + n * gv.cs]) : 0.f;
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

// means[i] = sums[i] / count[0] for i < n (n = 2 * N): the means of a call
// whose ranks each hold rows of one batch, from the [2][N] sums over every
// rank and the global row count.  The division is fp32, as jnp.mean
// divides by the row count converted to fp32, and as bn_sums_kernel and
// parallel/sync_bn.py divide; count is the ranks' exact counts summed in
// fp32 (exact below 2^24 rows).
__global__ void __launch_bounds__(kThreads)
bn_means_kernel(const float* __restrict__ sums, const float* __restrict__ count, int n,
                float* __restrict__ means) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) means[i] = sums[i] / count[0];
}

// The BN train backward, elementwise over (rows, N):
//   dz = MASK ? [z > 0] src : src,   z, xhat from y and the BN constants,
//   out = (gamma * rs) * (dz - mean(S_g) - xhat * mean(S_gx)), rounded.
// out may alias y (sweep 2) or src (sweep 3): each element is read, then
// written, by one thread.  y and out are [rows][N], src lies at its GView.
template <typename T, bool MASK>
__global__ void __launch_bounds__(kThreads)
bn_bwd_kernel(const T* y, const T* src, GView sv,
              const float* __restrict__ bn, const float* __restrict__ means, int N,
              long long total, T* out) {
  const long long o = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (o >= total) return;
  const int r = (int)(o / N);
  const int n = (int)(o - (long long)r * N);
  const float xhat = bn_xhat(to_f(y[o]), bn, N, n);
  float dz = to_f(src[sv.row(r) + n * sv.cs]);
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

// out = sum over splits of partial[split][j][k][n], in split order, written
// in PyTorch's weight layout: out[(n * K + k) * taps + j] (dWs (F, C, 1, 3,
// 3) with j = kh * 3 + kw, dWt (F, F', 3, 1, 1) with j = kt).  Threads walk
// the partials' order, so the split reads are coalesced.
__global__ void __launch_bounds__(kThreads)
split_sum_kernel(const float* __restrict__ partial, int splits, int taps, int K, int N,
                 float* __restrict__ out) {
  const long long size = (long long)taps * K * N;
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= size) return;
  const int n = (int)(e % N);
  const long long jk = e / N;
  const int k = (int)(jk % K), j = (int)(jk / K);
  float tot = 0.f;
  for (int s = 0; s < splits; ++s) tot += partial[s * size + e];
  out[((long long)n * K + k) * taps + j] = tot;
}

// The products' weight layouts and the BN constants, from PyTorch's:
//   w1[j][c][f] = w4[j][f][c] = ws[f][c][0][kh][kw]   (j = kh * 3 + kw)
//   w2[k][f'][f] = w3[k][f][f'] = wt[f][f'][k][0][0]
//   bn1, bn2 [4][F] = mu, 1 / sqrt(var + eps), gamma, beta
// Weights are rounded to the compute dtype; every input is fp32.  Index
// math in 32 bits: the plan keeps 18 C F + 6 F^2 + 8 F below 2^31.
template <typename T>
__global__ void __launch_bounds__(kThreads)
sep_prep_kernel(const float* __restrict__ ws, const float* __restrict__ wt,
                const float* __restrict__ g1, const float* __restrict__ b1,
                const float* __restrict__ g2, const float* __restrict__ b2,
                const float* __restrict__ mu1, const float* __restrict__ var1,
                const float* __restrict__ mu2, const float* __restrict__ var2, float eps,
                int C, int F, T* __restrict__ w1, T* __restrict__ w2, T* __restrict__ w3,
                T* __restrict__ w4, float* __restrict__ bn1, float* __restrict__ bn2) {
  const int cf = C * F, ff = F * F;
  const int total = 18 * cf + 6 * ff + 8 * F;
  for (int e = blockIdx.x * kThreads + threadIdx.x; e < total; e += gridDim.x * kThreads) {
    int i = e;
    if (i < 9 * cf) {
      const int j = i / cf, r = i - j * cf, c = r / F, f = r - c * F;
      w1[i] = from_f<T>(ws[(f * C + c) * 9 + j]);
      continue;
    }
    i -= 9 * cf;
    if (i < 9 * cf) {
      const int j = i / cf, r = i - j * cf, f = r / C, c = r - f * C;
      w4[i] = from_f<T>(ws[(f * C + c) * 9 + j]);
      continue;
    }
    i -= 9 * cf;
    if (i < 3 * ff) {
      const int k = i / ff, r = i - k * ff, fi = r / F, fo = r - fi * F;
      w2[i] = from_f<T>(wt[(fo * F + fi) * 3 + k]);
      continue;
    }
    i -= 3 * ff;
    if (i < 3 * ff) {
      const int k = i / ff, r = i - k * ff, fo = r / F, fi = r - fo * F;
      w3[i] = from_f<T>(wt[(fo * F + fi) * 3 + k]);
      continue;
    }
    i -= 3 * ff;
    const int q = i / F, n = i - q * F;
    const float* mu = q < 4 ? mu1 : mu2;
    const float* var = q < 4 ? var1 : var2;
    const float* gamma = q < 4 ? g1 : g2;
    const float* beta = q < 4 ? b1 : b2;
    float* dst = q < 4 ? bn1 : bn2;
    const int which = q % 4;
    dst[which * F + n] = which == 0 ? mu[n]
                       : which == 1 ? __frsqrt_rn(__fadd_rn(var[n], eps))
                       : which == 2 ? gamma[n] : beta[n];
  }
}

#include "sepconv_bwd_tc.cuh"

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
#define VGS_TRY(expr)                                \
  do {                                               \
    const int e_ = (expr);                           \
    if (e_ != 0) return e_;                          \
  } while (0)

// The launch plan of one call, as ops/sepconv_bwd.py:Plan.c_fields() lays
// it out (int64, in this order).  Offsets are in elements of the fp32
// buffer (o_bn1 .. o_sums) and of the compute-dtype buffer (o_w1 ..).
struct SepPlan {
  long long B, T, H, W, C, F;
  long long tc, is_bf16;
  long long bn_f, bn_c;                   // tc: conv tile widths for N = F, N = C
  long long wbm_t, wbn_t, splits_t, rps_t;  // dWt: tile (tc), row splits
  long long wbm_s, wbn_s, splits_s, rps_s;  // dWs
  long long ew_rows;                      // tc: rows per step of the elementwise pass
  long long mtiles;                       // row tiles of the conv products
  long long o_dws, o_dwt, o_sums, o_bn1, o_bn2, o_m1, o_m2, o_part, o_wpart;
  long long o_w1, o_w2, o_w3, o_w4, o_y1, o_a, o_y2, o_dz1;
};

// cudaFuncAttributeMaxDynamicSharedMemorySize, set again only when a launch
// needs more than the kernel's last setting
int set_smem(const void* fn, int bytes) {
  static const void* fns[64];
  static int set[64];
  static int n = 0;
  int i = 0;
  while (i < n && fns[i] != fn) ++i;
  if (i < n && set[i] >= bytes) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  if (i == n && n < 64) fns[n++] = fn;
  if (i < n) set[i] = bytes;
  return 0;
}

using ConvKernel = void (*)(tc::ConvArgs);
template <int BN>
ConvKernel conv_kernel_for(int mode) {
  switch (mode) {
    case kY1: return tc::sep_tc_p1_y1_kernel<BN>;
    case kY2: return tc::sep_tc_p2_y2_kernel<BN>;
    case kDA: return tc::sep_tc_p3_da_kernel<BN>;
    default: return tc::sep_tc_p5_dx_kernel<BN>;
  }
}

int launch_conv(int mode, int bn, int mtiles, const tc::ConvArgs& a, cudaStream_t st) {
  ConvKernel k;
  int smem;
  const bool aux = mode == kY2 || mode == kDA;
  const int nw = a.rows.nw;
#define VGS_CONV_CASE(W)                                                       \
  case W:                                                                      \
    k = conv_kernel_for<W>(mode);                                              \
    smem = aux ? tc::ConvCfg<W>::SMEM_AUX : tc::ConvCfg<W>::halo_smem(nw);     \
    break;
  switch (bn) {
    VGS_CONV_CASE(16)
    VGS_CONV_CASE(32)
    VGS_CONV_CASE(64)
    VGS_CONV_CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef VGS_CONV_CASE
  VGS_TRY(set_smem((const void*)k, smem));
  k<<<dim3(mtiles, (a.N + bn - 1) / bn), tc::kConvThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

using WgradKernel = void (*)(tc::WgradArgs);
template <int WBM, int WBN>
WgradKernel wgrad_kernel_for(bool temporal) {
  return temporal ? tc::sep_tc_p4_dwt_kernel<WBM, WBN> : tc::sep_tc_p6_dws_kernel<WBM, WBN>;
}

int launch_wgrad(bool temporal, int wbm, int wbn, int splits, int rps,
                 const __nv_bfloat16* A, int K, const __nv_bfloat16* D, int N, Rows rows,
                 float* partial, cudaStream_t st) {
  WgradKernel k;
  int smem;
  switch (wbm * 1000 + wbn) {
    case 32032: k = wgrad_kernel_for<32, 32>(temporal); smem = tc::WgradCfg<32, 32>::SMEM; break;
    case 32064: k = wgrad_kernel_for<32, 64>(temporal); smem = tc::WgradCfg<32, 64>::SMEM; break;
    case 64032: k = wgrad_kernel_for<64, 32>(temporal); smem = tc::WgradCfg<64, 32>::SMEM; break;
    case 64064: k = wgrad_kernel_for<64, 64>(temporal); smem = tc::WgradCfg<64, 64>::SMEM; break;
    default: return (int)cudaErrorInvalidValue;
  }
  VGS_TRY(set_smem((const void*)k, smem));
  tc::WgradArgs a{};
  a.A = A;
  a.D = D;
  a.K = K;
  a.N = N;
  a.rows = rows;
  a.taps = temporal ? temporal_taps(1) : spatial_taps(1);
  a.ktiles = (K + wbm - 1) / wbm;
  a.ntiles = (N + wbn - 1) / wbn;
  a.rows_per_split = rps;
  a.d_thw = make_div(rows.nt * rows.nh * rows.nw);
  a.d_hw = make_div(rows.nh * rows.nw);
  a.d_w = make_div(rows.nw);
  a.partial = partial;
  k<<<dim3(a.taps.n / tc::kTapsPerBlock * a.ktiles * a.ntiles, splits), tc::kWgradThreads,
        smem, st>>>(a);
  return (int)cudaGetLastError();
}

tc::ConvArgs conv_args(const __nv_bfloat16* A, const __nv_bfloat16* W, int K, int N,
                       Rows rows, Taps taps, const float* bn, const __nv_bfloat16* aux,
                       GView gv, __nv_bfloat16* out0, __nv_bfloat16* out1, float* partial) {
  tc::ConvArgs a{};
  a.A = A;
  a.W = W;
  a.K = K;
  a.N = N;
  a.rows = rows;
  a.taps = taps;
  a.bn = bn;
  a.aux = aux;
  a.g = gv;
  a.out0 = out0;
  a.out1 = out1;
  a.partial = partial;
  return a;
}

struct Params {   // fp32 PyTorch-layout inputs of the prep launch
  const float *ws, *wt, *g1, *b1, *g2, *b2, *mu1, *var1, *mu2, *var2;
};

// Stages first..last of one call, in order on one stream (the launches of
// stages 1-3 are the three sweeps and their prep):
//   1. prep; y1, a; y2 with its per-tile partials -> S_g2, S_gx2 (and their
//      means over this call's rows);
//   2. dy2; da -> dz1 with its partials -> S_g1, S_gx1 (and means); dWt;
//   3. dy1; dx; dWs.
// The one-call entry runs 1..3.  A caller whose ranks each hold rows of one
// batch runs each stage on its own and, between them, sums the stage's two
// BN sums over the ranks: then stages 2 and 3 start by rewriting the means
// from those sums (`reduced`, [2][F]) and the global row count (`gcount`,
// one fp32 on the device).  With reduced == nullptr a stage launches the
// same kernels as the one call.  dWs, dWt and the BN sums [4][F] (S_g1,
// S_gx1, S_g2, S_gx2) go to `out` at the plan's offsets, the rest of the
// scratch to f32.
template <typename T>
int run(int first, int last, const T* x, const T* g, GView gv, const Params& in, float eps,
        float* f32, float* out, T* act, T* dx, const SepPlan& p, const float* reduced,
        const float* gcount, cudaStream_t st) {
  const int C = (int)p.C, F = (int)p.F;
  T *w1 = act + p.o_w1, *w2 = act + p.o_w2, *w3 = act + p.o_w3, *w4 = act + p.o_w4;
  T* y1 = act + p.o_y1;
  T* a = act + p.o_a;
  T* y2 = act + p.o_y2;     // y2, then dy2 in place
  T* dz1 = act + p.o_dz1;   // dz1, then dy1 in place
  float *bn1 = f32 + p.o_bn1, *bn2 = f32 + p.o_bn2, *m1 = f32 + p.o_m1, *m2 = f32 + p.o_m2;
  float *part = f32 + p.o_part, *wpart = f32 + p.o_wpart;
  float *dws = out + p.o_dws, *dwt = out + p.o_dwt;
  float *s1 = out + p.o_sums, *s2 = s1 + 2 * F;   // [2][F] each: S_g, S_gx
  const Rows rows{(int)p.T, (int)p.H, (int)p.W, (int)(p.B * p.T * p.H * p.W)};
  const long long elems = (long long)rows.m * F;
  const float count = (float)rows.m;
  const int mtiles = (int)p.mtiles;
  const GView dense = make_view(rows.nt, rows.nh, rows.nw,   // a [rows][F] scratch
                                (long long)rows.nt * rows.nh * rows.nw * F,
                                (long long)rows.nh * rows.nw * F, (long long)rows.nw * F, F, 1, 1);
  const bool s1_on = first <= 1 && 1 <= last, s2_on = first <= 2 && 2 <= last,
             s3_on = first <= 3 && 3 <= last;
  // stages 2 and 3: the means of the sums over every rank
  auto global_means = [&](float* means) -> int {
    if (reduced == nullptr) return 0;
    bn_means_kernel<<<blocks_for(2LL * F), kThreads, 0, st>>>(reduced, gcount, 2 * F, means);
    return (int)cudaGetLastError();
  };

  if (s1_on) {
    const long long prep_elems = 18LL * C * F + 6LL * F * F + 8LL * F;
    sep_prep_kernel<T><<<(unsigned)std::min<long long>(blocks_for(prep_elems), 1024), kThreads,
                         0, st>>>(in.ws, in.wt, in.g1, in.b1, in.g2, in.b2, in.mu1, in.var1,
                                  in.mu2, in.var2, eps, C, F, w1, w2, w3, w4, bn1, bn2);
    VGS_CHECK();
  }

  if (p.tc) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      const int bnf = (int)p.bn_f, bnc = (int)p.bn_c;
      const unsigned ew_blocks =
          (unsigned)(((long long)(F / 8) * p.ew_rows + 255) / 256);
      if (s1_on) {   // sweep 1
        VGS_TRY(launch_conv(kY1, bnf, mtiles, conv_args(x, w1, C, F, rows, spatial_taps(1),
                                                        bn1, nullptr, dense, y1, a, nullptr),
                            st));
        VGS_TRY(launch_conv(kY2, bnf, mtiles, conv_args(a, w2, F, F, rows, temporal_taps(1),
                                                        bn2, g, gv, y2, nullptr, part), st));
        bn_sums_kernel<<<2 * F, kThreads, 0, st>>>(part, mtiles, F, count, s2, m2);
        VGS_CHECK();
      }
      if (s2_on) {   // sweep 2
        VGS_TRY(global_means(m2));
        tc::bn_bwd_vec_kernel<true><<<ew_blocks, 256, 0, st>>>(
            y2, g, gv, bn2, m2, F, rows.m, (int)p.ew_rows, y2);
        VGS_CHECK();
        VGS_TRY(launch_conv(kDA, bnf, mtiles, conv_args(y2, w3, F, F, rows, temporal_taps(-1),
                                                        bn1, y1, dense, dz1, nullptr, part),
                            st));
        bn_sums_kernel<<<2 * F, kThreads, 0, st>>>(part, mtiles, F, count, s1, m1);
        VGS_CHECK();
        VGS_TRY(launch_wgrad(true, (int)p.wbm_t, (int)p.wbn_t, (int)p.splits_t, (int)p.rps_t,
                             a, F, y2, F, rows, wpart, st));
        split_sum_kernel<<<blocks_for(3LL * F * F), kThreads, 0, st>>>(
            wpart, (int)p.splits_t, 3, F, F, dwt);
        VGS_CHECK();
      }
      if (s3_on) {   // sweep 3
        VGS_TRY(global_means(m1));
        tc::bn_bwd_vec_kernel<false><<<ew_blocks, 256, 0, st>>>(
            y1, dz1, dense, bn1, m1, F, rows.m, (int)p.ew_rows, dz1);
        VGS_CHECK();
        VGS_TRY(launch_conv(kDX, bnc, mtiles, conv_args(dz1, w4, F, C, rows, spatial_taps(-1),
                                                        nullptr, nullptr, dense, dx, nullptr,
                                                        nullptr), st));
        VGS_TRY(launch_wgrad(false, (int)p.wbm_s, (int)p.wbn_s, (int)p.splits_s,
                             (int)p.rps_s, x, C, dz1, F, rows, wpart, st));
        split_sum_kernel<<<blocks_for(9LL * C * F), kThreads, 0, st>>>(
            wpart, (int)p.splits_s, 9, C, F, dws);
        VGS_CHECK();
      }
      return 0;
    } else {
      return (int)cudaErrorInvalidValue;   // the tc route is bf16 only
    }
  }

  const dim3 grid_f(mtiles, (F + BN - 1) / BN);
  const dim3 grid_c(mtiles, (C + BN - 1) / BN);
  if (s1_on) {   // sweep 1
    conv_taps_kernel<T, kY1><<<grid_f, kThreads, 0, st>>>(
        x, w1, C, F, rows, spatial_taps(1), bn1, nullptr, dense, y1, a, nullptr);
    VGS_CHECK();
    conv_taps_kernel<T, kY2><<<grid_f, kThreads, 0, st>>>(
        a, w2, F, F, rows, temporal_taps(1), bn2, g, gv, y2, nullptr, part);
    VGS_CHECK();
    bn_sums_kernel<<<2 * F, kThreads, 0, st>>>(part, mtiles, F, count, s2, m2);
    VGS_CHECK();
  }
  if (s2_on) {   // sweep 2
    VGS_TRY(global_means(m2));
    bn_bwd_kernel<T, true><<<blocks_for(elems), kThreads, 0, st>>>(
        y2, g, gv, bn2, m2, F, elems, y2);
    VGS_CHECK();
    conv_taps_kernel<T, kDA><<<grid_f, kThreads, 0, st>>>(
        y2, w3, F, F, rows, temporal_taps(-1), bn1, y1, dense, dz1, nullptr, part);
    VGS_CHECK();
    bn_sums_kernel<<<2 * F, kThreads, 0, st>>>(part, mtiles, F, count, s1, m1);
    VGS_CHECK();
    const dim3 grid((F + BM - 1) / BM, (F + BN - 1) / BN, 3 * (int)p.splits_t);
    wgrad_taps_kernel<T><<<grid, kThreads, 0, st>>>(
        a, F, y2, F, rows, temporal_taps(1), (int)p.splits_t, (int)p.rps_t, wpart);
    VGS_CHECK();
    split_sum_kernel<<<blocks_for(3LL * F * F), kThreads, 0, st>>>(
        wpart, (int)p.splits_t, 3, F, F, dwt);
    VGS_CHECK();
  }
  if (s3_on) {   // sweep 3
    VGS_TRY(global_means(m1));
    bn_bwd_kernel<T, false><<<blocks_for(elems), kThreads, 0, st>>>(
        y1, dz1, dense, bn1, m1, F, elems, dz1);
    VGS_CHECK();
    conv_taps_kernel<T, kDX><<<grid_c, kThreads, 0, st>>>(
        dz1, w4, F, C, rows, spatial_taps(-1), nullptr, nullptr, dense, dx, nullptr, nullptr);
    VGS_CHECK();
    const dim3 grid((C + BM - 1) / BM, (F + BN - 1) / BN, 9 * (int)p.splits_s);
    wgrad_taps_kernel<T><<<grid, kThreads, 0, st>>>(
        x, C, dz1, F, rows, spatial_taps(1), (int)p.splits_s, (int)p.rps_s, wpart);
    VGS_CHECK();
    split_sum_kernel<<<blocks_for(9LL * C * F), kThreads, 0, st>>>(
        wpart, (int)p.splits_s, 9, C, F, dws);
    VGS_CHECK();
  }
  return 0;
}

int dispatch(int first, int last, const void* x, const void* g, const void* ws,
             const void* wt, const void* g1, const void* b1, const void* g2, const void* b2,
             const void* mu1, const void* var1, const void* mu2, const void* var2, void* f32,
             void* out, void* act, void* dx, const long long* plan, long long g_sb,
             long long g_cs, long long g_st, long long g_sh, long long g_sw, int g_vec,
             float eps, const void* reduced, const void* gcount, void* stream) {
  SepPlan p;
  memcpy(&p, plan, sizeof p);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* q) { return static_cast<const float*>(q); };
  const Params in{f(ws), f(wt), f(g1), f(b1), f(g2), f(b2), f(mu1), f(var1), f(mu2), f(var2)};
  float* buf = static_cast<float*>(f32);
  float* o = static_cast<float*>(out);
  const GView gv =
      make_view((int)p.T, (int)p.H, (int)p.W, g_sb, g_st, g_sh, g_sw, g_cs, g_vec);
  if (p.is_bf16) {
    using bf = __nv_bfloat16;
    return run<bf>(first, last, static_cast<const bf*>(x), static_cast<const bf*>(g), gv, in,
                   eps, buf, o, static_cast<bf*>(act), static_cast<bf*>(dx), p, f(reduced),
                   f(gcount), st);
  }
  return run<float>(first, last, static_cast<const float*>(x), static_cast<const float*>(g),
                    gv, in, eps, buf, o, static_cast<float*>(act), static_cast<float*>(dx), p,
                    f(reduced), f(gcount), st);
}

}  // namespace

// Fields of the plan array vgs_sepconv_bwd reads (the wrapper checks it).
extern "C" int vgs_sepconv_plan_fields() { return (int)(sizeof(SepPlan) / sizeof(long long)); }

// x (B, T, H, W, C) channels-last in the compute dtype, and g (B, F, T, H,
// W) in it at strides g_sb, g_cs, g_st, g_sh, g_sw (GView; g_vec: 16-byte
// loads allowed); ws (F, C, 1,
// 3, 3), wt (F, F, 3, 1, 1), the BN parameters and the forward's batch
// statistics (F,), all fp32.  f32 is the fp32 buffer (BN constants and
// means, partials; the outputs dWs (F, C, 1, 3, 3), dWt (F, F, 3, 1, 1)
// and the BN sums [4][F] = S_g1, S_gx1, S_g2, S_gx2), act the compute-dtype
// buffer (w1..w4, y1, a, y2, dz1), at the plan's offsets; dx (B, T, H, W,
// C) in the compute dtype.  All three stages, no reduce between them.
extern "C" int vgs_sepconv_bwd(const void* x, const void* g, const void* ws, const void* wt,
                               const void* g1, const void* b1, const void* g2,
                               const void* b2, const void* mu1, const void* var1,
                               const void* mu2, const void* var2, void* f32, void* act,
                               void* dx, const long long* plan, long long g_sb,
                               long long g_cs, long long g_st, long long g_sh,
                               long long g_sw, int g_vec, float eps, void* stream) {
  return dispatch(1, 3, x, g, ws, wt, g1, b1, g2, b2, mu1, var1, mu2, var2, f32, f32, act, dx,
                  plan, g_sb, g_cs, g_st, g_sh, g_sw, g_vec, eps, nullptr, nullptr, stream);
}

// One stage of the call above, with the arguments of vgs_sepconv_bwd and
// two buffers more: out (fp32) takes dWs, dWt and the BN sums at their plan
// offsets (f32 keeps the rest of the scratch); reduced ([2][F] fp32, or
// null) holds the previous stage's two sums over every rank (stage 2: S_g2,
// S_gx2; stage 3: S_g1, S_gx1) and gcount (one fp32) the global row count.
// Every stage reads the buffers the earlier ones wrote, so a call runs
// stages 1, 2, 3 in order on one stream, with the same plan and buffers.
#define VGS_STAGE_ENTRY(NAME, S)                                                           \
  extern "C" int NAME(const void* x, const void* g, const void* ws, const void* wt,        \
                      const void* g1, const void* b1, const void* g2, const void* b2,      \
                      const void* mu1, const void* var1, const void* mu2,                  \
                      const void* var2, void* f32, void* out, void* act, void* dx,         \
                      const long long* plan, long long g_sb, long long g_cs,               \
                      long long g_st, long long g_sh, long long g_sw, int g_vec,           \
                      float eps, const void* reduced, const void* gcount, void* stream) { \
    return dispatch(S, S, x, g, ws, wt, g1, b1, g2, b2, mu1, var1, mu2, var2, f32, out,   \
                    act, dx, plan, g_sb, g_cs, g_st, g_sh, g_sw, g_vec, eps, reduced,      \
                    gcount, stream);                                                       \
  }
VGS_STAGE_ENTRY(vgs_sepconv_bwd_stage1, 1)
VGS_STAGE_ENTRY(vgs_sepconv_bwd_stage2, 2)
VGS_STAGE_ENTRY(vgs_sepconv_bwd_stage3, 3)
#undef VGS_STAGE_ENTRY
