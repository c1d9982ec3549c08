// Max-pool backward for Hopper (sm_90a), every pool geometry of the
// backbones (window <= 3 per axis here; any stride and padding):
//
//     dx[j] = sum over outputs o whose window covers j and whose FIRST
//             maximal tap (t, h, w scan order) is j, of dy[o],
//
// with x (B, T, H, W, C), y = max_pool3d(x) and dy (B, To, Ho, Wo, C) in one
// dtype (bf16 or fp32), fp32 accumulation, dx in x's dtype.
//
// Replaces the TPU kernels video_graph_ssl_tpu/ops/pallas/maxpool_kernel.py:
// K3 (_mp_bwd -> _bwd_kernel, the 3x3x3 stride-1 pool of every Inception
// pool branch) and K4 (_strided_bwd -> _bwd_kernel_spatial/_bwd_kernel_full,
// the four strided pools).  One design serves both:
//
//   pass 1 (argmax_tap_kernel), per output o and channel: the index of the
//     first tap whose x equals y[o], into a uint8 scratch of y's shape.
//     Taps in the padding never match; y is a copy of one x tap, so the
//     fp32 compare is exact.  No int64 indices are saved by the forward.
//   pass 2 (grad_gather_kernel), per input j and channel: a gather over the
//     taps a with (j + p - a) divisible by s and o = (j + p - a) / s in
//     range, adding dy[o] where tap[o] == a.  No atomics: deterministic.
//     Taps run in reverse scan order, i.e. the covering outputs in
//     increasing order, the order in which PyTorch's CPU backward adds.
//
// Ties go to the first tap in t, h, w scan order: PyTorch's rule and the rule
// of the TPU K4; the TPU K3 split ties among all maxima instead.
//
// What bounds it on the H100: bytes.  The function must read x, y and dy
// and write dx, with a handful of integer operations per byte.  At pool_1
// of the bs-128 S3D step in bf16 (x (128, 8, 56, 56, 64)) that is 1.03 GB,
// 0.31 ms at 3.35 TB/s.  This design also writes and reads one byte of tap
// scratch per output element (0.10 GB more there), which a one-pass
// gather would not need.  Threads
// run along C with 16-byte vectors (8 bf16 or 4 fp32) on the channels-last
// layout, so every load and store is a full, coalesced vector.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned char kNoTap = 255;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

struct PoolGeom {
  int xt, xh, xw, nc;    // x (batch is the leading dim of the flat index)
  int yt, yh, yw;        // y
  int kt, kh, kw;
  int st, sh, sw;
  int pt, ph, pw;
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
argmax_tap_kernel(const T* __restrict__ x, const T* __restrict__ y,
                  unsigned char* __restrict__ tap, PoolGeom g, long long n_vec) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_vec) return;
  const int cv = g.nc / VEC;
  const int c = (int)(i % cv) * VEC;
  long long o = i / cv;
  const int wo = (int)(o % g.yw); o /= g.yw;
  const int ho = (int)(o % g.yh); o /= g.yh;
  const int to = (int)(o % g.yt);
  const long long b = o / g.yt;

  const Pack<T, VEC> yv = *reinterpret_cast<const Pack<T, VEC>*>(y + i * VEC);
  float yf[VEC];
  unsigned char res[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    yf[v] = to_f(yv.v[v]);
    res[v] = kNoTap;
  }
  int ti = 0;
  for (int a = 0; a < g.kt; ++a) {
    const int t = to * g.st - g.pt + a;
    for (int bb = 0; bb < g.kh; ++bb) {
      const int h = ho * g.sh - g.ph + bb;
      for (int cc = 0; cc < g.kw; ++cc, ++ti) {
        const int w = wo * g.sw - g.pw + cc;
        if (t < 0 || t >= g.xt || h < 0 || h >= g.xh || w < 0 || w >= g.xw) continue;
        const long long off = (((b * g.xt + t) * g.xh + h) * (long long)g.xw + w) * g.nc + c;
        const Pack<T, VEC> xv = *reinterpret_cast<const Pack<T, VEC>*>(x + off);
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          if (res[v] == kNoTap && to_f(xv.v[v]) == yf[v]) res[v] = (unsigned char)ti;
      }
    }
  }
  Pack<unsigned char, VEC> out;
#pragma unroll
  for (int v = 0; v < VEC; ++v) out.v[v] = res[v];
  *reinterpret_cast<Pack<unsigned char, VEC>*>(tap + i * VEC) = out;
}

// Output coordinate of input coordinate j under tap a, or -1 when tap a does
// not connect j to any output.
__device__ __forceinline__ int out_coord(int j, int a, int s, int p, int n_out) {
  const int num = j + p - a;
  if (num < 0 || num % s) return -1;
  const int o = num / s;
  return o < n_out ? o : -1;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
grad_gather_kernel(const T* __restrict__ dy, const unsigned char* __restrict__ tap,
                   T* __restrict__ dx, PoolGeom g, long long n_vec) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_vec) return;
  const int cv = g.nc / VEC;
  const int c = (int)(i % cv) * VEC;
  long long j = i / cv;
  const int w = (int)(j % g.xw); j /= g.xw;
  const int h = (int)(j % g.xh); j /= g.xh;
  const int t = (int)(j % g.xt);
  const long long b = j / g.xt;

  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
  for (int a = g.kt - 1; a >= 0; --a) {
    const int ot = out_coord(t, a, g.st, g.pt, g.yt);
    if (ot < 0) continue;
    for (int bb = g.kh - 1; bb >= 0; --bb) {
      const int oh = out_coord(h, bb, g.sh, g.ph, g.yh);
      if (oh < 0) continue;
      for (int cc = g.kw - 1; cc >= 0; --cc) {
        const int ow = out_coord(w, cc, g.sw, g.pw, g.yw);
        if (ow < 0) continue;
        const int ti = (a * g.kh + bb) * g.kw + cc;
        const long long off =
            (((b * g.yt + ot) * g.yh + oh) * (long long)g.yw + ow) * g.nc + c;
        const Pack<unsigned char, VEC> tv =
            *reinterpret_cast<const Pack<unsigned char, VEC>*>(tap + off);
        const Pack<T, VEC> dv = *reinterpret_cast<const Pack<T, VEC>*>(dy + off);
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          if (tv.v[v] == ti) acc[v] += to_f(dv.v[v]);
      }
    }
  }
  Pack<T, VEC> out;
#pragma unroll
  for (int v = 0; v < VEC; ++v) out.v[v] = from_f<T>(acc[v]);
  *reinterpret_cast<Pack<T, VEC>*>(dx + i * VEC) = out;
}

template <typename T, int VEC>
int launch(const void* x, const void* y, const void* dy, void* dx, void* tap,
           int B, const PoolGeom& g, cudaStream_t stream) {
  const long long n_out = (long long)B * g.yt * g.yh * g.yw * (g.nc / VEC);
  const long long n_in = (long long)B * g.xt * g.xh * g.xw * (g.nc / VEC);
  if (n_out > 0) {
    argmax_tap_kernel<T, VEC><<<(unsigned)((n_out + kThreads - 1) / kThreads),
                                kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(y),
        static_cast<unsigned char*>(tap), g, n_out);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (n_in > 0) {
    grad_gather_kernel<T, VEC><<<(unsigned)((n_in + kThreads - 1) / kThreads),
                                 kThreads, 0, stream>>>(
        static_cast<const T*>(dy), static_cast<const unsigned char*>(tap),
        static_cast<T*>(dx), g, n_in);
  }
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// x, dx (B, T, H, W, C); y, dy, tap (B, To, Ho, Wo, C); all contiguous in
// that order (channels-last), x/y/dy/dx of one dtype, tap uint8.
extern "C" int vgs_maxpool3d_bwd(const void* x, const void* y, const void* dy,
                                 void* dx, void* tap, int B, int T, int H, int W,
                                 int C, int To, int Ho, int Wo, int kt, int kh,
                                 int kw, int st, int sh, int sw, int pt, int ph,
                                 int pw, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PoolGeom g{T, H, W, C, To, Ho, Wo, kt, kh, kw, st, sh, sw, pt, ph, pw};
  const bool vec_ok = aligned16(x) && aligned16(y) && aligned16(dy) &&
                      aligned16(dx) && aligned16(tap);
  if (is_bf16) {
    if (vec_ok && C % 8 == 0)
      return launch<__nv_bfloat16, 8>(x, y, dy, dx, tap, B, g, s);
    return launch<__nv_bfloat16, 1>(x, y, dy, dx, tap, B, g, s);
  }
  if (vec_ok && C % 4 == 0) return launch<float, 4>(x, y, dy, dx, tap, B, g, s);
  return launch<float, 1>(x, y, dy, dx, tap, B, g, s);
}
