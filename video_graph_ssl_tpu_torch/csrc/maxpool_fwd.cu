// Max-pool forward for Hopper (sm_90a), every pool geometry of the
// backbones (window <= 3 per axis; any stride; low pads below the window):
//
//     y[o] = the maximum of x over o's window, clipped at the input's ends,
//
// with x (B, T, H, W, C) and y (B, To, Ho, Wo, C) channels-last in one dtype
// (bf16 or fp32).  y alone: no indices (the backward, csrc/maxpool_bwd.cu,
// finds each output's first maximal tap again from x), no scratch, and no
// padded copy of x.
//
// Mirrors video_graph_ssl_tpu/ops/pallas/maxpool_kernel.py:59 _fwd_kernel
// (read x once, the window maxima in fast memory, write y once), which the
// JAX package keeps beside K3 but never launches: its pools' forward is
// XLA's reduce_window.  Here it takes the place of PyTorch's
// max_pool3d_with_indices, which writes an int64 index per output (more
// bytes than x and y together at the S3D pools).
//
// Semantics are PyTorch's, bit for bit: a running maximum over the taps in
// t, h, w scan order that a tap replaces where it is greater or NaN (torch's
// `val > max || isnan(val)`), so ties keep the first tap (the sign of a tied
// zero is the first one's) and a window holding a NaN gives its last NaN.
//
// A block owns one strip of one slab's y and one group of channels: a slab
// is a whole clip (T, H, W), or one frame (H, W) when the window and stride
// are 1 in t (the wrapper passes the clips as B*T clips of one frame); a
// strip is a range of output frames by a range of output rows, all Wo
// (ops/maxpool.py:fwd_plan).
//
//   stage x: the x rows the strip's windows read, with their halo (read by
//     the neighbour strip too), of the block's channel group (32 to 256
//     bytes a position) go to dynamic shared memory with 16-byte cp.async.
//   max: a thread walks one output column (ho, wo) along t: each frame's
//     3x3 spatial maximum is taken once and reused by the next outputs
//     whose windows hold that frame (three at stride 1 in t), so a 3x3x3
//     output costs 9 loads and 10 merges from shared memory, not 27 and 26.
//     y is stored with 16-byte stores along C.
//
// What bounds it on the H100: bytes.  It must read x and write y, and it
// moves exactly those through device memory (halo rows twice, mostly from
// L2).  The S3D pools of the bs-256 MoCo step read and write 3.6 GB a
// pass in bf16, 1.07 ms at 3.35 TB/s.  The plan keeps blocks within 56 KB of
// shared memory where a strip fits (four per SM), so one block's loads
// overlap another's maxima.
// bf16 merges take two lanes at a time: a bf16x2 compare, a NaN mask from
// the bits, and a bitwise select.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWindow = 3;
constexpr int kMaxSmem = 232448;   // 227 KB: the most one block may take
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// n / d for 0 <= n < 2^31 and d >= 1 by a multiply and a shift.
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

struct FwdGeom {
  int xt, xh, xw, nc;    // one slab of x, and the channels
  int yt, yh, yw;        // the slab's outputs
  int kt, kh, kw;
  int st, sh, sw;
  int pt, ph, pw;
  int ts, hs;            // output frames and rows a block writes (a strip)
  int t_strips, h_strips;
  int nxt, nxh;          // shared layout: x [nxt][nxh][xw]
  FastDiv yw_d, xplane_d;
};

// The inputs [x0, x1) that the windows of outputs [o0, o1) of one axis read
// (ops/maxpool.py:axis_reads).
__device__ __forceinline__ int2 axis_reads(int o0, int o1, int k, int s, int p, int n_in) {
  return make_int2(max(0, o0 * s - p), min(n_in, (o1 - 1) * s - p + k));
}

// One channel vector from device to shared memory; 16-byte vectors go
// through cp.async (completed by stage_wait).
template <typename T, int VEC>
__device__ __forceinline__ void stage(T* dst, const T* src) {
  if constexpr (sizeof(T) * VEC == 16) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  } else {
    *reinterpret_cast<Pack<T, VEC>*>(dst) = *reinterpret_cast<const Pack<T, VEC>*>(src);
  }
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// m = v where v > m or v is NaN, per channel (torch's rule).
template <typename T, int VEC>
__device__ __forceinline__ void merge(Pack<T, VEC>& m, const Pack<T, VEC>& v) {
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const float a = to_f(v.v[e]);
    if (a > to_f(m.v[e]) || a != a) m.v[e] = v.v[e];
  }
}

// 0xffff in each bf16 lane of w that is NaN (exponent all ones, mantissa
// not 0): (w & 0x7fff) + 0x7f reaches bit 15 exactly then, and cannot carry
// into the next lane.
__device__ __forceinline__ unsigned nan_mask2(unsigned w) {
  return (((w & 0x7fff7fffu) + 0x007f007fu) >> 15 & 0x00010001u) * 0xffffu;
}

template <>
__device__ __forceinline__ void merge<__nv_bfloat16, 8>(Pack<__nv_bfloat16, 8>& m,
                                                         const Pack<__nv_bfloat16, 8>& v) {
  unsigned* mw = reinterpret_cast<unsigned*>(m.v);
  const unsigned* vw = reinterpret_cast<const unsigned*>(v.v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned a = vw[k], b = mw[k];
    const unsigned sel =
        __hgt2_mask(*reinterpret_cast<const __nv_bfloat162*>(&a),
                    *reinterpret_cast<const __nv_bfloat162*>(&b)) |
        nan_mask2(a);
    mw[k] = (b & ~sel) | (a & sel);
  }
}

// The spatial maximum of one frame's window: base points at x (t, h0, w0)
// of the thread's channels; rows [b_lo, b_hi) and columns [c_lo, c_hi)
// lie inside; taps in h, w scan order.
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> frame_max(const T* base, int row, int group, int b_lo,
                                                  int b_hi, int c_lo, int c_hi) {
  Pack<T, VEC> m = *reinterpret_cast<const Pack<T, VEC>*>(base + (b_lo * row + c_lo) * group);
#pragma unroll
  for (int bb = 0; bb < kMaxWindow; ++bb) {
    if (bb < b_lo || bb >= b_hi) continue;
#pragma unroll
    for (int cc = 0; cc < kMaxWindow; ++cc) {
      if (cc < c_lo || cc >= c_hi || (bb == b_lo && cc == c_lo)) continue;
      merge(m, *reinterpret_cast<const Pack<T, VEC>*>(base + (bb * row + cc) * group));
    }
  }
  return m;
}

// Block i writes channels [c0, c0 + group) with c0 = (i % groups) * group,
// masked at C, of (fastest first) its H strip, T strip and slab.  Thread t
// works on channel vector t % nv (nv = group / VEC = 1 << nv_shift) of
// positions t / nv, t / nv + blockDim / nv, ...  Shared memory: x as
// [position][group] of T in the plan's layout [nxt][nxh][W]; a block's
// frames and rows start at its first staged ones.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
maxpool_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, FwdGeom g, int group,
                   int groups, int nv_shift) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sv = reinterpret_cast<T*>(smem);
  int rest = blockIdx.x / groups;
  const int c0 = (int)(blockIdx.x - rest * groups) * group;
  const int hi = rest % g.h_strips;
  rest /= g.h_strips;
  const int ti = rest % g.t_strips;
  const long long slab = rest / g.t_strips;
  const int ot0 = ti * g.ts, ot1 = min(g.yt, ot0 + g.ts);
  const int oh0 = hi * g.hs, oh1 = min(g.yh, oh0 + g.hs);
  const int2 rt = axis_reads(ot0, ot1, g.kt, g.st, g.pt, g.xt);
  const int2 rh = axis_reads(oh0, oh1, g.kh, g.sh, g.ph, g.xh);
  // the plan's layout holds every strip (a wrong plan stops here)
  if (rt.y - rt.x > g.nxt || rh.y - rh.x > g.nxh) __trap();
  const int v = threadIdx.x & ((1 << nv_shift) - 1);
  const int first = threadIdx.x >> nv_shift, step = blockDim.x >> nv_shift;
  const int cv = v * VEC;
  // a masked vector of the last group (C % VEC == 0) idles but keeps to the
  // barrier
  const bool live = c0 + cv < g.nc;
  const int x_plane = g.nxh * g.xw, x_row = (rh.y - rh.x) * g.xw;
  const int n_x = live ? (rt.y - rt.x) * x_plane : 0;
  const T* xs = x + (slab * g.xt * g.xh + (long long)rt.x * g.xh + rh.x) * g.xw * g.nc + c0 + cv;
  T* ys = y + slab * g.yt * g.yh * g.yw * g.nc + c0 + cv;

  // x of the staged frames and rows; position j = (lt * nxh + lh) * W + w
  for (int j = first; j < n_x; j += step) {
    const int lt = g.xplane_d.div(j), r = j - lt * x_plane;
    if (r < x_row)
      stage<T, VEC>(sv + j * group + cv, xs + ((long long)lt * g.xh * g.xw + r) * g.nc);
  }
  stage_wait();
  __syncthreads();

  // every output of the strip, by output column (ho, wo) walked along t
  const int ncol = live ? (oh1 - oh0) * g.yw : 0;
  for (int col = first; col < ncol; col += step) {
    const int lho = g.yw_d.div(col), wo = col - lho * g.yw;
    const int ho = oh0 + lho;
    const int h0 = ho * g.sh - g.ph, w0 = wo * g.sw - g.pw;
    const int b_lo = max(0, -h0), b_hi = min(g.kh, g.xh - h0);
    const int c_lo = max(0, -w0), c_hi = min(g.kw, g.xw - w0);
    const T* col_base = sv + ((h0 - rh.x) * g.xw + w0) * group + cv;
    Pack<T, VEC> fm[kMaxWindow];   // fm[a]: frame have + a
    int have = -(1 << 30);
    for (int to = ot0; to < ot1; ++to) {
      const int t0 = to * g.st - g.pt;
      const int a_lo = max(0, -t0), a_hi = min(g.kt, g.xt - t0);
      // frame t0 + a is the previous output's frame a + d (d = 1 or 2 at
      // stride 1 or 2): reuse it.  Ascending a reads fm[a + d] before it
      // is overwritten; the index guards keep dead unrolled copies in range.
      const int d = t0 - have;
#pragma unroll
      for (int a = 0; a < kMaxWindow; ++a) {
        if (a < a_lo || a >= a_hi) continue;
        if (a + 1 < kMaxWindow && d == 1 && a + 1 < g.kt)
          fm[a] = fm[a + 1 < kMaxWindow ? a + 1 : a];
        else if (a + 2 < kMaxWindow && d == 2 && a + 2 < g.kt)
          fm[a] = fm[a + 2 < kMaxWindow ? a + 2 : a];
        else
          fm[a] = frame_max<T, VEC>(col_base + (t0 + a - rt.x) * x_plane * group, g.xw, group,
                                    b_lo, b_hi, c_lo, c_hi);
      }
      have = t0;
      Pack<T, VEC> m;
      bool first_frame = true;
#pragma unroll
      for (int a = 0; a < kMaxWindow; ++a) {
        if (a < a_lo || a >= a_hi) continue;
        if (first_frame) m = fm[a];
        else merge(m, fm[a]);
        first_frame = false;
      }
      *reinterpret_cast<Pack<T, VEC>*>(ys + ((long long)(to * g.yh + ho) * g.yw + wo) * g.nc) =
          m;
    }
  }
}

template <typename T, int VEC>
int launch(const void* x, void* y, int slabs, FwdGeom g, int group, int threads,
           cudaStream_t stream) {
  const long long smem = (long long)g.nxt * g.nxh * g.xw * group * sizeof(T);
  const long long groups = (g.nc + group - 1) / group;
  if (g.ts <= 0 || g.hs <= 0) return (int)cudaErrorInvalidValue;
  g.t_strips = (g.yt + g.ts - 1) / g.ts;
  g.h_strips = (g.yh + g.hs - 1) / g.hs;
  const long long blocks = (long long)slabs * g.t_strips * g.h_strips * groups;
  const int nv = group / VEC;
  int nv_shift = 0;
  while ((1 << nv_shift) < nv) ++nv_shift;
  if (group <= 0 || group % VEC || nv != (1 << nv_shift) || threads <= 0 ||
      threads > kThreads || threads % nv || smem > kMaxSmem || blocks > 0x7fffffffLL ||
      g.kt > kMaxWindow || g.kh > kMaxWindow || g.kw > kMaxWindow || g.nxt > g.xt ||
      g.nxh > g.xh || g.nxt <= 0 || g.nxh <= 0 || g.pt >= g.kt || g.ph >= g.kh ||
      g.pw >= g.kw || g.pt < 0 || g.ph < 0 || g.pw < 0)
    return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  auto kern = maxpool_fwd_kernel<T, VEC>;
  if (smem > kDefaultSmem) {
    // the limit goes to the most a block may take, once per device and
    // instantiation, so later launches pay nothing for it
    static bool raised[kMaxDevices];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= kMaxDevices || !raised[dev]) {
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (e != cudaSuccess) return (int)e;
      if (dev < kMaxDevices) raised[dev] = true;
    }
  }
  g.yw_d = make_div(g.yw);
  g.xplane_d = make_div(g.nxh * g.xw);
  kern<<<(unsigned)blocks, threads, (size_t)smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), g, group, (int)groups, nv_shift);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// x (slabs, T, H, W, C), y (slabs, To, Ho, Wo, C), contiguous in that order
// (channels-last), of one dtype.  A slab is a clip, or a frame (T = To = 1)
// for windows of 1 in t.  a holds the 24 integers of the call, in this
// order: slabs, T, H, W, C, To, Ho, Wo, kt, kh, kw, st, sh, sw, pt, ph, pw,
// group (channels per block), threads, ts, hs (the strip: output frames and
// rows per block), nxt, nxh (the shared layout: rows of x), is_bf16; they
// come from the wrapper's plan (ops/maxpool.py:fwd_plan), which keeps the
// array per geometry.
extern "C" int vgs_maxpool3d_fwd(const void* x, void* y, const int* a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int slabs = a[0];
  FwdGeom g{};
  g.xt = a[1], g.xh = a[2], g.xw = a[3], g.nc = a[4], g.yt = a[5], g.yh = a[6], g.yw = a[7];
  g.kt = a[8], g.kh = a[9], g.kw = a[10], g.st = a[11], g.sh = a[12], g.sw = a[13];
  g.pt = a[14], g.ph = a[15], g.pw = a[16];
  const int group = a[17], threads = a[18];
  g.ts = a[19], g.hs = a[20], g.nxt = a[21], g.nxh = a[22];
  const bool vec_ok = aligned16(x) && aligned16(y);
  if (a[23]) {
    if (vec_ok && g.nc % 8 == 0)
      return launch<__nv_bfloat16, 8>(x, y, slabs, g, group, threads, s);
    return launch<__nv_bfloat16, 1>(x, y, slabs, g, group, threads, s);
  }
  if (vec_ok && g.nc % 4 == 0) return launch<float, 4>(x, y, slabs, g, group, threads, s);
  return launch<float, 1>(x, y, slabs, g, group, threads, s);
}
