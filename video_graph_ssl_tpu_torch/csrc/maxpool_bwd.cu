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
// the four strided pools).  One kernel, one launch per backward call, serves
// both, with the TPU kernels' blocking where it fits: a block owns one slab
// and one group of channels, where a slab is a whole clip (T, H, W), or one
// frame (H, W) when the window and stride are 1 in t (the wrapper then
// passes the clips as B*T clips of one frame).  A slab too large for one
// block's shared memory (stage 1's pool or Mixed_3b's at 224x224) is cut
// into strips of dx rows: along H, and along T where one row of every
// frame does not fit.  A block owns the dx of its strip alone and stages
// what that needs: the outputs whose windows cover one of its rows (their
// y, dy and taps) and the x rows those windows read, a halo on either
// side.  It re-derives those outputs' first-max taps (a neighbour strip
// derives the shared ones again, from the same x), so no block needs
// another block's result, and the cut runs between input rows: a cut
// between output rows would leave the input row under a 3-wide stride-2
// window to two blocks.  An unstriped slab is the strip of all rows.
//
//   stage x: the slab's channel group (32 to 256 bytes a position, chosen
//     by the wrapper) goes to dynamic shared memory with cp.async.
//   phase A, per output o and channel: the first maximal tap, found in
//     shared memory.  A thread walks one output column (ho, wo) along t:
//     each frame's 3x3 spatial best is computed once and reused by the
//     next outputs whose windows hold that frame (three at stride 1 in t),
//     so a 3x3x3 output costs 12 compares, not 27.  Compares are strict
//     (>), so the first of equal maxima stays.  y is read once per output,
//     for one purpose: where y is NaN (torch's forward propagates a NaN in
//     the window) no tap is chosen, as no tap equals NaN.  The tap indices
//     go to a shared uint8 array.
//   stage dy: the slab's dy group overwrites x's space.
//   phase B, per input j and channel: a gather over the taps a with
//     (j + p - a) divisible by s and o = (j + p - a) / s in range, adding
//     dy[o] where tap[o] == a, from shared memory; dx is written once.  Taps
//     run in reverse scan order, i.e. the covering outputs in increasing
//     order, the order in which PyTorch's CPU backward adds.  No atomics:
//     deterministic, and bit for bit the wrapper's plain version.
//
// Ties go to the first tap in t, h, w scan order: PyTorch's rule and the rule
// of the TPU K4; the TPU K3 split ties among all maxima instead.
//
// What bounds it on the H100: bytes, in principle.  The function must read
// x, y and dy and write dx, and this kernel moves exactly those bytes
// through device memory (no scratch).  At pool_1 of the bs-128 S3D step in
// bf16 (x (128, 8, 56, 56, 64)) that is 1.03 GB, 0.31 ms at 3.35 TB/s.
// In practice the 3x3x3 pools are bound by the tap work (27 tap checks per
// input and channel in phase B) and every pool by the block's serial
// stage / compute / stage / compute order.  Threads run along C with
// 16-byte vectors (8 bf16 or 4 fp32) of the channels-last layout, bf16
// compares two lanes at a time.  The largest S3D slab (pool_1, one 56x56
// frame) takes 113 KB of shared memory; at 224x224 the wrapper cuts
// slabs above 227 KB into strips (ops/maxpool.py:bwd_plan).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxWindow = 3;
constexpr int kMaxSmem = 232448;   // 227 KB: the most one block may take
constexpr int kDefaultSmem = 48 * 1024;

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

// n / d for 0 <= n < 2^31 and d >= 1 by a multiply and a shift (the
// kernel's index arithmetic has no hardware divide).
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

struct PoolGeom {
  int xt, xh, xw, nc;    // one slab of x, and the channels
  int yt, yh, yw;        // the slab's outputs
  int kt, kh, kw;
  int st, sh, sw;
  int pt, ph, pw;
  int ts, hs;            // dx frames and rows a block owns (a strip)
  int t_strips, h_strips;
  int nxt, nxh, nyt, nyh;  // shared layout: x [nxt][nxh][xw], y [nyt][nyh][yw]
  FastDiv xw_d, yw_d, xplane_d, yplane_d, hs_d, st_d, sh_d, sw_d;
};

// The outputs [o0, o1) whose window covers one of the inputs [a0, a1) of one
// axis, and the inputs [x0, x1) those windows read (ops/maxpool.py:axis_cover).
struct Cover {
  int o0, o1, x0, x1;
};
__device__ __forceinline__ Cover axis_cover(int a0, int a1, int k, int s, int p, int n_in,
                                            int n_out) {
  const int n = a0 + p - k + 1;
  Cover c;
  c.o0 = n <= 0 ? 0 : (n + s - 1) / s;
  c.o1 = min(n_out, (a1 - 1 + p) / s + 1);
  if (c.o1 <= c.o0) {
    c.o1 = c.o0;
    c.x0 = c.x1 = 0;
  } else {
    c.x0 = max(0, c.o0 * s - p);
    c.x1 = min(n_in, (c.o1 - 1) * s - p + k);
  }
  return c;
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

// The running maximum of a window and its first maximal tap, per channel:
// init takes the first tap, offer a later one (strict >, so the first of
// equal maxima stays; offering the first tap again changes nothing);
// init_from and take do the same with a sub-window's best, its taps
// shifted by dt.  Values are moved, never converted, so a winner is one of
// the window's inputs.
template <typename T, int VEC>
struct Best {
  Pack<T, VEC> val;
  unsigned char tap[VEC];
  __device__ __forceinline__ void init(const Pack<T, VEC>& v, unsigned ti) {
    val = v;
#pragma unroll
    for (int e = 0; e < VEC; ++e) tap[e] = (unsigned char)ti;
  }
  __device__ __forceinline__ void offer(const Pack<T, VEC>& v, unsigned ti) {
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      if (to_f(v.v[e]) > to_f(val.v[e])) {
        val.v[e] = v.v[e];
        tap[e] = (unsigned char)ti;
      }
  }
  __device__ __forceinline__ void init_from(const Best& b, unsigned dt) {
    val = b.val;
#pragma unroll
    for (int e = 0; e < VEC; ++e) tap[e] = (unsigned char)(b.tap[e] + dt);
  }
  __device__ __forceinline__ void take(const Best& b, unsigned dt) {
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      if (to_f(b.val.v[e]) > to_f(val.v[e])) {
        val.v[e] = b.val.v[e];
        tap[e] = (unsigned char)(b.tap[e] + dt);
      }
  }
  __device__ __forceinline__ unsigned char get(int e) const { return tap[e]; }
};

// bf16x2 compares (0xffff per greater lane), bitwise selects, and four
// channels' taps per word
template <>
struct Best<__nv_bfloat16, 8> {
  unsigned val[4];
  unsigned tap[2];
  __device__ __forceinline__ void init(const Pack<__nv_bfloat16, 8>& v, unsigned ti) {
#pragma unroll
    for (int k = 0; k < 4; ++k) val[k] = reinterpret_cast<const unsigned*>(v.v)[k];
    tap[0] = tap[1] = ti * 0x01010101u;
  }
  __device__ __forceinline__ void merge(const unsigned (&v)[4], const unsigned (&t)[2]) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const unsigned m0 = __hgt2_mask(as_bf2(v[2 * k]), as_bf2(val[2 * k]));
      const unsigned m1 = __hgt2_mask(as_bf2(v[2 * k + 1]), as_bf2(val[2 * k + 1]));
      val[2 * k] = (val[2 * k] & ~m0) | (v[2 * k] & m0);
      val[2 * k + 1] = (val[2 * k + 1] & ~m1) | (v[2 * k + 1] & m1);
      const unsigned bm = __byte_perm(m0, m1, 0x6420);
      tap[k] = (tap[k] & ~bm) | (t[k] & bm);
    }
  }
  __device__ __forceinline__ void offer(const Pack<__nv_bfloat16, 8>& v, unsigned ti) {
    const unsigned t[2] = {ti * 0x01010101u, ti * 0x01010101u};
    merge(reinterpret_cast<const unsigned(&)[4]>(v.v), t);
  }
  __device__ __forceinline__ void init_from(const Best& b, unsigned dt) {
#pragma unroll
    for (int k = 0; k < 4; ++k) val[k] = b.val[k];
    tap[0] = b.tap[0] + dt * 0x01010101u;
    tap[1] = b.tap[1] + dt * 0x01010101u;
  }
  __device__ __forceinline__ void take(const Best& b, unsigned dt) {
    const unsigned t[2] = {b.tap[0] + dt * 0x01010101u, b.tap[1] + dt * 0x01010101u};
    merge(b.val, t);
  }
  __device__ __forceinline__ unsigned char get(int e) const {
    return (unsigned char)(tap[e / 4] >> 8 * (e % 4));
  }
  static __device__ __forceinline__ __nv_bfloat162 as_bf2(unsigned u) {
    return *reinterpret_cast<const __nv_bfloat162*>(&u);
  }
};

template <typename T, int VEC>
__device__ __forceinline__ bool is_nan(const Pack<T, VEC>& v, int e) {
  return to_f(v.v[e]) != to_f(v.v[e]);
}

// The spatial best of one frame: base points at x (t, h0, w0) of the
// thread's channels; rows [b_lo, b_hi) and columns [c_lo, c_hi) lie inside.
template <typename T, int VEC>
__device__ __forceinline__ Best<T, VEC> frame_best(const T* base, const PoolGeom& g, int group,
                                                   int b_lo, int b_hi, int c_lo, int c_hi) {
  Best<T, VEC> b;
  b.init(*reinterpret_cast<const Pack<T, VEC>*>(base + (b_lo * g.xw + c_lo) * group),
         b_lo * g.kw + c_lo);
#pragma unroll
  for (int bb = 0; bb < kMaxWindow; ++bb) {
    if (bb < b_lo || bb >= b_hi) continue;
#pragma unroll
    for (int cc = 0; cc < kMaxWindow; ++cc) {
      if (cc < c_lo || cc >= c_hi) continue;
      b.offer(*reinterpret_cast<const Pack<T, VEC>*>(base + (bb * g.xw + cc) * group),
              bb * g.kw + cc);
    }
  }
  return b;
}

// A vector's tap bytes xor'd with tap ti, a word per four channels.
template <int VEC>
struct TapWords {
  static constexpr int kWords = (VEC + 3) / 4;
  unsigned w[kWords];
  __device__ __forceinline__ TapWords(const unsigned char* p, unsigned ti) {
    if constexpr (VEC % 4 == 0) {
#pragma unroll
      for (int k = 0; k < kWords; ++k)
        w[k] = reinterpret_cast<const unsigned*>(p)[k] ^ ti * 0x01010101u;
    } else {
      w[0] = 0;
#pragma unroll
      for (int e = 0; e < VEC; ++e) w[0] |= (unsigned)(p[e] ^ ti) << 8 * e;
    }
  }
  __device__ __forceinline__ bool chose(int e) const {
    return (w[e / 4] & 0xffu << 8 * (e % 4)) == 0;
  }
};

// The taps of one axis that connect input coordinate j to an output: with
// q = (j + p) / s and r = (j + p) - q s, tap a = r + m s reaches output
// q - m.  Bit m of the result is set when both exist (m < kMaxWindow).
__device__ __forceinline__ int axis_taps(int j, int k, int s, int p, int n_out,
                                         FastDiv s_d, int& q, int& r) {
  q = s_d.div(j + p);
  r = j + p - q * s;
  int mask = 0;
#pragma unroll
  for (int m = 0; m < kMaxWindow; ++m)
    if (r + m * s < k && q - m >= 0 && q - m < n_out) mask |= 1 << m;
  return mask;
}

// Block i owns channels [c0, c0 + group) with c0 = (i % groups) * group,
// masked at C, then (fastest first) H strip, T strip and slab.  Thread t
// works on channel vector t % nv (nv = group / VEC = 1 << nv_shift) of
// positions t / nv, t / nv + blockDim / nv, ...  Shared memory: x, then
// dy, as [position][group] of T in the plan's layout (x [nxt][nxh][W], y
// [nyt][nyh][Wo], the larger of the two), then the taps as [output][group]
// bytes.  STRIPS is false where every slab is one block (the layout is
// then the slab's, every staged range starts at 0, and the index
// arithmetic folds to a slab's): those plans keep the code they had before
// strips existed.
template <typename T, int VEC, bool STRIPS>
__global__ void __launch_bounds__(kMaxThreads)
maxpool_bwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                   const T* __restrict__ dy, T* __restrict__ dx, PoolGeom g,
                   int group, int groups, int nv_shift) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nxh = STRIPS ? g.nxh : g.xh, nyh = STRIPS ? g.nyh : g.yh;
  const int x_plane = nxh * g.xw, y_plane = nyh * g.yw;
  const int nin = g.xt * g.xh * g.xw, nout = g.yt * g.yh * g.yw;
  T* sv = reinterpret_cast<T*>(smem);
  unsigned char* stap =
      smem + (size_t)(STRIPS ? max(g.nxt * x_plane, g.nyt * y_plane) : max(nin, nout)) *
                 group * sizeof(T);
  long long slab;
  int c0, own_t0 = 0, own_t1 = g.xt, own_h0 = 0, own_h1 = g.xh;
  Cover ct{0, g.yt, 0, g.xt}, ch{0, g.yh, 0, g.xh};
  if constexpr (STRIPS) {
    int rest = blockIdx.x / groups;
    c0 = (int)(blockIdx.x - rest * groups) * group;
    const int hi = rest % g.h_strips;
    rest /= g.h_strips;
    const int ti = rest % g.t_strips;
    slab = rest / g.t_strips;
    own_t0 = ti * g.ts, own_t1 = min(g.xt, own_t0 + g.ts);
    own_h0 = hi * g.hs, own_h1 = min(g.xh, own_h0 + g.hs);
    ct = axis_cover(own_t0, own_t1, g.kt, g.st, g.pt, g.xt, g.yt);
    ch = axis_cover(own_h0, own_h1, g.kh, g.sh, g.ph, g.xh, g.yh);
    // the plan's layout holds every strip (a wrong plan stops here)
    if (ct.x1 - ct.x0 > g.nxt || ch.x1 - ch.x0 > g.nxh || ct.o1 - ct.o0 > g.nyt ||
        ch.o1 - ch.o0 > g.nyh)
      __trap();
  } else {
    slab = blockIdx.x / groups;
    c0 = (int)(blockIdx.x % groups) * group;
  }
  const int v = threadIdx.x & ((1 << nv_shift) - 1);
  const int first = threadIdx.x >> nv_shift, step = blockDim.x >> nv_shift;
  const int cv = v * VEC;
  // a masked vector of the last group (C % VEC == 0) idles but keeps to the
  // barriers
  const bool live = c0 + cv < g.nc;
  const int n_x = live ? (STRIPS ? (ct.x1 - ct.x0) * x_plane : nin) : 0;
  const int n_y = live ? (STRIPS ? (ct.o1 - ct.o0) * y_plane : nout) : 0;
  const int x_row = (ch.x1 - ch.x0) * g.xw, y_row = (ch.o1 - ch.o0) * g.yw;
  const T* xs = x + slab * nin * g.nc + c0 + cv;
  const T* ys = y + slab * nout * g.nc + c0 + cv;
  const T* dys = dy + slab * nout * g.nc + c0 + cv;
  T* dxs = dx + slab * nin * g.nc + c0 + cv;

  // x of the staged frames and rows; position j = (lt * nxh + lh) * W + w
  for (int j = first; j < n_x; j += step) {
    if constexpr (STRIPS) {
      const int lt = g.xplane_d.div(j), r = j - lt * x_plane;
      if (r < x_row)
        stage<T, VEC>(sv + j * group + cv,
                      xs + ((long long)(ct.x0 + lt) * g.xh + ch.x0) * g.xw * g.nc +
                          (long long)r * g.nc);
    } else {
      stage<T, VEC>(sv + j * group + cv, xs + (long long)j * g.nc);
    }
  }
  stage_wait();
  __syncthreads();

  // phase A: the first maximal tap of every staged output, by output
  // column (ho, wo) walked along t.  Where y is NaN the window held a NaN
  // and no tap is chosen (255), as in the plain version, where no tap
  // equals NaN.
  const int ncol = n_y == 0 ? 0 : y_row;
  for (int col = first; col < ncol; col += step) {
    const int lho = g.yw_d.div(col), wo = col - lho * g.yw;
    const int ho = ch.o0 + lho;
    const int h0 = ho * g.sh - g.ph, w0 = wo * g.sw - g.pw;
    const int b_lo = max(0, -h0), b_hi = min(g.kh, g.xh - h0);
    const int c_lo = max(0, -w0), c_hi = min(g.kw, g.xw - w0);
    const int tap_hw = g.kh * g.kw;
    Best<T, VEC> fb[kMaxWindow];   // fb[a]: frame have + a
    int have = -(1 << 30);
    for (int to = ct.o0; to < ct.o1; ++to) {
      const int t0 = to * g.st - g.pt;
      const int a_lo = max(0, -t0), a_hi = min(g.kt, g.xt - t0);
      // frame t0 + a is the previous output's frame a + d (d = 1 or 2 at
      // stride 1 or 2): reuse it.  Ascending a reads fb[a + d] before it
      // is overwritten; the index guards keep dead unrolled copies in range.
      const int d = t0 - have;
#pragma unroll
      for (int a = 0; a < kMaxWindow; ++a) {
        if (a < a_lo || a >= a_hi) continue;
        if (a + 1 < kMaxWindow && d == 1 && a + 1 < g.kt)
          fb[a] = fb[a + 1 < kMaxWindow ? a + 1 : a];
        else if (a + 2 < kMaxWindow && d == 2 && a + 2 < g.kt)
          fb[a] = fb[a + 2 < kMaxWindow ? a + 2 : a];
        else
          fb[a] = frame_best<T, VEC>(
              sv + (((t0 + a - ct.x0) * nxh + h0 - ch.x0) * g.xw + w0) * group + cv, g, group,
              b_lo, b_hi, c_lo, c_hi);
      }
      have = t0;
      Best<T, VEC> best;
      bool first_frame = true;
#pragma unroll
      for (int a = 0; a < kMaxWindow; ++a) {
        if (a < a_lo || a >= a_hi) continue;
        if (first_frame) best.init_from(fb[a], a * tap_hw);
        else best.take(fb[a], a * tap_hw);
        first_frame = false;
      }
      const int o = (to * g.yh + ho) * g.yw + wo;
      const int lo = STRIPS ? ((to - ct.o0) * nyh + lho) * g.yw + wo : o;
      const Pack<T, VEC> yv = *reinterpret_cast<const Pack<T, VEC>*>(ys + (long long)o * g.nc);
      Pack<unsigned char, VEC> out;
#pragma unroll
      for (int e = 0; e < VEC; ++e) out.v[e] = is_nan(yv, e) ? 255 : best.get(e);
      *reinterpret_cast<Pack<unsigned char, VEC>*>(stap + lo * group + cv) = out;
    }
  }
  __syncthreads();

  // dy of the staged outputs, over x's space; position (lt * nyh + lh) * Wo + wo
  for (int j = first; j < n_y; j += step) {
    if constexpr (STRIPS) {
      const int lt = g.yplane_d.div(j), r = j - lt * y_plane;
      if (r < y_row)
        stage<T, VEC>(sv + j * group + cv,
                      dys + ((long long)(ct.o0 + lt) * g.yh + ch.o0) * g.yw * g.nc +
                          (long long)r * g.nc);
    } else {
      stage<T, VEC>(sv + j * group + cv, dys + (long long)j * g.nc);
    }
  }
  stage_wait();
  __syncthreads();

  // phase B: for every owned input, gather dy over the outputs that chose
  // it, in increasing output order (m descending on every axis); all of
  // them are staged
  const int n_own = live ? (STRIPS ? (own_t1 - own_t0) * g.hs * g.xw : nin) : 0;
  for (int j = first; j < n_own; j += step) {
    const int th = g.xw_d.div(j), w = j - th * g.xw;
    const int lt = g.hs_d.div(th), lh = th - lt * g.hs;   // hs = H without strips
    const int t = own_t0 + lt, h = own_h0 + lh;
    if (STRIPS && h >= own_h1) continue;
    int qt, rt, qh, rh, qw, rw;
    const int mt = axis_taps(t, g.kt, g.st, g.pt, g.yt, g.st_d, qt, rt);
    const int mh = axis_taps(h, g.kh, g.sh, g.ph, g.yh, g.sh_d, qh, rh);
    const int mw = axis_taps(w, g.kw, g.sw, g.pw, g.yw, g.sw_d, qw, rw);
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll
    for (int it = kMaxWindow - 1; it >= 0; --it) {
      if (!((mt >> it) & 1)) continue;
      const int a = rt + it * g.st, ot = qt - it - ct.o0;
#pragma unroll
      for (int ih = kMaxWindow - 1; ih >= 0; --ih) {
        if (!((mh >> ih) & 1)) continue;
        const int bb = rh + ih * g.sh, oh = qh - ih - ch.o0;
        const int row = (ot * nyh + oh) * g.yw;
        const int tab = (a * g.kh + bb) * g.kw;
#pragma unroll
        for (int iw = kMaxWindow - 1; iw >= 0; --iw) {
          if (!((mw >> iw) & 1)) continue;
          const unsigned char tix = (unsigned char)(tab + rw + iw * g.sw);
          const int off = (row + qw - iw) * group + cv;
          // bytes of tw ^ tix are 0 where the output chose this input
          const TapWords<VEC> tw(stap + off, tix);
          const Pack<T, VEC> dv = *reinterpret_cast<const Pack<T, VEC>*>(sv + off);
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            if (tw.chose(e)) acc[e] += to_f(dv.v[e]);
        }
      }
    }
    Pack<T, VEC> out;
#pragma unroll
    for (int e = 0; e < VEC; ++e) out.v[e] = from_f<T>(acc[e]);
    const long long pos = STRIPS ? ((long long)t * g.xh + h) * g.xw + w : j;
    *reinterpret_cast<Pack<T, VEC>*>(dxs + pos * g.nc) = out;
  }
}

template <typename T, int VEC>
int launch(const void* x, const void* y, const void* dy, void* dx, int slabs,
           PoolGeom g, int group, int threads, cudaStream_t stream) {
  const long long n_x = (long long)g.nxt * g.nxh * g.xw, n_y = (long long)g.nyt * g.nyh * g.yw;
  const long long smem = (n_x > n_y ? n_x : n_y) * group * sizeof(T) + n_y * group;
  const long long groups = (g.nc + group - 1) / group;
  if (g.ts <= 0 || g.hs <= 0) return (int)cudaErrorInvalidValue;
  g.t_strips = (g.xt + g.ts - 1) / g.ts;
  g.h_strips = (g.xh + g.hs - 1) / g.hs;
  const long long blocks = (long long)slabs * g.t_strips * g.h_strips * groups;
  const int nv = group / VEC;
  int nv_shift = 0;
  while ((1 << nv_shift) < nv) ++nv_shift;
  if (group <= 0 || group % VEC || nv != (1 << nv_shift) || threads <= 0 ||
      threads > kMaxThreads || threads % nv || smem > kMaxSmem || blocks > 0x7fffffffLL ||
      g.kt > kMaxWindow || g.kh > kMaxWindow || g.kw > kMaxWindow || g.nxt > g.xt ||
      g.nxh > g.xh || g.nyt > g.yt || g.nyh > g.yh ||
      (g.t_strips == 1 && g.h_strips == 1 &&
       (g.nxt != g.xt || g.nxh != g.xh || g.nyt != g.yt || g.nyh != g.yh || g.hs != g.xh)))
    return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  const bool strips = g.t_strips > 1 || g.h_strips > 1;
  auto kern = strips ? maxpool_bwd_kernel<T, VEC, true> : maxpool_bwd_kernel<T, VEC, false>;
  if (smem > kDefaultSmem) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  g.xw_d = make_div(g.xw);
  g.yw_d = make_div(g.yw);
  g.xplane_d = make_div(g.nxh * g.xw);
  g.yplane_d = make_div(g.nyh * g.yw);
  g.hs_d = make_div(g.hs);
  g.st_d = make_div(g.st);
  g.sh_d = make_div(g.sh);
  g.sw_d = make_div(g.sw);
  kern<<<(unsigned)blocks, threads, (size_t)smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const T*>(dy),
      static_cast<T*>(dx), g, group, (int)groups, nv_shift);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// x, dx (slabs, T, H, W, C); y, dy (slabs, To, Ho, Wo, C); all contiguous in
// that order (channels-last), of one dtype.  A slab is a clip, or a frame
// (T = To = 1) for windows of 1 in t.  group (channels per block), threads,
// the strips (ts frames, hs rows of dx per block) and the shared layout
// (nxt x nxh rows of x, nyt x nyh rows of y) come from the wrapper's plan
// (ops/maxpool.py:bwd_plan).
extern "C" int vgs_maxpool3d_bwd(const void* x, const void* y, const void* dy,
                                 void* dx, int slabs, int T, int H, int W,
                                 int C, int To, int Ho, int Wo, int kt, int kh,
                                 int kw, int st, int sh, int sw, int pt, int ph,
                                 int pw, int group, int threads, int ts, int hs,
                                 int nxt, int nxh, int nyt, int nyh, int is_bf16,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PoolGeom g{};
  g.xt = T, g.xh = H, g.xw = W, g.nc = C, g.yt = To, g.yh = Ho, g.yw = Wo;
  g.kt = kt, g.kh = kh, g.kw = kw, g.st = st, g.sh = sh, g.sw = sw;
  g.pt = pt, g.ph = ph, g.pw = pw, g.ts = ts, g.hs = hs;
  g.nxt = nxt, g.nxh = nxh, g.nyt = nyt, g.nyh = nyh;
  const bool vec_ok = aligned16(x) && aligned16(y) && aligned16(dy) && aligned16(dx);
  if (is_bf16) {
    if (vec_ok && C % 8 == 0)
      return launch<__nv_bfloat16, 8>(x, y, dy, dx, slabs, g, group, threads, s);
    return launch<__nv_bfloat16, 1>(x, y, dy, dx, slabs, g, group, threads, s);
  }
  if (vec_ok && C % 4 == 0) return launch<float, 4>(x, y, dy, dx, slabs, g, group, threads, s);
  return launch<float, 1>(x, y, dy, dx, slabs, g, group, threads, s);
}
