// Forward of a dense 3D convolution whose input has few channels (C < 8),
// on the tensor cores of Hopper (sm_90a): the first convolution of every 3D
// backbone (S3D's 1x7x7 / (1,2,2), I3D's 7x7x7 / 2, I3D-ResNet-50-NL's and
// SlowFast's 5x7x7, R3D's 7x7x7, the 2-channel Flow stems), 3 -> 8..64.
//
//     y[b, f, t, h, w] = bias[f] + sum_{dt, dh, dw, c} x[b, t*st - pt + dt,
//                        h*sh - ph + dh, w*sw - pw + dw, c] * wt[f, c, dt, dh, dw]
//
// x is read as it reaches the stem: (B, T, H, W, C) at any strides (the
// augmentation's clips keep a frame's channel planes apart, H fastest),
// fp32 or bf16,
// each element rounded to bf16 as it is staged (the cast the library
// path makes with x.to(dtype)); taps outside x read zero, so any padding,
// the TF-SAME (lo, hi) pads included, needs no padded copy.  An optional
// frame table (int64) makes frame t of the convolution's input x's frame
// table[t] (SlowFast's Slow pathway reads its frames of the clip in place).
// y is bf16 (B, To, Ho, Wo, F) in memory: the (B, F, To, Ho, Wo) tensor in
// channels_last_3d that the backbone's batch norm takes.  Products of bf16
// operands are summed in fp32 and rounded to bf16 once.
//
// Replaces no TPU kernel: the JAX package leaves the stem to XLA.  It takes
// the place of cuDNN's path for a 3-channel bf16 input, which copies x to
// NCHW fp32, runs an FFMA kernel off the tensor cores and copies y back.
//
// The implicit GEMM: M = output positions, N = F (up to 64 a block; more
// in blocks of 64 along grid.y), K = C kt kh kw.  K is ordered (dt, dh, dw,
// c): for one (dt, dh) the kw*C values (dw, c) of a position's window are
// contiguous in a staged x row, so a pair of neighbouring k is one 4-byte
// shared load.  Each (dt, dh) row of taps takes G = kw*C rounded up to even
// (one masked element before or after the row keeps every pair 4-byte
// aligned), and each dt's kh*G values are padded to whole k-steps of 16.
//
//   block: persistent; walks units (b, a strip of rh output rows, all Wo)
//     and, inside a unit, the output frames in order, keeping a ring of the
//     kt input frames of the current window in shared memory: a step stages
//     only the st frames it has not seen (the window's rows, with their
//     halo, all columns), rounded to bf16 (four elements a load where
//     (W, C) is dense, else one).
//   weights: all of K for the block's F columns, staged once per block.
//   warp: MT tiles of 16 positions along W by all F, mma.sync.m16n8k16 with
//     fp32 accumulators; A fragments are 4-byte shared loads at offsets from
//     a per-lane table (masked where a pair holds a pad element), B
//     fragments ldmatrix from the weights.
//   store: each tile through a per-warp shared buffer, 16-byte stores of y.
//
// What bounds it on the H100: bytes where F is 64 and K small (S3D's
// 1x7x7: y is 1.6 GB a pass at bs 256), bf16 operations where K is large
// (5x7x7 and 7x7x7 at F 64), and shared-memory loads of the A operand where
// F is 8 (each staged element feeds only 8 products).  Its time falls with
// the warps an SM holds, so the wrapper's plan picks the strip and launch
// bound that keep the most (PERF.md §6, row S: 3.5x to 22x its bound).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kMaxSmem = 232448;   // 227 KB: the most one block may take
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxDevices = 64;
constexpr int kArgs = 43;          // integers of one call (ops/stem_conv.py:launch_args)
constexpr int kMaxC = 7;           // input channels the kernel takes (ops/stem_conv.py:MAX_CHANNELS - 1)

struct StemGeom {
  int B, T, H, W, C;      // x (B, T, H, W, C)
  int tsel;               // frames the convolution reads (the table's length, or T)
  int to, ho, wo, f;      // y (B, To, Ho, Wo, F)
  int kt, kh, kw, st, sh, sw, pt, ph, pw;   // kernel, stride, low pads
  int group;              // G: elements of one (dt, dh) row of taps in K
  int lead;               // masked elements before a row of taps (0 or 1)
  int kspd;               // k-steps of 16 per dt
  int rh, wt;             // a unit's output rows; 16-position tiles per output row
  int sr, rp;             // staged rows per frame; elements per staged row
  int zoff, xoff;         // staged row: a position's window starts at w*sw*C + zoff;
                          // staged element e holds x's element e - xoff of the row
  int hb, units;          // strips of rh rows per clip; B * hb
  int warps;
  int vec;                // (W, C) dense and rows in aligned fours: 4-element loads
  long long xs[5];        // x strides (B, T, H, W, C), elements
  long long ws[5];        // weight strides (F, C, kt, kh, kw), elements
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned lds32(unsigned addr) {
  unsigned v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ unsigned lds16(unsigned addr) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr));
  return v;
}

// two neighbouring bf16 of a staged row as one A register (the lower k in
// the low half); two 2-byte loads where a position's base may be odd
template <bool PAIRED>
__device__ __forceinline__ unsigned load_pair(unsigned addr) {
  if constexpr (PAIRED)
    return lds32(addr);
  else
    return lds16(addr) | (lds16(addr + 2) << 16);
}

__device__ __forceinline__ void ldsm_x4(unsigned r[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(unsigned r[2], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulator
__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ int wrap(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

__host__ __device__ constexpr int align16(long long n) { return (int)((n + 15) & ~15LL); }

struct Layout {
  int w_pitch, w_bytes, tbl_bytes, x_bytes, s_pitch, s_bytes, total;
};

__host__ __device__ inline Layout layout(const StemGeom& g, int nt) {
  Layout l;
  const int kdim = g.kt * g.kspd * 16;
  l.w_pitch = kdim + 8;                       // 16 B mod 32: conflict-free ldmatrix rows
  l.w_bytes = align16((long long)nt * 8 * l.w_pitch * 2);
  l.tbl_bytes = g.kspd * 4 * (16 + 8);     // per k-step and lane group: 4 offsets, 2 masks
  l.x_bytes = align16((long long)g.kt * g.sr * g.rp * 2);
  l.s_pitch = nt * 8 + 8;
  l.s_bytes = g.warps * 16 * l.s_pitch * 2;
  l.total = l.w_bytes + l.tbl_bytes + l.x_bytes + l.s_bytes;
  return l;
}

// Stage input frames [lo, hi) of the window (their ring slots), rows
// h0*sh - ph .. + sr, every staged column, rounded to bf16; zero outside x.
// Where (W, C) is dense (the channels-last clip) four elements load at
// once; any other layout (the augmentation's clips keep each channel's
// plane of a frame apart, H fastest) loads a column's C channels one by one.
template <typename TX>
__device__ void stage_frames(const TX* __restrict__ x, const long long* __restrict__ frames,
                             bf16* X, const StemGeom& g, int b, int h0, int lo, int hi,
                             int warp, int lane) {
  const int rows = (hi - lo) * g.sr;
  const int wc = g.W * g.C;
  const int x0 = g.xoff / g.C;                 // staged column of x's column 0
  for (int rr = warp; rr < rows; rr += g.warps) {
    const int fi = lo + rr / g.sr;
    const int r = rr - (fi - lo) * g.sr;
    const int hin = h0 * g.sh - g.ph + r;
    bf16* dst = X + ((long long)wrap(fi, g.kt) * g.sr + r) * g.rp;
    const bool valid = fi >= 0 && fi < g.tsel && hin >= 0 && hin < g.H;
    const TX* src = nullptr;
    if (valid) {
      const long long tx = frames ? frames[fi] : fi;
      src = x + b * g.xs[0] + tx * g.xs[1] + hin * g.xs[2];
    }
    if (g.vec) {
#pragma unroll 4
      for (int q = lane; q * 4 < g.rp; q += 32) {
        const int gi = q * 4 - g.xoff;
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        if (valid && gi >= 0 && gi < wc) {
          if constexpr (sizeof(TX) == 4) {
            const float4 u = *reinterpret_cast<const float4*>(src + gi);
            v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
          } else {
            const uint2 u = *reinterpret_cast<const uint2*>(src + gi);
            const bf16* h = reinterpret_cast<const bf16*>(&u);
            v[0] = to_f(h[0]), v[1] = to_f(h[1]), v[2] = to_f(h[2]), v[3] = to_f(h[3]);
          }
        }
        uint2 o;
        o.x = pack_bf16(v[0], v[1]);
        o.y = pack_bf16(v[2], v[3]);
        *reinterpret_cast<uint2*>(dst + q * 4) = o;
      }
    } else {
#pragma unroll 2
      for (int col = lane; col * g.C < g.rp; col += 32) {
        const int wi = col - x0;
        const bool in = valid && wi >= 0 && wi < g.W;
        float v[kMaxC];
#pragma unroll
        for (int c = 0; c < kMaxC; ++c)
          v[c] = in && c < g.C ? to_f(src[wi * g.xs[3] + c * g.xs[4]]) : 0.f;
#pragma unroll
        for (int c = 0; c < kMaxC; ++c)
          if (c < g.C && col * g.C + c < g.rp) dst[col * g.C + c] = __float2bfloat16_rn(v[c]);
      }
    }
  }
}

// One output frame of this warp's tiles: acc += A B over every dt and
// k-step.  mb: each tile's row-g position in a staged frame (bytes); toff:
// per k-step and lane group the byte offsets of its pairs (row g, row g + 8
// at k 2t, then at k 2t + 8); tmask: their masks.
template <int NT, int MT, bool PAIRED>
__device__ __forceinline__ void frame_product(float (&acc)[MT][NT][4], const unsigned (&mb)[MT],
                                              const int4* toff, const int2* tmask,
                                              unsigned x_s, unsigned w_s, int first,
                                              const StemGeom& g, int fbytes, int kdt,
                                              int w_row_bytes, int tq) {
  for (int dt = 0; dt < g.kt; ++dt) {
    const unsigned xs = x_s + (unsigned)(wrap(first + dt, g.kt) * fbytes);
    const unsigned wd = w_s + (unsigned)(dt * kdt * 2);
    for (int ks = 0; ks < g.kspd; ++ks) {
      const int4 o = toff[ks * 4 + tq];
      const int2 m = tmask[ks * 4 + tq];
      unsigned a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const unsigned p = xs + mb[i];
        a[i][0] = load_pair<PAIRED>(p + o.x) & (unsigned)m.x;
        a[i][1] = load_pair<PAIRED>(p + o.y) & (unsigned)m.x;
        a[i][2] = load_pair<PAIRED>(p + o.z) & (unsigned)m.y;
        a[i][3] = load_pair<PAIRED>(p + o.w) & (unsigned)m.y;
      }
      const unsigned wk = wd + (unsigned)(ks * 32);
      unsigned bf[NT][2];
      if constexpr (NT == 1) {
        ldsm_x2(bf[0], wk);
      } else {
#pragma unroll
        for (int n = 0; n + 1 < NT; n += 2) {
          unsigned r[4];
          ldsm_x4(r, wk + (unsigned)(n * 8 * w_row_bytes));
          bf[n][0] = r[0], bf[n][1] = r[1], bf[n + 1][0] = r[2], bf[n + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_bf16(acc[i][n], a[i], bf[n][0], bf[n][1]);
    }
  }
}

// MAXT threads at most, MINB blocks per SM at least: for F 64, a block of
// up to 8 warps with 128 registers a thread (two blocks on an SM where their
// shared memory fits), or of up to 12 warps with up to 170
template <typename TX, int NT, int MT, int MAXT, int MINB>
__global__ void __launch_bounds__(MAXT, MINB)
stem_conv_fwd_kernel(const TX* __restrict__ x, const bf16* __restrict__ w,
                     const bf16* __restrict__ bias, const long long* __restrict__ frames,
                     bf16* __restrict__ y, const StemGeom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(g, NT);
  bf16* Ws = reinterpret_cast<bf16*>(smem);
  int4* toff = reinterpret_cast<int4*>(smem + L.w_bytes);
  int2* tmask = reinterpret_cast<int2*>(smem + L.w_bytes + g.kspd * 4 * 16);
  bf16* X = reinterpret_cast<bf16*>(smem + L.w_bytes + L.tbl_bytes);
  bf16* S = reinterpret_cast<bf16*>(smem + L.w_bytes + L.tbl_bytes + L.x_bytes);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = g.warps * 32;
  const int f0 = blockIdx.y * 64;
  const int nf = min(64, g.f - f0);
  const int kwc = g.kw * g.C;
  const int kdt = g.kspd * 16;
  const int kdim = g.kt * kdt;
  const bool paired = (g.sw * g.C) % 2 == 0;
  const int row8 = 8 * g.sw * g.C * 2;       // bytes from row g to row g + 8 of a tile

  // weights: Ws[n][k], k = dt * kdt + dh * G + j, j - lead the element (dw, c)
  for (int i = tid; i < NT * 8 * kdim; i += nthreads) {
    const int n = i / kdim, k = i - n * kdim;
    const int dt = k / kdt, kk = k - dt * kdt;
    const int dh = kk / g.group, e = kk - dh * g.group - g.lead;
    bf16 v = __float2bfloat16_rn(0.f);
    if (n < nf && dh < g.kh && e >= 0 && e < kwc) {
      const int dw = e / g.C, c = e - dw * g.C;
      v = w[(f0 + n) * g.ws[0] + c * g.ws[1] + dt * g.ws[2] + dh * g.ws[3] + dw * g.ws[4]];
    }
    Ws[n * L.w_pitch + k] = v;
  }
  // per lane group t and k-step: the byte offsets of its A pairs in a staged
  // frame (rows g and g + 8 of a tile) and their masks (a pair's element
  // outside the taps reads zero)
  for (int i = tid; i < g.kspd * 4; i += nthreads) {
    const int ks = i >> 2, t = i & 3;
    int o[2], m[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int kk = ks * 16 + 2 * t + 8 * j;
      const int dh = kk / g.group, e = kk - dh * g.group - g.lead;
      o[j] = -g.lead, m[j] = 0;   // a pad pair past the taps: read aligned, masked
      if (dh < g.kh) {
        o[j] = dh * g.rp + e;
        m[j] = (e >= 0 && e < kwc ? 0xFFFF : 0) | (e + 1 >= 0 && e + 1 < kwc ? 0xFFFF0000 : 0);
      }
    }
    toff[i] = make_int4(2 * o[0], 2 * o[0] + row8, 2 * o[1], 2 * o[1] + row8);
    tmask[i] = make_int2(m[0], m[1]);
  }

  // this warp's tiles of a unit: tile m = warp * MT + i is output row m / wt,
  // positions (m % wt) * 16 .. + 16
  const int tiles = g.rh * g.wt;
  const int gq = lane >> 2, tq = lane & 3;
  unsigned mb[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int m = min(warp * MT + i, tiles - 1);
    const int r = m / g.wt, c16 = m - r * g.wt;
    mb[i] = 2 * (r * g.sh * g.rp + (c16 * 16 + gq) * g.sw * g.C + g.zoff);
  }
  const unsigned x_s = smem_addr(X);
  const int fp = g.sr * g.rp;
  // ldmatrix rows of this lane: n = lane % 8 (+ 8 for the x4's second pair), k half (lane / 8) % 2
  const unsigned w_s = smem_addr(Ws) +
      (unsigned)((((lane & 7) + ((lane >> 4) << 3)) * L.w_pitch + ((lane >> 3) & 1) * 8) * 2);
  bf16* Sw = S + warp * 16 * L.s_pitch;
  float bv[NT][2];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = n * 8 + 2 * tq + j;
      bv[n][j] = (bias && c < nf) ? to_f(bias[f0 + c]) : 0.f;
    }
  }

  for (int unit = blockIdx.x; unit < g.units; unit += gridDim.x) {
    const int b = unit / g.hb;
    const int h0 = (unit - b * g.hb) * g.rh;
    for (int to = 0; to < g.to; ++to) {
      const int first = to * g.st - g.pt;
      const int lo = to == 0 ? first : max(first, first - g.st + g.kt);
      __syncthreads();   // the ring's slots and the weights are free / written
      stage_frames<TX>(x, frames, X, g, b, h0, lo, first + g.kt, warp, lane);
      __syncthreads();

      float acc[MT][NT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][n][j] = 0.f;

      if (warp * MT < tiles) {
        if (paired)
          frame_product<NT, MT, true>(acc, mb, toff, tmask, x_s, w_s, first, g, fp * 2, kdt,
                                      L.w_pitch * 2, tq);
        else
          frame_product<NT, MT, false>(acc, mb, toff, tmask, x_s, w_s, first, g, fp * 2, kdt,
                                       L.w_pitch * 2, tq);
      }

      // y through the warp's buffer: 16 rows (positions) of NT * 8 channels
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int m = warp * MT + i;
        const int r = m / g.wt, c16 = m - r * g.wt;
        if (m >= tiles || h0 + r >= g.ho) continue;   // warp-uniform
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int c = n * 8 + 2 * tq;
          *reinterpret_cast<unsigned*>(Sw + gq * L.s_pitch + c) =
              pack_bf16(acc[i][n][0] + bv[n][0], acc[i][n][1] + bv[n][1]);
          *reinterpret_cast<unsigned*>(Sw + (gq + 8) * L.s_pitch + c) =
              pack_bf16(acc[i][n][2] + bv[n][0], acc[i][n][3] + bv[n][1]);
        }
        __syncwarp();
        bf16* yrow = y + ((((long long)b * g.to + to) * g.ho + h0 + r) * g.wo) * g.f + f0;
        for (int q = lane; q < 16 * NT; q += 32) {
          const int pr = q / NT, ch = q - pr * NT;
          const int wo = c16 * 16 + pr;
          if (wo < g.wo && ch * 8 < nf)
            *reinterpret_cast<int4*>(yrow + (long long)wo * g.f + ch * 8) =
                *reinterpret_cast<const int4*>(Sw + pr * L.s_pitch + ch * 8);
        }
        __syncwarp();
      }
    }
  }
}

template <typename TX, int NT, int MT, int MAXT, int MINB>
int launch(const void* x, const void* w, const void* bias, const void* frames, void* y,
           const StemGeom& g, cudaStream_t stream) {
  const Layout L = layout(g, NT);
  if (L.total > kMaxSmem || g.warps * 32 > MAXT) return (int)cudaErrorInvalidValue;
  auto kern = stem_conv_fwd_kernel<TX, NT, MT, MAXT, MINB>;
  const int threads = g.warps * 32;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (L.total > kDefaultSmem) {
    // raised once per device and instantiation; later launches pay nothing
    static bool raised[kMaxDevices];
    if (dev >= kMaxDevices || !raised[dev]) {
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (e != cudaSuccess) return (int)e;
      if (dev < kMaxDevices) raised[dev] = true;
    }
  }
  static int sms[kMaxDevices];
  int n_sm = dev < kMaxDevices ? sms[dev] : 0;
  if (n_sm == 0) {
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < kMaxDevices) sms[dev] = n_sm;
  }
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, L.total);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long blocks = (long long)n_sm * per_sm;
  const unsigned gx = (unsigned)(g.units < blocks ? g.units : blocks);
  const unsigned gy = (unsigned)((g.f + 63) / 64);
  kern<<<dim3(gx, gy), threads, (size_t)L.total, stream>>>(
      static_cast<const TX*>(x), static_cast<const bf16*>(w), static_cast<const bf16*>(bias),
      static_cast<const long long*>(frames), static_cast<bf16*>(y), g);
  return (int)cudaGetLastError();
}

// The instantiations, by index: 8-channel columns NT, 16-position tiles a
// warp MT, and the launch bound (threads, blocks an SM); F 64 has two.  The
// wrapper reads each with its registers (vgs_stem_conv3d_variants) and
// names the one its plan takes by its index.
#define STEM_VARIANTS(X) \
  X(0, 1, 4, 512, 1) X(1, 2, 8, 512, 1) X(2, 4, 4, 256, 1) X(3, 8, 2, 256, 2) X(4, 8, 2, 384, 1)

// the NT of F output channels: 8-channel columns, a power of two, up to 8
int columns(int f) {
  int nt = 1;
  while (nt * 8 < f && nt < 8) nt *= 2;
  return nt;
}

template <typename TX>
int dispatch(int variant, const void* x, const void* w, const void* bias, const void* frames,
             void* y, const StemGeom& g, cudaStream_t s) {
  const int nt = columns(g.f);
  switch (variant) {
#define STEM_CASE(i, NT, MT, MAXT, MINB)                                   \
    case i:                                                                \
      if (nt != NT) return (int)cudaErrorInvalidValue;                     \
      return launch<TX, NT, MT, MAXT, MINB>(x, w, bias, frames, y, g, s);
    STEM_VARIANTS(STEM_CASE)
#undef STEM_CASE
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Six integers a row for each instantiation, in the order of its index:
// NT, MT, the launch bound's threads and blocks an SM, and the registers a
// thread of the fp32-input and of the bf16-input kernel, as built.  Fills
// at most cap rows and returns how many there are (a CUDA error code,
// negated, on failure).
extern "C" int vgs_stem_conv3d_variants(long long* out, int cap) {
  int n = 0;
  cudaFuncAttributes af, ab;
  cudaError_t e;
#define STEM_ROW(i, NT, MT, MAXT, MINB)                                             \
  if (i < cap) {                                                                    \
    e = cudaFuncGetAttributes(&af, stem_conv_fwd_kernel<float, NT, MT, MAXT, MINB>); \
    if (e != cudaSuccess) return -(int)e;                                           \
    e = cudaFuncGetAttributes(&ab, stem_conv_fwd_kernel<bf16, NT, MT, MAXT, MINB>);  \
    if (e != cudaSuccess) return -(int)e;                                           \
    long long* r = out + 6 * i;                                                     \
    r[0] = NT, r[1] = MT, r[2] = MAXT, r[3] = MINB, r[4] = af.numRegs, r[5] = ab.numRegs; \
  }                                                                                 \
  ++n;
  STEM_VARIANTS(STEM_ROW)
#undef STEM_ROW
  return n;
}

// x (B, T, H, W, C), fp32 or bf16, and w bf16 (F, C, kt, kh, kw) at the
// strides given; bias bf16 (F) or null; frames int64 (tsel) or null; y bf16
// (B, To, Ho, Wo, F) contiguous.  a holds the call's kArgs integers in the
// order of ops/stem_conv.py:launch_args (the plan is the wrapper's, the
// instantiation its variant's index).
extern "C" int vgs_stem_conv3d_fwd(const void* x, const void* w, const void* bias,
                                   const void* frames, void* y, const long long* a,
                                   void* stream) {
  StemGeom g{};
  int v[31];
  for (int i = 0; i < 31; ++i) v[i] = (int)a[i];
  g.B = v[0], g.T = v[1], g.H = v[2], g.W = v[3], g.C = v[4], g.tsel = v[5];
  g.to = v[6], g.ho = v[7], g.wo = v[8], g.f = v[9];
  g.kt = v[10], g.kh = v[11], g.kw = v[12], g.st = v[13], g.sh = v[14], g.sw = v[15];
  g.pt = v[16], g.ph = v[17], g.pw = v[18];
  g.group = v[19], g.lead = v[20], g.kspd = v[21], g.rh = v[22], g.wt = v[23];
  g.sr = v[24], g.rp = v[25], g.zoff = v[26], g.xoff = v[27], g.hb = v[28];
  g.units = v[29], g.warps = v[30];
  const int variant = (int)a[31];
  const bool is_bf16 = a[32] != 0;
  for (int i = 0; i < 5; ++i) g.xs[i] = a[kArgs - 10 + i], g.ws[i] = a[kArgs - 5 + i];
  if (g.warps < 1 || g.C > kMaxC || g.rp % 4 || g.kt < 1 || g.st < 1 ||
      g.kspd * 16 < g.kh * g.group || g.units < 1 || g.f < 1)
    return (int)cudaErrorInvalidValue;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  g.vec = g.xs[4] == 1 && g.xs[3] == g.C && g.xs[2] % 4 == 0 && g.xs[1] % 4 == 0 &&
          g.xs[0] % 4 == 0 && g.xoff % 4 == 0 && (g.W * g.C) % 4 == 0 &&
          (xa & (is_bf16 ? 7 : 15)) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return dispatch<bf16>(variant, x, w, bias, frames, y, g, s);
  return dispatch<float>(variant, x, w, bias, frames, y, g, s);
}
