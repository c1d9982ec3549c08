// The tensor-core route of the SepConv-pair backward (included by
// sepconv_bwd.cu, which holds the design note).  bf16 only, C and F
// multiples of 8.  Six products, each an implicit GEMM on
// mma.sync.m16n8k16 (bf16 in, fp32 accumulator) fed from shared memory by
// ldmatrix, with a multi-stage ring of 16-byte cp.async copies:
//
//   P1 y1  = conv_s(x)       sep_tc_p1_y1_kernel   rows x F, K = 9 taps x C
//   P2 y2  = conv_t(a)       sep_tc_p2_y2_kernel   rows x F, K = 3 taps x F
//   P3 da  = conv_t^T(dy2)   sep_tc_p3_da_kernel   rows x F, K = 3 taps x F
//   P4 dWt = a^T dy2         sep_tc_p4_dwt_kernel  F x F per tap, K = rows
//   P5 dx  = conv_s^T(dy1)   sep_tc_p5_dx_kernel   rows x C, K = 9 taps x F
//   P6 dWs = x^T dy1         sep_tc_p6_dws_kernel  C x F per tap, K = rows
//
// Conv products (P1-P3, P5): a block owns kBM = 128 output rows and BN
// output channels.  The temporal products (P2, P3) walk (tap, 32-channel
// chunk) pairs, so a chunk never straddles two taps: a thread stages the
// same two rows of the A tile in every chunk and decodes their (t, h, w)
// once; a row whose tap-shifted source falls outside its clip (the conv
// padding), and a chunk's channels past Cin, are the zero-fill form of
// cp.async.  The spatial products (P1, P5) stage each 16-channel chunk's
// rows once with a halo of W + 1 rows on either side and run all nine taps
// on it (the padding is applied to the A fragments).  Weight
// products (P4, P6): a block owns three taps and a WBM x WBN tile of the
// weight gradient, stages each 32-row chunk of D once for the three, and
// reduces one row split into its own fp32 partial.
#pragma once

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;       // conv: output rows per block
constexpr int kBK = 32;        // conv: channels per K chunk; wgrad: rows per K chunk
constexpr int kHaloBK = 16;    // spatial conv: channels per staged chunk (two
                               // blocks of 128 x 128 fit an SM)
constexpr int kConvStages = 3;   // depth of the cp.async rings (deeper rings
constexpr int kWgradStages = 4;  // measured no faster on the H100)
constexpr int kConvThreads = 256;
constexpr int kWgradThreads = 128;
constexpr int kPad = 8;        // bf16 of padding per staged row: ldmatrix rows
                               // of one 8x8 matrix fall in distinct banks

// ---- PTX wrappers -------------------------------------------------------- //
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; zero-filled (nothing read) when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
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

__device__ __forceinline__ float rnd_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// ---- conv products -------------------------------------------------------- //
struct ConvArgs {
  const bf16* A;       // [rows][K] (row stride K)
  const bf16* W;       // [taps][K][N]
  int K, N;
  Rows rows;
  Taps taps;
  const float* bn;     // [4][N] BN constants (kY1, kY2, kDA)
  const bf16* aux;     // kY2: g (at GView g), kDA: y1 ([rows][N])
  GView g;
  bf16* out0;          // [rows][N]
  bf16* out1;          // kY1: a
  float* partial;      // kY2, kDA: [row tiles][2][N]
};

// Warp layout of a 128 x BN block of 8 warps: WM x WN warps, each owning
// MT m16 tiles by NT n8 tiles of the accumulator.  Behind the ring, kY2
// and kDA stage the epilogue's input tile (g or y1, [128][BN]) by cp.async
// at the start, so its loads overlap the K loop.
template <int BN>
struct ConvCfg {
  static constexpr int WN = BN >= 64 ? 2 : 1;
  static constexpr int WM = 8 / WN;
  static constexpr int RPT = kBM * 4 / kConvThreads;   // A rows staged per thread
  static constexpr int WTM = kBM / WM, WTN = BN / WN;
  static constexpr int MT = WTM / 16, NT = WTN / 8;
  static constexpr int AS = kBK + kPad;   // A row stride (elements)
  static constexpr int BS = BN + kPad;    // B row stride (elements)
  static constexpr int STAGES = kConvStages;
  static constexpr int STAGE = kBM * AS + kBK * BS;
  static constexpr int RING = STAGES * STAGE;        // elements
  static constexpr int SMEM_AUX = (RING + kBM * BS) * 2;   // bytes, kY2 and kDA
  // spatial products (kY1, kDX): a 2-stage ring of [128 + 2 halo rows][HAS]
  // A regions and [9 taps][kHaloBK][BS] B tiles
  static constexpr int HAS = kHaloBK + kPad;
  static constexpr int B_TAP = kHaloBK * BS;
  static_assert(NT % 2 == 0, "B fragments are loaded two n8 tiles at a time");
  static_assert((2 * WM + 4) * BN * 4 <= RING * 2 && (2 * WM + 4) * BN * 4 <= 4 * kBM * HAS,
                "epilogue scratch fits either ring");
  static __host__ __device__ int halo_stage(int nw) { return (kBM + 2 * (nw + 1)) * HAS + 9 * B_TAP; }
  static int halo_smem(int nw) { return 2 * halo_stage(nw) * 2; }
};

template <int MODE, int BN>
__device__ __forceinline__ void conv_tc(const ConvArgs& p) {
  using Cfg = ConvCfg<BN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % Cfg::WM, wn = warp / Cfg::WM;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * BN;
  const int K = p.K, N = p.N;
  const int nw = p.rows.nw, hw = p.rows.nh * p.rows.nw;

  // the epilogue's input tile (g for kY2 where 16-byte loads are allowed,
  // y1 for kDA) into shared memory behind the ring: its own cp.async group,
  // the oldest, so the K loop's waits cover it
  constexpr bool kAux = MODE == kY2 || MODE == kDA;
  bf16* aux_s = smem + Cfg::RING;
  const bool aux_staged = kAux && (MODE == kDA || p.g.vec);
  if (aux_staged) {
    for (int i = tid; i < kBM * BN / 8; i += kConvThreads) {
      const int rr = i / (BN / 8), pc = i % (BN / 8);
      const int r = m0 + rr, n = n0 + pc * 8;
      const bool ok = r < p.rows.m && n < N;
      const bf16* src = p.aux;
      if (ok) src += MODE == kDA ? (long long)r * N + n : p.g.row(r) + n;
      cp_async16(aux_s + rr * Cfg::BS + pc * 8, src, ok);
    }
  }
  cp_async_commit();

  float acc[Cfg::MT][Cfg::NT][4];
#pragma unroll
  for (int i = 0; i < Cfg::MT; ++i)
#pragma unroll
    for (int j = 0; j < Cfg::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  if constexpr (MODE == kY1 || MODE == kDX) {
    // Spatial taps (dt = 0): each 16-channel chunk stages the block's rows
    // plus nw + 1 halo rows on either side once; tap j reads them shifted by
    // dh * nw + dw rows.  A shifted row that leaves its frame is real data
    // of a neighbour row, so the conv padding is applied in the fragments:
    // the A registers of an output row whose tap j falls outside the frame
    // are zeroed.
    const int halo = nw + 1, R = kBM + 2 * halo;
    const int a_elems = R * Cfg::HAS, stage = Cfg::halo_stage(nw);
    const int nch = (K + kHaloBK - 1) / kHaloBK;
    unsigned tmask[Cfg::MT][2];   // bit j: tap j of the fragment row is inside the frame
#pragma unroll
    for (int mt = 0; mt < Cfg::MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + wm * Cfg::WTM + mt * 16 + (lane >> 2) + 8 * half;
        unsigned mask = 0;
        if (r < p.rows.m) {
          const int rem = r % hw, h = rem / nw, w = rem % nw;
#pragma unroll
          for (int j = 0; j < 9; ++j) {
            const int h2 = h + p.taps.dh[j], w2 = w + p.taps.dw[j];
            if (h2 >= 0 && h2 < p.rows.nh && w2 >= 0 && w2 < nw) mask |= 1u << j;
          }
        }
        tmask[mt][half] = mask;
      }
    auto load_halo = [&](int slot, int c0) {
      bf16* As = smem + slot * stage;
      bf16* Bs = As + a_elems;
      for (int i = tid; i < R * (kHaloBK / 8); i += kConvThreads) {
        const int q = i >> 1, c = c0 + (i & 1) * 8, r = m0 - halo + q;
        const bool ok = r >= 0 && r < p.rows.m && c < K;
        cp_async16(As + q * Cfg::HAS + (i & 1) * 8, ok ? p.A + ((long long)r * K + c) : p.A, ok);
      }
      for (int i = tid; i < 9 * kHaloBK * BN / 8; i += kConvThreads) {
        const int j = i / (kHaloBK * BN / 8), rem = i % (kHaloBK * BN / 8);
        const int kr = rem / (BN / 8), np = rem % (BN / 8);
        const int gk = c0 + kr, gn = n0 + np * 8;
        const bool ok = gk < K && gn < N;
        cp_async16(Bs + j * Cfg::B_TAP + kr * Cfg::BS + np * 8,
                   ok ? p.W + (((long long)j * K + gk) * N + gn) : p.W, ok);
      }
    };
    static_assert(kHaloBK == 16, "one k16 step per tap and chunk");
    load_halo(0, 0);
    cp_async_commit();
    for (int kc = 0; kc < nch; ++kc) {
      cp_async_wait<0>();
      __syncthreads();   // chunk kc has landed; every warp is done with kc - 1
      if (kc + 1 < nch) load_halo((kc + 1) & 1, (kc + 1) * kHaloBK);
      cp_async_commit();
      const bf16* As = smem + (kc & 1) * stage;
      const bf16* Bs = As + a_elems;
#pragma unroll
      for (int j = 0; j < 9; ++j) {
        const int off = halo + p.taps.dh[j] * nw + p.taps.dw[j];
        unsigned af[Cfg::MT][4], bfr[Cfg::NT][2];
#pragma unroll
        for (int mt = 0; mt < Cfg::MT; ++mt) {
          ldsm_x4(af[mt], As + (wm * Cfg::WTM + mt * 16 + (lane & 15) + off) * Cfg::HAS +
                              (lane >> 4) * 8);
          if (!((tmask[mt][0] >> j) & 1u)) af[mt][0] = af[mt][2] = 0u;   // row g
          if (!((tmask[mt][1] >> j) & 1u)) af[mt][1] = af[mt][3] = 0u;   // row g + 8
        }
#pragma unroll
        for (int np = 0; np < Cfg::NT / 2; ++np) {
          unsigned r[4];
          ldsm_x4_t(r, Bs + j * Cfg::B_TAP + (lane & 15) * Cfg::BS + wn * Cfg::WTN + np * 16 +
                           (lane >> 4) * 8);
          bfr[2 * np][0] = r[0];
          bfr[2 * np][1] = r[1];
          bfr[2 * np + 1][0] = r[2];
          bfr[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int mt = 0; mt < Cfg::MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < Cfg::NT; ++nt)
            mma_bf16(acc[mt][nt], af[mt], bfr[nt][0], bfr[nt][1]);
      }
    }
  } else {
    const int cpt = (K + kBK - 1) / kBK;   // chunks per tap
    const int nk = p.taps.n * cpt;         // (tap, chunk) pairs
    // the A rows this thread stages, decoded once
    const int kp = tid & 3;                // its 8-channel piece of a chunk
    int ar[Cfg::RPT], at[Cfg::RPT], ah[Cfg::RPT], aw[Cfg::RPT];
#pragma unroll
    for (int q = 0; q < Cfg::RPT; ++q) {
      ar[q] = m0 + (tid >> 2) + (kConvThreads / 4) * q;
      const int rem = ar[q] % (p.rows.nt * hw);
      at[q] = rem / hw;
      ah[q] = (rem % hw) / nw;
      aw[q] = rem % nw;
    }
    int lj = 0, lc0 = 0;                   // (tap, first channel) of the next load
    auto load_stage = [&](int slot) {
      bf16* As = smem + slot * Cfg::STAGE;
      bf16* Bs = As + kBM * Cfg::AS;
      const int dt = p.taps.dt[lj], dh = p.taps.dh[lj], dw = p.taps.dw[lj];
      const int c = lc0 + kp * 8;
#pragma unroll
      for (int q = 0; q < Cfg::RPT; ++q) {
        const int t2 = at[q] + dt, h2 = ah[q] + dh, w2 = aw[q] + dw;
        const bool ok = ar[q] < p.rows.m && c < K && t2 >= 0 && t2 < p.rows.nt &&
                        h2 >= 0 && h2 < p.rows.nh && w2 >= 0 && w2 < nw;
        const bf16* src = ok ? p.A + ((long long)(ar[q] + dt * hw + dh * nw + dw) * K + c) : p.A;
        cp_async16(As + ((tid >> 2) + (kConvThreads / 4) * q) * Cfg::AS + kp * 8, src, ok);
      }
      const bf16* wj = p.W + (long long)lj * K * N;
#pragma unroll
      for (int i = tid; i < kBK * BN / 8; i += kConvThreads) {
        const int kr = i / (BN / 8), np = i % (BN / 8);
        const int gk = lc0 + kr, gn = n0 + np * 8;
        const bool ok = gk < K && gn < N;
        cp_async16(Bs + kr * Cfg::BS + np * 8, ok ? wj + (long long)gk * N + gn : p.W, ok);
      }
      lc0 += kBK;
      if (lc0 >= K) {
        lc0 = 0;
        ++lj;
      }
    };

#pragma unroll
    for (int s = 0; s < Cfg::STAGES - 1; ++s) {
      if (s < nk) load_stage(s);
      cp_async_commit();
    }
    for (int kc = 0; kc < nk; ++kc) {   // (cp.async groups: aux, then one per chunk)
      cp_async_wait<Cfg::STAGES - 2>();
      __syncthreads();   // chunk kc has landed; every warp is done with kc - 1
      if (kc + Cfg::STAGES - 1 < nk) load_stage((kc + Cfg::STAGES - 1) % Cfg::STAGES);
      cp_async_commit();
      const bf16* As = smem + (kc % Cfg::STAGES) * Cfg::STAGE;
      const bf16* Bs = As + kBM * Cfg::AS;
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {
        unsigned af[Cfg::MT][4], bfr[Cfg::NT][2];
#pragma unroll
        for (int mt = 0; mt < Cfg::MT; ++mt)
          ldsm_x4(af[mt], As + (wm * Cfg::WTM + mt * 16 + (lane & 15)) * Cfg::AS +
                              ks * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < Cfg::NT / 2; ++np) {
          unsigned r[4];
          ldsm_x4_t(r, Bs + (ks * 16 + (lane & 15)) * Cfg::BS + wn * Cfg::WTN + np * 16 +
                           (lane >> 4) * 8);
          bfr[2 * np][0] = r[0];
          bfr[2 * np][1] = r[1];
          bfr[2 * np + 1][0] = r[2];
          bfr[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int mt = 0; mt < Cfg::MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < Cfg::NT; ++nt) mma_bf16(acc[mt][nt], af[mt], bfr[nt][0], bfr[nt][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: the epilogue reuses it

  // epilogue scratch in the ring: per-warp-row BN sums [WM][2][BN], BN
  // constants [4][BN]
  float* red = reinterpret_cast<float*>(smem_raw);
  float* bnc = red + 2 * Cfg::WM * BN;
  if constexpr (MODE != kDX) {
    for (int i = tid; i < 4 * BN; i += kConvThreads) {
      const int q = i / BN, col = i % BN;
      bnc[i] = n0 + col < N ? p.bn[q * N + n0 + col] : 0.f;
    }
    __syncthreads();
  }
  // the thread's rows (mt, half), and where g holds them
  int rr[Cfg::MT][2];
  long long go[Cfg::MT][2];
#pragma unroll
  for (int mt = 0; mt < Cfg::MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      rr[mt][half] = m0 + wm * Cfg::WTM + mt * 16 + (lane >> 2) + 8 * half;
      go[mt][half] = 0;
      if constexpr (MODE == kY2)
        if (!aux_staged && rr[mt][half] < p.rows.m) go[mt][half] = p.g.row(rr[mt][half]);
    }
  float s0[Cfg::NT][2], s1[Cfg::NT][2];
#pragma unroll
  for (int nt = 0; nt < Cfg::NT; ++nt) {
    const int col = wn * Cfg::WTN + nt * 8 + 2 * (lane & 3);
    const int n = n0 + col;
    float mu[2], rs[2], ga[2], be[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s0[nt][e] = s1[nt][e] = 0.f;
      if constexpr (MODE != kDX) {
        mu[e] = bnc[col + e];
        rs[e] = bnc[BN + col + e];
        ga[e] = bnc[2 * BN + col + e];
        be[e] = bnc[3 * BN + col + e];
      }
    }
    if (n >= N) continue;                  // N % 8 == 0: a pair is in or out
#pragma unroll
    for (int mt = 0; mt < Cfg::MT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = rr[mt][half];
        if (r >= p.rows.m) continue;
        const long long o = (long long)r * N + n;
        const float v[2] = {acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]};
        if constexpr (MODE == kDX) {
          store2(p.out0 + o, v[0], v[1]);
        } else {
          float res0[2], res1[2];
          float2 ax = {0.f, 0.f};
          if (aux_staged) {
            ax = load2(aux_s + (r - m0) * Cfg::BS + col);
          } else if constexpr (MODE == kY2) {   // g read channel by channel
            const long long g0 = go[mt][half];
            ax = make_float2(__bfloat162float(p.aux[g0 + n * p.g.cs]),
                             __bfloat162float(p.aux[g0 + (n + 1) * p.g.cs]));
          }
          const float axv[2] = {ax.x, ax.y};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if constexpr (MODE == kY1) {
              const float y = rnd_bf16(v[e]);
              const float z =
                  __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(y, mu[e]), rs[e]), ga[e]), be[e]);
              res0[e] = y;
              res1[e] = fmaxf(z, 0.f);
            } else if constexpr (MODE == kY2) {
              const float y = rnd_bf16(v[e]);
              const float xhat = __fmul_rn(__fsub_rn(y, mu[e]), rs[e]);
              const float dz = __fadd_rn(__fmul_rn(xhat, ga[e]), be[e]) > 0.f ? axv[e] : 0.f;
              res0[e] = y;
              s0[nt][e] += dz;
              s1[nt][e] = fmaf(dz, xhat, s1[nt][e]);
            } else {   // kDA: aux = y1
              const float da = rnd_bf16(v[e]);
              const float xhat = __fmul_rn(__fsub_rn(axv[e], mu[e]), rs[e]);
              const float dz = __fadd_rn(__fmul_rn(xhat, ga[e]), be[e]) > 0.f ? da : 0.f;
              res0[e] = dz;
              s0[nt][e] += dz;
              s1[nt][e] = fmaf(dz, xhat, s1[nt][e]);
            }
          }
          store2(p.out0 + o, res0[0], res0[1]);
          if constexpr (MODE == kY1) store2(p.out1 + o, res1[0], res1[1]);
        }
      }
    }
  }
  if constexpr (MODE == kY2 || MODE == kDA) {
    // the 8 lanes of one column pair (same lane & 3), then the WM warp rows,
    // each in a fixed order
#pragma unroll
    for (int nt = 0; nt < Cfg::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          s0[nt][e] += __shfl_xor_sync(0xffffffffu, s0[nt][e], off);
          s1[nt][e] += __shfl_xor_sync(0xffffffffu, s1[nt][e], off);
        }
    if (lane < 4) {
#pragma unroll
      for (int nt = 0; nt < Cfg::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = wn * Cfg::WTN + nt * 8 + 2 * lane + e;
          red[(wm * 2 + 0) * BN + col] = s0[nt][e];
          red[(wm * 2 + 1) * BN + col] = s1[nt][e];
        }
    }
    __syncthreads();
    for (int i = tid; i < 2 * BN; i += kConvThreads) {
      const int s = i / BN, col = i % BN, n = n0 + col;
      if (n >= N) continue;
      float tot = 0.f;
      for (int w = 0; w < Cfg::WM; ++w) tot += red[(w * 2 + s) * BN + col];
      p.partial[((long long)blockIdx.x * 2 + s) * N + n] = tot;
    }
  }
}

// one kernel name per product, so a trace splits the route by product
template <int BN>
__global__ void __launch_bounds__(kConvThreads, 2) sep_tc_p1_y1_kernel(ConvArgs p) {
  conv_tc<kY1, BN>(p);
}
template <int BN>
__global__ void __launch_bounds__(kConvThreads) sep_tc_p2_y2_kernel(ConvArgs p) {
  conv_tc<kY2, BN>(p);
}
template <int BN>
__global__ void __launch_bounds__(kConvThreads) sep_tc_p3_da_kernel(ConvArgs p) {
  conv_tc<kDA, BN>(p);
}
template <int BN>
__global__ void __launch_bounds__(kConvThreads, 2) sep_tc_p5_dx_kernel(ConvArgs p) {
  conv_tc<kDX, BN>(p);
}

// ---- weight-gradient products ------------------------------------------- //
constexpr int kTapsPerBlock = 3;   // taps sharing one staged D tile

struct WgradArgs {
  const bf16* A;       // [rows][K], read tap-shifted
  const bf16* D;       // [rows][N]
  int K, N;
  Rows rows;
  Taps taps;           // taps.n a multiple of kTapsPerBlock
  int ktiles, ntiles, rows_per_split;
  FastDiv d_thw, d_hw, d_w;
  float* partial;      // [splits][taps][K][N]
};

// partial[split][j][k][n] = sum over the split's rows r of A[shift_j(r), k] D[r, n].
// Grid (taps / 3 * ktiles * ntiles, splits): a block owns three taps (the
// three temporal taps, or one kh row of the spatial ones) of one WBM x WBN
// tile and stages each chunk's D rows once for the three; 4 warps as 2 x 2,
// each owning a (WBM / 2) x (WBN / 2) tile per tap.  Both operands are
// staged [row][channel], so both fragments come from ldmatrix.trans.
template <int WBM, int WBN>
struct WgradCfg {
  static constexpr int WTM = WBM / 2, WTN = WBN / 2;
  static constexpr int MT = WTM / 16, NT = WTN / 8;
  static constexpr int AS = WBM + kPad, DS = WBN + kPad;
  static constexpr int STAGES = kWgradStages;
  static constexpr int A_TILE = kBK * AS;
  static constexpr int STAGE = kTapsPerBlock * A_TILE + kBK * DS;
  static constexpr int SMEM = STAGES * STAGE * 2;
  static_assert(NT % 2 == 0, "D fragments are loaded two n8 tiles at a time");
};

template <int WBM, int WBN>
__device__ __forceinline__ void wgrad_tc(const WgradArgs& p) {
  using Cfg = WgradCfg<WBM, WBN>;
  constexpr int TPB = kTapsPerBlock;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int tiles = p.ktiles * p.ntiles;
  const int j0 = (blockIdx.x / tiles) * TPB, tile = blockIdx.x % tiles;
  const int k0 = (tile % p.ktiles) * WBM, n0 = (tile / p.ktiles) * WBN;
  const int split = blockIdx.y;
  const int r_begin = split * p.rows_per_split;
  const int r_end = min(p.rows.m, r_begin + p.rows_per_split);
  const int nchunks = r_end > r_begin ? (r_end - r_begin + kBK - 1) / kBK : 0;
  const int nw = p.rows.nw, hw = p.rows.nh * nw;

  auto load_stage = [&](int slot, int chunk) {
    bf16* As = smem + slot * Cfg::STAGE;
    bf16* Ds = As + TPB * Cfg::A_TILE;
    const int r0 = r_begin + chunk * kBK;
#pragma unroll
    for (int i = tid; i < kBK * WBM / 8; i += kWgradThreads) {
      const int rr = i / (WBM / 8), pc = i % (WBM / 8);
      const int r = r0 + rr, c = k0 + pc * 8;
      const bool in = r < r_end && c < p.K;
      int t = 0, h = 0, w = 0;
      if (in) {   // the row's (t, h, w), once for the three taps
        const int b = p.d_thw.div(r), rem = r - b * (p.rows.nt * hw);
        t = p.d_hw.div(rem);
        const int rem2 = rem - t * hw;
        h = p.d_w.div(rem2);
        w = rem2 - h * nw;
      }
#pragma unroll
      for (int u = 0; u < TPB; ++u) {
        const int j = j0 + u;
        const int dt = p.taps.dt[j], dh = p.taps.dh[j], dw = p.taps.dw[j];
        const bool ok = in && t + dt >= 0 && t + dt < p.rows.nt && h + dh >= 0 &&
                        h + dh < p.rows.nh && w + dw >= 0 && w + dw < nw;
        const long long src = (long long)(r + dt * hw + dh * nw + dw) * p.K + c;
        cp_async16(As + u * Cfg::A_TILE + rr * Cfg::AS + pc * 8, ok ? p.A + src : p.A, ok);
      }
    }
#pragma unroll
    for (int i = tid; i < kBK * WBN / 8; i += kWgradThreads) {
      const int rr = i / (WBN / 8), pc = i % (WBN / 8);
      const int r = r0 + rr, n = n0 + pc * 8;
      const bool ok = r < r_end && n < p.N;
      cp_async16(Ds + rr * Cfg::DS + pc * 8, ok ? p.D + ((long long)r * p.N + n) : p.D, ok);
    }
  };

  float acc[TPB][Cfg::MT][Cfg::NT][4];
#pragma unroll
  for (int u = 0; u < TPB; ++u)
#pragma unroll
    for (int i = 0; i < Cfg::MT; ++i)
#pragma unroll
      for (int jj = 0; jj < Cfg::NT; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[u][i][jj][e] = 0.f;

#pragma unroll
  for (int s = 0; s < Cfg::STAGES - 1; ++s) {
    if (s < nchunks) load_stage(s, s);
    cp_async_commit();
  }
  for (int kc = 0; kc < nchunks; ++kc) {
    cp_async_wait<Cfg::STAGES - 2>();
    __syncthreads();
    if (kc + Cfg::STAGES - 1 < nchunks)
      load_stage((kc + Cfg::STAGES - 1) % Cfg::STAGES, kc + Cfg::STAGES - 1);
    cp_async_commit();
    const bf16* As = smem + (kc % Cfg::STAGES) * Cfg::STAGE;
    const bf16* Ds = As + TPB * Cfg::A_TILE;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      unsigned bfr[Cfg::NT][2];
#pragma unroll
      for (int np = 0; np < Cfg::NT / 2; ++np) {
        unsigned r[4];
        ldsm_x4_t(r, Ds + (ks * 16 + (lane & 15)) * Cfg::DS + wn * Cfg::WTN + np * 16 +
                         (lane >> 4) * 8);
        bfr[2 * np][0] = r[0];
        bfr[2 * np][1] = r[1];
        bfr[2 * np + 1][0] = r[2];
        bfr[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int u = 0; u < TPB; ++u) {
        // A^T: matrix q of the x4 holds m offset (q & 1) * 8, k offset (q >> 1) * 8
        unsigned af[Cfg::MT][4];
#pragma unroll
        for (int mt = 0; mt < Cfg::MT; ++mt)
          ldsm_x4_t(af[mt], As + u * Cfg::A_TILE +
                                (ks * 16 + ((lane >> 4) << 3) + (lane & 7)) * Cfg::AS +
                                wm * Cfg::WTM + mt * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < Cfg::MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < Cfg::NT; ++nt)
            mma_bf16(acc[u][mt][nt], af[mt], bfr[nt][0], bfr[nt][1]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int u = 0; u < TPB; ++u) {
    float* out = p.partial + ((long long)split * p.taps.n + j0 + u) * p.K * p.N;
#pragma unroll
    for (int mt = 0; mt < Cfg::MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int k = k0 + wm * Cfg::WTM + mt * 16 + (lane >> 2) + 8 * half;
        if (k >= p.K) continue;
#pragma unroll
        for (int nt = 0; nt < Cfg::NT; ++nt) {
          const int n = n0 + wn * Cfg::WTN + nt * 8 + 2 * (lane & 3);
          if (n < p.N)
            *reinterpret_cast<float2*>(out + (long long)k * p.N + n) =
                make_float2(acc[u][mt][nt][2 * half], acc[u][mt][nt][2 * half + 1]);
        }
      }
  }
}

template <int WBM, int WBN>
__global__ void __launch_bounds__(kWgradThreads) sep_tc_p4_dwt_kernel(WgradArgs p) {
  wgrad_tc<WBM, WBN>(p);
}
template <int WBM, int WBN>
__global__ void __launch_bounds__(kWgradThreads) sep_tc_p6_dws_kernel(WgradArgs p) {
  wgrad_tc<WBM, WBN>(p);
}

// ---- the BN train backward, 8 channels (16 bytes) per thread ------------- //
// Same arithmetic as bn_bwd_kernel.  Thread g owns channel vector
// g % (N / 8) for good and walks rows g / (N / 8), + rows_per_step, ...;
// its BN constants stay in registers.  y and out are [rows][N]; src is
// read at its GView (16-byte loads where it allows them).
template <bool MASK>
__global__ void __launch_bounds__(256)
bn_bwd_vec_kernel(const bf16* y, const bf16* src, GView sv_,
                  const float* __restrict__ bn, const float* __restrict__ means, int N,
                  int rows, int rows_per_step, bf16* out) {
  const int nv = N / 8;
  const int gid = blockIdx.x * 256 + threadIdx.x;
  const int r0 = gid / nv, n0 = (gid - r0 * nv) * 8;
  if (r0 >= rows_per_step) return;
  float mu[8], rs[8], ga[8], be[8], al[8], mg[8], mx[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int n = n0 + e;
    mu[e] = bn[n];
    rs[e] = bn[N + n];
    ga[e] = bn[2 * N + n];
    be[e] = bn[3 * N + n];
    al[e] = __fmul_rn(ga[e], rs[e]);
    mg[e] = means[n];
    mx[e] = means[N + n];
  }
  for (int r = r0; r < rows; r += rows_per_step) {
    const uint4 yv = *reinterpret_cast<const uint4*>(y + (long long)r * N + n0);
    const long long so = sv_.row(r);
    uint4 sv;
    if (sv_.vec) {
      sv = *reinterpret_cast<const uint4*>(src + so + n0);
    } else {
      bf16* s8 = reinterpret_cast<bf16*>(&sv);
#pragma unroll
      for (int e = 0; e < 8; ++e) s8[e] = src[so + (long long)(n0 + e) * sv_.cs];
    }
    const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&yv);
    const __nv_bfloat162* sp = reinterpret_cast<const __nv_bfloat162*>(&sv);
    uint4 ov;
    __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(&ov);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 yf = __bfloat1622float2(yp[q]), sf = __bfloat1622float2(sp[q]);
      const float yy[2] = {yf.x, yf.y}, ss[2] = {sf.x, sf.y};
      float res[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 2 * q + e;
        const float xhat = __fmul_rn(__fsub_rn(yy[e], mu[c]), rs[c]);
        float dz = ss[e];
        if (MASK && !(__fadd_rn(__fmul_rn(xhat, ga[c]), be[c]) > 0.f)) dz = 0.f;
        res[e] = __fmul_rn(al[c], __fsub_rn(__fsub_rn(dz, mg[c]), __fmul_rn(xhat, mx[c])));
      }
      op[q] = __floats2bfloat162_rn(res[0], res[1]);
    }
    *reinterpret_cast<uint4*>(out + (long long)r * N + n0) = ov;
  }
}

}  // namespace tc
