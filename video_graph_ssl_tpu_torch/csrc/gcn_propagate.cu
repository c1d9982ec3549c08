// GCN frame-axis propagation for Hopper (sm_90a):
//
//     out[b, i, f] = sum_j A[b, i, j] * x[b, j, f],   f over H*W*C,
//     A = adj (transpose == 0) or adj^T (transpose == 1),
//
// with x and out in one dtype (bf16 or fp32), adj in fp32 or x's dtype
// and rounded to x's dtype on load (the contract's cast), fp32
// accumulation, the sum rounded once to x's dtype.
//
// Replaces the TPU kernel video_graph_ssl_tpu/ops/pallas/gcn_propagate.py
// (_propagate_pallas -> _propagate_kernel).  The TPU kernel had to read x in
// its (W, C) tiling to dodge an HBM relayout; here x is a plain row-major
// (B, T, F) view of the channels-last activation, so no relayout exists.
//
// What bounds it on the H100: bytes.  It does 2*T FLOPs per element it
// reads (T <= 32), far below the ~295 FLOP/byte ridge, so the floor is one
// read of x plus one write of out (at the first S3D aug point in bf16:
// 77 MB each way, 46 us).  Forming each output row from staged x vectors
// on the CUDA cores costs T^2 shared loads and T^2 * 8 conversions per 8
// columns, so instructions, not bytes, would set the time at T = 32.
//
// Two routes, chosen by the wrapper's plan (ops/gcn_propagate.py:
// propagate_plan):
//
//   tc (bf16 x, F a multiple of 8, 16-byte aligned): the product on the
//     tensor cores, mma.sync.m16n8k16 bf16 with fp32 accumulators -- the
//     contract's function exactly (bf16 operands, fp32 sums).  Each warp
//     takes a run of consecutive items of a flattened (clip, 64-column
//     slice) space, so no clip leaves a tail block.  A is adj[b] (or
//     adj[b]^T, read transposed, never materialised) padded to KPAD = 16
//     or 32 rows and columns with zeros, loaded into registers at each
//     clip the run enters.  x slices (T rows x 64 columns, 16-byte
//     cp.async, zero-filled past F) go through a ring of 4 slices per warp
//     in shared memory, the length of a run, so a run's loads are all in
//     flight at once; ldmatrix.trans reads them as the B operand, its rows
//     past T pointed at one zero row, so a slice holds only T rows and
//     small T keeps more warps in flight.  The
//     warp writes its bf16 results over its slice in shared memory and
//     then to device memory with 16-byte stores.  No block barrier: each
//     warp's ring is its own.
//   simt (fp32 x, or F ragged): a thread owns VEC columns (16 bytes, or 1
//     element) of one clip in the flattened (clip, column) space, holds
//     x[b, :, cols] in registers converted once, and forms the T output
//     rows from it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 4;               // warps per block, tc route
constexpr int kTcCols = 64;               // columns of a warp's slice
constexpr int kStages = 4;                // slices in a warp's ring
constexpr int kRowStride = kTcCols + 8;   // elements: 144 B, conflict-free ldmatrix
constexpr int kSimtThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// adj[idx] cast to T, as a float
template <typename T, typename A>
__device__ __forceinline__ float adj_as(const A* adj, long long idx) {
  return to_f(from_f<T>(to_f(adj[idx])));
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo (low half)
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- tc route
// A (KPAD x KPAD) as mma.sync A fragments: a[mt][kt][4], tile rows mt * 16,
// columns kt * 16.
template <int KPAD, typename A>
__device__ __forceinline__ void load_a(unsigned (&a)[KPAD / 16][KPAD / 16][4], const A* adj_b,
                                       int nt, int transpose, int lane) {
  const int g = lane >> 2, q = lane & 3;
  auto el = [&](int i, int j) -> float {
    if (i >= nt || j >= nt) return 0.f;
    return adj_as<bf16>(adj_b, transpose ? j * nt + i : i * nt + j);
  };
#pragma unroll
  for (int mt = 0; mt < KPAD / 16; ++mt)
#pragma unroll
    for (int kt = 0; kt < KPAD / 16; ++kt) {
      const int r = mt * 16 + g, c = kt * 16 + 2 * q;
      a[mt][kt][0] = pack_bf16(el(r, c), el(r, c + 1));
      a[mt][kt][1] = pack_bf16(el(r + 8, c), el(r + 8, c + 1));
      a[mt][kt][2] = pack_bf16(el(r, c + 8), el(r, c + 9));
      a[mt][kt][3] = pack_bf16(el(r + 8, c + 8), el(r + 8, c + 9));
    }
}

// A (clip, 64-column slice) position of a warp's run, advanced without a
// divide
struct Cursor {
  long long b;
  int tile;
  __device__ __forceinline__ void next(int col_tiles) {
    if (++tile == col_tiles) {
      tile = 0;
      ++b;
    }
  }
};

// x[b, :nt, c0 : c0 + 64] into a ring slice of nt rows (16-byte cp.async;
// chunks past F are zero-filled and their source clamped to x); one commit
// group per call, empty past the run
__device__ __forceinline__ void load_slice(bf16* slice, const bf16* x, Cursor c, bool live,
                                           int nt, long long F, int lane) {
  if (live) {
    const long long c0 = (long long)c.tile * kTcCols;
    const bf16* src = x + c.b * nt * F + c0;
    for (int e = lane; e < nt * (kTcCols / 8); e += 32) {
      const int row = e >> 3, chunk = e & 7;
      const bool in = c0 + chunk * 8 < F;
      const bf16* s = in ? src + row * F + chunk * 8 : x;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       smem_addr(slice + row * kRowStride + chunk * 8)),
                   "l"(s), "r"(in ? 16 : 0));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Warp w of the grid takes items [w * per_warp, (w + 1) * per_warp).  Its
// shared memory: one zero row, then kStages slices of nt rows x kRowStride.
// ldmatrix reads the KPAD rows of the B operand; rows nt .. KPAD read the
// zero row, so a slice holds only the clip's nt frames.
template <int KPAD, typename A>
__global__ void __launch_bounds__(kTcWarps * 32)
propagate_tc_kernel(const A* __restrict__ adj, const bf16* __restrict__ x,
                    bf16* __restrict__ out, int nt, long long F, int transpose,
                    long long items, int col_tiles, int per_warp) {
  constexpr int MT = KPAD / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* zero = reinterpret_cast<bf16*>(smem) + warp * (1 + kStages * nt) * kRowStride;
  bf16* ring = zero + kRowStride;
  if (lane < kRowStride / 8) reinterpret_cast<uint4*>(zero)[lane] = make_uint4(0u, 0u, 0u, 0u);

  const long long first = ((long long)blockIdx.x * kTcWarps + warp) * per_warp;
  const int n = (int)max(0LL, min(items, first + per_warp) - first);
  Cursor cur{first / col_tiles, (int)(first % col_tiles)};
  Cursor ld = cur;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    load_slice(ring + s * nt * kRowStride, x, ld, s < n, nt, F, lane);
    ld.next(col_tiles);
  }
  unsigned a[MT][MT][4];
  if (n > 0) load_a<KPAD>(a, adj + cur.b * nt * nt, nt, transpose, lane);
  long long a_b = cur.b;
  __syncwarp();   // the zero row is written

  const int g = lane >> 2, q = lane & 3;
  // ldmatrix row of this lane in each k half: frame k, or the zero row
  const int m = lane >> 3, r8 = lane & 7;
  for (int i = 0, stage = 0; i < n; ++i, stage = stage + 1 == kStages ? 0 : stage + 1) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    __syncwarp();
    if (cur.b != a_b) {
      load_a<KPAD>(a, adj + cur.b * nt * nt, nt, transpose, lane);
      a_b = cur.b;
    }
    bf16* slice = ring + stage * nt * kRowStride;
    float acc[MT][kTcCols / 8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nn = 0; nn < kTcCols / 8; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nn][e] = 0.f;
#pragma unroll
    for (int kt = 0; kt < MT; ++kt) {
      const int k = kt * 16 + (m & 1) * 8 + r8;
      const bf16* row = k < nt ? slice + k * kRowStride : zero;
#pragma unroll
      for (int np = 0; np < kTcCols / 16; ++np) {
        // four 8x8 matrices: k halves 0/1 of n-tiles 2np and 2np + 1
        unsigned b0, b1, b2, b3;
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                     : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
                     : "r"(smem_addr(row + np * 16 + (m >> 1) * 8)));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          float* c = acc[mt][2 * np];
          asm volatile(
              "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
              "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
              : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
              : "r"(a[mt][kt][0]), "r"(a[mt][kt][1]), "r"(a[mt][kt][2]), "r"(a[mt][kt][3]),
                "r"(b0), "r"(b1));
          float* d = acc[mt][2 * np + 1];
          asm volatile(
              "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
              "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
              : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
              : "r"(a[mt][kt][0]), "r"(a[mt][kt][1]), "r"(a[mt][kt][2]), "r"(a[mt][kt][3]),
                "r"(b2), "r"(b3));
        }
      }
    }
    __syncwarp();   // every lane's ldmatrix of the slice is done
    // the result's rows < nt over the slice
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nn = 0; nn < kTcCols / 8; ++nn) {
        const int rr = mt * 16 + g, col = nn * 8 + 2 * q;
        if (rr < nt)
          *reinterpret_cast<unsigned*>(slice + rr * kRowStride + col) =
              pack_bf16(acc[mt][nn][0], acc[mt][nn][1]);
        if (rr + 8 < nt)
          *reinterpret_cast<unsigned*>(slice + (rr + 8) * kRowStride + col) =
              pack_bf16(acc[mt][nn][2], acc[mt][nn][3]);
      }
    __syncwarp();
    const long long c0 = (long long)cur.tile * kTcCols;
    bf16* dst = out + cur.b * nt * F + c0;
    for (int e = lane; e < nt * (kTcCols / 8); e += 32) {
      const int row = e >> 3, chunk = e & 7;
      if (c0 + chunk * 8 < F)
        *reinterpret_cast<uint4*>(dst + row * F + chunk * 8) =
            *reinterpret_cast<const uint4*>(slice + row * kRowStride + chunk * 8);
    }
    __syncwarp();   // the slice is read out before the ring refills it
    const int fill = stage == 0 ? kStages - 1 : stage - 1;
    load_slice(ring + fill * nt * kRowStride, x, ld, i + kStages - 1 < n, nt, F, lane);
    ld.next(col_tiles);
    cur.next(col_tiles);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// -------------------------------------------------------------- simt route
template <typename T, typename A, int VEC, int TMAX>
__global__ void __launch_bounds__(kSimtThreads)
propagate_simt_kernel(const A* __restrict__ adj, const T* __restrict__ x, T* __restrict__ out,
                      int nt, long long F, int transpose, long long items, long long per_clip) {
  const long long it = (long long)blockIdx.x * kSimtThreads + threadIdx.x;
  if (it >= items) return;
  const long long b = it / per_clip;
  const long long col = (it - b * per_clip) * VEC;
  const T* xb = x + b * nt * F + col;
  T* ob = out + b * nt * F + col;
  const A* ab = adj + b * nt * nt;
  float xr[TMAX][VEC];
#pragma unroll
  for (int j = 0; j < TMAX; ++j) {
    if (j < nt) {
      const Pack<T, VEC> v = *reinterpret_cast<const Pack<T, VEC>*>(xb + j * F);
#pragma unroll
      for (int e = 0; e < VEC; ++e) xr[j][e] = to_f(v.v[e]);
    }
  }
  for (int i = 0; i < nt; ++i) {
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll
    for (int j = 0; j < TMAX; ++j) {
      if (j < nt) {
        const float w = adj_as<T>(ab, transpose ? j * nt + i : i * nt + j);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = fmaf(w, xr[j][e], acc[e]);
      }
    }
    Pack<T, VEC> o;
#pragma unroll
    for (int e = 0; e < VEC; ++e) o.v[e] = from_f<T>(acc[e]);
    *reinterpret_cast<Pack<T, VEC>*>(ob + i * F) = o;
  }
}

template <int KPAD, typename A>
int launch_tc(const void* adj, const void* x, void* out, int B, int nt, long long F,
              int transpose, int blocks, int per_warp, cudaStream_t st) {
  const int col_tiles = (int)((F + kTcCols - 1) / kTcCols);
  const long long items = (long long)B * col_tiles;
  const int smem = kTcWarps * (1 + kStages * nt) * kRowStride * (int)sizeof(bf16);
  auto kern = propagate_tc_kernel<KPAD, A>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<blocks, kTcWarps * 32, smem, st>>>(static_cast<const A*>(adj),
                                            static_cast<const bf16*>(x),
                                            static_cast<bf16*>(out), nt, F, transpose, items,
                                            col_tiles, per_warp);
  return (int)cudaGetLastError();
}

template <typename T, typename A, int VEC>
int launch_simt(const void* adj, const void* x, void* out, int B, int nt, long long F,
                int transpose, cudaStream_t st) {
  const long long per_clip = F / VEC, items = (long long)B * per_clip;
  const long long blocks = (items + kSimtThreads - 1) / kSimtThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const A* a = static_cast<const A*>(adj);
  const T* xx = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  if (nt <= 8)
    propagate_simt_kernel<T, A, VEC, 8><<<(unsigned)blocks, kSimtThreads, 0, st>>>(
        a, xx, o, nt, F, transpose, items, per_clip);
  else if (nt <= 16)
    propagate_simt_kernel<T, A, VEC, 16><<<(unsigned)blocks, kSimtThreads, 0, st>>>(
        a, xx, o, nt, F, transpose, items, per_clip);
  else
    propagate_simt_kernel<T, A, VEC, 32><<<(unsigned)blocks, kSimtThreads, 0, st>>>(
        a, xx, o, nt, F, transpose, items, per_clip);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// adj (B, T, T) in fp32 or x's dtype (adj_f32); x and out (B, T, F) of one
// dtype, all contiguous, T <= 32.  route 1 (tc: bf16, F % 8 == 0, x and out
// 16-byte aligned) with kpad (16 or 32), blocks and per_warp (items of a
// warp's run), or route 0 (simt) with
// vec (16 bytes for fp32, else 1), from the wrapper's plan
// (ops/gcn_propagate.py:propagate_plan).
extern "C" int vgs_gcn_propagate(const void* adj, const void* x, void* out, int B, int T,
                                 long long F, int transpose, int is_bf16, int adj_f32,
                                 int route, int kpad, int blocks, int per_warp, int vec,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T < 1 || T > 32 || B < 1 || F < 1) return (int)cudaErrorInvalidValue;
  const bool vec_ok = aligned16(x) && aligned16(out);
  if (route == 1) {
    const long long items = (long long)B * ((F + kTcCols - 1) / kTcCols);
    if (!is_bf16 || F % 8 || !vec_ok || blocks < 1 || per_warp < 1 || kpad < T ||
        (kpad != 16 && kpad != 32) || (long long)blocks * kTcWarps * per_warp < items)
      return (int)cudaErrorInvalidValue;
    if (kpad == 16)
      return adj_f32 ? launch_tc<16, float>(adj, x, out, B, T, F, transpose, blocks, per_warp, s)
                     : launch_tc<16, bf16>(adj, x, out, B, T, F, transpose, blocks, per_warp, s);
    return adj_f32 ? launch_tc<32, float>(adj, x, out, B, T, F, transpose, blocks, per_warp, s)
                   : launch_tc<32, bf16>(adj, x, out, B, T, F, transpose, blocks, per_warp, s);
  }
  const int esize = is_bf16 ? 2 : 4;
  if (vec != 1 && (vec * esize != 16 || F % vec || !vec_ok)) return (int)cudaErrorInvalidValue;
  if (is_bf16) {   // aligned bf16 with F % 8 == 0 takes the tc route
    if (vec != 1) return (int)cudaErrorInvalidValue;
    return adj_f32 ? launch_simt<bf16, float, 1>(adj, x, out, B, T, F, transpose, s)
                   : launch_simt<bf16, bf16, 1>(adj, x, out, B, T, F, transpose, s);
  }
  if (!adj_f32) return (int)cudaErrorInvalidValue;   // fp32 x takes fp32 adj
  if (vec == 4) return launch_simt<float, float, 4>(adj, x, out, B, T, F, transpose, s);
  return launch_simt<float, float, 1>(adj, x, out, B, T, F, transpose, s);
}
