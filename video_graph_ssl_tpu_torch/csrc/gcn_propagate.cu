// GCN frame-axis propagation for Hopper (sm_90a):
//
//     out[b, i, f] = sum_j A[b, i, j] * x[b, j, f],   f over H*W*C,
//     A = adj (transpose == 0) or adj^T (transpose == 1),
//
// with x, adj and out in one dtype (bf16 or fp32) and fp32 accumulation.
//
// Replaces the TPU kernel video_graph_ssl_tpu/ops/pallas/gcn_propagate.py
// (_propagate_pallas -> _propagate_kernel).  The TPU kernel had to read x in
// its (W, C) tiling to dodge an HBM relayout; here x is a plain row-major
// (B, T, F) view of the channels-last activation, so no relayout exists.
//
// What bounds it on the H100: bytes.  It does 2*T FLOPs per element it
// reads (T <= 32), far below the ~295 FLOP/byte ridge, so the floor is one
// read of x plus one write of out (at the first S3D aug point in bf16:
// 77 MB each way).  Design: grid (F chunks, B); each block stages adj[b]
// (T x T, fp32) in shared memory, each thread owns VEC contiguous columns
// (16-byte loads and stores when F allows) and stages its x[b, :, cols]
// column in shared memory rather than in registers, so T = 32 does not
// spill; every output row i is then a T-term dot product over that column.
// The transpose flag reads adj[b, j, i], so the backward's dx runs this
// kernel without materialising adj^T.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
propagate_kernel(const T* __restrict__ adj, const T* __restrict__ x,
                 T* __restrict__ out, int nt, long long F, int transpose,
                 int adj_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* a_s = reinterpret_cast<float*>(smem);
  Pack<T, VEC>* x_s = reinterpret_cast<Pack<T, VEC>*>(smem + adj_bytes);

  const int b = blockIdx.y;
  const T* adj_b = adj + (long long)b * nt * nt;
  for (int e = threadIdx.x; e < nt * nt; e += kThreads) {
    const int i = e / nt, j = e - i * nt;
    a_s[e] = to_f(transpose ? adj_b[j * nt + i] : adj_b[e]);
  }

  // F % VEC == 0 (the host picks VEC so), so col < F means col + VEC <= F
  const long long col = ((long long)blockIdx.x * kThreads + threadIdx.x) * VEC;
  const bool active = col < F;
  const T* xb = x + (long long)b * nt * F + col;
  T* ob = out + (long long)b * nt * F + col;
  if (active) {
    for (int j = 0; j < nt; ++j)
      x_s[j * kThreads + threadIdx.x] =
          *reinterpret_cast<const Pack<T, VEC>*>(xb + (long long)j * F);
  }
  __syncthreads();
  if (!active) return;

  for (int i = 0; i < nt; ++i) {
    float acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
    for (int j = 0; j < nt; ++j) {
      const float a = a_s[i * nt + j];
      const Pack<T, VEC> xv = x_s[j * kThreads + threadIdx.x];
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] = fmaf(a, to_f(xv.v[v]), acc[v]);
    }
    Pack<T, VEC> o;
#pragma unroll
    for (int v = 0; v < VEC; ++v) o.v[v] = from_f<T>(acc[v]);
    *reinterpret_cast<Pack<T, VEC>*>(ob + (long long)i * F) = o;
  }
}

template <typename T, int VEC>
int launch(const void* adj, const void* x, void* out, int B, int nt,
           long long F, int transpose, cudaStream_t stream) {
  const int adj_bytes = (int)align16(sizeof(float) * nt * nt);
  const size_t smem = adj_bytes + sizeof(Pack<T, VEC>) * nt * kThreads;
  auto kern = propagate_kernel<T, VEC>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long per_block = (long long)kThreads * VEC;
  dim3 grid((unsigned)((F + per_block - 1) / per_block), (unsigned)B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(adj), static_cast<const T*>(x), static_cast<T*>(out),
      nt, F, transpose, adj_bytes);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// adj (B, T, T), x and out (B, T, F), all of one dtype, contiguous.
extern "C" int vgs_gcn_propagate(const void* adj, const void* x, void* out,
                                 int B, int T, long long F, int transpose,
                                 int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec_ok = aligned16(x) && aligned16(out);
  if (is_bf16) {
    if (vec_ok && F % 8 == 0)
      return launch<__nv_bfloat16, 8>(adj, x, out, B, T, F, transpose, s);
    return launch<__nv_bfloat16, 1>(adj, x, out, B, T, F, transpose, s);
  }
  if (vec_ok && F % 4 == 0)
    return launch<float, 4>(adj, x, out, B, T, F, transpose, s);
  return launch<float, 1>(adj, x, out, B, T, F, transpose, s);
}
