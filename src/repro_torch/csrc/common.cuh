// Shared pieces of the FlashOmni Hopper kernels: element conversion, the
// dtype codes of the C interface, the tags of the instance dispatch, and the
// register-blocked tile product that the sparse GEMMs (gemm_q.cu, gemm_o.cu)
// share.
//
// Every kernel reads its operands as T (float or bf16), converts to float
// on the way into shared memory and accumulates in float.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include <type_traits>

namespace fo {

enum DType { kF32 = 0, kBF16 = 1 };

// Type and value tags for the host-side dispatch over built instances: a
// generic lambda receives them and names the kernel template instance.
template <typename T> struct Tag { using type = T; };
template <int V> using Int = std::integral_constant<int, V>;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// Sparse-GEMM tile: a BM x kBN output tile per block of kThreads threads laid
// out as a 16 x 16 grid (ty, tx). Thread (ty, tx) owns rows ty + 16*i
// (i < BM/16) and columns tx + 16*j (j < kTN): strided ownership keeps the
// shared-memory reads of B conflict-free and the global stores coalesced.
// The reduction runs in kBK-deep slices staged in shared memory as float.
constexpr int kThreads = 256;
constexpr int kBN = 128;
constexpr int kBK = 16;
constexpr int kTN = kBN / 16;

template <int BM>
struct GemmSmem {
  float a[kBK][BM + 1];  // A slice, transposed; +1 keeps the column stores conflict-free
  float b[kBK][kBN];     // B slice
};

// acc[i][j] += sum_k a[k][ty + 16 i] * b[k][tx + 16 j] over one staged slice.
template <int BM>
__device__ __forceinline__ void tile_fma(const GemmSmem<BM>& s, float (&acc)[BM / 16][kTN],
                                         int ty, int tx) {
  constexpr int TM = BM / 16;
#pragma unroll
  for (int k = 0; k < kBK; ++k) {
    float a[TM], b[kTN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = s.a[k][ty + 16 * i];
#pragma unroll
    for (int j = 0; j < kTN; ++j) b[j] = s.b[k][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Stage B[k0:k0+kBK, n0:n0+kBN] of a row-major (K, F) matrix; zeros past the edges.
template <typename T, int BM>
__device__ __forceinline__ void load_b(GemmSmem<BM>& s, const T* __restrict__ b, int k0, int n0,
                                       int K, int F) {
  for (int idx = threadIdx.x; idx < kBK * kBN; idx += kThreads) {
    const int kr = idx / kBN, n = idx % kBN;
    const int k = k0 + kr, col = n0 + n;
    s.b[kr][n] = (k < K && col < F) ? to_f(b[(size_t)k * F + col]) : 0.f;
  }
}

}  // namespace fo
