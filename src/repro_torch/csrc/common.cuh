// Shared pieces of the FlashOmni Hopper kernels: element conversion, the
// dtype codes of the C interface, the tags of the instance dispatch and the
// block size. The warp-level tensor-core primitives are in mma.cuh.
//
// Every kernel reads its operands as T (float or bf16) and accumulates in
// float.
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
template <bool V> using Bool = std::integral_constant<bool, V>;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

constexpr int kThreads = 256;    // threads of a full block (8 warps)

}  // namespace fo
