// Warp-level primitives of the FlashOmni Hopper kernels, shared by the
// attention row body (attention_row.cuh) and the sparse-GEMM tile
// (gemm_tile.cuh): cp.async copies into shared memory, ldmatrix fragment
// loads, the mma.sync tensor-core products (bf16 m16n8k16 and TF32 m16n8k8)
// with the 3xTF32 split that gives f32 about f32 accuracy, the paired
// stores, a CSR list's bit mask, and the launch of a kernel that takes more
// than 48 KB of dynamic shared memory.
#pragma once

#include "common.cuh"

namespace fo {

constexpr size_t kSmemMax = 232448;     // dynamic shared memory a block may use (227 KB)

// ---- shared memory and cp.async ---------------------------------------------

__device__ __forceinline__ unsigned char* dyn_smem() {
  extern __shared__ __align__(16) unsigned char fo_smem[];
  return fo_smem;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void zero16(void* dst) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
}

// ---- fragments and products -------------------------------------------------

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a b on one m16n8k16 bf16 tile (f32 accumulators).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b on one m16n8k8 TF32 tile.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The two products above when p, else nothing; p must be the same in every
// lane of the warp. Predicated, not branched on: ptxas can then interleave
// the products of several tiles that each carry their own p.
__device__ __forceinline__ void mma_bf16_if(bool p, float (&c)[4], const unsigned (&a)[4],
                                            unsigned b0, unsigned b1) {
  asm("{\n.reg .pred q;\nsetp.ne.b32 q, %10, 0;\n"
      "@q mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n}\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"((int)p));
}
__device__ __forceinline__ void mma_tf32_if(bool p, float (&c)[4], const unsigned (&a)[4],
                                            unsigned b0, unsigned b1) {
  asm("{\n.reg .pred q;\nsetp.ne.b32 q, %10, 0;\n"
      "@q mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n}\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"((int)p));
}

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// c += a b in 3xTF32: the two small cross terms first, the large one last.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const unsigned (&ah)[4],
                                           const unsigned (&al)[4], unsigned bh0, unsigned bh1,
                                           unsigned bl0, unsigned bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---- list masks ---------------------------------------------------------------

// Warp-wide: the mask of a CSR list ids[0..n) (bit j of word j / 32 for
// each listed id j < limit); n = 0 clears it.
__device__ __forceinline__ void mask_from_list(unsigned* mask, int words,
                                               const int* __restrict__ ids, int n, int limit) {
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < words; i += 32) mask[i] = 0u;
  __syncwarp();
  for (int e = lane; e < n; e += 32) {
    const int j = ids[e];
    if ((unsigned)j < (unsigned)limit) atomicOr(&mask[j >> 5], 1u << (j & 31));
  }
  __syncwarp();
}

// ---- host side ----------------------------------------------------------------

// Raise a kernel's dynamic shared-memory limit and launch it; returns the
// attribute call's error, 0 otherwise.
template <typename Kernel, typename... Args>
int launch_with_smem(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t stream,
                     Args... args) {
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<grid, threads, smem, stream>>>(args...);
  return 0;
}

}  // namespace fo
