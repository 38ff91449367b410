// OP_reuse: the TaylorSeer forecast over the cached blocks only (paper §3.4,
// cache-then-reuse).
//
// Replaces repro/kernels/taylor_reuse.py::taylor_reuse_kernel (Pallas, TPU).
//
//   out[bh, ids[bh,c]*block + r, :] = sum_d coef[d] * derivs[d, bh, ids[bh,c]*block + r, :]
//                                                          for c < cnt[bh]
// derivs (D+1, BH, N, d) and out (BH, N, d) in float or bf16 (each its own),
// coef (D+1,) f32, ids (BH, Cc), cnt (BH,) int32. Every other block of
// ``out`` is left alone: the wrapper clones ``base`` into it first.
//
// What bounds it on the H100: bytes. Each element costs D+1 multiply-adds
// against (D+1) reads and one write, far below the card's FLOP:byte ratio.
// Design: one block of 256 threads per (bh, listed slot); neighbouring
// threads take neighbouring elements of the block's contiguous block*d
// span, so every load and store is coalesced. The sum runs in f32 as
// acc = coef[0]*d0, then acc = fmaf(coef[d], d_d, acc), and is rounded once
// into out's type. Slots c >= cnt return before any load: padding ids and a
// (b, h) with nothing cached cost nothing.
#include "common.cuh"

namespace {

template <typename TD, typename TO>
__global__ void __launch_bounds__(fo::kThreads)
taylor_reuse_kernel(const TD* __restrict__ derivs, const float* __restrict__ coef,
                    TO* __restrict__ out, const int* __restrict__ ids,
                    const int* __restrict__ cnt, int order1, int BH, int N, int d, int Cc,
                    int block) {
  const int c = blockIdx.x, bh = blockIdx.y;
  if (c >= cnt[bh]) return;
  const size_t span = (size_t)block * d;
  const size_t first = ((size_t)bh * N + (size_t)ids[bh * Cc + c] * block) * d;
  const size_t stride = (size_t)BH * N * d;  // between orders of the stack
  for (size_t idx = threadIdx.x; idx < span; idx += fo::kThreads) {
    const size_t off = first + idx;
    float acc = coef[0] * fo::to_f(derivs[off]);
    for (int o = 1; o < order1; ++o) acc = fmaf(coef[o], fo::to_f(derivs[o * stride + off]), acc);
    out[off] = fo::from_f<TO>(acc);
  }
}

template <typename TD, typename TO>
void launch(const void* derivs, const void* coef, void* out, const void* ids, const void* cnt,
            int order1, int BH, int N, int d, int Cc, int block, cudaStream_t st) {
  if (Cc == 0 || BH == 0) return;
  taylor_reuse_kernel<TD, TO><<<dim3(Cc, BH), fo::kThreads, 0, st>>>(
      static_cast<const TD*>(derivs), static_cast<const float*>(coef), static_cast<TO*>(out),
      static_cast<const int*>(ids), static_cast<const int*>(cnt), order1, BH, N, d, Cc, block);
}

template <typename TD>
int on_out_type(int out_dtype, const void* derivs, const void* coef, void* out, const void* ids,
                const void* cnt, int order1, int BH, int N, int d, int Cc, int block,
                cudaStream_t st) {
  if (out_dtype == fo::kF32)
    launch<TD, float>(derivs, coef, out, ids, cnt, order1, BH, N, d, Cc, block, st);
  else if (out_dtype == fo::kBF16)
    launch<TD, __nv_bfloat16>(derivs, coef, out, ids, cnt, order1, BH, N, d, Cc, block, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// Returns the launch's error code (0 on success). ``out`` holds base on
// entry; only the listed blocks are overwritten.
extern "C" int fo_taylor_reuse(int derivs_dtype, int out_dtype, const void* derivs,
                               const void* coef, void* out, const void* ids, const void* cnt,
                               int order1, int BH, int N, int d, int Cc, int block,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (derivs_dtype == fo::kF32)
    rc = on_out_type<float>(out_dtype, derivs, coef, out, ids, cnt, order1, BH, N, d, Cc, block,
                            st);
  else if (derivs_dtype == fo::kBF16)
    rc = on_out_type<__nv_bfloat16>(out_dtype, derivs, coef, out, ids, cnt, order1, BH, N, d, Cc,
                                    block, st);
  else
    rc = static_cast<int>(cudaErrorInvalidValue);
  return rc ? rc : static_cast<int>(cudaGetLastError());
}
