// GEMM-Q: the compact row-gathered query projection (paper §3.5, Obs. 2).
//
// Replaces repro/kernels/gemm_q.py::gemm_q_sparse_kernel (Pallas, TPU).
//
//   out[b, c*bm + r, :] = x[b, row_ids[b, c]*bm + r, :] @ W    for c <  row_cnt[b]
//                       = 0                                    for c >= row_cnt[b]
//
// x (B, N, K), W (K, F), row_ids (B, Cr), row_cnt (B,) int32 -> out (B, Cr*bm, F).
//
// What bounds it on the H100: operations. At the serving shapes
// (B*Cr*bm = 6912 rows, K = F = 3072) each weight byte is reused thousands of
// times, far above the card's FLOP:byte ratio, so the multiply-add rate decides.
// Design: one 128 x 128 output tile per block, an 8 x 8 register block per
// thread, the reduction staged through shared memory 16 deep. The gather is
// free: each thread resolves its source rows once, before the reduction loop,
// so gathered rows cost the same as contiguous ones. Padding slots are not
// multiplied (their A rows stage as zeros) and a tile made only of padding
// slots skips the reduction and stores zeros. f32 runs on the CUDA cores: the
// tensor cores would round the operands to TF32. wgmma and TMA are later work.
#include "common.cuh"

namespace {

constexpr int BM = 128;
constexpr int TM = BM / 16;

template <typename T>
__global__ void __launch_bounds__(fo::kThreads)
gemm_q_kernel(const T* __restrict__ x, const T* __restrict__ w, const int* __restrict__ row_ids,
              const int* __restrict__ row_cnt, T* __restrict__ out, int N, int K, int F, int Cr,
              int bm) {
  __shared__ fo::GemmSmem<BM> s;
  const int b = blockIdx.z, m0 = blockIdx.y * BM, n0 = blockIdx.x * fo::kBN;
  const int M = Cr * bm, cnt = row_cnt[b];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[TM][fo::kTN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < fo::kTN; ++j) acc[i][j] = 0.f;

  // Live slots come first, so a tile whose first slot is padding is all padding.
  if (m0 / bm < cnt) {
    const T* xb = x + (size_t)b * N * K;
    const T* src[TM];  // source row of each owned row, nullptr for padding
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + ty + 16 * i, slot = m / bm;
      src[i] = (m < M && slot < cnt)
                   ? xb + ((size_t)row_ids[b * Cr + slot] * bm + m % bm) * K
                   : nullptr;
    }
    for (int k0 = 0; k0 < K; k0 += fo::kBK) {
      const int k = k0 + tx;
#pragma unroll
      for (int i = 0; i < TM; ++i)
        s.a[tx][ty + 16 * i] = (src[i] != nullptr && k < K) ? fo::to_f(src[i][k]) : 0.f;
      fo::load_b<T, BM>(s, w, k0, n0, K, F);
      __syncthreads();
      fo::tile_fma<BM>(s, acc, ty, tx);
      __syncthreads();
    }
  }

  T* ob = out + (size_t)b * M * F;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
    const bool live = m / bm < cnt;
#pragma unroll
    for (int j = 0; j < fo::kTN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < F) ob[(size_t)m * F + n] = fo::from_f<T>(live ? acc[i][j] : 0.f);
    }
  }
}

template <typename T>
void launch(const void* x, const void* w, const void* row_ids, const void* row_cnt, void* out,
            int B, int N, int K, int F, int Cr, int bm, cudaStream_t stream) {
  const dim3 grid((F + fo::kBN - 1) / fo::kBN, (Cr * bm + BM - 1) / BM, B);
  gemm_q_kernel<T><<<grid, fo::kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const int*>(row_ids),
      static_cast<const int*>(row_cnt), static_cast<T*>(out), N, K, F, Cr, bm);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int fo_gemm_q(int dtype, const void* x, const void* w, const void* row_ids,
                         const void* row_cnt, void* out, int B, int N, int K, int F, int Cr,
                         int bm, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == fo::kF32)
    launch<float>(x, w, row_ids, row_cnt, out, B, N, K, F, Cr, bm, st);
  else if (dtype == fo::kBF16)
    launch<__nv_bfloat16>(x, w, row_ids, row_cnt, out, B, N, K, F, Cr, bm, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
