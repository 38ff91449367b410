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
// (B*Cr*bm = 6912 rows, K = F = 3072) each weight byte is reused thousands
// of times, far above the card's FLOP:byte ratio: the tensor cores decide,
// through three TF32 products per f32 product in f32. The first version ran
// an 8 x 8 register block of fmaf on the CUDA cores, which cuBLAS's SGEMM
// beats in f32 and which gained nothing from bf16.
// Design: a plain tensor-core GEMM with a row-block gather, on the shared
// tile (gemm_tile.cuh): a 128 x 256 (f32) or 128 x 128 (bf16) output tile
// per block of 8 warps, 3xTF32 or bf16 mma.sync, the K slices staged by
// cp.async 4 or 3 deep. Each
// slot's bm source rows are contiguous in x, so the tile's 128 rows are
// 128 / bm contiguous runs: their source pointers are resolved once, before
// the K loop, into a table in shared memory, and gathered rows cost what
// contiguous ones do. Live slots come first, so the live rows of a tile are
// a prefix: padding rows stage as zeros, an m16 tile of padding skips its
// products, a tile made only of padding skips the reduction and stores
// zeros.
#include "gemm_tile.cuh"

namespace {

template <typename T, bool kVec>
__global__ void __launch_bounds__(fo::kThreads, fo::Tile<T>::kBlocks)
gemm_q_kernel(const T* __restrict__ x, const T* __restrict__ w, const int* __restrict__ row_ids,
              const int* __restrict__ row_cnt, T* __restrict__ out, int N, int K, int F, int Cr,
              int bm) {
  using L = fo::Tile<T>;
  const int b = blockIdx.z, m0 = blockIdx.y * L::BM, n0 = blockIdx.x * L::BN;
  const int M = Cr * bm, live_rows = min(M, row_cnt[b] * bm);   // live rows: m < live_rows
  fo::Acc<T> acc;
  fo::zero_acc<T>(acc);

  if (m0 < live_rows) {
    const T** rows = reinterpret_cast<const T**>(fo::dyn_smem() + L::kRing);
    for (int r = threadIdx.x; r < L::BM; r += fo::kThreads) {
      const int m = m0 + r;
      rows[r] = m < live_rows
                    ? x + ((size_t)b * N + (size_t)row_ids[b * Cr + m / bm] * bm + m % bm) * K
                    : nullptr;
    }
    __syncthreads();
    const unsigned live = fo::warp_live<T>([&](int r) { return m0 + r < live_rows; });
    fo::tile_mainloop<T>(
        L::iters(K),
        [&](int it, T* as, T* bs) {
          fo::stage_a<T, kVec>(as, [&](int r) { return rows[r]; }, it * L::BK, K);
          fo::stage_b<T, kVec>(bs, w, it * L::BK, K, n0, F);
        },
        [&](int) { return live; }, acc);
  }

  T* ob = out + (size_t)b * M * F;
  fo::tile_pairs<T>(acc, [&](int r, int c, float v0, float v1) {
    const int m = m0 + r;
    if (m >= M) return;
    const bool lv = m < live_rows;
    fo::store_pair<T, kVec>(ob + (size_t)m * F, n0 + c, F, lv ? v0 : 0.f, lv ? v1 : 0.f);
  });
}

}  // namespace

// vec: 1 when x and W start on 16-byte boundaries and their rows (K and F
// elements) are multiples of 16 bytes (16-byte cp.async staging), else 0.
// Returns the launch's error code (0 on success).
extern "C" int fo_gemm_q(int dtype, int vec, const void* x, const void* w, const void* row_ids,
                         const void* row_cnt, void* out, int B, int N, int K, int F, int Cr,
                         int bm, void* stream) {
  const int rc = fo::on_gemm_instance(dtype, vec, [&](auto t, auto v) {
    using T = typename decltype(t)::type;
    using L = fo::Tile<T>;
    const dim3 grid((F + L::BN - 1) / L::BN, (Cr * bm + L::BM - 1) / L::BM, B);
    return fo::launch_with_smem(
        gemm_q_kernel<T, decltype(v)::value>, grid, fo::kThreads,
        L::kRing + L::BM * sizeof(const T*), static_cast<cudaStream_t>(stream),
        static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const int*>(row_ids),
        static_cast<const int*>(row_cnt), static_cast<T*>(out), N, K, F, Cr, bm);
  });
  return rc ? rc : static_cast<int>(cudaGetLastError());
}
