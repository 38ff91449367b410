// GEMM-O: the output projection with head sparsity (paper §3.5, Obs. 3, Eq. 3-4),
// uniform and occupancy-bucketed row layouts.
//
// Replaces repro/kernels/gemm_o.py::gemm_o_sparse_kernel (B3) and
// ::gemm_o_sparse_bucketed_kernel (B5) (Pallas, TPU).
//
//   out[b, row] = bias[b, row] + sum_{h in the slot's head list} O[b, h, row] @ W[h]
//
// O (B, H, N, dh), W (H, dh, F), out (B, N, F) already holding the bias (the
// wrapper clones it once). Uniform (B3): slot c of batch b covers row block
// row_ids[b,c] with heads head_ids[b,c,:head_cnt[b,c]] (row_ids/head_cnt
// (B, Cr), head_ids (B, Cr, H)). Bucketed (B5): the plan sorted the slots by
// live-head count; slot r reads O at row block src[b,r], writes block
// rows[b,r], with heads head_ids[b, row_off[r] : + head_cnt[b,r]] in the same
// ascending order as B3's lists (rows/src/head_cnt (B, Cr), head_ids (B, S),
// row_off (Cr,)). Both kernels run heads_tile below, so on the same plan B5
// gives B3's bits.
//
// What bounds it on the H100: operations. Every live (row block, head) pair is
// a bm x dh x F product whose W_h slice is shared by all the row blocks that
// keep head h, so at the serving shapes the arithmetic intensity is far above
// the card's FLOP:byte ratio. Design: one bm x 128 output tile per block (the
// tile never spans two slots, so one head list drives the whole tile), the
// bias loaded as the accumulator's initial value, and the reduction walking
// only the slot's live heads, dh in 16-deep shared-memory slices. Slots with
// no head (padding or dead) exit before touching memory: they never store, so
// the bias of their row is never overwritten. Live row ids are unique, so no
// two blocks write the same element.
#include "common.cuh"

namespace {

// One BM x kBN tile at output rows [row0, row0 + BM) of ob (= out at batch b),
// O rows [src0, src0 + BM) of ob_o (= O at batch b), over the heads
// hids[0..hc), accumulated from the bias already in ob.
template <typename T, int BM>
__device__ __forceinline__ void heads_tile(const T* __restrict__ o_b, const T* __restrict__ w,
                                           const int* __restrict__ hids, int hc, int src0,
                                           T* __restrict__ ob, int N, int dh, int F, int n0) {
  constexpr int TM = BM / 16;
  __shared__ fo::GemmSmem<BM> s;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[TM][fo::kTN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < fo::kTN; ++j) {
      const int n = n0 + tx + 16 * j;
      acc[i][j] = n < F ? fo::to_f(ob[(size_t)(ty + 16 * i) * F + n]) : 0.f;
    }

  for (int hh = 0; hh < hc; ++hh) {
    const int h = hids[hh];
    const T* oh = o_b + ((size_t)h * N + src0) * dh;
    const T* wh = w + (size_t)h * dh * F;
    for (int k0 = 0; k0 < dh; k0 += fo::kBK) {
      const int k = k0 + tx;
#pragma unroll
      for (int i = 0; i < TM; ++i)
        s.a[tx][ty + 16 * i] = k < dh ? fo::to_f(oh[(size_t)(ty + 16 * i) * dh + k]) : 0.f;
      fo::load_b<T, BM>(s, wh, k0, n0, dh, F);
      __syncthreads();
      fo::tile_fma<BM>(s, acc, ty, tx);
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < fo::kTN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < F) ob[(size_t)(ty + 16 * i) * F + n] = fo::from_f<T>(acc[i][j]);
    }
}

template <typename T, int BM>
__global__ void __launch_bounds__(fo::kThreads)
gemm_o_kernel(const T* __restrict__ o, const T* __restrict__ w, const int* __restrict__ row_ids,
              const int* __restrict__ head_ids, const int* __restrict__ head_cnt,
              T* __restrict__ out, int H, int N, int dh, int F, int Cr, int bm) {
  const int b = blockIdx.z, tiles = bm / BM;
  const int c = blockIdx.y / tiles, sub = blockIdx.y % tiles;
  const int slot = b * Cr + c;
  const int hc = head_cnt[slot];
  if (hc == 0) return;
  const int row0 = row_ids[slot] * bm + sub * BM;
  heads_tile<T, BM>(o + (size_t)b * H * N * dh, w, head_ids + (size_t)slot * H, hc, row0,
                    out + ((size_t)b * N + row0) * F, N, dh, F, blockIdx.x * fo::kBN);
}

template <typename T, int BM>
__global__ void __launch_bounds__(fo::kThreads)
gemm_o_bucketed_kernel(const T* __restrict__ o, const T* __restrict__ w,
                       const int* __restrict__ rows, const int* __restrict__ src,
                       const int* __restrict__ head_ids, const int* __restrict__ head_cnt,
                       const int* __restrict__ row_off, T* __restrict__ out, int H, int N,
                       int dh, int F, int Cr, int S, int bm) {
  const int b = blockIdx.z, tiles = bm / BM;
  const int r = blockIdx.y / tiles, sub = blockIdx.y % tiles;
  const int slot = b * Cr + r;
  const int hc = head_cnt[slot];
  if (hc == 0) return;
  const int dst0 = rows[slot] * bm + sub * BM;
  heads_tile<T, BM>(o + (size_t)b * H * N * dh, w, head_ids + (size_t)b * S + row_off[r], hc,
                    src[slot] * bm + sub * BM, out + ((size_t)b * N + dst0) * F, N, dh, F,
                    blockIdx.x * fo::kBN);
}

// Calls f(Tag<T>{}, Int<BM>{}) for the built element type and row block, or
// returns cudaErrorInvalidValue.
template <typename T, typename F>
int on_block_rows(int bm, F& f) {
  switch (bm) {
    case 16: return f(fo::Tag<T>{}, fo::Int<16>{});
    case 32: return f(fo::Tag<T>{}, fo::Int<32>{});
    case 64: return f(fo::Tag<T>{}, fo::Int<64>{});
    case 128: return f(fo::Tag<T>{}, fo::Int<128>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename F>
int on_gemm_o_instance(int dtype, int bm, F&& f) {
  if (dtype == fo::kF32) return on_block_rows<float>(bm, f);
  if (dtype == fo::kBF16) return on_block_rows<__nv_bfloat16>(bm, f);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Grid: F tiles x (slots x row tiles of the block) x B.
dim3 grid_of(int B, int F, int Cr, int bm, int BM) {
  return dim3((F + fo::kBN - 1) / fo::kBN, Cr * (bm / BM), B);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). ``out`` holds
// the bias on entry and the result on exit.
extern "C" int fo_gemm_o(int dtype, const void* o, const void* w, const void* row_ids,
                         const void* head_ids, const void* head_cnt, void* out, int B, int H,
                         int N, int dh, int F, int Cr, int bm, void* stream) {
  const int rc = on_gemm_o_instance(dtype, bm, [&](auto t, auto m) {
    using T = typename decltype(t)::type;
    constexpr int BM = decltype(m)::value;
    gemm_o_kernel<T, BM><<<grid_of(B, F, Cr, bm, BM), fo::kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(o), static_cast<const T*>(w), static_cast<const int*>(row_ids),
        static_cast<const int*>(head_ids), static_cast<const int*>(head_cnt),
        static_cast<T*>(out), H, N, dh, F, Cr, bm);
    return 0;
  });
  return rc ? rc : static_cast<int>(cudaGetLastError());
}

// The bucketed layout: rows/src/head_cnt (B, Cr), head_ids (B, S), row_off
// (Cr,) int32. Returns cudaGetLastError() after the launch. ``out`` holds the
// bias on entry and the result on exit.
extern "C" int fo_gemm_o_bucketed(int dtype, const void* o, const void* w, const void* rows,
                                  const void* src, const void* head_ids, const void* head_cnt,
                                  const void* row_off, void* out, int B, int H, int N, int dh,
                                  int F, int Cr, int S, int bm, void* stream) {
  const int rc = on_gemm_o_instance(dtype, bm, [&](auto t, auto m) {
    using T = typename decltype(t)::type;
    constexpr int BM = decltype(m)::value;
    gemm_o_bucketed_kernel<T, BM><<<grid_of(B, F, Cr, bm, BM), fo::kThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(o), static_cast<const T*>(w), static_cast<const int*>(rows),
        static_cast<const int*>(src), static_cast<const int*>(head_ids),
        static_cast<const int*>(head_cnt), static_cast<const int*>(row_off),
        static_cast<T*>(out), H, N, dh, F, Cr, S, bm);
    return 0;
  });
  return rc ? rc : static_cast<int>(cudaGetLastError());
}
