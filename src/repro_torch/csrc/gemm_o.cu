// GEMM-O: the output projection with head sparsity (paper §3.5, Obs. 3, Eq. 3-4).
//
// Replaces repro/kernels/gemm_o.py::gemm_o_sparse_kernel (Pallas, TPU).
//
//   out[b, row] = bias[b, row] + sum_{h in head_ids[b,c,:head_cnt[b,c]]} O[b, h, row] @ W[h]
//
// for the rows of every slot c with head_cnt[b,c] > 0, row in the block
// row_ids[b,c]*bm + [0, bm). O (B, H, N, dh), W (H, dh, F), out (B, N, F)
// already holding the bias (the wrapper clones it once), row_ids/head_cnt
// (B, Cr), head_ids (B, Cr, H) int32.
//
// What bounds it on the H100: operations. Every live (row block, head) pair is
// a bm x dh x F product whose W_h slice is shared by all the row blocks that
// keep head h, so at the serving shapes the arithmetic intensity is far above
// the card's FLOP:byte ratio. Design: one bm x 128 output tile per block (the
// tile never spans two slots, so one head list drives the whole tile), the
// bias loaded as the accumulator's initial value, and the reduction walking
// only the slot's live heads, dh in 16-deep shared-memory slices. Padding
// slots (head_cnt == 0) exit before touching memory: they never store, so the
// bias of their duplicated row id is never overwritten. Live row ids are
// unique, so no two blocks write the same element.
#include "common.cuh"

namespace {

template <typename T, int BM>
__global__ void __launch_bounds__(fo::kThreads)
gemm_o_kernel(const T* __restrict__ o, const T* __restrict__ w, const int* __restrict__ row_ids,
              const int* __restrict__ head_ids, const int* __restrict__ head_cnt,
              T* __restrict__ out, int H, int N, int dh, int F, int Cr, int bm) {
  constexpr int TM = BM / 16;
  __shared__ fo::GemmSmem<BM> s;
  const int b = blockIdx.z, tiles = bm / BM;
  const int c = blockIdx.y / tiles, sub = blockIdx.y % tiles;
  const int n0 = blockIdx.x * fo::kBN;
  const int slot = b * Cr + c;
  const int hc = head_cnt[slot];
  if (hc == 0) return;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = row_ids[slot] * bm + sub * BM;
  T* ob = out + ((size_t)b * N + row0) * F;

  float acc[TM][fo::kTN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < fo::kTN; ++j) {
      const int n = n0 + tx + 16 * j;
      acc[i][j] = n < F ? fo::to_f(ob[(size_t)(ty + 16 * i) * F + n]) : 0.f;
    }

  for (int hh = 0; hh < hc; ++hh) {
    const int h = head_ids[(size_t)slot * H + hh];
    const T* oh = o + (((size_t)b * H + h) * N + row0) * dh;
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
void launch(const void* o, const void* w, const void* row_ids, const void* head_ids,
            const void* head_cnt, void* out, int B, int H, int N, int dh, int F, int Cr, int bm,
            cudaStream_t stream) {
  const dim3 grid((F + fo::kBN - 1) / fo::kBN, Cr * (bm / BM), B);
  gemm_o_kernel<T, BM><<<grid, fo::kThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(w), static_cast<const int*>(row_ids),
      static_cast<const int*>(head_ids), static_cast<const int*>(head_cnt), static_cast<T*>(out),
      H, N, dh, F, Cr, bm);
}

template <typename T>
int dispatch_bm(const void* o, const void* w, const void* row_ids, const void* head_ids,
                const void* head_cnt, void* out, int B, int H, int N, int dh, int F, int Cr,
                int bm, cudaStream_t st) {
  switch (bm) {
    case 16: launch<T, 16>(o, w, row_ids, head_ids, head_cnt, out, B, H, N, dh, F, Cr, bm, st); break;
    case 32: launch<T, 32>(o, w, row_ids, head_ids, head_cnt, out, B, H, N, dh, F, Cr, bm, st); break;
    case 64: launch<T, 64>(o, w, row_ids, head_ids, head_cnt, out, B, H, N, dh, F, Cr, bm, st); break;
    case 128: launch<T, 128>(o, w, row_ids, head_ids, head_cnt, out, B, H, N, dh, F, Cr, bm, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). ``out`` holds
// the bias on entry and the result on exit.
extern "C" int fo_gemm_o(int dtype, const void* o, const void* w, const void* row_ids,
                         const void* head_ids, const void* head_cnt, void* out, int B, int H,
                         int N, int dh, int F, int Cr, int bm, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == fo::kF32)
    rc = dispatch_bm<float>(o, w, row_ids, head_ids, head_cnt, out, B, H, N, dh, F, Cr, bm, st);
  else if (dtype == fo::kBF16)
    rc = dispatch_bm<__nv_bfloat16>(o, w, row_ids, head_ids, head_cnt, out, B, H, N, dh, F, Cr,
                                    bm, st);
  else
    rc = static_cast<int>(cudaErrorInvalidValue);
  return rc ? rc : static_cast<int>(cudaGetLastError());
}
