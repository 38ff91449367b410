// FlashOmni CSR sparse attention (paper §3.4, Algorithm 1 over per-row CSR lists).
//
// Replaces repro/kernels/flashomni_attention.py::flashomni_attention_csr (Pallas, TPU).
//
// For every (bh, slot c) with c < q_cnt[bh]:
//   Q block  = q[bh, q_src[bh,c]*BQ : +BQ]            (compact GEMM-Q layout or full)
//   for j < kv_cnt[bh,c], ascending:  kb = kv_ids[bh,c,j]
//     S = Q K[bh, kb*bkv : +bkv]^T * scale ; online softmax in f32 ; acc += P V
//   out[bh, q_ids[bh,c]*BQ : +BQ] = acc / l            (zeros when l == 0)
// Rows of slots c >= q_cnt[bh] are never written, so they keep the o_reuse
// values the wrapper cloned into ``out``: this covers both the duplicated
// padding ids and a (b, h) whose rows are all cached.
//
// What bounds it on the H100: operations at the serving shapes (head_dim 128,
// 16 x 16 tiles: each K/V byte staged feeds BQ rows of work, and most rows
// keep hundreds of KV blocks), though small tiles keep the intensity modest.
// Design: one block of 256 threads per live (bh, q block), looping over the
// row's own KV list in the reference's ascending order so the online-softmax
// reduction order matches it. The per-row body is attend_row
// (attention_row.cuh), shared with the bucketed kernel
// (flashomni_attention_bucketed.cu), which therefore gives the same bits.
#include "attention_row.cuh"

namespace {

template <typename T, int D, int BQ>
__global__ void __launch_bounds__(fo::kThreads)
csr_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ out, const int* __restrict__ q_ids,
                     const int* __restrict__ q_src, const int* __restrict__ q_cnt,
                     const int* __restrict__ kv_ids, const int* __restrict__ kv_cnt, int Nq,
                     int Nkv, int N, int Cq, int Ckv, int bkv, float scale) {
  const int c = blockIdx.x, bh = blockIdx.y;
  if (c >= q_cnt[bh]) return;
  const int slot = bh * Cq + c;
  fo::attend_row<T, D, BQ>(q + ((size_t)bh * Nq + (size_t)q_src[slot] * BQ) * D,
                           k + (size_t)bh * Nkv * D, v + (size_t)bh * Nkv * D,
                           kv_ids + (size_t)slot * Ckv, kv_cnt[slot],
                           out + ((size_t)bh * N + (size_t)q_ids[slot] * BQ) * D, bkv, scale);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). ``out`` holds
// o_reuse on entry; only the rows of live q slots are overwritten.
extern "C" int fo_csr_attention(int dtype, const void* q, const void* k, const void* v, void* out,
                                const void* q_ids, const void* q_src, const void* q_cnt,
                                const void* kv_ids, const void* kv_cnt, int BH, int Nq, int Nkv,
                                int N, int d, int Cq, int Ckv, int bq, int bkv, float scale,
                                void* stream) {
  if (!fo::kv_block_built(bkv)) return static_cast<int>(cudaErrorInvalidValue);
  const int rc = fo::on_attention_instance(dtype, d, bq, [&](auto t, auto dd, auto bb) {
    using T = typename decltype(t)::type;
    constexpr int D = decltype(dd)::value, BQ = decltype(bb)::value;
    return fo::launch_rows(csr_attention_kernel<T, D, BQ>, dim3(Cq, BH),
                           fo::attention_smem_bytes(D, BQ, bkv),
                           static_cast<cudaStream_t>(stream), static_cast<const T*>(q),
                           static_cast<const T*>(k), static_cast<const T*>(v),
                           static_cast<T*>(out), static_cast<const int*>(q_ids),
                           static_cast<const int*>(q_src), static_cast<const int*>(q_cnt),
                           static_cast<const int*>(kv_ids), static_cast<const int*>(kv_cnt), Nq,
                           Nkv, N, Cq, Ckv, bkv, scale);
  });
  return rc ? rc : static_cast<int>(cudaGetLastError());
}
