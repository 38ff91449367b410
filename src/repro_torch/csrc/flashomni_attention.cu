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
// What bounds it on the H100: operations at the serving shapes (head_dim
// 128, 16 x 16 tiles, about 250 of 288 KV blocks live per row): the tensor
// cores in bf16, and in f32 the 3xTF32 split's three TF32 products. What
// held the first version back was the path to them: one dot product per
// thread from shared memory, a row softmax on 16 of 256 threads, and each
// staged KV block feeding only 16 query rows (8 FLOP per byte moved from L2).
// Design: a block of 8 warps takes 128 query rows of ONE bh, the 128 / BQ
// consecutive slots starting at blockIdx.x * 128 / BQ, each warp one 16-row
// slice; the block walks the union of their KV lists and stages each KV
// block once for all of them (attention_row.cuh), so the L2 traffic falls
// by about 8 at flashomni's density. A slot >= q_cnt[bh] is an idle warp.
// The per-warp update is warp_update (attention_row.cuh), shared with the
// bucketed and the symbols kernels, which therefore give the same bits.
#include "attention_row.cuh"

namespace {

template <typename T, int D, int BKV>
__global__ void __launch_bounds__(fo::kThreads, fo::RowLayout<T, D, BKV>::kBlocks)
csr_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ out, const int* __restrict__ q_ids,
                     const int* __restrict__ q_src, const int* __restrict__ q_cnt,
                     const int* __restrict__ kv_ids, const int* __restrict__ kv_cnt, int Nq,
                     int Nkv, int N, int Cq, int Ckv, int BQ, float scale,
                     unsigned long long* __restrict__ walk) {
  const int bh = blockIdx.y, spq = BQ / fo::kRows;      // warps per q block
  const int c0 = blockIdx.x * (fo::kWarps / spq);
  const int cnt = q_cnt[bh];
  if (c0 >= cnt) return;                                // the whole block is idle
  const int w = threadIdx.x >> 5, c = c0 + w / spq, sl = w % spq;
  const int tkv = Nkv / BKV;
  const bool live = c < cnt;
  const int slot = bh * Cq + (live ? c : c0);
  fo::mask_from_list(fo::warp_mask<T, D, BKV>(tkv), fo::RowLayout<T, D, BKV>::words(tkv),
                     kv_ids + (size_t)slot * Ckv, live ? kv_cnt[slot] : 0, tkv);
  const size_t row = (size_t)sl * fo::kRows;
  fo::attend_rows<T, D, BKV>(q + ((size_t)bh * Nq + (size_t)q_src[slot] * BQ + row) * D,
                             out + ((size_t)bh * N + (size_t)q_ids[slot] * BQ + row) * D, live,
                             k + (size_t)bh * Nkv * D, v + (size_t)bh * Nkv * D, tkv, scale,
                             walk);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). ``out`` holds
// o_reuse on entry; only the rows of live q slots are overwritten. walk: the
// walk counters (attention_row.cuh), or null.
extern "C" int fo_csr_attention(int dtype, const void* q, const void* k, const void* v, void* out,
                                const void* q_ids, const void* q_src, const void* q_cnt,
                                const void* kv_ids, const void* kv_cnt, int BH, int Nq, int Nkv,
                                int N, int d, int Cq, int Ckv, int bq, int bkv, float scale,
                                void* walk, void* stream) {
  const int rc = fo::on_attention_instance(dtype, d, bq, bkv, [&](auto t, auto dd, auto bb) {
    using T = typename decltype(t)::type;
    constexpr int D = decltype(dd)::value, BKV = decltype(bb)::value;
    const int slots = fo::kWarps * fo::kRows / bq;      // slots per block
    return fo::launch_with_smem(
        csr_attention_kernel<T, D, BKV>, dim3((Cq + slots - 1) / slots, BH), fo::kThreads,
        fo::RowLayout<T, D, BKV>::bytes(fo::kWarps, Nkv / BKV), static_cast<cudaStream_t>(stream),
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(out), static_cast<const int*>(q_ids), static_cast<const int*>(q_src),
        static_cast<const int*>(q_cnt), static_cast<const int*>(kv_ids),
        static_cast<const int*>(kv_cnt), Nq, Nkv, N, Cq, Ckv, bq, scale,
        static_cast<unsigned long long*>(walk));
  });
  return rc ? rc : static_cast<int>(cudaGetLastError());
}
