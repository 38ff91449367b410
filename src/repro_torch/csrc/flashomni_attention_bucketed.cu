// FlashOmni CSR sparse attention over the occupancy-bucketed layout.
//
// Replaces repro/kernels/flashomni_attention.py::flashomni_attention_csr_bucketed
// (Pallas, TPU).
//
// The plan's layout rows r of batch b fold the heads in (R = H * Cq), sorted
// live first and by descending KV count into halving-width buckets. Row
// (b, r) is head head[b,r]: it reads its Q block at q_read[b,r] (compact
// GEMM-Q layout or full), walks kv_ids[b, row_off[r] : + kv_cnt[b,r]] with
// the f32 online softmax, and writes block q_write[b,r] (zeros when l == 0).
// A dead row (q_write == N / BQ) returns before any load or store, so the
// TPU's trash block is not needed; every row no live layout row writes keeps
// the o_reuse the wrapper cloned into ``out``.
//
// What bounds it on the H100: operations, as the uniform kernel
// (flashomni_attention.cu). On a GPU every row already stops at its own list
// length, so bucketing cannot shorten a reduction; what it gives is the order
// of the work. Design: one block per layout row, in layout order (widest
// bucket first, the batches interleaved), so the longest rows start first and
// a dead row costs one load; row_off, the start of each row's list, replaces
// the TPU grid's per-slot decode. Consecutive layout rows seldom share a head,
// so a block holds the BQ / 16 warps of ONE layout row and stages the KV
// blocks of that row alone (G = 1 q block: staging per row, no reuse across
// rows); grouping the rows of one head is left to a head-aware layout. Its
// blocks of BQ / 16 warps are bounded by shared memory, not registers, so
// its __launch_bounds__ do not cap registers as the 8-warp kernels' do. The
// walk and the per-warp update are the uniform kernel's (attend_rows and
// warp_update, attention_row.cuh), so on the same plan the two give the same
// bits.
#include "attention_row.cuh"

namespace {

template <typename T, int D, int BKV>
__global__ void __launch_bounds__(fo::kThreads)
csr_bucketed_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    T* __restrict__ out, const int* __restrict__ head,
                    const int* __restrict__ q_write, const int* __restrict__ q_read,
                    const int* __restrict__ kv_ids, const int* __restrict__ kv_cnt,
                    const int* __restrict__ row_off, int B, int H, int R, int S, int Nq, int Nkv,
                    int N, int BQ, float scale, unsigned long long* __restrict__ walk) {
  const int b = blockIdx.x % B, r = blockIdx.x / B;
  const int lr = b * R + r;
  const int qw = q_write[lr];
  if (qw >= N / BQ) return;
  const int tkv = Nkv / BKV;
  fo::mask_from_list(fo::warp_mask<T, D, BKV>(tkv), fo::RowLayout<T, D, BKV>::words(tkv),
                     kv_ids + (size_t)b * S + row_off[r], kv_cnt[lr], tkv);
  const size_t bh = (size_t)b * H + head[lr], row = (size_t)(threadIdx.x >> 5) * fo::kRows;
  fo::attend_rows<T, D, BKV>(q + (bh * Nq + (size_t)q_read[lr] * BQ + row) * D,
                             out + (bh * N + (size_t)qw * BQ + row) * D, true, k + bh * Nkv * D,
                             v + bh * Nkv * D, tkv, scale, walk);
}

}  // namespace

// head/q_write/q_read/kv_cnt (B, R), kv_ids (B, S), row_off (R,) int32.
// Returns cudaGetLastError() after the launch (0 on success). ``out`` holds
// o_reuse on entry; only the blocks of live layout rows are overwritten.
// walk: the walk counters (attention_row.cuh), or null.
extern "C" int fo_csr_attention_bucketed(int dtype, const void* q, const void* k, const void* v,
                                         void* out, const void* head, const void* q_write,
                                         const void* q_read, const void* kv_ids,
                                         const void* kv_cnt, const void* row_off, int B, int H,
                                         int R, int S, int Nq, int Nkv, int N, int d, int bq,
                                         int bkv, float scale, void* walk, void* stream) {
  const int rc = fo::on_attention_instance(dtype, d, bq, bkv, [&](auto t, auto dd, auto bb) {
    using T = typename decltype(t)::type;
    constexpr int D = decltype(dd)::value, BKV = decltype(bb)::value;
    const int warps = bq / fo::kRows;
    return fo::launch_with_smem(
        csr_bucketed_kernel<T, D, BKV>, dim3(B * R), 32 * warps,
        fo::RowLayout<T, D, BKV>::bytes(warps, Nkv / BKV), static_cast<cudaStream_t>(stream),
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(out), static_cast<const int*>(head), static_cast<const int*>(q_write),
        static_cast<const int*>(q_read), static_cast<const int*>(kv_ids),
        static_cast<const int*>(kv_cnt), static_cast<const int*>(row_off), B, H, R, S, Nq, Nkv,
        N, bq, scale, static_cast<unsigned long long*>(walk));
  });
  return rc ? rc : static_cast<int>(cudaGetLastError());
}
