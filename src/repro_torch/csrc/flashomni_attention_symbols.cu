// FlashOmni attention on the packed sparse symbols (paper §3.4, Algorithm 1 as written).
//
// Replaces repro/kernels/flashomni_attention.py::flashomni_attention_symbols (Pallas, TPU).
//
// For every (bh, q block i):
//   F(S_c, i) = (s_c[bh, i/8] >> (7 - i%8)) & 1
//   F == 0 (cache-then-reuse, lines 5-10): out[bh, i*BQ : +BQ] = o_reuse[...].
//   F == 1 (compute-on-demand, lines 11-19): the live j of row i,
//     J(S_s, i, j) = F(s_s[bh], i*T_kv + j), ascending; flash attention over
//     them with an f32 online softmax; zeros when the row has no live j.
// S_s is the row-major (T_q x T_kv) bit matrix, big-endian within a byte,
// with no per-row byte padding.
//
// What bounds it on the H100: operations at the serving shapes, as the CSR
// kernel (flashomni_attention.cu): the same work on the same live pairs,
// plus a copy of the cached rows (bytes) and T_kv bits of decode per live row.
// Design: a block of 8 warps takes 128 query rows of one bh: the 128 / BQ
// q blocks of RANK blockIdx.x * 128 / BQ ... among the bh's live ones (each
// warp finds its q block by a ballot select over the S_c bits), each warp one
// 16-row slice. So a block holds live rows only, as the CSR kernel does on
// the compacted lists: grouping consecutive q blocks instead would leave the
// warps of cached rows idle through the walk. The same block also copies the
// cached q blocks among blockIdx.x * 128 / BQ ... (the copy of o_reuse is
// fused here, so the wrapper allocates the output uninitialised and clones
// nothing). A live warp decodes its row's T_kv bits 32 at a time (ballot)
// straight into its KV mask words. The block then walks the union of the
// warps' masks, staging each KV block once (attend_rows,
// attention_row.cuh), and each warp runs warp_update, the CSR kernels'
// per-warp update: on the lists the CSR path builds from the same masks it
// gives their bits.
#include "attention_row.cuh"

namespace {

__device__ __forceinline__ int bit_at(const unsigned char* __restrict__ bits, size_t f) {
  return (bits[f >> 3] >> (7 - (f & 7))) & 1;
}

// Warp-wide: the index of the r-th set bit among bits[0..n), or n.
__device__ __forceinline__ int select_set(const unsigned char* __restrict__ bits, int n, int r) {
  const int lane = threadIdx.x & 31;
  for (int i0 = 0, seen = 0; i0 < n; i0 += 32) {
    const int bit = i0 + lane < n ? bit_at(bits, i0 + lane) : 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, bit);
    if (seen + __popc(ballot) > r) {
      const bool hit = bit && __popc(ballot & ((1u << lane) - 1u)) == r - seen;
      return i0 + __ffs(__ballot_sync(0xffffffffu, hit)) - 1;
    }
    seen += __popc(ballot);
  }
  return n;
}

// Warp-wide copy of 16 rows of D elements (16-byte aligned).
template <typename T, int D>
__device__ __forceinline__ void copy_rows(T* __restrict__ dst, const T* __restrict__ src) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int i = threadIdx.x & 31; i < fo::kRows * D * (int)sizeof(T) / 16; i += 32) d[i] = s[i];
}

template <typename T, int D, int BKV>
__global__ void __launch_bounds__(fo::kThreads, fo::RowLayout<T, D, BKV>::kBlocks)
symbols_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ o_reuse,
                         T* __restrict__ out, const unsigned char* __restrict__ s_c,
                         const unsigned char* __restrict__ s_s, int N, int Nkv, int c_bytes,
                         int s_bytes, int BQ, float scale,
                         unsigned long long* __restrict__ walk) {
  const int bh = blockIdx.y, spq = BQ / fo::kRows;      // warps per q block
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int first = blockIdx.x * (fo::kWarps / spq) + w / spq;
  const int tq = N / BQ, tkv = Nkv / BKV;
  const unsigned char* cbits = s_c + (size_t)bh * c_bytes;
  const size_t slice = (size_t)(w % spq) * fo::kRows;
  if (first < tq && !bit_at(cbits, first)) {            // a cached q block: o_reuse
    const size_t at = ((size_t)bh * N + (size_t)first * BQ + slice) * D;
    copy_rows<T, D>(out + at, o_reuse + at);
  }
  const int i = select_set(cbits, tq, first);           // the live q block of this rank
  const bool live = i < tq;
  if (!__syncthreads_or(live)) return;
  unsigned* mask = fo::warp_mask<T, D, BKV>(tkv);
  const int words = fo::RowLayout<T, D, BKV>::words(tkv);
  const unsigned char* bits = s_s + (size_t)bh * s_bytes;
  const size_t row_bits = (size_t)i * tkv;
  for (int wd = 0; wd < words; ++wd) {
    const int j = wd * 32 + lane;
    const int bit = live && j < tkv ? bit_at(bits, row_bits + j) : 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, bit);
    if (lane == 0) mask[wd] = ballot;
  }
  const size_t row0 = ((size_t)bh * N + (size_t)i * BQ + slice) * D;
  fo::attend_rows<T, D, BKV>(q + row0, out + row0, live, k + (size_t)bh * Nkv * D,
                             v + (size_t)bh * Nkv * D, tkv, scale, walk);
}

}  // namespace

// Returns the launch's error code (0 on success). ``out`` is written whole:
// cached row blocks with o_reuse, live ones with their attention. walk: the
// walk counters (attention_row.cuh), or null.
extern "C" int fo_symbols_attention(int dtype, const void* q, const void* k, const void* v,
                                    const void* o_reuse, void* out, const void* s_c,
                                    const void* s_s, int BH, int N, int Nkv, int d, int c_bytes,
                                    int s_bytes, int bq, int bkv, float scale, void* walk,
                                    void* stream) {
  const int rc = fo::on_attention_instance(dtype, d, bq, bkv, [&](auto t, auto dd, auto bb) {
    using T = typename decltype(t)::type;
    constexpr int D = decltype(dd)::value, BKV = decltype(bb)::value;
    const int per_block = fo::kWarps * fo::kRows / bq;  // q blocks per block
    return fo::launch_with_smem(
        symbols_attention_kernel<T, D, BKV>, dim3((N / bq + per_block - 1) / per_block, BH),
        fo::kThreads, fo::RowLayout<T, D, BKV>::bytes(fo::kWarps, Nkv / BKV),
        static_cast<cudaStream_t>(stream), static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(o_reuse), static_cast<T*>(out),
        static_cast<const unsigned char*>(s_c), static_cast<const unsigned char*>(s_s), N, Nkv,
        c_bytes, s_bytes, bq, scale, static_cast<unsigned long long*>(walk));
  });
  return rc ? rc : static_cast<int>(cudaGetLastError());
}
