// FlashOmni attention on the packed sparse symbols (paper §3.4, Algorithm 1 as written).
//
// Replaces repro/kernels/flashomni_attention.py::flashomni_attention_symbols (Pallas, TPU).
//
// For every (bh, q block i):
//   F(S_c, i) = (s_c[bh, i/8] >> (7 - i%8)) & 1
//   F == 0 (cache-then-reuse, lines 5-10): out[bh, i*BQ : +BQ] = o_reuse[...], return.
//   F == 1 (compute-on-demand, lines 11-19): the live j of row i,
//     J(S_s, i, j) = F(s_s[bh], i*T_kv + j), ascending; flash attention over
//     them with an f32 online softmax; zeros when the row has no live j.
// S_s is the row-major (T_q x T_kv) bit matrix, big-endian within a byte,
// with no per-row byte padding.
//
// What bounds it on the H100: operations at the serving shapes, as the CSR
// kernel (flashomni_attention.cu): the same work on the same live pairs,
// plus a copy of the cached rows (bytes) and T_kv bits of decode per live row.
// Design: one block of 256 threads per (bh, i). A cached block copies its
// o_reuse rows and returns: the copy is fused here, so the wrapper allocates
// the output uninitialised and clones nothing. A live block's first warp
// decodes the row's T_kv bits 32 at a time (ballot + popcount) into an
// ascending id list in shared memory, placed after attend_row's buffers; the
// row then runs attend_row (attention_row.cuh), the body of the CSR kernels.
// On the lists the CSR path builds from the same masks it gives their bits.
#include "attention_row.cuh"

namespace {

template <typename T, int D, int BQ>
__global__ void __launch_bounds__(fo::kThreads)
symbols_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ o_reuse,
                         T* __restrict__ out, const unsigned char* __restrict__ s_c,
                         const unsigned char* __restrict__ s_s, int N, int Nkv, int c_bytes,
                         int s_bytes, int Tkv, int bkv, float scale) {
  const int i = blockIdx.x, bh = blockIdx.y;
  const size_t row0 = ((size_t)bh * N + (size_t)i * BQ) * D;
  const int live = (s_c[(size_t)bh * c_bytes + (i >> 3)] >> (7 - (i & 7))) & 1;
  if (!live) {
    for (int idx = threadIdx.x; idx < BQ * D; idx += fo::kThreads)
      out[row0 + idx] = o_reuse[row0 + idx];
    return;
  }
  extern __shared__ float smem[];
  int* ids = reinterpret_cast<int*>(smem + fo::attention_smem_bytes(D, BQ, bkv) / sizeof(float));
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const unsigned char* bits = s_s + (size_t)bh * s_bytes;
    const size_t first = (size_t)i * Tkv;
    int count = 0;
    for (int j0 = 0; j0 < Tkv; j0 += 32) {
      const int j = j0 + lane;
      int bit = 0;
      if (j < Tkv) {
        const size_t f = first + j;
        bit = (bits[f >> 3] >> (7 - (f & 7))) & 1;
      }
      const unsigned mask = __ballot_sync(0xffffffffu, bit);
      if (bit) ids[count + __popc(mask & ((1u << lane) - 1u))] = j;
      count += __popc(mask);
    }
    if (lane == 0) ids[Tkv] = count;
  }
  __syncthreads();
  fo::attend_row<T, D, BQ>(q + row0, k + (size_t)bh * Nkv * D, v + (size_t)bh * Nkv * D, ids,
                           ids[Tkv], out + row0, bkv, scale);
}

}  // namespace

// Returns the launch's error code (0 on success). ``out`` is written whole:
// cached row blocks with o_reuse, live ones with their attention.
extern "C" int fo_symbols_attention(int dtype, const void* q, const void* k, const void* v,
                                    const void* o_reuse, void* out, const void* s_c,
                                    const void* s_s, int BH, int N, int Nkv, int d, int c_bytes,
                                    int s_bytes, int bq, int bkv, float scale, void* stream) {
  if (!fo::kv_block_built(bkv)) return static_cast<int>(cudaErrorInvalidValue);
  const int Tq = N / bq, Tkv = Nkv / bkv;
  const int rc = fo::on_attention_instance(dtype, d, bq, [&](auto t, auto dd, auto bb) {
    using T = typename decltype(t)::type;
    constexpr int D = decltype(dd)::value, BQ = decltype(bb)::value;
    return fo::launch_rows(
        symbols_attention_kernel<T, D, BQ>, dim3(Tq, BH),
        fo::attention_smem_bytes(D, BQ, bkv) + sizeof(int) * ((size_t)Tkv + 1),
        static_cast<cudaStream_t>(stream), static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(o_reuse), static_cast<T*>(out),
        static_cast<const unsigned char*>(s_c), static_cast<const unsigned char*>(s_s), N, Nkv,
        c_bytes, s_bytes, Tkv, bkv, scale);
  });
  return rc ? rc : static_cast<int>(cudaGetLastError());
}
