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
// reduction order matches it. Q stays in shared memory for the whole loop; K
// and V share one staging buffer (V is loaded while the row maxima and
// exponentials are taken, after the scores no longer need K), which keeps the
// largest tiling (128 x 128 at head_dim 128) inside the 227 KB a block may use.
// Rows are padded by one float so the per-element dot products read distinct
// banks. Each thread owns one head-dim column of BQ / (256 / D) rows of the
// accumulator, in registers.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;  // the reference's finite -inf (no inf - inf)

template <typename T, int D, int BQ>
__global__ void __launch_bounds__(kThreads)
csr_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ out, const int* __restrict__ q_ids,
                     const int* __restrict__ q_src, const int* __restrict__ q_cnt,
                     const int* __restrict__ kv_ids, const int* __restrict__ kv_cnt, int Nq,
                     int Nkv, int N, int Cq, int Ckv, int bkv, float scale) {
  constexpr int LD = D + 1;            // padded row stride of Q and K/V
  constexpr int RG = kThreads / D;     // row groups of the accumulator
  constexpr int ACC = BQ / RG;         // accumulator rows per thread
  const int c = blockIdx.x, bh = blockIdx.y;
  if (c >= q_cnt[bh]) return;

  extern __shared__ float smem[];
  const int lds = bkv + 1;
  float* qs = smem;                    // BQ  x LD
  float* kvs = qs + BQ * LD;           // bkv x LD (K, then V)
  float* ss = kvs + bkv * LD;          // BQ  x lds scores, then probabilities
  float* m_s = ss + BQ * lds;          // running row max
  float* l_s = m_s + BQ;               // running row sum
  float* a_s = l_s + BQ;               // this step's rescale factor

  const int tid = threadIdx.x, dd = tid % D, rg = tid / D;
  const int slot = bh * Cq + c;
  const T* qb = q + ((size_t)bh * Nq + (size_t)q_src[slot] * BQ) * D;
  for (int idx = tid; idx < BQ * D; idx += kThreads) qs[(idx / D) * LD + idx % D] = fo::to_f(qb[idx]);
  if (tid < BQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[ACC];
#pragma unroll
  for (int a = 0; a < ACC; ++a) acc[a] = 0.f;
  const int n = kv_cnt[slot];
  const int* ids = kv_ids + (size_t)slot * Ckv;
  const T* kbh = k + (size_t)bh * Nkv * D;
  const T* vbh = v + (size_t)bh * Nkv * D;
  __syncthreads();

  for (int j = 0; j < n; ++j) {
    const size_t off = (size_t)ids[j] * bkv * D;
    for (int idx = tid; idx < bkv * D; idx += kThreads)
      kvs[(idx / D) * LD + idx % D] = fo::to_f(kbh[off + idx]);
    __syncthreads();

    for (int idx = tid; idx < BQ * bkv; idx += kThreads) {
      const int i = idx / bkv, jj = idx % bkv;
      const float* qi = qs + i * LD;
      const float* kj = kvs + jj * LD;
      float dot = 0.f;
#pragma unroll 8
      for (int kk = 0; kk < D; ++kk) dot = fmaf(qi[kk], kj[kk], dot);
      ss[i * lds + jj] = dot * scale;
    }
    __syncthreads();

    if (tid < BQ) {
      float* row = ss + tid * lds;
      const float m_prev = m_s[tid];
      float m_cur = row[0];
      for (int jj = 1; jj < bkv; ++jj) m_cur = fmaxf(m_cur, row[jj]);
      const float m_new = fmaxf(m_prev, m_cur);
      float sum = 0.f;
      for (int jj = 0; jj < bkv; ++jj) {
        const float p = expf(row[jj] - m_new);
        row[jj] = p;
        sum += p;
      }
      const float alpha = expf(m_prev - m_new);
      l_s[tid] = l_s[tid] * alpha + sum;
      m_s[tid] = m_new;
      a_s[tid] = alpha;
    }
    // K is dead once the scores exist: stage V into the same buffer.
    for (int idx = tid; idx < bkv * D; idx += kThreads)
      kvs[(idx / D) * LD + idx % D] = fo::to_f(vbh[off + idx]);
    __syncthreads();

#pragma unroll
    for (int a = 0; a < ACC; ++a) {
      const int i = rg + a * RG;
      const float* p = ss + i * lds;
      float pv = 0.f;
      for (int jj = 0; jj < bkv; ++jj) pv = fmaf(p[jj], kvs[jj * LD + dd], pv);
      acc[a] = acc[a] * a_s[i] + pv;
    }
    __syncthreads();
  }

  T* ob = out + ((size_t)bh * N + (size_t)q_ids[slot] * BQ) * D;
#pragma unroll
  for (int a = 0; a < ACC; ++a) {
    const int i = rg + a * RG;
    const float l = l_s[i];
    ob[(size_t)i * D + dd] = fo::from_f<T>(acc[a] / (l == 0.f ? 1.f : l));
  }
}

size_t smem_bytes(int d, int bq, int bkv) {
  return sizeof(float) * ((size_t)bq * (d + 1) + (size_t)bkv * (d + 1) +
                          (size_t)bq * (bkv + 1) + 3 * (size_t)bq);
}

template <typename T, int D, int BQ>
int launch(const void* q, const void* k, const void* v, void* out, const void* q_ids,
           const void* q_src, const void* q_cnt, const void* kv_ids, const void* kv_cnt, int BH,
           int Nq, int Nkv, int N, int Cq, int Ckv, int bkv, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(D, BQ, bkv);
  auto kernel = csr_attention_kernel<T, D, BQ>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(Cq, BH);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<const int*>(q_ids), static_cast<const int*>(q_src),
      static_cast<const int*>(q_cnt), static_cast<const int*>(kv_ids),
      static_cast<const int*>(kv_cnt), Nq, Nkv, N, Cq, Ckv, bkv, scale);
  return 0;
}

template <typename T, int D>
int dispatch_bq(int bq, const void* q, const void* k, const void* v, void* out, const void* q_ids,
                const void* q_src, const void* q_cnt, const void* kv_ids, const void* kv_cnt,
                int BH, int Nq, int Nkv, int N, int Cq, int Ckv, int bkv, float scale,
                cudaStream_t st) {
  switch (bq) {
    case 16: return launch<T, D, 16>(q, k, v, out, q_ids, q_src, q_cnt, kv_ids, kv_cnt, BH, Nq, Nkv, N, Cq, Ckv, bkv, scale, st);
    case 32: return launch<T, D, 32>(q, k, v, out, q_ids, q_src, q_cnt, kv_ids, kv_cnt, BH, Nq, Nkv, N, Cq, Ckv, bkv, scale, st);
    case 64: return launch<T, D, 64>(q, k, v, out, q_ids, q_src, q_cnt, kv_ids, kv_cnt, BH, Nq, Nkv, N, Cq, Ckv, bkv, scale, st);
    case 128: return launch<T, D, 128>(q, k, v, out, q_ids, q_src, q_cnt, kv_ids, kv_cnt, BH, Nq, Nkv, N, Cq, Ckv, bkv, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_d(int d, int bq, const void* q, const void* k, const void* v, void* out,
               const void* q_ids, const void* q_src, const void* q_cnt, const void* kv_ids,
               const void* kv_cnt, int BH, int Nq, int Nkv, int N, int Cq, int Ckv, int bkv,
               float scale, cudaStream_t st) {
  switch (d) {
    case 32: return dispatch_bq<T, 32>(bq, q, k, v, out, q_ids, q_src, q_cnt, kv_ids, kv_cnt, BH, Nq, Nkv, N, Cq, Ckv, bkv, scale, st);
    case 64: return dispatch_bq<T, 64>(bq, q, k, v, out, q_ids, q_src, q_cnt, kv_ids, kv_cnt, BH, Nq, Nkv, N, Cq, Ckv, bkv, scale, st);
    case 128: return dispatch_bq<T, 128>(bq, q, k, v, out, q_ids, q_src, q_cnt, kv_ids, kv_cnt, BH, Nq, Nkv, N, Cq, Ckv, bkv, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). ``out`` holds
// o_reuse on entry; only the rows of live q slots are overwritten.
extern "C" int fo_csr_attention(int dtype, const void* q, const void* k, const void* v, void* out,
                                const void* q_ids, const void* q_src, const void* q_cnt,
                                const void* kv_ids, const void* kv_cnt, int BH, int Nq, int Nkv,
                                int N, int d, int Cq, int Ckv, int bq, int bkv, float scale,
                                void* stream) {
  if (bkv != 16 && bkv != 32 && bkv != 64 && bkv != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == fo::kF32)
    rc = dispatch_d<float>(d, bq, q, k, v, out, q_ids, q_src, q_cnt, kv_ids, kv_cnt, BH, Nq, Nkv,
                           N, Cq, Ckv, bkv, scale, st);
  else if (dtype == fo::kBF16)
    rc = dispatch_d<__nv_bfloat16>(d, bq, q, k, v, out, q_ids, q_src, q_cnt, kv_ids, kv_cnt, BH,
                                   Nq, Nkv, N, Cq, Ckv, bkv, scale, st);
  else
    rc = static_cast<int>(cudaErrorInvalidValue);
  return rc ? rc : static_cast<int>(cudaGetLastError());
}
