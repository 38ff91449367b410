// The per-row body of the FlashOmni attention kernels
// (flashomni_attention.cu, flashomni_attention_bucketed.cu,
// flashomni_attention_symbols.cu):
// one q block of BQ rows attends its own KV-block list with an f32 online
// softmax. The uniform, the occupancy-bucketed and the symbols kernel all
// call it, so that on the same lists they give the same bits.
//
// Called by all kThreads threads of a block, with attention_smem_bytes(D, BQ,
// bkv) bytes of dynamic shared memory. Q stays in shared memory for the whole
// loop; K and V share one staging buffer (V is loaded while the row maxima and
// exponentials are taken, after the scores no longer need K), which keeps the
// largest tiling (128 x 128 at head_dim 128) inside the 227 KB a block may use.
// Rows are padded by one float so the per-element dot products read distinct
// banks. Each thread owns one head-dim column of BQ / (256 / D) rows of the
// accumulator, in registers. Every multiply-add is an explicit fmaf.
#pragma once

#include "common.cuh"

namespace fo {

constexpr float kNegInf = -1e30f;  // the reference's finite -inf (no inf - inf)

__host__ __device__ inline size_t attention_smem_bytes(int d, int bq, int bkv) {
  return sizeof(float) * ((size_t)bq * (d + 1) + (size_t)bkv * (d + 1) +
                          (size_t)bq * (bkv + 1) + 3 * (size_t)bq);
}

// qb: the Q block (BQ x D); kbh/vbh: this (b, h)'s K and V (N_kv x D);
// ids[0..n): the row's KV blocks, walked in order; ob: where the BQ output
// rows go (acc / l, zeros when l == 0).
template <typename T, int D, int BQ>
__device__ __forceinline__ void attend_row(const T* __restrict__ qb, const T* __restrict__ kbh,
                                           const T* __restrict__ vbh, const int* __restrict__ ids,
                                           int n, T* __restrict__ ob, int bkv, float scale) {
  constexpr int LD = D + 1;            // padded row stride of Q and K/V
  constexpr int RG = kThreads / D;     // row groups of the accumulator
  constexpr int ACC = BQ / RG;         // accumulator rows per thread
  extern __shared__ float smem[];
  const int lds = bkv + 1;
  float* qs = smem;                    // BQ  x LD
  float* kvs = qs + BQ * LD;           // bkv x LD (K, then V)
  float* ss = kvs + bkv * LD;          // BQ  x lds scores, then probabilities
  float* m_s = ss + BQ * lds;          // running row max
  float* l_s = m_s + BQ;               // running row sum
  float* a_s = l_s + BQ;               // this step's rescale factor

  const int tid = threadIdx.x, dd = tid % D, rg = tid / D;
  for (int idx = tid; idx < BQ * D; idx += kThreads) qs[(idx / D) * LD + idx % D] = to_f(qb[idx]);
  if (tid < BQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[ACC];
#pragma unroll
  for (int a = 0; a < ACC; ++a) acc[a] = 0.f;
  __syncthreads();

  for (int j = 0; j < n; ++j) {
    const size_t off = (size_t)ids[j] * bkv * D;
    for (int idx = tid; idx < bkv * D; idx += kThreads)
      kvs[(idx / D) * LD + idx % D] = to_f(kbh[off + idx]);
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
      l_s[tid] = fmaf(l_s[tid], alpha, sum);
      m_s[tid] = m_new;
      a_s[tid] = alpha;
    }
    // K is dead once the scores exist: stage V into the same buffer.
    for (int idx = tid; idx < bkv * D; idx += kThreads)
      kvs[(idx / D) * LD + idx % D] = to_f(vbh[off + idx]);
    __syncthreads();

#pragma unroll
    for (int a = 0; a < ACC; ++a) {
      const int i = rg + a * RG;
      const float* p = ss + i * lds;
      float pv = 0.f;
      for (int jj = 0; jj < bkv; ++jj) pv = fmaf(p[jj], kvs[jj * LD + dd], pv);
      acc[a] = fmaf(acc[a], a_s[i], pv);
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < ACC; ++a) {
    const int i = rg + a * RG;
    const float l = l_s[i];
    ob[(size_t)i * D + dd] = from_f<T>(acc[a] / (l == 0.f ? 1.f : l));
  }
}

// Raise a kernel's dynamic shared-memory limit and launch it with kThreads
// threads a block; returns the attribute call's error, 0 otherwise.
template <typename Kernel, typename... Args>
int launch_rows(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream, Args... args) {
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return 0;
}

inline bool kv_block_built(int bkv) {
  return bkv == 16 || bkv == 32 || bkv == 64 || bkv == 128;
}

// Calls f(Tag<T>{}, Int<D>{}, Int<BQ>{}) for the built element type, head_dim
// and q-block size, or returns cudaErrorInvalidValue for one that is not built.
template <typename T, int D, typename F>
int on_block_q(int bq, F& f) {
  switch (bq) {
    case 16: return f(Tag<T>{}, Int<D>{}, Int<16>{});
    case 32: return f(Tag<T>{}, Int<D>{}, Int<32>{});
    case 64: return f(Tag<T>{}, Int<D>{}, Int<64>{});
    case 128: return f(Tag<T>{}, Int<D>{}, Int<128>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, typename F>
int on_head_dim(int d, int bq, F& f) {
  switch (d) {
    case 32: return on_block_q<T, 32>(bq, f);
    case 64: return on_block_q<T, 64>(bq, f);
    case 128: return on_block_q<T, 128>(bq, f);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename F>
int on_attention_instance(int dtype, int d, int bq, F&& f) {
  if (dtype == kF32) return on_head_dim<float>(d, bq, f);
  if (dtype == kBF16) return on_head_dim<__nv_bfloat16>(d, bq, f);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace fo
