// The shared body of the FlashOmni attention kernels
// (flashomni_attention.cu, flashomni_attention_bucketed.cu,
// flashomni_attention_symbols.cu), on the Hopper tensor cores.
//
// One warp owns one 16-row slice of a q block (the mma.sync M) and attends
// the KV blocks of its row's list with an f32 online softmax, the scores S,
// the probabilities P and the accumulator O held in mma fragments:
//   bf16: mma.sync m16n8k16 (bf16 in, f32 accumulate); Q and K fragments
//         through ldmatrix, V through ldmatrix.trans; P is rounded to bf16
//         in registers as the A operand of P V.
//   f32:  mma.sync m16n8k8 TF32 with the 3xTF32 split: a = hi + lo with
//         hi = tf32(a), lo = tf32(a - hi), and a*b ~ lo*hi + hi*lo + hi*hi,
//         accumulated in f32 (about f32 accuracy; plain TF32 keeps 3 digits).
//         P is the A operand straight from the S accumulators: the quad holds
//         columns 2t and 2t+1 where the A layout wants t and t+4, so the
//         k index of P V is relabelled (k' = t <-> kv row 2t, t+4 <-> 2t+1)
//         and V is read in the same order.
// (The cp.async, ldmatrix, mma.sync and 3xTF32 primitives are mma.cuh's,
// shared with the sparse-GEMM tile.)
// A row's softmax step runs in registers per KV block, in base 2 (one
// ex2.approx per probability): the row max and sum go over the quad that
// holds the row (__shfl_xor_sync 1, 2), and the O rescale is skipped when
// every row of the warp keeps its max (the factor is then exactly 1).
//
// A block holds W warps of ONE (b, h) and walks the ascending union of
// their KV lists (a bit mask over T_kv per warp, OR-ed into the block's
// walk mask), staging each KV block once for all W warps with cp.async in
// a ring of kStages (2 where it fits 227 KB, else 1) so that the next
// block's K and V arrive while this one computes. A warp whose own mask
// lacks block j skips it: no rescale, no update. So a row's output bits
// depend only on its Q slice, its own KV list (walked ascending; lists are
// ascending and free of repeats, as every plan builds them), K, V and
// scale: never on W, on which rows share its block, or on which of the
// three kernels runs it. warp_update is the one per-warp update all three
// call, and every rounding step in it is explicit (__fmul_rn, __fsub_rn,
// fmaf), so no kernel contracts it differently.
//
// Edge semantics: a live warp with an empty list writes zeros (l == 0); an
// idle warp (live == false) takes part in the staging and stores nothing.
//
// Walk counters: when a launch passes a non-null `walk` (two u64 on the
// card), each block adds the KV blocks its walk staged to walk[0] and each
// live warp the warp_updates it made to walk[1], so a measuring launch
// reads how often a staged block was reused. The walk stages each block of
// the union mask once and a warp updates each block of its own mask, so
// both are read off those masks before the walk starts: the loop is the
// same with or without counters.
#pragma once

#include <type_traits>

#include "mma.cuh"

namespace fo {

constexpr float kNegInf = -1e30f;       // the reference's finite -inf (no inf - inf)
constexpr int kWarps = kThreads / 32;   // warps of a full block
constexpr int kRows = 16;               // query rows of one warp: the mma M
constexpr size_t kMaskReserve = 8192;   // room kept for the KV masks when sizing the ring

// Shared-memory layout of a block of `warps` warps: the warps' Q slices,
// the K/V ring, each warp's KV mask, then the block's union mask. Rows are
// padded by 16 bytes, so the fragment reads (ldmatrix rows, or the TF32
// (row g, col t) pattern) hit 32 distinct banks.
template <typename T, int D, int BKV>
struct RowLayout {
  static constexpr int kChunk = 16 / (int)sizeof(T);    // elements of one 16-byte copy
  static constexpr int LD = D + kChunk;                 // padded row stride
  static constexpr size_t kQ = sizeof(T) * kRows * LD;  // one warp's Q slice
  static constexpr size_t kStage = sizeof(T) * 2 * BKV * LD;   // one K and one V block
  static constexpr int kStages = kWarps * kQ + 2 * kStage + kMaskReserve <= kSmemMax ? 2 : 1;
  // Blocks of kWarps an SM holds by shared memory (1 or 2): the 8-warp
  // kernels' __launch_bounds__ ask for that many, so that registers (the
  // f32 serving instance wants just over 128) do not halve it.
  static constexpr int kBlocks =
      2 * (kWarps * kQ + kStages * kStage + kMaskReserve) <= kSmemMax ? 2 : 1;
  __host__ __device__ static int words(int tkv) { return (tkv + 31) / 32; }
  __host__ __device__ static size_t bytes(int warps, int tkv) {
    return warps * kQ + kStages * kStage + sizeof(unsigned) * (size_t)(warps + 1) * words(tkv);
  }
};

// ---- softmax --------------------------------------------------------------

// 2^x (ex2.approx: relative error about 2^-22; ex2(-1e30) = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- the per-warp update ----------------------------------------------------

// One online-softmax step of a warp's 16 rows over one staged KV block:
// S = Q K^T * scale, m' = max(m, rowmax S), P = exp(S - m'),
// l = l * exp(m - m') + rowsum P, O = O * exp(m - m') + P V
// (in base 2, m and S in units of log2(e)).
// qs: the warp's Q slice (16 x LD); ks, vs: the staged K and V block
// (BKV x LD). Thread (g = lane / 4, t = lane % 4) holds rows g and g + 8:
// m[r], l[r] and o[n][2r], o[n][2r+1] at columns 8n + 2t, 8n + 2t + 1.
template <typename T, int D, int BKV>
__device__ __forceinline__ void warp_update(const T* __restrict__ qs, const T* __restrict__ ks,
                                            const T* __restrict__ vs, float scale,
                                            float (&o)[D / 8][4], float (&m)[2], float (&l)[2]) {
  constexpr int LD = RowLayout<T, D, BKV>::LD;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float s[BKV / 8][4];
#pragma unroll
  for (int n = 0; n < BKV / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;

  if constexpr (std::is_same<T, float>::value) {
#pragma unroll 2
    for (int kk = 0; kk < D; kk += 8) {
      unsigned ah[4], al[4];
      split_tf32(qs[g * LD + kk + t], ah[0], al[0]);
      split_tf32(qs[(g + 8) * LD + kk + t], ah[1], al[1]);
      split_tf32(qs[g * LD + kk + t + 4], ah[2], al[2]);
      split_tf32(qs[(g + 8) * LD + kk + t + 4], ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < BKV / 8; ++n) {
        const float* kr = ks + (n * 8 + g) * LD + kk + t;
        unsigned bh0, bl0, bh1, bl1;
        split_tf32(kr[0], bh0, bl0);
        split_tf32(kr[4], bh1, bl1);
        mma_3xtf32(s[n], ah, al, bh0, bh1, bl0, bl1);
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      unsigned a[4];
      ldsm_x4(a, qs + (lane & 15) * LD + kk + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < BKV / 16; ++np) {
        unsigned b[4];
        ldsm_x4(b, ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk +
                       ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], a, b[0], b[1]);
        mma_bf16(s[2 * np + 1], a, b[2], b[3]);
      }
    }
  }

  // The softmax runs in base 2: the scores are scaled by scale * log2(e),
  // m is kept in those units and exp(x - m) is ex2(x' - m') (one MUFU op,
  // relative error about 2^-22).
  const float scale2 = __fmul_rn(scale, 1.4426950408889634f);
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = kNegInf;
#pragma unroll
    for (int n = 0; n < BKV / 8; ++n) {
      s[n][2 * r] = __fmul_rn(s[n][2 * r], scale2);
      s[n][2 * r + 1] = __fmul_rn(s[n][2 * r + 1], scale2);
      mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx);
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < BKV / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float p = ex2(__fsub_rn(s[n][2 * r + c], m_new));
        s[n][2 * r + c] = p;
        sum = __fadd_rn(sum, p);
      }
    }
    sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 1));
    sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 2));
    alpha[r] = ex2(__fsub_rn(m[r], m_new));
    l[r] = fmaf(l[r], alpha[r], sum);
    m[r] = m_new;
  }
  // O *= alpha, skipped when every row of the warp keeps its max (alpha is
  // then exactly 1 and the product would not change a bit).
  if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[n][c] = __fmul_rn(o[n][c], alpha[c >> 1]);
  }

  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int kt = 0; kt < BKV / 8; ++kt) {
      unsigned ph[4], pl[4];            // A of P V, k relabelled: t <-> 2t, t + 4 <-> 2t + 1
      split_tf32(s[kt][0], ph[0], pl[0]);
      split_tf32(s[kt][2], ph[1], pl[1]);
      split_tf32(s[kt][1], ph[2], pl[2]);
      split_tf32(s[kt][3], ph[3], pl[3]);
      const float* v0 = vs + (kt * 8 + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        unsigned bh0, bl0, bh1, bl1;
        split_tf32(v0[n * 8], bh0, bl0);
        split_tf32(v0[LD + n * 8], bh1, bl1);
        mma_3xtf32(o[n], ph, pl, bh0, bh1, bl0, bl1);
      }
    }
  } else {
#pragma unroll
    for (int kt = 0; kt < BKV / 16; ++kt) {
      const unsigned a[4] = {pack_bf16(s[2 * kt][0], s[2 * kt][1]),
                             pack_bf16(s[2 * kt][2], s[2 * kt][3]),
                             pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]),
                             pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        unsigned b[4];
        ldsm_x4_trans(b, vs + (kt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dp * 16 +
                             (lane >> 4) * 8);
        mma_bf16(o[2 * dp], a, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
      }
    }
  }
}

// ---- the block walk ---------------------------------------------------------

// The first KV block after j in the union mask, or tkv.
__device__ __forceinline__ int next_live(const unsigned* uni, int tkv, int j) {
  for (int i = j + 1; i < tkv; i = (i | 31) + 1) {
    const unsigned bits = uni[i >> 5] & (~0u << (i & 31));
    if (bits) return (i & ~31) + __ffs(bits) - 1;
  }
  return tkv;
}

// This warp's KV mask words (RowLayout::words(tkv) of them) in shared memory.
template <typename T, int D, int BKV>
__device__ __forceinline__ unsigned* warp_mask(int tkv) {
  using L = RowLayout<T, D, BKV>;
  const int nw = blockDim.x >> 5;
  return reinterpret_cast<unsigned*>(dyn_smem() + nw * L::kQ + L::kStages * L::kStage) +
         (threadIdx.x >> 5) * L::words(tkv);
}

// The KV blocks set in a mask of `words` words.
__device__ __forceinline__ unsigned long long mask_count(const unsigned* mask, int words) {
  unsigned long long n = 0;
  for (int i = 0; i < words; ++i) n += __popc(mask[i]);
  return n;
}

// Called by every thread of the block after each warp has built its mask
// (warp_mask). qw: the warp's 16 Q rows; ow: where its 16 output rows go
// (O / l, zeros when l == 0); kbh, vbh: the block's (b, h) K and V
// (tkv * BKV rows). An idle warp (live == false) stores nothing. walk:
// the walk counters, or null.
template <typename T, int D, int BKV>
__device__ __forceinline__ void attend_rows(const T* __restrict__ qw, T* __restrict__ ow,
                                            bool live, const T* __restrict__ kbh,
                                            const T* __restrict__ vbh, int tkv, float scale,
                                            unsigned long long* __restrict__ walk) {
  using L = RowLayout<T, D, BKV>;
  constexpr int CPR = D / L::kChunk;            // 16-byte copies per row
  constexpr int kStageElems = (int)(L::kStage / sizeof(T));
  unsigned char* sm = dyn_smem();
  const int nw = blockDim.x >> 5, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int words = L::words(tkv);
  T* qs = reinterpret_cast<T*>(sm + w * L::kQ);
  T* ring = reinterpret_cast<T*>(sm + nw * L::kQ);
  unsigned* masks = reinterpret_cast<unsigned*>(sm + nw * L::kQ + L::kStages * L::kStage);
  const unsigned* mine = masks + w * words;
  unsigned* uni = masks + nw * words;

  __syncthreads();                              // every warp's mask is built
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    unsigned u = 0u;
    for (int x = 0; x < nw; ++x) u |= masks[x * words + i];
    uni[i] = u;
  }
  if (live)
    for (int idx = lane; idx < kRows * CPR; idx += 32) {
      const int r = idx / CPR, c = (idx % CPR) * L::kChunk;
      cp_async16(qs + r * L::LD + c, qw + (size_t)r * D + c);
    }
  __syncthreads();                              // the union is built
  if (walk != nullptr) {                        // the walk counters
    if (threadIdx.x == 0) atomicAdd(walk, mask_count(uni, words));
    if (live && lane == 0) atomicAdd(walk + 1, mask_count(mine, words));
  }

  auto stage = [&](int j, int buf) {
    T* ks = ring + buf * kStageElems;
    T* vs = ks + BKV * L::LD;
    const size_t off = (size_t)j * BKV * D;
    for (int idx = threadIdx.x; idx < BKV * CPR; idx += blockDim.x) {
      const int r = idx / CPR, c = (idx % CPR) * L::kChunk;
      cp_async16(ks + r * L::LD + c, kbh + off + (size_t)r * D + c);
      cp_async16(vs + r * L::LD + c, vbh + off + (size_t)r * D + c);
    }
  };

  float o[D / 8][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  int j = next_live(uni, tkv, -1);
  if (j < tkv) stage(j, 0);
  cp_async_commit();                            // Q and the first KV block
  int buf = 0;
  while (j < tkv) {
    cp_async_wait_all();
    __syncthreads();                            // block j is in; its ring slot has no readers
    const int jn = next_live(uni, tkv, j);
    if (L::kStages == 2 && jn < tkv) {
      stage(jn, buf ^ 1);
      cp_async_commit();
    }
    if (live && ((mine[j >> 5] >> (j & 31)) & 1u)) {
      const T* ks = ring + buf * kStageElems;
      warp_update<T, D, BKV>(qs, ks, ks + BKV * L::LD, scale, o, m, l);
    }
    if (L::kStages == 1) {
      __syncthreads();
      if (jn < tkv) {
        stage(jn, 0);
        cp_async_commit();
      }
    } else {
      buf ^= 1;
    }
    j = jn;
  }
  cp_async_wait_all();
  if (!live) return;

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float den = l[r] == 0.f ? 1.f : l[r];
    T* orow = ow + (size_t)(g + 8 * r) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store2(orow + n * 8, __fdiv_rn(o[n][2 * r], den), __fdiv_rn(o[n][2 * r + 1], den));
  }
}

// ---- host side --------------------------------------------------------------

inline bool q_block_built(int bq) { return bq == 16 || bq == 32 || bq == 64 || bq == 128; }

// Calls f(Tag<T>{}, Int<D>{}, Int<BKV>{}) for the built element type,
// head_dim and KV-block size, or returns cudaErrorInvalidValue for one that
// is not built. (The q block is a runtime size: BQ / 16 warps each.)
template <typename T, int D, typename F>
int on_block_kv(int bkv, F& f) {
  switch (bkv) {
    case 16: return f(Tag<T>{}, Int<D>{}, Int<16>{});
    case 32: return f(Tag<T>{}, Int<D>{}, Int<32>{});
    case 64: return f(Tag<T>{}, Int<D>{}, Int<64>{});
    case 128: return f(Tag<T>{}, Int<D>{}, Int<128>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, typename F>
int on_head_dim(int d, int bkv, F& f) {
  switch (d) {
    case 32: return on_block_kv<T, 32>(bkv, f);
    case 64: return on_block_kv<T, 64>(bkv, f);
    case 128: return on_block_kv<T, 128>(bkv, f);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename F>
int on_attention_instance(int dtype, int d, int bq, int bkv, F&& f) {
  if (!q_block_built(bq)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kF32) return on_head_dim<float>(d, bkv, f);
  if (dtype == kBF16) return on_head_dim<__nv_bfloat16>(d, bkv, f);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace fo
