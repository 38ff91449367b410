// The sparse-GEMM tile of GEMM-Q (gemm_q.cu) and GEMM-O (gemm_o.cu, both
// layouts), on the Hopper tensor cores.
//
// A block of 8 warps computes a BM x BN tile of C += A B (Tile below: 128 x
// 256 in f32, 128 x 128 in bf16). A is BM rows the caller names one by one
// (gathered row blocks of x for GEMM-Q, the rows of a group of slots in O_h
// for GEMM-O), B a row-major (K, F) matrix (W, or W_h). Each warp owns a
// WM x WN sub-tile of MI x NJ mma tiles of 16 x 8, accumulated in f32
// registers.
//   bf16: mma.sync m16n8k16; A through ldmatrix, B (rows along k) through
//         ldmatrix.trans.
//   f32:  mma.sync m16n8k8 TF32 in 3xTF32 (mma.cuh: hi = tf32(a), lo =
//         tf32(a - hi), three products), where plain TF32 would miss 1e-4
//         at K = 3072. A fragments come through ldmatrix too (a b16 pair is
//         one f32), B by (k = t, n = g) loads.
//         Where the split happens: in registers, once per fragment a warp
//         loads, and every product of the warp tile that reads it uses that
//         split: an A split feeds the NJ = 8 N tiles, a B split the MI = 4
//         M tiles, so a split costs under 1 instruction per TF32 product
//         (the attention body, whose warps own 16 rows, pays about 3).
//         Splitting into hi/lo planes at staging would also save the 2-4
//         warps' repeats of one element, but doubles the fragment loads and
//         adds a pass and a barrier to every K slice.
//         The tensor cores add each product into their f32 sum with
//         truncation, an error that grows with the products per output, so
//         each k8 step's three products are summed from zero and added to
//         the accumulator by an f32 add (round to nearest).
// The reduction runs over `iters` K slices of BK elements, staged by the
// caller's stage(it, As, Bs) into a ring of kStages slices in dynamic shared
// memory, one barrier a slice: the next kStages - 1 slices are in flight
// while one is multiplied. Rows are padded so fragment loads hit distinct
// banks: A rows are 144 bytes apart (8 ldmatrix rows on 8 distinct 16-byte
// bank groups), B rows BN + 8 elements (f32: the (t, g) loads on 32 banks;
// bf16: ldmatrix.trans rows on distinct groups).
// An m16 tile whose bit is clear in the caller's live(it) skips its
// products: GEMM-O's warps skip the heads their slot lacks, GEMM-Q's the
// padding.
//
// Staging: 16-byte cp.async where every row starts on a 16-byte boundary
// (kVec); element loads and shared stores into the same ring otherwise (a
// bf16 row of 100 elements is 200 bytes), chosen by the wrapper from the
// data pointers and row lengths. Past K, F or a caller's missing row the
// slice holds zeros. Both paths give the same bits.
#pragma once

#include <type_traits>

#include "mma.cuh"

namespace fo {

// The shapes, by type (each measured the faster on the H100 at the serving
// shapes): f32 a 128 x 256 tile, 64 x 64 a warp (4 x 8 mma tiles: each
// 3xTF32 split feeds more products), 4 slices deep, one block an SM; bf16 a
// 128 x 128 tile, 32 x 64 a warp, 3 slices deep, two blocks an SM (the
// other block's slices hide this one's barrier). A slice is 128 bytes of a
// row: 32 f32 or 64 bf16.
template <typename T>
struct Tile {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kWarpsM = kF32 ? 2 : 4, kWarpsN = kThreads / 32 / kWarpsM;
  static constexpr int MI = 128 / 16 / kWarpsM, NJ = 8;    // m16 and n8 mma tiles of a warp
  static constexpr int WM = 16 * MI, WN = 8 * NJ;          // a warp's rows and columns
  static constexpr int BM = WM * kWarpsM, BN = WN * kWarpsN;
  static constexpr int kChunk = 16 / (int)sizeof(T);       // elements of one 16-byte copy
  static constexpr int BK = 8 * kChunk;
  static constexpr int LDA = BK + kChunk;                  // 144-byte A rows
  static constexpr int LDB = BN + 8;
  static constexpr int kStages = kF32 ? 4 : 3;
  static constexpr int kBlocks = kF32 ? 1 : 2;             // blocks an SM (launch bounds)
  static constexpr unsigned kAllLive = (1u << MI) - 1u;
  static constexpr size_t kA = sizeof(T) * BM * LDA;
  static constexpr size_t kStage = kA + sizeof(T) * BK * LDB;
  static constexpr size_t kRing = kStages * kStage;        // 204 KB f32, 105 KB bf16
  __host__ __device__ static int iters(int K) { return (K + BK - 1) / BK; }
};

static_assert(Tile<float>::kRing + 4096 <= kSmemMax, "the f32 ring and a kernel's tables fit");
static_assert(2 * (Tile<__nv_bfloat16>::kRing + 4096) <= kSmemMax,
              "two bf16 blocks fit an SM");

template <typename T>
using Acc = float[Tile<T>::MI][Tile<T>::NJ][4];

// ---- staging ----------------------------------------------------------------

// A[0:BM, k0:k0+BK] into As: row r from row(r) (a pointer to its element
// 0, or nullptr for a row of zeros), zeros at k >= K.
template <typename T, bool kVec, typename RowPtr>
__device__ __forceinline__ void stage_a(T* __restrict__ As, RowPtr&& row, int k0, int K) {
  using L = Tile<T>;
  if constexpr (kVec) {
    constexpr int CPR = L::BK / L::kChunk;
    for (int idx = threadIdx.x; idx < L::BM * CPR; idx += kThreads) {
      const int r = idx / CPR, k = k0 + (idx % CPR) * L::kChunk;
      T* dst = As + r * L::LDA + (idx % CPR) * L::kChunk;
      const T* src = row(r);
      if (src != nullptr && k < K) cp_async16(dst, src + k);
      else zero16(dst);
    }
  } else {
    for (int idx = threadIdx.x; idx < L::BM * L::BK; idx += kThreads) {
      const int r = idx / L::BK, k = k0 + idx % L::BK;
      const T* src = row(r);
      As[r * L::LDA + idx % L::BK] = (src != nullptr && k < K) ? src[k] : from_f<T>(0.f);
    }
  }
}

// B[k0:k0+BK, n0:n0+BN] of a row-major (K, F) matrix into Bs; zeros past K and F.
template <typename T, bool kVec>
__device__ __forceinline__ void stage_b(T* __restrict__ Bs, const T* __restrict__ b, int k0,
                                        int K, int n0, int F) {
  using L = Tile<T>;
  if constexpr (kVec) {
    constexpr int CPR = L::BN / L::kChunk;
    for (int idx = threadIdx.x; idx < L::BK * CPR; idx += kThreads) {
      const int kr = idx / CPR, c = (idx % CPR) * L::kChunk;
      const int k = k0 + kr, col = n0 + c;
      T* dst = Bs + kr * L::LDB + c;
      if (k < K && col < F) cp_async16(dst, b + (size_t)k * F + col);
      else zero16(dst);
    }
  } else {
    for (int idx = threadIdx.x; idx < L::BK * L::BN; idx += kThreads) {
      const int kr = idx / L::BN, c = idx % L::BN;
      const int k = k0 + kr, col = n0 + c;
      Bs[kr * L::LDB + c] = (k < K && col < F) ? b[(size_t)k * F + col] : from_f<T>(0.f);
    }
  }
}

// ---- the warp's product over one staged slice ---------------------------------

// acc += A B over the slice (As, Bs) for the warp's m16 tiles i with on[i]
// (kAll: all of them, unpredicated).
template <typename T, bool kAll>
__device__ __forceinline__ void warp_slice(const T* __restrict__ As, const T* __restrict__ Bs,
                                           const bool (&on)[Tile<T>::MI], Acc<T>& acc) {
  using L = Tile<T>;
  constexpr int MI = L::MI, NJ = L::NJ;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const T* arow = As + (L::WM * (w / L::kWarpsN) + (lane & 15)) * L::LDA;
  const int n0 = L::WN * (w % L::kWarpsN);
  if constexpr (std::is_same<T, float>::value) {
    const int g = lane >> 2, t = lane & 3;
    auto mma = [&](int i, float (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
      if constexpr (kAll) mma_tf32(c, a, b0, b1);
      else mma_tf32_if(on[i], c, a, b0, b1);
    };
    // Not unrolled: at 128 accumulators a thread, ptxas fills the registers
    // with the next steps' fragments either way, and the unrolled loop was
    // the slower (B3 3.22 against 2.98 ms on the H100).
#pragma unroll 1
    for (int kk = 0; kk < L::BK; kk += 8) {
      unsigned ah[MI][4], al[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        unsigned a[4];
        ldsm_x4(a, arow + 16 * i * L::LDA + kk + (lane >> 4) * 4);
#pragma unroll
        for (int c = 0; c < 4; ++c) split_tf32(__uint_as_float(a[c]), ah[i][c], al[i][c]);
      }
      const float* bcol = Bs + (kk + t) * L::LDB + n0 + g;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        unsigned bh0, bl0, bh1, bl1;
        split_tf32(bcol[8 * j], bh0, bl0);
        split_tf32(bcol[4 * L::LDB + 8 * j], bh1, bl1);
        // This k8 step's 3xTF32 product, summed from 0 and added to the
        // accumulator in f32: the tensor cores truncate each product into
        // their sum, and 3 products per 8 of K straight into a large sum
        // came to 0.8 of the 1e-4 tolerance at K = 3072 (0.09 so).
        float p[MI][4];
#pragma unroll
        for (int i = 0; i < MI; ++i) p[i][0] = p[i][1] = p[i][2] = p[i][3] = 0.f;
#pragma unroll
        for (int i = 0; i < MI; ++i) mma(i, p[i], al[i], bh0, bh1);
#pragma unroll
        for (int i = 0; i < MI; ++i) mma(i, p[i], ah[i], bl0, bl1);
#pragma unroll
        for (int i = 0; i < MI; ++i) mma(i, p[i], ah[i], bh0, bh1);
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[i][j][c] = (kAll || on[i]) ? __fadd_rn(acc[i][j][c], p[i][c]) : acc[i][j][c];
      }
    }
  } else {
    auto mma = [&](int i, int j, const unsigned (&a)[4], unsigned b0, unsigned b1) {
      if constexpr (kAll) mma_bf16(acc[i][j], a, b0, b1);
      else mma_bf16_if(on[i], acc[i][j], a, b0, b1);
    };
    const T* brow = Bs + ((lane & 7) + ((lane >> 3) & 1) * 8) * L::LDB + n0 + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < L::BK; kk += 16) {
      unsigned a[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) ldsm_x4(a[i], arow + 16 * i * L::LDA + kk + (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < NJ / 2; ++jp) {
        unsigned b[4];
        ldsm_x4_trans(b, brow + kk * L::LDB + 16 * jp);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          mma(i, 2 * jp, a[i], b[0], b[1]);
          mma(i, 2 * jp + 1, a[i], b[2], b[3]);
        }
      }
    }
  }
}

// acc += A B over the slice for the m16 tiles i with bit i of live: all of
// them unpredicated (the common case), none, or some with the others'
// products predicated off (not branched around, so ptxas still interleaves
// the tiles). In f32 each tile's three TF32 products go in the order al*bh,
// ah*bl, ah*bh, each round over the warp's m16 tiles, so the three products
// into one accumulator are MI apart.
template <typename T>
__device__ __forceinline__ void warp_tile(const T* __restrict__ As, const T* __restrict__ Bs,
                                          unsigned live, Acc<T>& acc) {
  using L = Tile<T>;
  bool on[L::MI];
#pragma unroll
  for (int i = 0; i < L::MI; ++i) on[i] = (live >> i) & 1u;
  if (live == L::kAllLive) warp_slice<T, true>(As, Bs, on, acc);
  else if (live != 0u) warp_slice<T, false>(As, Bs, on, acc);
}

// ---- the K loop -----------------------------------------------------------------

// acc += the product over slices 0..iters-1. stage(it, As, Bs) issues slice
// it's copies (every thread calls it); live(it) is this warp's m16 tile mask
// for slice it. Called by every thread of the block; the ring is the start of
// dynamic shared memory.
template <typename T, typename Stage, typename Live>
__device__ __forceinline__ void tile_mainloop(int iters, Stage&& stage, Live&& live,
                                              Acc<T>& acc) {
  using L = Tile<T>;
  unsigned char* ring = dyn_smem();
  auto as = [&](int s) { return reinterpret_cast<T*>(ring + s * L::kStage); };
  auto bs = [&](int s) { return reinterpret_cast<T*>(ring + s * L::kStage + L::kA); };
#pragma unroll
  for (int s = 0; s < L::kStages - 1; ++s) {
    if (s < iters) stage(s, as(s), bs(s));
    cp_async_commit();
  }
  for (int it = 0; it < iters; ++it) {
    cp_async_wait<L::kStages - 2>();
    __syncthreads();                  // slice it is in; slice it - 1's buffer has no readers
    const int nx = it + L::kStages - 1;
    if (nx < iters) stage(nx, as(nx % L::kStages), bs(nx % L::kStages));
    cp_async_commit();
    const int s = it % L::kStages;
    warp_tile<T>(as(s), bs(s), live(it), acc);
  }
  cp_async_wait<0>();
}

// ---- accumulators and the epilogue -------------------------------------------

template <typename T>
__device__ __forceinline__ void zero_acc(Acc<T>& acc) {
#pragma unroll
  for (int i = 0; i < Tile<T>::MI; ++i)
#pragma unroll
    for (int j = 0; j < Tile<T>::NJ; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
}

// Calls f(row, col, v0, v1) for each pair of this thread's accumulators:
// tile row `row`, tile columns col and col + 1.
template <typename T, typename Fn>
__device__ __forceinline__ void tile_pairs(Acc<T>& acc, Fn&& f) {
  using L = Tile<T>;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int r0 = L::WM * (w / L::kWarpsN) + (lane >> 2);
  const int c0 = L::WN * (w % L::kWarpsN) + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < L::MI; ++i)
#pragma unroll
    for (int j = 0; j < L::NJ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f(r0 + 16 * i + 8 * h, c0 + 8 * j, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
}

// The warp's m16 tiles whose first row r (of the block tile) has row_live(r).
template <typename T, typename RowLive>
__device__ __forceinline__ unsigned warp_live(RowLive&& row_live) {
  using L = Tile<T>;
  const int r0 = L::WM * ((threadIdx.x >> 5) / L::kWarpsN);
  unsigned live = 0u;
#pragma unroll
  for (int i = 0; i < L::MI; ++i) live |= (row_live(r0 + 16 * i) ? 1u : 0u) << i;
  return live;
}

// Columns col, col + 1 of a row of F elements; those at or past F are skipped
// (read as 0). With kVec, F is a multiple of the 16-byte chunk: col < F means
// both columns are in, and one paired store writes them.
template <typename T>
__device__ __forceinline__ void load_pair(const T* row, int col, int F, float& v0, float& v1) {
  v0 = col < F ? to_f(row[col]) : 0.f;
  v1 = col + 1 < F ? to_f(row[col + 1]) : 0.f;
}
template <typename T, bool kVec>
__device__ __forceinline__ void store_pair(T* row, int col, int F, float v0, float v1) {
  if constexpr (kVec) {
    if (col < F) store2(row + col, v0, v1);
  } else {
    if (col < F) row[col] = from_f<T>(v0);
    if (col + 1 < F) row[col + 1] = from_f<T>(v1);
  }
}

// ---- host side --------------------------------------------------------------------

// Calls f(Tag<T>{}, Bool<kVec>{}) for the built element type and staging path,
// or returns cudaErrorInvalidValue.
template <typename F>
int on_gemm_instance(int dtype, int vec, F&& f) {
  if (dtype == kF32)
    return vec ? f(Tag<float>{}, Bool<true>{}) : f(Tag<float>{}, Bool<false>{});
  if (dtype == kBF16)
    return vec ? f(Tag<__nv_bfloat16>{}, Bool<true>{}) : f(Tag<__nv_bfloat16>{}, Bool<false>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace fo
