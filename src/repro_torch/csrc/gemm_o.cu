// GEMM-O: the output projection with head sparsity (paper §3.5, Obs. 3, Eq. 3-4),
// uniform and occupancy-bucketed row layouts.
//
// Replaces repro/kernels/gemm_o.py::gemm_o_sparse_kernel (B3) and
// ::gemm_o_sparse_bucketed_kernel (B5) (Pallas, TPU).
//
//   out[b, row] = bias[b, row] + sum_{h in the slot's head list} O[b, h, row] @ W[h]
//
// O (B, H, N, dh), W (H, dh, F), out (B, N, F) already holding the bias (the
// wrapper clones it once). Uniform (B3): slot c of batch b covers row block
// row_ids[b,c] with heads head_ids[b,c,:head_cnt[b,c]] (row_ids/head_cnt
// (B, Cr), head_ids (B, Cr, H)). Bucketed (B5): the plan sorted the slots by
// live-head count; slot r reads O at row block src[b,r], writes block
// rows[b,r], with heads head_ids[b, row_off[r] : + head_cnt[b,r]] (rows/src/
// head_cnt (B, Cr), head_ids (B, S), row_off (Cr,)). Both kernels run
// heads_group_tile below, so on the same plan B5 gives B3's bits.
//
// What bounds it on the H100: the tensor cores (three TF32 products per f32
// product in f32), once each staged W_h slice feeds enough rows. The first
// version ran one slot (bm = 32 rows) per block on the CUDA cores: each W_h
// slice it staged fed 32 rows, about 13 FLOP per byte from L2 in f32, so at
// the 3xTF32 rate it would have needed about 13 TB/s of L2.
// Design: a block takes a group of 128 / bm consecutive slots (128 rows) and
// a 256-column (f32) or 128-column (bf16) tile of F, on the shared tile
// (gemm_tile.cuh). It walks the ascending union of the group's head lists
// (a bit mask per slot), staging each K slice of O_h (the rows of the slots
// that keep h) and of W_h once for the whole group; an m16 tile whose slot
// lacks h skips its products. The accumulators start from the bias. So a row's sum is bias + its own heads in
// ascending order, each over the same K slices: its bits depend on neither
// the group nor the layout. Lists are ascending and free of repeats, as
// every plan builds them. A slot with no head (padding or dead) stages
// nothing and never stores, so its rows keep the bias; a group of such slots
// exits before touching O, W or out. Live row ids are unique, so no two
// blocks write the same element.
#include "gemm_tile.cuh"

namespace {

constexpr int kMaxSlots = fo::kThreads / 32;    // a group's slots: one warp builds each mask

// One slot of a group: its head list (ascending), count, O row block and
// output row block. cnt == 0: a dead or missing slot.
struct Slot {
  const int* heads;
  int cnt, src, dst;
};

// Shared memory past the tile's ring: per tile row its O row and output
// row (-1: a dead slot's) and slot, the union's count and heads, each
// slot's head mask.
struct GroupLayout {
  int row_src[128], row_dst[128], row_slot[128], n_union, pad[3];
  __host__ __device__ static int words(int H) { return (H + 31) / 32; }
  __host__ __device__ static size_t bytes(int H) {
    return sizeof(GroupLayout) + sizeof(int) * (size_t)H +
           sizeof(unsigned) * (size_t)kMaxSlots * words(H);
  }
};

// Called by every thread of the block, warp w passing slot w of the group
// (slots past the group's G = 128 / bm are missing). o_b, ob: O and out at
// batch b; n0: the first output column.
template <typename T, bool kVec>
__device__ __forceinline__ void heads_group_tile(const T* __restrict__ o_b,
                                                 const T* __restrict__ w, T* __restrict__ ob,
                                                 Slot mine, int H, int N, int dh, int F, int bm,
                                                 int n0) {
  using L = fo::Tile<T>;
  static_assert(L::BM == 128, "GroupLayout holds 128 tile rows");
  GroupLayout& gl = *reinterpret_cast<GroupLayout*>(fo::dyn_smem() + L::kRing);
  int* ulist = reinterpret_cast<int*>(&gl + 1);
  const int words = GroupLayout::words(H);
  unsigned* masks = reinterpret_cast<unsigned*>(ulist + H);
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;

  fo::mask_from_list(masks + wid * words, words, mine.heads, mine.cnt, H);
  __syncthreads();
  if (wid == 0) {                 // the ascending union of the group's heads
    int u = 0;
    for (int h0 = 0; h0 < H; h0 += 32) {
      unsigned word = 0u;
      for (int s = 0; s < kMaxSlots; ++s) word |= masks[s * words + (h0 >> 5)];
      if ((word >> lane) & 1u) ulist[u + __popc(word & ((1u << lane) - 1u))] = h0 + lane;
      u += __popc(word);
    }
    if (lane == 0) gl.n_union = u;
  }
  for (int r = wid * bm + lane; r < min((wid + 1) * bm, L::BM); r += 32) {   // slot wid's rows
    gl.row_slot[r] = wid;
    gl.row_src[r] = mine.cnt > 0 ? mine.src * bm + r % bm : -1;
    gl.row_dst[r] = mine.cnt > 0 ? mine.dst * bm + r % bm : -1;
  }
  __syncthreads();
  const int n_union = gl.n_union;
  if (n_union == 0) return;       // every slot of the group is dead

  auto has = [&](int s, int h) { return (masks[s * words + (h >> 5)] >> (h & 31)) & 1u; };
  fo::Acc<T> acc;
  fo::tile_pairs<T>(acc, [&](int r, int c, float& v0, float& v1) {     // the bias
    const int row = gl.row_dst[r];
    if (row >= 0) fo::load_pair<T>(ob + (size_t)row * F, n0 + c, F, v0, v1);
    else v0 = v1 = 0.f;
  });
  const int ks = L::iters(dh);
  fo::tile_mainloop<T>(
      n_union * ks,
      [&](int it, T* as, T* bs) {
        const int h = ulist[it / ks], k0 = (it % ks) * L::BK;
        const T* oh = o_b + (size_t)h * N * dh;
        fo::stage_a<T, kVec>(as, [&](int r) -> const T* {
          const int src = gl.row_src[r];
          return src >= 0 && has(gl.row_slot[r], h) ? oh + (size_t)src * dh : nullptr;
        }, k0, dh);
        fo::stage_b<T, kVec>(bs, w + (size_t)h * dh * F, k0, dh, n0, F);
      },
      [&](int it) {
        const int h = ulist[it / ks];
        return fo::warp_live<T>([&](int r) { return has(gl.row_slot[r], h) != 0u; });
      },
      acc);

  fo::tile_pairs<T>(acc, [&](int r, int c, float v0, float v1) {
    const int row = gl.row_dst[r];
    if (row >= 0) fo::store_pair<T, kVec>(ob + (size_t)row * F, n0 + c, F, v0, v1);
  });
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(fo::kThreads, fo::Tile<T>::kBlocks)
gemm_o_kernel(const T* __restrict__ o, const T* __restrict__ w, const int* __restrict__ row_ids,
              const int* __restrict__ head_ids, const int* __restrict__ head_cnt,
              T* __restrict__ out, int H, int N, int dh, int F, int Cr, int bm) {
  const int b = blockIdx.z, G = fo::Tile<T>::BM / bm, s = threadIdx.x >> 5;
  const int c = blockIdx.y * G + s;
  Slot mine{nullptr, 0, 0, 0};
  if (s < G && c < Cr) {
    const int slot = b * Cr + c;
    mine = Slot{head_ids + (size_t)slot * H, head_cnt[slot], row_ids[slot], row_ids[slot]};
  }
  heads_group_tile<T, kVec>(o + (size_t)b * H * N * dh, w, out + (size_t)b * N * F, mine, H, N,
                            dh, F, bm, blockIdx.x * fo::Tile<T>::BN);
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(fo::kThreads, fo::Tile<T>::kBlocks)
gemm_o_bucketed_kernel(const T* __restrict__ o, const T* __restrict__ w,
                       const int* __restrict__ rows, const int* __restrict__ src,
                       const int* __restrict__ head_ids, const int* __restrict__ head_cnt,
                       const int* __restrict__ row_off, T* __restrict__ out, int H, int N,
                       int dh, int F, int Cr, int S, int bm) {
  const int b = blockIdx.z, G = fo::Tile<T>::BM / bm, s = threadIdx.x >> 5;
  const int r = blockIdx.y * G + s;
  Slot mine{nullptr, 0, 0, 0};
  if (s < G && r < Cr) {
    const int slot = b * Cr + r;
    mine = Slot{head_ids + (size_t)b * S + row_off[r], head_cnt[slot], src[slot], rows[slot]};
  }
  heads_group_tile<T, kVec>(o + (size_t)b * H * N * dh, w, out + (size_t)b * N * F, mine, H, N,
                            dh, F, bm, blockIdx.x * fo::Tile<T>::BN);
}

inline bool block_rows_built(int bm) { return bm == 16 || bm == 32 || bm == 64 || bm == 128; }

// Grid: F tiles x slot groups x B.
template <typename T>
dim3 grid_of(int B, int F, int Cr, int bm) {
  using L = fo::Tile<T>;
  const int G = L::BM / bm;
  return dim3((F + L::BN - 1) / L::BN, (Cr + G - 1) / G, B);
}

template <typename T>
size_t smem_of(int H) {
  return fo::Tile<T>::kRing + GroupLayout::bytes(H);
}

}  // namespace

// vec: 1 when O, W and out start on 16-byte boundaries and their rows (dh
// and F elements) are multiples of 16 bytes, else 0. Returns the launch's
// error code (0 on success). ``out`` holds the bias on entry and the result
// on exit.
extern "C" int fo_gemm_o(int dtype, int vec, const void* o, const void* w, const void* row_ids,
                         const void* head_ids, const void* head_cnt, void* out, int B, int H,
                         int N, int dh, int F, int Cr, int bm, void* stream) {
  if (!block_rows_built(bm)) return static_cast<int>(cudaErrorInvalidValue);
  const int rc = fo::on_gemm_instance(dtype, vec, [&](auto t, auto v) {
    using T = typename decltype(t)::type;
    return fo::launch_with_smem(
        gemm_o_kernel<T, decltype(v)::value>, grid_of<T>(B, F, Cr, bm), fo::kThreads,
        smem_of<T>(H), static_cast<cudaStream_t>(stream), static_cast<const T*>(o),
        static_cast<const T*>(w), static_cast<const int*>(row_ids),
        static_cast<const int*>(head_ids), static_cast<const int*>(head_cnt),
        static_cast<T*>(out), H, N, dh, F, Cr, bm);
  });
  return rc ? rc : static_cast<int>(cudaGetLastError());
}

// The bucketed layout: rows/src/head_cnt (B, Cr), head_ids (B, S), row_off
// (Cr,) int32; vec as for fo_gemm_o. Returns the launch's error code.
// ``out`` holds the bias on entry and the result on exit.
extern "C" int fo_gemm_o_bucketed(int dtype, int vec, const void* o, const void* w,
                                  const void* rows, const void* src, const void* head_ids,
                                  const void* head_cnt, const void* row_off, void* out, int B,
                                  int H, int N, int dh, int F, int Cr, int S, int bm,
                                  void* stream) {
  if (!block_rows_built(bm)) return static_cast<int>(cudaErrorInvalidValue);
  const int rc = fo::on_gemm_instance(dtype, vec, [&](auto t, auto v) {
    using T = typename decltype(t)::type;
    return fo::launch_with_smem(
        gemm_o_bucketed_kernel<T, decltype(v)::value>, grid_of<T>(B, F, Cr, bm), fo::kThreads,
        smem_of<T>(H), static_cast<cudaStream_t>(stream), static_cast<const T*>(o),
        static_cast<const T*>(w), static_cast<const int*>(rows), static_cast<const int*>(src),
        static_cast<const int*>(head_ids), static_cast<const int*>(head_cnt),
        static_cast<const int*>(row_off), static_cast<T*>(out), H, N, dh, F, Cr, S, bm);
  });
  return rc ? rc : static_cast<int>(cudaGetLastError());
}
