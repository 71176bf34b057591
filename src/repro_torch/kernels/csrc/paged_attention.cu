// Attention, written by hand for Hopper (sm_90a).
//
// Kernels over K/V rows that are found either through a page table (a
// shared pool (n_pages, page_size, kvh, d) walked through each slot's table
// row (b, max_pages), page 0 being the null page) or at a fixed base per
// batch row (a contiguous cache or sequence (b, max_len, kvh, d)):
//
//   decode_split_kernel<PagedLayout> replaces repro/kernels/flash_decode.py
//                                    flash_decode_paged (_paged_decode_kernel,
//                                    _decode_body): one query token per slot.
//   decode_split_kernel<ContiguousLayout>
//                                    replaces repro/kernels/flash_decode.py
//                                    flash_decode (_decode_kernel): the same
//                                    decode over a contiguous ragged cache.
//   prefill_kernel<PagedLayout>      replaces repro/kernels/flash_attention.py
//                                    flash_attention_paged
//                                    (_paged_prefill_kernel): one causal chunk
//                                    of queries per slot.
//   prefill_kernel<ContiguousLayout> replaces repro/kernels/flash_attention.py
//                                    flash_attention (_flash_kernel,
//                                    _lower_tri_maps): full-sequence GQA
//                                    attention, causal or not, q (b, sq, h, d)
//                                    against k/v (b, skv, kvh, d).
//
// The prefills run prefill_kernel (CUDA cores) in fp32 and
// prefill_mma_kernel (tensor cores) in bf16, each templated on the layout.
// The two decodes share one body, and the two prefills another; only how
// a logical row's address is found differs (the layout's `rows(slot)`, or
// for the decode `stage`), and where the queries sit: a chunk's rows start
// at `starts[slot]`, a sequence's at skv - sq (the causal diagonal's
// offset). All keep the TPU kernels' math: fp32 scores, an fp32 online
// softmax (running max m, denominator l, accumulator acc), fp32 sums, and
// the output rounded once to q's dtype; K/V stay in their own dtype and
// are widened on use, never copied. In fp32 the products run on the CUDA
// cores (the tensor cores would take fp32 only as TF32). In bf16 they run
// on the tensor cores by mma.sync, bf16 times bf16 into fp32 (exact
// products), and P.V takes P as a bf16 high part plus a bf16 residual, so
// that each weight keeps 16 bits.
//
// What bounds them on an H100. Decode reads every live K/V row of a slot
// once per kv head and does 4 * group * d flops per row: it is bound by
// bytes (2 * kvh * d * sizeof(T) per row per layer over 3.35 TB/s). Its
// design is flash-decoding (decode_split_kernel, below): the context is cut
// into splits of rows_per_split rows, one CTA per (kv head, slot, split),
// so a batch of 8 long slots fills the card where one CTA per (kv head,
// slot) left half the SMs idle; each warp streams its tiles through a
// cp.async ring in K/V's own dtype, so loads overlap the scoring; the last
// split of a slot to finish merges the splits' fp32 partials in a fixed
// order. What is left: each CTA's start (lengths, then the page-table
// entries, then the first copies, one after another), and the merge's tail
// after a wave whose last CTAs finish alone.
//
// Prefill at a 256-row chunk, and the full-sequence forward, do 4 * d flops per
// (query, key) pair and read each K/V row once per query block: they are bound
// by operations. The design: one CTA per (batch row, q head, BQ query rows), BQ
// chosen at launch among PrefillBlockQs (16 or 64: the caller's tile, or
// core.autotune's choice). bf16 runs FlashAttention-2's mma.sync body on the
// tensor cores (prefill_mma_kernel: a warp of 16 query rows for every 16 rows
// of BQ, Q in registers, K/V tiles double-buffered by cp.async). fp32 stays on
// the CUDA cores, which keep full fp32 where the tensor cores would take it
// only as TF32: 256 threads each own a (BQ / 16) x 4 block of the BQ x 64 score
// tile in registers (rows ty+16i, columns tx+16j, so shared-memory reads are
// conflict-free), fp32 FMAs (prefill_kernel). A short query block (the
// speculative verify's 5 rows) pads to 16 rows, not 64: the 64-row tile ran 3
// of its 4 warps on zeros. The key tile stays kTileK = 64. Causality is a loop
// bound, not a grid: a CTA walks key tiles up to the last key its last query
// row sees, and masks only what lies past the diagonal (or past the end) inside
// a tile, so any sq and skv work, 1 and primes included. The TPU kernel instead
// enumerates the lower triangle of (q block, k block) pairs in
// scalar-prefetched maps and snaps its blocks to divisors of the lengths. q, k and v
// are read in their (b, s, heads, d) layout; GQA is kv_head = head / group. A
// wgmma body (head_dim 80's 160-byte rows do not fit wgmma's 128-byte swizzle)
// is later work.
//
// The page walk: the prefill reads each row's physical page from the table
// (page_table[slot, row / page_size]) before a tile's rows are loaded; the
// decode stages its split's entries in shared memory first. Entries past
// the rows a slot needs are never read. `starts` and `lengths` are data,
// so one build serves every chunk position and every context length.

#include <type_traits>
#include <utility>

#include "common.cuh"

namespace {

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::Elem;
using repro::fast_exp2;
using repro::kNegInf;
using repro::ldsm_x4;
using repro::ldsm_x4_trans;
using repro::mma_bf16;
using repro::pack_bf16;
using repro::smem_u32;
using repro::split_bf16;

constexpr int kThreads = 256;
constexpr int kTileK = 64;     // key rows staged per iteration
// The prefill query blocks the build instantiates (``BLOCK_QS`` of
// kernels/flash_attention.py): BQ query rows a CTA, chosen at launch by
// the entries' block_q. The mma body runs one warp for every 16 rows; the
// fp32 body's 256 threads each own BQ / 16 rows of the score tile.
using PrefillBlockQs = std::integer_sequence<int, 16, 64>;

// Where a slot's logical K/V rows live. rows(slot)(r) is the index of
// logical row r in the (rows, kvh, d) view of the pool or cache, and
// max_rows() bounds what a slot can reach. The decode stages a split's
// rows first (stage: the page-table entries it needs, read once into
// shared memory) and finds them through what that returns.
struct PagedRows {
  const int* trow;  // the slot's page-table row
  int page_size;
  __device__ int64_t operator()(int row) const {
    const int64_t page = trow[row / page_size];
    return page * page_size + row % page_size;
  }
};

// Rows through table entries staged in shared memory: pages[i] maps the
// slot's logical page first + i.
struct StagedPages {
  const int* pages;
  int first;
  int page_size;
  __device__ int64_t operator()(int row) const {
    return (int64_t)pages[row / page_size - first] * page_size +
           row % page_size;
  }
};

struct PagedLayout {
  const int* table;  // (b, max_pages)
  int page_size;
  int max_pages;
  __device__ int max_rows() const { return max_pages * page_size; }
  __device__ PagedRows rows(int slot) const {
    return {table + (int64_t)slot * max_pages, page_size};
  }
  // Entries a split of `rows` rows may span (host: shared-memory size).
  int split_entries(int rows) const { return rows / page_size + 2; }
  // Stage the entries of rows [r0, r1), r1 > r0, into `pages`; entries
  // past r1 stay unread. The caller syncs the CTA before using them.
  __device__ StagedPages stage(int slot, int r0, int r1, int* pages) const {
    const int first = r0 / page_size;
    const int count = (r1 - 1) / page_size - first + 1;
    const int* trow = table + (int64_t)slot * max_pages + first;
    for (int i = threadIdx.x; i < count; i += blockDim.x) pages[i] = trow[i];
    return {pages, first, page_size};
  }
};

struct ContiguousRows {
  int64_t base;  // slot * max_len
  __device__ int64_t operator()(int row) const { return base + row; }
};

struct ContiguousLayout {
  int max_len;
  __device__ int max_rows() const { return max_len; }
  __device__ ContiguousRows rows(int slot) const {
    return {(int64_t)slot * max_len};
  }
  int split_entries(int) const { return 0; }
  __device__ ContiguousRows stage(int slot, int, int, int*) const {
    return rows(slot);
  }
};

// Reductions over the 16 lanes that share one prefill query row.
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o, 16));
  return v;
}

__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o, 16);
  return v;
}

// Stage logical rows [k0, k0 + kTileK) of kv head `hk` into `dst` as fp32
// (row stride D + 1), finding each row through `rows`. Rows at or past
// `n_rows` are zero-filled and their addresses (page-table entries) unread.
template <typename T, int D, typename Rows>
__device__ void load_kv_tile(const T* __restrict__ src, Rows rows, int kvh,
                             int hk, int k0, int n_rows,
                             float* __restrict__ dst) {
  constexpr int kPer = Elem<T>::kPerVec;
  constexpr int kVecs = D / kPer;
  for (int v = threadIdx.x; v < kTileK * kVecs; v += kThreads) {
    const int r = v / kVecs;
    const int c = (v % kVecs) * kPer;
    const int row = k0 + r;
    float tmp[kPer];
    if (row < n_rows) {
      Elem<T>::load16(src + (rows(row) * kvh + hk) * D + c, tmp);
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e) tmp[e] = 0.f;
    }
    float* o = dst + r * (D + 1) + c;
#pragma unroll
    for (int e = 0; e < kPer; ++e) o[e] = tmp[e];
  }
}

// Query r of batch row `slot` sits at position `start + r`, where start is
// starts[slot] (a chunk through a page table) or, without `starts`, the
// fixed `offset` (skv - sq: a sequence's causal diagonal). Causal: it sees
// keys <= its position that the layout holds (< max_rows()); otherwise
// every key the layout holds.
template <typename T, int D, int BQ, typename Layout>
__global__ void __launch_bounds__(kThreads, 2)
prefill_kernel(const T* __restrict__ q, const T* __restrict__ kp,
               const T* __restrict__ vp, Layout layout,
               const int* __restrict__ starts, int offset, bool causal,
               T* __restrict__ out, int sq, int h, int kvh, float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = kTileK + 1;
  constexpr int DC = D / 16;  // output columns per thread
  constexpr int RI = BQ / 16;  // query rows per thread
  constexpr int kPer = Elem<T>::kPerVec;
  constexpr int kVecs = D / kPer;
  const int qb = blockIdx.x;
  const int head = blockIdx.y;
  const int slot = blockIdx.z;
  const int hk = head / (h / kvh);
  extern __shared__ float smem[];
  float* q_s = smem;                  // BQ x DP
  float* k_s = q_s + BQ * DP;         // kTileK x DP
  float* v_s = k_s + kTileK * DP;     // kTileK x DP
  float* p_s = v_s + kTileK * DP;     // BQ x PP
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int start = starts != nullptr ? starts[slot] : offset;
  const int q0 = qb * BQ;
  const int nq = min(BQ, sq - q0);
  // The loop bound: the last key this block's last query sees.
  const int n_keys = causal ? min(start + q0 + nq, layout.max_rows())
                            : layout.max_rows();
  const auto rows = layout.rows(slot);
  for (int v = tid; v < BQ * kVecs; v += kThreads) {
    const int r = v / kVecs;
    const int c = (v % kVecs) * kPer;
    float tmp[kPer];
    if (r < nq) {
      Elem<T>::load16(q + (((int64_t)slot * sq + q0 + r) * h + head) * D + c,
                      tmp);
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e) tmp[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kPer; ++e) q_s[r * DP + c + e] = tmp[e];
  }
  float m[RI], l[RI], acc[RI][DC];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }
  for (int k0 = 0; k0 < n_keys; k0 += kTileK) {
    __syncthreads();
    load_kv_tile<T, D>(kp, rows, kvh, hk, k0, n_keys, k_s);
    load_kv_tile<T, D>(vp, rows, kvh, hk, k0, n_keys, v_s);
    __syncthreads();
    float s[RI][4];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[RI], b[4];
#pragma unroll
      for (int i = 0; i < RI; ++i) a[i] = q_s[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = k_s[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int pos = start + q0 + ty + 16 * i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        ok[j] = col < n_keys && (!causal || col <= pos);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        p_s[(ty + 16 * i) * PP + tx + 16 * j] = p;
      }
      sum = half_sum(sum);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kTileK; ++kk) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = v_s[kk * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float p = p_s[(ty + 16 * i) * PP + kk];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
    if (r >= nq) continue;
    // Zero-guarded denominator, as in the TPU kernel.
    const float denom = l[i] > 0.f ? l[i] : 1.f;
    T* o = out + (((int64_t)slot * sq + q0 + r) * h + head) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[tx + 16 * c] = Elem<T>::store(acc[i][c] / denom);
  }
}

// ---------------------------------------------------------------------------
// The bf16 prefill body on the tensor cores (mma.sync), FlashAttention-2's
// design: one CTA per (batch row, q head, BQ query rows), one warp for each 16
// query rows (BQ 64: 4 warps; BQ 16: one). Q is staged once and held in
// registers as ldmatrix A-fragments; 64-key K/V tiles are double-buffered in
// shared memory with cp.async (16 bytes at a time, zero-filled past n_keys so
// that table entries past a slot's rows are never read). S = Q.K^T is mma.sync
// m16n8k16 into fp32 (K fed by ldmatrix); the online softmax works on the
// accumulator fragments, reducing across each row's quad of lanes; P stays in
// registers and becomes the A-fragments of P.V (V fed by ldmatrix.trans), into
// an fp32 O. P rounded once to bf16 would move each weight by up to 2^-9 of
// itself, enough to move a row over a few keys by two bf16 steps of its output,
// past ref.TOLERANCE; so P goes in as a bf16 high part plus a bf16 residual,
// two products that keep 16 bits of each weight. Shared-memory rows are padded
// to D + 8 elements: at 144, 176, 208 and 272 bytes the 8 row addresses of an
// ldmatrix fall on distinct banks.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

template <int D, int BQ>
struct MmaTile {
  static constexpr int kThreads = BQ * 2;  // a warp for every 16 rows
  static constexpr int kRow = D + 8;  // padded row, elements
  static constexpr int kBytes = kTileK * kRow * 2;  // one K or V tile
  static constexpr int kQBytes = BQ * kRow * 2;     // the Q tile
  // Q, then K and V double-buffered.
  static constexpr int kSmem = kQBytes + 4 * kBytes;
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Issue the copies of logical rows [k0, k0 + kTileK) of kv head `hk` into
// the padded tile at `dst`; rows at or past n_rows are zero-filled and
// their addresses (page-table entries) unread.
template <int D, int BQ, typename Rows>
__device__ __forceinline__ void load_tile_async(const bf16* __restrict__ src,
                                                Rows rows, int kvh, int hk,
                                                int k0, int n_rows,
                                                uint32_t dst) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  for (int v = threadIdx.x; v < kTileK * kChunks;
       v += MmaTile<D, BQ>::kThreads) {
    const int r = v / kChunks;
    const int c = (v % kChunks) * 8;
    const bool valid = k0 + r < n_rows;
    const bf16* g = valid ? src + (rows(k0 + r) * kvh + hk) * D + c : src;
    cp_async16(dst + (r * MmaTile<D, BQ>::kRow + c) * 2, g, valid);
  }
}

// The same contract as prefill_kernel, for bf16.
template <int D, int BQ, typename Layout>
__global__ void __launch_bounds__(MmaTile<D, BQ>::kThreads)
prefill_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kp,
                   const bf16* __restrict__ vp, Layout layout,
                   const int* __restrict__ starts, int offset, bool causal,
                   bf16* __restrict__ out, int sq, int h, int kvh,
                   float scale_log2) {
  using M = MmaTile<D, BQ>;
  constexpr int kRow = M::kRow;
  constexpr int KD = D / 16;  // k-steps of Q.K^T over d
  constexpr int ND = D / 8;   // 8-column blocks of O
  extern __shared__ __align__(16) uint8_t mma_smem[];
  const uint32_t q_s = smem_u32(mma_smem);
  const auto k_s = [&](int buf) {
    return q_s + M::kQBytes + buf * M::kBytes;
  };
  const auto v_s = [&](int buf) {
    return q_s + M::kQBytes + (2 + buf) * M::kBytes;
  };
  // The last query blocks, which see the most keys, start first.
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int head = blockIdx.y;
  const int slot = blockIdx.z;
  const int hk = head / (h / kvh);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int start = starts != nullptr ? starts[slot] : offset;
  const int q0 = qb * BQ;
  const int nq = min(BQ, sq - q0);
  // The loop bound: the last key this block's last query sees.
  const int n_keys = causal ? min(start + q0 + nq, layout.max_rows())
                            : layout.max_rows();
  const int n_tiles = (n_keys + kTileK - 1) / kTileK;
  const auto rows = layout.rows(slot);

  // Q (zeros past sq) and the first K/V tile: one group.
  for (int v = tid; v < BQ * (D / 8); v += M::kThreads) {
    const int r = v / (D / 8);
    const int c = (v % (D / 8)) * 8;
    const bool valid = r < nq;
    const bf16* g =
        valid ? q + (((int64_t)slot * sq + q0 + r) * h + head) * D + c : q;
    cp_async16(q_s + (r * kRow + c) * 2, g, valid);
  }
  if (n_tiles > 0) {
    load_tile_async<D, BQ>(kp, rows, kvh, hk, 0, n_keys, k_s(0));
    load_tile_async<D, BQ>(vp, rows, kvh, hk, 0, n_keys, v_s(0));
  }
  cp_async_commit();

  // This thread's two query rows of the warp's 16: g and g + 8.
  const int r_lo = warp * 16 + (lane >> 2);
  float o[ND][4], m[2], l[2];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    m[hh] = kNegInf;  // in scaled (base-2) units
    l[hh] = 0.f;      // this thread's share; the quad's sum at the end
  }
  uint32_t qf[KD][4];

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      load_tile_async<D, BQ>(kp, rows, kvh, hk, (t + 1) * kTileK, n_keys,
                             k_s(buf ^ 1));
      load_tile_async<D, BQ>(vp, rows, kvh, hk, (t + 1) * kTileK, n_keys,
                             v_s(buf ^ 1));
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile t (and Q) have landed
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const int r = warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
        const int c = kk * 16 + 8 * (lane >> 4);
        ldsm_x4(q_s + (r * kRow + c) * 2, qf[kk]);
      }
    }

    // S = Q.K^T: 16 rows x 64 keys a warp, 8 blocks of 8 keys.
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t b[4];
        const int key = jp * 16 + (lane & 7) + 8 * (lane >> 4);
        const int c = kk * 16 + 8 * ((lane >> 3) & 1);
        ldsm_x4(k_s(buf) + (key * kRow + c) * 2, b);
        mma_bf16(s[2 * jp], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], b[2], b[3]);
      }
    }

    // Online softmax in base 2 (scores times scale * log2 e). Only tiles
    // that cross the end or the diagonal of this block's first row are
    // masked.
    const int k0 = t * kTileK;
    const bool edge =
        k0 + kTileK > n_keys || (causal && k0 + kTileK - 1 > start + q0);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int pos = start + q0 + r_lo + 8 * hh;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + 8 * j + 2 * (lane & 3) + e;
          float v = s[j][2 * hh + e] * scale_log2;
          if (edge && (col >= n_keys || (causal && col > pos))) v = kNegInf;
          s[j][2 * hh + e] = v;
          mx = fmaxf(mx, v);
        }
      const float m_new = fmaxf(m[hh], quad_max(mx));
      const float alpha = fast_exp2(m[hh] - m_new);
      // A row with no key yet keeps p = 0 for its masked scores.
      const float m_use = m_new == kNegInf ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = fast_exp2(s[j][2 * hh + e] - m_use);
          s[j][2 * hh + e] = p;
          sum += p;
        }
      l[hh] = l[hh] * alpha + sum;
      m[hh] = m_new;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        o[j][2 * hh] *= alpha;
        o[j][2 * hh + 1] *= alpha;
      }
    }

    // O += P.V: P's accumulator fragments are P.V's A-fragments, P split
    // into a bf16 high part and a bf16 residual (two products into one
    // fp32 O), so that the weights keep 16 bits, not bf16's 8.
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* p = &s[2 * kk + (i >> 1)][2 * (i & 1)];
        split_bf16(p[0], p[1], hi[i], lo[i]);
      }
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t b[4];
        const int key = kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
        const int c = dp * 16 + 8 * (lane >> 4);
        ldsm_x4_trans(v_s(buf) + (key * kRow + c) * 2, b);
        mma_bf16(o[2 * dp], hi, b[0], b[1]);
        mma_bf16(o[2 * dp], lo, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], hi, b[2], b[3]);
        mma_bf16(o[2 * dp + 1], lo, b[2], b[3]);
      }
    }
    __syncthreads();  // the next iteration refills this buffer
  }
  cp_async_wait<0>();

  // Zero-guarded denominator, as in the TPU kernel; one rounding to bf16.
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r_lo + 8 * hh;
    const float lsum = quad_sum(l[hh]);
    if (r >= nq) continue;
    const float inv = 1.f / (lsum > 0.f ? lsum : 1.f);
    bf16* orow = out + (((int64_t)slot * sq + q0 + r) * h + head) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * (lane & 3)) =
          pack_bf16(o[j][2 * hh] * inv, o[j][2 * hh + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// Decode, flash-decoding's design. The grid is (kv head x query block, slot,
// split): each CTA attends one run of rows_per_split rows of one slot for
// up to G query rows of one kv head (the group's rows share each K/V row
// read). rows_per_split is the decode's tile, taken at launch (one of
// kernels/flash_decode.py's SPLIT_ROWS_SET, rounded to whole pages: any
// positive value runs). The host sizes n_splits from the cache's reach
// (max_pages * page_size, or max_len), never from `lengths`; a split at
// or past the slot's clamped length reads nothing and exits. Inside a
// split each of the 4 warps walks its own 16-row tiles (warp w takes tiles w,
// w + 4, ...) through its own ring of kStages shared-memory stages filled
// by cp.async in K/V's own dtype (16 bytes a copy; rows padded by 16 bytes,
// so that a quarter-warp's 16-byte reads of 8 rows, and ldmatrix's 8 row
// addresses, fall on distinct banks): one tile's copies are in flight
// while the last is scored, and no CTA-wide barrier runs in the loop. Rows
// past the split's end are zero-filled by the copies (their table entries
// unread) and masked out of the softmax, so they add nothing to P.V. Each
// warp keeps its own online softmax (WarpDecode, below: fp32 FMAs on the
// CUDA cores for fp32, mma.sync for bf16); the warps' (m, l, acc) merge in
// a fixed order into the split's fp32 partial. The last of a slot's live
// splits to finish, found by an integer counter per (slot, query block),
// merges the live splits' partials in split order (log-sum-exp) and rounds
// once to T; a zero-length slot's first split writes zeros. No float
// atomics: the output is bit-reproducible from launch to launch.
// ---------------------------------------------------------------------------

constexpr int kDecThreads = 128;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kWarpRows = 16;  // rows a warp scores per tile
constexpr float kLn2 = 0.6931471805599453f;

template <typename T, int D>
struct DecodeTile {
  static constexpr int kPer = 16 / sizeof(T);      // elements a 16-byte chunk
  static constexpr int kVecs = D / kPer;           // chunks a row
  static constexpr int kRow = D * sizeof(T) + 16;  // padded row, bytes
  static constexpr int kStages = sizeof(T) == 2 ? 3 : 2;
  static constexpr int kStage = 2 * kWarpRows * kRow;  // K then V, bytes
  static constexpr int kRing = kStages * kStage;       // one warp's ring
  // CTAs an SM holds by shared memory (at most 3: the register budget a
  // thread then has, 170, leaves the bf16 body unspilled).
  static constexpr int kPerSm = 220 * 1024 / (kDecWarps * kRing) < 3
                                    ? 220 * 1024 / (kDecWarps * kRing)
                                    : 3;
};

// Two consecutive elements of a shared-memory row, widened.
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// One warp's online softmax over its tiles on the CUDA cores, in fp32, for
// G query rows. Scores: lane (row lane & 15, half lane >> 4) dots its half
// of the row's chunks with each query row (q staged in fp32), the halves
// summed by one shuffle. P.V: lane accumulates the column pairs lane + 32u,
// each row's weights broadcast by shuffles.
template <typename T, int D, int G>
struct WarpDecode {
  using Tile = DecodeTile<T, D>;
  static constexpr int kQBytes = G * D * 4;  // q_s: fp32 (G, D)
  static constexpr int kHalf = Tile::kVecs / 2;  // chunks a lane scores
  static constexpr int kUnits = (D / 2 + 31) / 32;  // column pairs a lane sums
  static_assert(Tile::kVecs % 2 == 0, "each half-warp scores half the chunks");
  float m[G], l[G], acc[G][kUnits][2];

  // The block's gc query rows (contiguous in q), zeros past them.
  static __device__ void stage_q(const T* qg, int gc, uint8_t* q_smem) {
    float* q_s = reinterpret_cast<float*>(q_smem);
    for (int v = threadIdx.x; v < G * Tile::kVecs; v += blockDim.x) {
      float tmp[Tile::kPer];
      if (v < gc * Tile::kVecs) {
        Elem<T>::load16(qg + v * Tile::kPer, tmp);
      } else {
#pragma unroll
        for (int e = 0; e < Tile::kPer; ++e) tmp[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < Tile::kPer; ++e) q_s[v * Tile::kPer + e] = tmp[e];
    }
  }

  __device__ void init(const uint8_t*, int) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      m[g] = kNegInf;
      l[g] = 0.f;
#pragma unroll
      for (int u = 0; u < kUnits; ++u) acc[g][u][0] = acc[g][u][1] = 0.f;
    }
  }

  // One tile: rows [0, n_live) of it are live.
  __device__ void tile(const uint8_t* k_t, const uint8_t* v_t, int n_live,
                       const uint8_t* q_smem, float scale, int lane) {
    const float* q_s = reinterpret_cast<const float*>(q_smem);
    const int row = lane & 15;
    const int half = lane >> 4;
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
#pragma unroll
    for (int j = 0; j < kHalf; ++j) {
      const int c = half * kHalf + j;
      float kf[Tile::kPer];
      Elem<T>::load16(
          reinterpret_cast<const T*>(k_t + row * Tile::kRow + c * 16), kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4* qc =
            reinterpret_cast<const float4*>(q_s + g * D + c * Tile::kPer);
#pragma unroll
        for (int e4 = 0; e4 < Tile::kPer / 4; ++e4) {
          const float4 qv = qc[e4];
          s[g] = fmaf(qv.x, kf[4 * e4], s[g]);
          s[g] = fmaf(qv.y, kf[4 * e4 + 1], s[g]);
          s[g] = fmaf(qv.z, kf[4 * e4 + 2], s[g]);
          s[g] = fmaf(qv.w, kf[4 * e4 + 3], s[g]);
        }
      }
    }
    const bool live = row < n_live;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float sc = s[g] + __shfl_xor_sync(0xffffffffu, s[g], 16);
      sc = live ? sc * scale : kNegInf;
      const float m_new = fmaxf(m[g], half_max(sc));
      const float p = live ? expf(sc - m_new) : 0.f;
      const float alpha = expf(m[g] - m_new);
      l[g] = l[g] * alpha + half_sum(p);
      m[g] = m_new;
      s[g] = p;  // lane r (< 16) holds row r's weight
#pragma unroll
      for (int u = 0; u < kUnits; ++u) {
        acc[g][u][0] *= alpha;
        acc[g][u][1] *= alpha;
      }
    }
#pragma unroll
    for (int r = 0; r < kWarpRows; ++r) {
      float p[G];
#pragma unroll
      for (int g = 0; g < G; ++g) p[g] = __shfl_sync(0xffffffffu, s[g], r);
      const T* vrow = reinterpret_cast<const T*>(v_t + r * Tile::kRow);
#pragma unroll
      for (int u = 0; u < kUnits; ++u) {
        const int cp = lane + 32 * u;
        if (cp < D / 2) {
          const float2 vv = load_pair(vrow + 2 * cp);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            acc[g][u][0] = fmaf(p[g], vv.x, acc[g][u][0]);
            acc[g][u][1] = fmaf(p[g], vv.y, acc[g][u][1]);
          }
        }
      }
    }
  }

  // The warp's (acc, m, l) of query row g at w_s + g * (D + 2).
  __device__ void store(float* w_s, int lane) const {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int u = 0; u < kUnits; ++u) {
        const int cp = lane + 32 * u;
        if (cp < D / 2) {
          w_s[g * (D + 2) + 2 * cp] = acc[g][u][0];
          w_s[g * (D + 2) + 2 * cp + 1] = acc[g][u][1];
        }
      }
      if (lane == 0) {
        w_s[g * (D + 2) + D] = m[g];
        w_s[g * (D + 2) + D + 1] = l[g];
      }
    }
  }
};

// The same on the tensor cores for bf16, G = 16 query rows (rows past the
// group are zeros): S = Q.K^T by mma.sync m16n8k16 into fp32 (Q held as
// A-fragments, K fed by ldmatrix), the online softmax in base 2 on the
// accumulator fragments, O += P.V with P as a bf16 high part plus a bf16
// residual (16 bits a weight, as prefill_mma_kernel) and V fed by
// ldmatrix.trans. The products are exact in fp32; the sums are fp32.
template <int D, int G>
struct WarpDecode<bf16, D, G> {
  static_assert(G == 16, "one m16 block of query rows");
  static constexpr int kRowE = D + 8;  // padded row, elements
  static constexpr int kQBytes = G * kRowE * 2;  // q_s: bf16 (16, D + 8)
  static constexpr int KD = D / 16;  // k-steps of Q.K^T over d
  static constexpr int ND = D / 8;   // 8-column blocks of O
  uint32_t qf[KD][4];
  float o[ND][4], m[2], l[2];  // rows lane / 4 and lane / 4 + 8

  static __device__ void stage_q(const bf16* qg, int gc, uint8_t* q_smem) {
    for (int v = threadIdx.x; v < G * (D / 8); v += blockDim.x) {
      const int r = v / (D / 8);
      const int c = (v % (D / 8)) * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (r < gc) x = *reinterpret_cast<const uint4*>(qg + r * D + c);
      *reinterpret_cast<uint4*>(q_smem + (r * kRowE + c) * 2) = x;
    }
  }

  __device__ void init(const uint8_t* q_smem, int lane) {
    const uint32_t q_s = smem_u32(q_smem);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const int r = (lane & 7) + 8 * ((lane >> 3) & 1);
      const int c = kk * 16 + 8 * (lane >> 4);
      ldsm_x4(q_s + (r * kRowE + c) * 2, qf[kk]);
    }
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    m[0] = m[1] = kNegInf;  // in scaled (base-2) units
    l[0] = l[1] = 0.f;      // this lane's share; the quad's sum at the end
  }

  __device__ void tile(const uint8_t* k_t, const uint8_t* v_t, int n_live,
                       const uint8_t*, float scale, int lane) {
    const uint32_t k_s = smem_u32(k_t);
    const uint32_t v_s = smem_u32(v_t);
    const float scale_log2 = scale * kLog2e;
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t b[4];
      const int key = (lane & 7) + 8 * (lane >> 4);
      const int c = kk * 16 + 8 * ((lane >> 3) & 1);
      ldsm_x4(k_s + (key * kRowE + c) * 2, b);
      mma_bf16(s[0], qf[kk], b[0], b[1]);
      mma_bf16(s[1], qf[kk], b[2], b[3]);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * (lane & 3) + e;
          const float v =
              col < n_live ? s[j][2 * hh + e] * scale_log2 : kNegInf;
          s[j][2 * hh + e] = v;
          mx = fmaxf(mx, v);
        }
      const float m_new = fmaxf(m[hh], quad_max(mx));  // finite: key 0 lives
      const float alpha = fast_exp2(m[hh] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = fast_exp2(s[j][2 * hh + e] - m_new);
          s[j][2 * hh + e] = p;
          sum += p;
        }
      l[hh] = l[hh] * alpha + sum;
      m[hh] = m_new;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        o[j][2 * hh] *= alpha;
        o[j][2 * hh + 1] *= alpha;
      }
    }
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float* p = &s[i >> 1][2 * (i & 1)];
      split_bf16(p[0], p[1], hi[i], lo[i]);
    }
#pragma unroll
    for (int dp = 0; dp < ND / 2; ++dp) {
      uint32_t b[4];
      const int key = (lane & 7) + 8 * ((lane >> 3) & 1);
      const int c = dp * 16 + 8 * (lane >> 4);
      ldsm_x4_trans(v_s + (key * kRowE + c) * 2, b);
      mma_bf16(o[2 * dp], hi, b[0], b[1]);
      mma_bf16(o[2 * dp], lo, b[0], b[1]);
      mma_bf16(o[2 * dp + 1], hi, b[2], b[3]);
      mma_bf16(o[2 * dp + 1], lo, b[2], b[3]);
    }
  }

  // m leaves in natural-log units, as the CUDA-core path's.
  __device__ void store(float* w_s, int lane) const {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int g = (lane >> 2) + 8 * hh;
      const float lsum = quad_sum(l[hh]);
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const int c = 8 * j + 2 * (lane & 3);
        w_s[g * (D + 2) + c] = o[j][2 * hh];
        w_s[g * (D + 2) + c + 1] = o[j][2 * hh + 1];
      }
      if ((lane & 3) == 0) {
        w_s[g * (D + 2) + D] = m[hh] * kLn2;
        w_s[g * (D + 2) + D + 1] = lsum;
      }
    }
  }
};

// Merge the first n_live splits' partials of one (slot, head) row in split
// order, and round once to T: one warp, each lane its columns lane + 32k.
// Where lse is not null, lane 0 also writes the row's log-sum-exp of its
// scaled scores, m + log(l), in natural-log units.
// acc: (n_splits, D) and ml: (n_splits, 2) of the row. Other CTAs wrote
// them, so they are read through L2 (ld.global.cg), past this SM's L1; the
// loads of the first kAhead splits are all issued before any is used, so
// the merge of up to kAhead splits waits on L2 once. Every live split has
// l >= 1 (its largest score's weight is 1).
template <typename T, int D>
__device__ void merge_splits(const float* __restrict__ acc,
                             const float* __restrict__ ml, int n_live,
                             T* __restrict__ orow, float* __restrict__ lse,
                             int lane) {
  constexpr int kCols = (D + 31) / 32;
  constexpr int kAhead = 8;
  float m_a[kAhead], l_a[kAhead], a[kAhead][kCols];
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    m_a[j] = j < n_live ? __ldcg(ml + 2 * j) : kNegInf;
    l_a[j] = j < n_live ? __ldcg(ml + 2 * j + 1) : 0.f;
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int c = lane + 32 * k;
      a[j][k] = j < n_live && c < D ? __ldcg(acc + j * D + c) : 0.f;
    }
  }
  float mx = kNegInf;  // lane j reads the m of splits j, j + 32, ...
  for (int sp = lane; sp < n_live; sp += 32)
    mx = fmaxf(mx, __ldcg(ml + 2 * sp));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  float o[kCols], lsum = 0.f;  // the same sums, in split order, in each lane
#pragma unroll
  for (int k = 0; k < kCols; ++k) o[k] = 0.f;
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    if (j < n_live) {
      const float w = expf(m_a[j] - mx);
      lsum = fmaf(w, l_a[j], lsum);
#pragma unroll
      for (int k = 0; k < kCols; ++k) o[k] = fmaf(w, a[j][k], o[k]);
    }
  }
  for (int j = kAhead; j < n_live; ++j) {
    const float w = expf(__ldcg(ml + 2 * j) - mx);
    lsum = fmaf(w, __ldcg(ml + 2 * j + 1), lsum);
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int c = lane + 32 * k;
      if (c < D) o[k] = fmaf(w, __ldcg(acc + (int64_t)j * D + c), o[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const int c = lane + 32 * k;
    if (c < D) orow[c] = Elem<T>::store(o[k] / lsum);
  }
  if (lse != nullptr && lane == 0) *lse = mx + logf(lsum);
}

// part: fp32 scratch, acc (b, h, n_splits, D) then (m, l) (b, h, n_splits,
// 2); counters: int (b, h), zeros (the last CTA of a slot's query block
// resets its own); lse: fp32 (b, h) or null, each row's log-sum-exp (-inf
// for a zero-length slot). Query block gb of kv head hk holds the group's rows
// gb * G onwards; blockIdx.x = hk * n_gb + gb < h.
template <typename T, int D, int G, typename Layout>
__global__ void __launch_bounds__(kDecThreads, (DecodeTile<T, D>::kPerSm))
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, Layout layout,
                    const int* __restrict__ lengths, float* __restrict__ part,
                    int* __restrict__ counters, T* __restrict__ out,
                    float* __restrict__ lse, int h, int kvh,
                    int rows_per_split, float scale) {
  using Tile = DecodeTile<T, D>;
  using Warp = WarpDecode<T, D, G>;
  static_assert(Tile::kRing >= G * (D + 2) * 4, "a ring holds its warp's partial");
  constexpr int kVecs = Tile::kVecs;
  constexpr int kStages = Tile::kStages;
  const int group = h / kvh;
  const int n_gb = (group + G - 1) / G;
  const int hk = blockIdx.x / n_gb;
  const int g0 = (blockIdx.x % n_gb) * G;
  const int gc = min(G, group - g0);
  const int slot = blockIdx.y;
  const int split = blockIdx.z;
  const int n_splits = gridDim.z;
  const int head0 = hk * group + g0;
  // Rows past the table's reach (or the cache's end) are not there: the
  // TPU kernels' grids stop at max_pages * page_size (max_len) rows too.
  const int n = max(0, min(lengths[slot], layout.max_rows()));
  const int s0 = split * rows_per_split;
  float* part_ml = part + (int64_t)gridDim.y * h * n_splits * D;
  const auto at = [=](int g) {
    return ((int64_t)slot * h + head0 + g) * n_splits + split;
  };
  if (s0 >= n) {
    // An empty split: the merge reads only the live splits, which come
    // first. A zero-length slot (a freed engine slot) has none: zeros.
    if (split == 0) {
      T* og = out + ((int64_t)slot * h + head0) * D;
      for (int e = threadIdx.x; e < gc * D; e += kDecThreads)
        og[e] = Elem<T>::store(0.f);
      if (lse != nullptr)
        for (int g = threadIdx.x; g < gc; g += kDecThreads)
          lse[(int64_t)slot * h + head0 + g] = __int_as_float(0xff800000);
    }
    return;
  }
  const int n_end = min(n, s0 + rows_per_split);
  extern __shared__ __align__(16) uint8_t dec_smem[];
  uint8_t* q_s = dec_smem + kDecWarps * Tile::kRing;
  int* pages_s = reinterpret_cast<int*>(q_s + Warp::kQBytes);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  Warp::stage_q(q + ((int64_t)slot * h + head0) * D, gc, q_s);
  const auto rows = layout.stage(slot, s0, n_end, pages_s);
  __syncthreads();

  uint8_t* ring = dec_smem + warp * Tile::kRing;
  const int n_tiles = (n_end - s0 + kWarpRows - 1) / kWarpRows;
  const int my_tiles =
      n_tiles > warp ? (n_tiles - warp + kDecWarps - 1) / kDecWarps : 0;
  const auto tile_row = [=](int i) {
    return s0 + (warp + i * kDecWarps) * kWarpRows;
  };
  // The copies of the warp's i-th tile into stage i % kStages.
  const auto issue = [=](int i) {
    const int r0 = tile_row(i);
    const uint32_t st = smem_u32(ring + (i % kStages) * Tile::kStage);
    for (int v = lane; v < kWarpRows * kVecs; v += 32) {
      const int r = v / kVecs;
      const int c = v % kVecs;
      const bool valid = r0 + r < n_end;
      const int64_t off =
          valid ? (rows(r0 + r) * kvh + hk) * D + c * Tile::kPer : 0;
      cp_async16(st + r * Tile::kRow + c * 16, kp + off, valid);
      cp_async16(st + (kWarpRows + r) * Tile::kRow + c * 16, vp + off, valid);
    }
  };

  Warp w;
  w.init(q_s, lane);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < my_tiles) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < my_tiles; ++i) {
    if (i + kStages - 1 < my_tiles) issue(i + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // tile i has landed
    __syncwarp();
    const uint8_t* k_t = ring + (i % kStages) * Tile::kStage;
    w.tile(k_t, k_t + kWarpRows * Tile::kRow, n_end - tile_row(i), q_s,
           scale, lane);
    __syncwarp();  // the stage is read out before it is refilled
  }
  cp_async_wait<0>();
  __syncwarp();

  // Each warp's (m, l, acc) into its own ring (its copies have landed),
  // then merged over the warps in order into the split's partial. A warp
  // without a tile has m = -inf, l = 0, acc = 0: weight 0 (warp 0 always
  // has one, so the merged max is finite).
  w.store(reinterpret_cast<float*>(ring), lane);
  __syncthreads();
  const auto warp_part = [=](int wi, int g) {
    return reinterpret_cast<const float*>(dec_smem + wi * Tile::kRing) +
           g * (D + 2);
  };
  for (int e = tid; e < gc * D; e += kDecThreads) {
    const int g = e / D;
    const int c = e % D;
    float mx = kNegInf;
#pragma unroll
    for (int wi = 0; wi < kDecWarps; ++wi) mx = fmaxf(mx, warp_part(wi, g)[D]);
    float a = 0.f, lsum = 0.f;
#pragma unroll
    for (int wi = 0; wi < kDecWarps; ++wi) {
      const float* ws = warp_part(wi, g);
      const float wt = expf(ws[D] - mx);
      a = fmaf(wt, ws[c], a);
      lsum = fmaf(wt, ws[D + 1], lsum);
    }
    part[at(g) * D + c] = a;
    if (c == 0) {
      part_ml[at(g) * 2] = mx;
      part_ml[at(g) * 2 + 1] = lsum;
    }
  }

  // The last of the slot's live splits to finish (an integer counter per
  // (slot, query block) finds it, and is left at 0 for the next launch)
  // merges them, one warp a query row.
  const int n_live = (n + rows_per_split - 1) / rows_per_split;
  __shared__ bool last;
  __syncthreads();
  if (tid == 0) {
    __threadfence();  // this split's partial is visible before the count
    int* count = counters + (int64_t)slot * h + blockIdx.x;
    last = atomicAdd(count, 1) == n_live - 1;
    if (last) *count = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int g = warp; g < gc; g += kDecWarps) {
    const int64_t r = (int64_t)slot * h + head0 + g;
    merge_splits<T, D>(part + r * n_splits * D, part_ml + r * n_splits * 2,
                       n_live, out + r * D,
                       lse == nullptr ? nullptr : lse + r, lane);
  }
}

template <typename T, int D, int G, typename Layout>
cudaError_t launch_decode(const void* q, const void* k, const void* v,
                          Layout layout, const void* lengths, void* part,
                          void* counters, void* out, void* lse, int b, int h,
                          int kvh, int rows_per_split, int n_splits,
                          cudaStream_t stream) {
  using Tile = DecodeTile<T, D>;
  const size_t smem = kDecWarps * Tile::kRing + WarpDecode<T, D, G>::kQBytes +
                      sizeof(int) * layout.split_entries(rows_per_split);
  auto kernel = decode_split_kernel<T, D, G, Layout>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(kvh * ((h / kvh + G - 1) / G), b, n_splits);
  kernel<<<grid, kDecThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), layout, static_cast<const int*>(lengths),
      static_cast<float*>(part), static_cast<int*>(counters),
      static_cast<T*>(out), static_cast<float*>(lse), h, kvh, rows_per_split,
      1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

// Query blocks of 16 rows on the tensor cores (bf16), of 8 on the CUDA
// cores (fp32). At a group of 1 (MHA: phi3-mini's 32 kv heads of 96) a
// block holds one live row: 15 of the bf16 block's 16 rows are zeros that
// the mma.sync multiplies all the same, and a CTA reads its kv head's rows
// for one query. Right, not fast: the decode stays bound by the K/V bytes
// it reads, which MHA does not share between query rows anyway.
template <typename T, int D, typename Layout>
cudaError_t dispatch_decode(const void* q, const void* k, const void* v,
                            Layout layout, const void* lengths, void* part,
                            void* counters, void* out, void* lse, int b, int h,
                            int kvh, int rows_per_split, int n_splits,
                            cudaStream_t stream) {
  constexpr int G = std::is_same<T, bf16>::value ? 16 : 8;
  return launch_decode<T, D, G>(q, k, v, layout, lengths, part, counters, out,
                                lse, b, h, kvh, rows_per_split, n_splits,
                                stream);
}

template <int D, int BQ, typename Layout>
cudaError_t launch_prefill_mma(const void* q, const void* kp, const void* vp,
                               Layout layout, const void* starts, int offset,
                               bool causal, void* out, int b, int sq, int h,
                               int kvh, cudaStream_t stream) {
  using M = MmaTile<D, BQ>;
  auto kernel = prefill_mma_kernel<D, BQ, Layout>;
  cudaError_t err = repro::allow_smem(kernel, M::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, h, b);
  kernel<<<grid, M::kThreads, M::kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kp),
      static_cast<const bf16*>(vp), layout, static_cast<const int*>(starts),
      offset, causal, static_cast<bf16*>(out), sq, h, kvh,
      kLog2e / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

template <typename T, int D, int BQ, typename Layout>
cudaError_t launch_prefill(const void* q, const void* kp, const void* vp,
                           Layout layout, const void* starts, int offset,
                           bool causal, void* out, int b, int sq, int h,
                           int kvh, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
                      ((BQ + 2 * kTileK) * (D + 1) + BQ * (kTileK + 1));
  auto kernel = prefill_kernel<T, D, BQ, Layout>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, h, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      layout, static_cast<const int*>(starts), offset, causal, static_cast<T*>(out),
      sq, h, kvh, 1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

// Run `launch` at the instantiated query block equal to block_q; an
// uninstantiated one returns kUnsupported and launches nothing.
template <typename Launch, int... BQs>
int by_block_q(std::integer_sequence<int, BQs...>, int block_q,
               Launch launch) {
  int err = repro::kUnsupported;
  (void)((block_q == BQs &&
          (err = static_cast<int>(launch(std::integral_constant<int, BQs>{})),
           true)) ||
         ...);
  return err;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. head_dim d in {64, 80, 96, 128}. part:
// fp32 scratch of b * h * n_splits * (d + 2) floats; counters: b * h ints,
// zeros, which each launch leaves at zero (one stream at a time); lse (the
// contiguous decode's): null, or b * h floats for each row's log-sum-exp;
// n_splits
// runs of rows_per_split rows must cover the layout's reach. Returns the
// cudaError_t of the launches (0 on success), or -1 for a dtype, head_dim
// or split this build does not take.
#define DISPATCH_DECODE(LAYOUT, MAX_ROWS)                                      \
  if (kvh <= 0 || h % kvh != 0 || rows_per_split <= 0 || n_splits <= 0 ||     \
      n_splits > 65535 || (int64_t)n_splits * rows_per_split < (MAX_ROWS))    \
    return repro::kUnsupported;                                                \
  if (dtype == 0) {                                                            \
    if (d == 64) DECODE(float, 64, LAYOUT);                                    \
    if (d == 80) DECODE(float, 80, LAYOUT);                                    \
    if (d == 96) DECODE(float, 96, LAYOUT);                                    \
    if (d == 128) DECODE(float, 128, LAYOUT);                                  \
  } else if (dtype == 1) {                                                     \
    if (d == 64) DECODE(__nv_bfloat16, 64, LAYOUT);                            \
    if (d == 80) DECODE(__nv_bfloat16, 80, LAYOUT);                            \
    if (d == 96) DECODE(__nv_bfloat16, 96, LAYOUT);                            \
    if (d == 128) DECODE(__nv_bfloat16, 128, LAYOUT);                          \
  }                                                                            \
  return repro::kUnsupported
#define DECODE(T, D, LAYOUT)                                                   \
  return static_cast<int>(dispatch_decode<T, D>(                               \
      q, k, v, LAYOUT, lengths, part, counters, out, lse, b, h, kvh,           \
      rows_per_split, n_splits, static_cast<cudaStream_t>(stream)))

extern "C" int paged_decode(int dtype, int d, const void* q, const void* k,
                            const void* v, const void* table,
                            const void* lengths, void* part, void* counters,
                            void* out, int b, int h, int kvh, int page_size,
                            int max_pages, int rows_per_split, int n_splits,
                            void* stream) {
  if (page_size <= 0) return repro::kUnsupported;
  const PagedLayout layout{static_cast<const int*>(table), page_size, max_pages};
  void* const lse = nullptr;
  DISPATCH_DECODE(layout, (int64_t)max_pages * page_size);
}

extern "C" int contiguous_decode(int dtype, int d, const void* q,
                                 const void* k, const void* v,
                                 const void* lengths, void* part,
                                 void* counters, void* out, void* lse, int b,
                                 int h, int kvh, int max_len,
                                 int rows_per_split, int n_splits,
                                 void* stream) {
  const ContiguousLayout layout{max_len};
  DISPATCH_DECODE(layout, (int64_t)max_len);
}
#undef DECODE
#undef DISPATCH_DECODE

#define DISPATCH_PREFILL(LAYOUT, STARTS, OFFSET, CAUSAL)                      \
  if (dtype == 0) {                                                            \
    if (d == 64) PREFILL(float, 64, LAYOUT, STARTS, OFFSET, CAUSAL);           \
    if (d == 80) PREFILL(float, 80, LAYOUT, STARTS, OFFSET, CAUSAL);           \
    if (d == 96) PREFILL(float, 96, LAYOUT, STARTS, OFFSET, CAUSAL);           \
    if (d == 128) PREFILL(float, 128, LAYOUT, STARTS, OFFSET, CAUSAL);         \
  } else if (dtype == 1) { /* bf16: the tensor-core body */                  \
    if (d == 64) PREFILL_MMA(64, LAYOUT, STARTS, OFFSET, CAUSAL);              \
    if (d == 80) PREFILL_MMA(80, LAYOUT, STARTS, OFFSET, CAUSAL);              \
    if (d == 96) PREFILL_MMA(96, LAYOUT, STARTS, OFFSET, CAUSAL);              \
    if (d == 128) PREFILL_MMA(128, LAYOUT, STARTS, OFFSET, CAUSAL);            \
  }                                                                            \
  return repro::kUnsupported
#define PREFILL(T, D, LAYOUT, STARTS, OFFSET, CAUSAL)                          \
  return by_block_q(PrefillBlockQs{}, block_q, [&](auto bq) {                  \
    return launch_prefill<T, D, decltype(bq)::value>(                          \
        q, k, v, LAYOUT, STARTS, OFFSET, CAUSAL, out, b, sq, h, kvh,           \
        static_cast<cudaStream_t>(stream));                                    \
  })
#define PREFILL_MMA(D, LAYOUT, STARTS, OFFSET, CAUSAL)                         \
  return by_block_q(PrefillBlockQs{}, block_q, [&](auto bq) {                  \
    return launch_prefill_mma<D, decltype(bq)::value>(                         \
        q, k, v, LAYOUT, STARTS, OFFSET, CAUSAL, out, b, sq, h, kvh,           \
        static_cast<cudaStream_t>(stream));                                    \
  })

// block_q: the query rows a CTA, one of PrefillBlockQs (else -1, nothing
// launched).
extern "C" int paged_prefill(int dtype, int d, const void* q, const void* k,
                             const void* v, const void* table,
                             const void* starts, void* out, int b, int sq,
                             int h, int kvh, int page_size, int max_pages,
                             int block_q, void* stream) {
  const PagedLayout layout{static_cast<const int*>(table), page_size, max_pages};
  DISPATCH_PREFILL(layout, starts, 0, true);
}

// q (b, sq, h, d), k/v (b, skv, kvh, d), out like q; causal 0 or 1. The
// caller guarantees skv >= sq when causal (every query sees a key).
extern "C" int flash_attention(int dtype, int d, const void* q, const void* k,
                               const void* v, void* out, int b, int sq,
                               int skv, int h, int kvh, int causal,
                               int block_q, void* stream) {
  const ContiguousLayout layout{skv};
  DISPATCH_PREFILL(layout, nullptr, skv - sq, causal != 0);
}
#undef PREFILL
#undef PREFILL_MMA
#undef DISPATCH_PREFILL
