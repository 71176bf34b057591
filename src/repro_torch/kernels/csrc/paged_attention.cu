// Attention, written by hand for Hopper (sm_90a).
//
// Four kernels over K/V rows that are found either through a page table
// (a shared pool (n_pages, page_size, kvh, d) walked through each slot's
// table row (b, max_pages), page 0 being the null page) or at a fixed base
// per batch row (a contiguous cache or sequence (b, max_len, kvh, d)):
//
//   decode_kernel<PagedLayout>       replaces repro/kernels/flash_decode.py
//                                    flash_decode_paged (_paged_decode_kernel,
//                                    _decode_body): one query token per slot.
//   decode_kernel<ContiguousLayout>  replaces repro/kernels/flash_decode.py
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
// a logical row's address is found differs (the layout's `rows(slot)`),
// and where the queries sit: a chunk's rows start at `starts[slot]`, a
// sequence's at skv - sq (the causal diagonal's offset). The decodes and
// the fp32 prefill keep the TPU kernels' math: q, k and v are read as
// fp32, scores, the online softmax (running max m, denominator l,
// accumulator acc) and the P.V products are fp32, and the output is
// rounded once to q's dtype. K/V stay in their own dtype: they are widened
// to fp32 per tile on load, never copied. The bf16 prefill
// (prefill_mma_kernel, below) multiplies bf16 on the tensor cores into
// fp32, and feeds P.V the bf16 high part and residual of P.
//
// What bounds them on an H100. Decode reads every live K/V row of a slot
// once per kv head and does 4 * group * d flops per row: it is bound by
// bytes (2 * kvh * d * sizeof(T) per row per layer over 3.35 TB/s). Its
// design: one CTA per (slot, kv head) holds the group's query rows, so
// each K/V row is read from device memory once for all of them, and a
// tile of 64 rows is staged in shared memory with 16-byte loads. At b=8,
// kvh=8 that is 64 CTAs on 132 SMs: the card is underfilled at small
// batch, and nothing overlaps one tile's loads with the last tile's math.
// Splitting the context across CTAs (flash-decoding) is the next step.
//
// Prefill at a 256-row chunk, and the full-sequence forward, do 4 * d
// flops per (query, key) pair and read each K/V row once per query block:
// they are bound by operations. The design: one CTA per (batch row, q
// head, 64 query rows). bf16 runs FlashAttention-2's mma.sync body on the
// tensor cores (prefill_mma_kernel: 4 warps of 16 query rows, Q in
// registers, K/V tiles double-buffered by cp.async). fp32 stays on the
// CUDA cores, which keep full fp32 where the tensor cores would take it
// only as TF32: 256 threads each own a 4x4 block of the 64x64 score tile
// in registers (rows ty+16i, columns tx+16j, so shared-memory reads are
// conflict-free), fp32 FMAs (prefill_kernel). Causality is a loop
// bound, not a grid: a CTA walks key tiles up to the last key its last
// query row sees, and masks only what lies past the diagonal (or past the
// end) inside a tile, so any sq and skv work, 1 and primes included. The
// TPU kernel instead enumerates the lower triangle of (q block, k block)
// pairs in scalar-prefetched maps and snaps its blocks to divisors of the
// lengths. q, k and v are read in their (b, s, heads, d) layout; GQA is
// kv_head = head / group. A wgmma body (head_dim 80's 160-byte rows do
// not fit wgmma's 128-byte swizzle) is later work.
//
// The page walk: before a tile's rows are loaded, each row's physical page
// is read from the table (page_table[slot, row / page_size]); entries past
// the rows a slot needs are never read. `starts` and `lengths` are data,
// so one build serves every chunk position and every context length.

#include "common.cuh"

namespace {

using repro::Elem;
using repro::kNegInf;
using repro::warp_max;
using repro::warp_sum;

constexpr int kThreads = 256;
constexpr int kTileK = 64;     // key rows staged per iteration
constexpr int kBlockQ = 64;    // prefill query rows per CTA

// Where a slot's logical K/V rows live. rows(slot)(r) is the index of
// logical row r in the (rows, kvh, d) view of the pool or cache, and
// max_rows() bounds what a slot can reach.
struct PagedRows {
  const int* trow;  // the slot's page-table row
  int page_size;
  __device__ int64_t operator()(int row) const {
    const int64_t page = trow[row / page_size];
    return page * page_size + row % page_size;
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

template <typename T, int D, typename Layout>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
              const T* __restrict__ vp, Layout layout,
              const int* __restrict__ lengths, T* __restrict__ out, int h,
              int kvh, float scale) {
  constexpr int DP = D + 1;
  constexpr int kWarps = kThreads / 32;
  constexpr int kPer = Elem<T>::kPerVec;
  const int hk = blockIdx.x;
  const int slot = blockIdx.y;
  const int group = h / kvh;
  extern __shared__ float smem[];
  float* k_s = smem;                  // kTileK x DP
  float* v_s = k_s + kTileK * DP;     // kTileK x DP
  float* q_s = v_s + kTileK * DP;     // group x D
  float* acc_s = q_s + group * D;     // group x D
  float* s_s = acc_s + group * D;     // group x kTileK (scores, then p)
  float* m_s = s_s + group * kTileK;  // group
  float* l_s = m_s + group;           // group
  float* a_s = l_s + group;           // group (this tile's rescale)
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // Rows past the table's reach (or the cache's end) are not there: the
  // TPU kernels' grids stop at max_pages * page_size (max_len) rows too.
  const int n = max(0, min(lengths[slot], layout.max_rows()));
  const auto rows = layout.rows(slot);
  // The group's query rows are contiguous in q (b, h, d).
  const T* qg = q + ((int64_t)slot * h + (int64_t)hk * group) * D;
  for (int v = tid; v < group * D / kPer; v += kThreads) {
    float tmp[kPer];
    Elem<T>::load16(qg + v * kPer, tmp);
#pragma unroll
    for (int e = 0; e < kPer; ++e) q_s[v * kPer + e] = tmp[e];
  }
  for (int e = tid; e < group * D; e += kThreads) acc_s[e] = 0.f;
  for (int g = tid; g < group; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  for (int k0 = 0; k0 < n; k0 += kTileK) {
    __syncthreads();  // the last tile's readers are done with k_s/v_s/s_s
    load_kv_tile<T, D>(kp, rows, kvh, hk, k0, n, k_s);
    load_kv_tile<T, D>(vp, rows, kvh, hk, k0, n, v_s);
    __syncthreads();
    for (int e = tid; e < group * kTileK; e += kThreads) {
      const int g = e / kTileK;
      const int r = e % kTileK;
      const float* qr = q_s + g * D;
      const float* kr = k_s + r * DP;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      s_s[e] = (k0 + r < n) ? dot * scale : kNegInf;
    }
    __syncthreads();
    for (int g = warp; g < group; g += kWarps) {
      float* s = s_s + g * kTileK;
      float mx = kNegInf;
      for (int r = lane; r < kTileK; r += 32) mx = fmaxf(mx, s[r]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = lane; r < kTileK; r += 32) {
        const float p = (k0 + r < n) ? expf(s[r] - m_new) : 0.f;
        s[r] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    for (int e = tid; e < group * D; e += kThreads) {
      const int g = e / D;
      const int c = e % D;
      const float* p = s_s + g * kTileK;
      float acc = acc_s[e] * a_s[g];
#pragma unroll 8
      for (int r = 0; r < kTileK; ++r) acc = fmaf(p[r], v_s[r * DP + c], acc);
      acc_s[e] = acc;
    }
  }
  __syncthreads();
  // A zero-length slot (a freed engine slot) has l = 0 and acc = 0: zeros.
  T* og = out + ((int64_t)slot * h + (int64_t)hk * group) * D;
  for (int e = tid; e < group * D; e += kThreads) {
    const float l = l_s[e / D];
    og[e] = Elem<T>::store(acc_s[e] / (l > 0.f ? l : 1.f));
  }
}

// Query r of batch row `slot` sits at position `start + r`, where start is
// starts[slot] (a chunk through a page table) or, without `starts`, the
// fixed `offset` (skv - sq: a sequence's causal diagonal). Causal: it sees
// keys <= its position that the layout holds (< max_rows()); otherwise
// every key the layout holds.
template <typename T, int D, typename Layout>
__global__ void __launch_bounds__(kThreads, 2)
prefill_kernel(const T* __restrict__ q, const T* __restrict__ kp,
               const T* __restrict__ vp, Layout layout,
               const int* __restrict__ starts, int offset, bool causal,
               T* __restrict__ out, int sq, int h, int kvh, float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = kTileK + 1;
  constexpr int DC = D / 16;  // output columns per thread
  constexpr int kPer = Elem<T>::kPerVec;
  constexpr int kVecs = D / kPer;
  const int qb = blockIdx.x;
  const int head = blockIdx.y;
  const int slot = blockIdx.z;
  const int hk = head / (h / kvh);
  extern __shared__ float smem[];
  float* q_s = smem;                  // kBlockQ x DP
  float* k_s = q_s + kBlockQ * DP;    // kTileK x DP
  float* v_s = k_s + kTileK * DP;     // kTileK x DP
  float* p_s = v_s + kTileK * DP;     // kBlockQ x PP
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int start = starts != nullptr ? starts[slot] : offset;
  const int q0 = qb * kBlockQ;
  const int nq = min(kBlockQ, sq - q0);
  // The loop bound: the last key this block's last query sees.
  const int n_keys = causal ? min(start + q0 + nq, layout.max_rows())
                            : layout.max_rows();
  const auto rows = layout.rows(slot);
  for (int v = tid; v < kBlockQ * kVecs; v += kThreads) {
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
  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
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
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = q_s[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = k_s[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
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
      for (int i = 0; i < 4; ++i) {
        const float p = p_s[(ty + 16 * i) * PP + kk];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
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
// design: one CTA per (batch row, q head, 64 query rows), 4 warps of 16
// query rows. Q is staged once and held in registers as ldmatrix
// A-fragments; 64-key K/V tiles are double-buffered in shared memory with
// cp.async (16 bytes at a time, zero-filled past n_keys so that table
// entries past a slot's rows are never read). S = Q.K^T is mma.sync
// m16n8k16 into fp32 (K fed by ldmatrix); the online softmax works on the
// accumulator fragments, reducing across each row's quad of lanes; P stays
// in registers and becomes the A-fragments of P.V (V fed by
// ldmatrix.trans), into an fp32 O. P rounded once to bf16 would move each
// weight by up to 2^-9 of itself, enough to move a row over a few keys by
// two bf16 steps of its output, past ref.TOLERANCE; so P goes in as a bf16
// high part plus a bf16 residual, two products that keep 16 bits of each
// weight. Shared-memory rows
// are padded to D + 8 elements: at 144, 176 and 272 bytes the 8 row
// addresses of an ldmatrix fall on distinct banks.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kMmaThreads = 128;  // 4 warps x 16 query rows = kBlockQ
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct MmaTile {
  static constexpr int kRow = D + 8;  // padded row, elements
  static constexpr int kBytes = kTileK * kRow * 2;  // one 64-row tile
};
static_assert(kBlockQ == kTileK, "q and k/v tiles share one layout");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros (and no read) if !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col).
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (a, b) as packed bf16 pairs hi and lo with a = hi.x + lo.x, b = hi.y +
// lo.y to 16 bits.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - __low2float(h), b - __high2float(h));
}

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
template <int D, typename Rows>
__device__ __forceinline__ void load_tile_async(const bf16* __restrict__ src,
                                                Rows rows, int kvh, int hk,
                                                int k0, int n_rows,
                                                uint32_t dst) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  for (int v = threadIdx.x; v < kTileK * kChunks; v += kMmaThreads) {
    const int r = v / kChunks;
    const int c = (v % kChunks) * 8;
    const bool valid = k0 + r < n_rows;
    const bf16* g = valid ? src + (rows(k0 + r) * kvh + hk) * D + c : src;
    cp_async16(dst + (r * MmaTile<D>::kRow + c) * 2, g, valid);
  }
}

// The same contract as prefill_kernel, for bf16.
template <int D, typename Layout>
__global__ void __launch_bounds__(kMmaThreads)
prefill_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kp,
                   const bf16* __restrict__ vp, Layout layout,
                   const int* __restrict__ starts, int offset, bool causal,
                   bf16* __restrict__ out, int sq, int h, int kvh,
                   float scale_log2) {
  using M = MmaTile<D>;
  constexpr int kRow = M::kRow;
  constexpr int KD = D / 16;  // k-steps of Q.K^T over d
  constexpr int ND = D / 8;   // 8-column blocks of O
  extern __shared__ __align__(16) uint8_t mma_smem[];
  const uint32_t q_s = smem_u32(mma_smem);
  const auto k_s = [&](int buf) { return q_s + (1 + buf) * M::kBytes; };
  const auto v_s = [&](int buf) { return q_s + (3 + buf) * M::kBytes; };
  // The last query blocks, which see the most keys, start first.
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int head = blockIdx.y;
  const int slot = blockIdx.z;
  const int hk = head / (h / kvh);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int start = starts != nullptr ? starts[slot] : offset;
  const int q0 = qb * kBlockQ;
  const int nq = min(kBlockQ, sq - q0);
  // The loop bound: the last key this block's last query sees.
  const int n_keys = causal ? min(start + q0 + nq, layout.max_rows())
                            : layout.max_rows();
  const int n_tiles = (n_keys + kTileK - 1) / kTileK;
  const auto rows = layout.rows(slot);

  // Q (zeros past sq) and the first K/V tile: one group.
  for (int v = tid; v < kBlockQ * (D / 8); v += kMmaThreads) {
    const int r = v / (D / 8);
    const int c = (v % (D / 8)) * 8;
    const bool valid = r < nq;
    const bf16* g =
        valid ? q + (((int64_t)slot * sq + q0 + r) * h + head) * D + c : q;
    cp_async16(q_s + (r * kRow + c) * 2, g, valid);
  }
  if (n_tiles > 0) {
    load_tile_async<D>(kp, rows, kvh, hk, 0, n_keys, k_s(0));
    load_tile_async<D>(vp, rows, kvh, hk, 0, n_keys, v_s(0));
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
      load_tile_async<D>(kp, rows, kvh, hk, (t + 1) * kTileK, n_keys,
                         k_s(buf ^ 1));
      load_tile_async<D>(vp, rows, kvh, hk, (t + 1) * kTileK, n_keys,
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

template <int D, typename Layout>
cudaError_t launch_prefill_mma(const void* q, const void* kp, const void* vp,
                               Layout layout, const void* starts, int offset,
                               bool causal, void* out, int b, int sq, int h,
                               int kvh, cudaStream_t stream) {
  constexpr int smem = 5 * MmaTile<D>::kBytes;  // q, k[2], v[2]
  auto kernel = prefill_mma_kernel<D, Layout>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, h, b);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kp),
      static_cast<const bf16*>(vp), layout, static_cast<const int*>(starts),
      offset, causal, static_cast<bf16*>(out), sq, h, kvh,
      kLog2e / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

template <typename T, int D, typename Layout>
cudaError_t launch_decode(const void* q, const void* k, const void* v,
                          Layout layout, const void* lengths, void* out,
                          int b, int h, int kvh, cudaStream_t stream) {
  const int group = h / kvh;
  const size_t smem =
      sizeof(float) * (2 * kTileK * (D + 1) + 2 * group * D + group * kTileK + 3 * group);
  auto kernel = decode_kernel<T, D, Layout>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(kvh, b), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      layout, static_cast<const int*>(lengths), static_cast<T*>(out), h, kvh,
      1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

template <typename T, int D, typename Layout>
cudaError_t launch_prefill(const void* q, const void* kp, const void* vp,
                           Layout layout, const void* starts, int offset,
                           bool causal, void* out, int b, int sq, int h,
                           int kvh, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
                      ((kBlockQ + 2 * kTileK) * (D + 1) + kBlockQ * (kTileK + 1));
  auto kernel = prefill_kernel<T, D, Layout>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, h, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      layout, static_cast<const int*>(starts), offset, causal, static_cast<T*>(out),
      sq, h, kvh, 1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. head_dim d in {64, 80, 128}.
// Returns the cudaError_t of the launch (0 on success), or -1 for a dtype
// or head_dim this build does not instantiate.
#define DISPATCH_DECODE(LAYOUT)                                                 \
  if (dtype == 0) {                                                            \
    if (d == 64) DECODE(float, 64, LAYOUT);                                    \
    if (d == 80) DECODE(float, 80, LAYOUT);                                    \
    if (d == 128) DECODE(float, 128, LAYOUT);                                  \
  } else if (dtype == 1) {                                                     \
    if (d == 64) DECODE(__nv_bfloat16, 64, LAYOUT);                            \
    if (d == 80) DECODE(__nv_bfloat16, 80, LAYOUT);                            \
    if (d == 128) DECODE(__nv_bfloat16, 128, LAYOUT);                          \
  }                                                                            \
  return repro::kUnsupported
#define DECODE(T, D, LAYOUT)                                                   \
  return static_cast<int>(launch_decode<T, D>(q, k, v, LAYOUT, lengths, out,  \
                                              b, h, kvh,                       \
                                              static_cast<cudaStream_t>(stream)))

extern "C" int paged_decode(int dtype, int d, const void* q, const void* k,
                            const void* v, const void* table,
                            const void* lengths, void* out, int b, int h,
                            int kvh, int page_size, int max_pages,
                            void* stream) {
  const PagedLayout layout{static_cast<const int*>(table), page_size, max_pages};
  DISPATCH_DECODE(layout);
}

extern "C" int contiguous_decode(int dtype, int d, const void* q,
                                 const void* k, const void* v,
                                 const void* lengths, void* out, int b, int h,
                                 int kvh, int max_len, void* stream) {
  const ContiguousLayout layout{max_len};
  DISPATCH_DECODE(layout);
}
#undef DECODE
#undef DISPATCH_DECODE

#define DISPATCH_PREFILL(LAYOUT, STARTS, OFFSET, CAUSAL)                      \
  if (dtype == 0) {                                                            \
    if (d == 64) PREFILL(float, 64, LAYOUT, STARTS, OFFSET, CAUSAL);           \
    if (d == 80) PREFILL(float, 80, LAYOUT, STARTS, OFFSET, CAUSAL);           \
    if (d == 128) PREFILL(float, 128, LAYOUT, STARTS, OFFSET, CAUSAL);         \
  } else if (dtype == 1) { /* bf16: the tensor-core body */                  \
    if (d == 64) PREFILL_MMA(64, LAYOUT, STARTS, OFFSET, CAUSAL);              \
    if (d == 80) PREFILL_MMA(80, LAYOUT, STARTS, OFFSET, CAUSAL);              \
    if (d == 128) PREFILL_MMA(128, LAYOUT, STARTS, OFFSET, CAUSAL);            \
  }                                                                            \
  return repro::kUnsupported
#define PREFILL(T, D, LAYOUT, STARTS, OFFSET, CAUSAL)                          \
  return static_cast<int>(launch_prefill<T, D>(                                \
      q, k, v, LAYOUT, STARTS, OFFSET, CAUSAL, out, b, sq, h, kvh,             \
      static_cast<cudaStream_t>(stream)))
#define PREFILL_MMA(D, LAYOUT, STARTS, OFFSET, CAUSAL)                         \
  return static_cast<int>(launch_prefill_mma<D>(                               \
      q, k, v, LAYOUT, STARTS, OFFSET, CAUSAL, out, b, sq, h, kvh,             \
      static_cast<cudaStream_t>(stream)))

extern "C" int paged_prefill(int dtype, int d, const void* q, const void* k,
                             const void* v, const void* table,
                             const void* starts, void* out, int b, int sq,
                             int h, int kvh, int page_size, int max_pages,
                             void* stream) {
  const PagedLayout layout{static_cast<const int*>(table), page_size, max_pages};
  DISPATCH_PREFILL(layout, starts, 0, true);
}

// q (b, sq, h, d), k/v (b, skv, kvh, d), out like q; causal 0 or 1. The
// caller guarantees skv >= sq when causal (every query sees a key).
extern "C" int flash_attention(int dtype, int d, const void* q, const void* k,
                               const void* v, void* out, int b, int sq,
                               int skv, int h, int kvh, int causal,
                               void* stream) {
  const ContiguousLayout layout{skv};
  DISPATCH_PREFILL(layout, nullptr, skv - sq, causal != 0);
}
#undef PREFILL
#undef PREFILL_MMA
#undef DISPATCH_PREFILL
