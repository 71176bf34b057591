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
// The two decodes share one body, and the two prefills another; only how
// a logical row's address is found differs (the layout's `rows(slot)`),
// and where the queries sit: a chunk's rows start at `starts[slot]`, a
// sequence's at skv - sq (the causal diagonal's offset). All keep the TPU
// kernels' math: q, k and v are read as fp32, scores, the online softmax
// (running max m, denominator l, accumulator acc) and the P.V products are
// fp32, and the output is rounded once to q's dtype. K/V stay in their
// own dtype: they are widened to fp32 per tile on load, never copied.
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
// head, 64 query rows), 256 threads each owning a 4x4 block of the 64x64
// score tile in registers (rows ty+16i, columns tx+16j, so shared-memory
// reads are conflict-free), fp32 FMAs on CUDA cores. Causality is a loop
// bound, not a grid: a CTA walks key tiles up to the last key its last
// query row sees, and masks only what lies past the diagonal (or past the
// end) inside a tile, so any sq and skv work, 1 and primes included. The
// TPU kernel instead enumerates the lower triangle of (q block, k block)
// pairs in scalar-prefetched maps and snaps its blocks to divisors of the
// lengths. q, k and v are read in their (b, s, heads, d) layout; GQA is
// kv_head = head / group. Tensor cores (mma.sync, then wgmma/TMA) are
// later work.
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
  } else if (dtype == 1) {                                                     \
    if (d == 64) PREFILL(__nv_bfloat16, 64, LAYOUT, STARTS, OFFSET, CAUSAL);   \
    if (d == 80) PREFILL(__nv_bfloat16, 80, LAYOUT, STARTS, OFFSET, CAUSAL);   \
    if (d == 128) PREFILL(__nv_bfloat16, 128, LAYOUT, STARTS, OFFSET, CAUSAL); \
  }                                                                            \
  return repro::kUnsupported
#define PREFILL(T, D, LAYOUT, STARTS, OFFSET, CAUSAL)                          \
  return static_cast<int>(launch_prefill<T, D>(                                \
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
#undef DISPATCH_PREFILL
