// Chunked Mamba-2 SSD scan, written by hand for Hopper (sm_90a).
//
// Replaces repro/kernels/ssd_scan.py ssd_scan (_ssd_kernel). Inputs:
// x (bt, l, h, p) dt-scaled, a_log (bt, l, h) fp32 log decays (<= 0),
// b and c (bt, l, n) shared by every head of a batch row (one group),
// optional h0 (bt, h, p, n) fp32. Outputs y (bt, l, h, p) in x's dtype and
// the final state (bt, h, p, n) fp32. Per chunk of CHUNK rows, with
// a_cum the chunk's inclusive cumulative sum of a_log:
//
//   y[i]   = sum_{j <= i} (C[i] . B[j]) exp(a_cum[i] - a_cum[j]) x[j]
//          + exp(a_cum[i]) (h_prev C[i])              (carried state)
//   S      = sum_j exp(a_cum[-1] - a_cum[j]) x[j] B[j]^T
//   h_next = exp(a_cum[-1]) h_prev + S
//
// with fp32 sums and y rounded once. The TPU kernel carries the state in
// VMEM scratch across a sequential grid axis over chunks. On Hopper blocks
// run in parallel and in no order, so the carry is made explicit.
//
// The chunk is a template argument, as the reference's Pallas grid takes
// it from ops.ssd_scan(chunk=): CHUNK in {32, 64, 128} (launch_chunk).
// 32 is the least that the cumulative sum (whole rows a lane) and the fp32
// body's 32-row score blocks allow; 256 would need 232,832 B of shared
// memory in the fp32 body at d_state 128, past the 232,448 B a block may
// opt into. A smaller chunk makes more CTAs of less work each and a
// longer hand-off chain (l / CHUNK chunks in a row).
//
// The grid is (head x p-block, chunk, batch row). Rows of p are
// independent: y[:, p-block] and the state's p-block rows need only
// x[:, p-block]. So each CTA owns kPBlock rows of p of one head over one
// chunk (bt 1, l 1024, h 32, chunk 128: 512 CTAs, where one CTA per head
// looping over the chunks gave 32). Chunks are independent except for the
// state, which goes from chunk to chunk through a look-back hand-off in the
// same launch:
//   1. a CTA takes its chunk from an int ticket per (batch row, head,
//      p-block), so chunk c belongs to a CTA that started after the one
//      that holds chunk c - 1, whatever order the hardware schedules
//      blocks in: a CTA only ever waits on one that already runs;
//   2. it stages its chunk and computes its own contribution S;
//   3. it waits for chunk c - 1's count (acquire), reads h_prev (h0 or
//      zeros for chunk 0), writes h_next and publishes its count (release);
//   4. then it computes y, its chunk's rows of its p-block.
// The states go through the output state buffer itself: chunk c reads
// h_{c-1} there, keeps it in shared memory for step 4 and overwrites it
// with h_c before it publishes, so the last chunk leaves the final state
// and no scratch is needed. The last chunk resets the ticket and the
// count, so the int buffer (kept zeroed per device and stream by the
// caller) is zero again after every launch. The result does not depend on
// the schedule: every sum runs in a fixed order, and two launches give the
// same bits.
//
// bf16 (ssd_scan_mma_kernel): x, B and C are staged by cp.async in their
// own dtype and all four products run on the tensor cores by mma.sync
// m16n8k16 into fp32 (at d_state 16, C.B^T and C.h^T are one k-step). C.B^T takes bf16 inputs, so its products are exact.
// The three others carry an fp32 operand (the decayed scores, x weighted
// by exp(a_cum[-1] - a_cum), the fp32 state), which goes in as a bf16 high
// part plus a bf16 residual (16 bits, as the attention bodies' P.V): one
// bf16 rounding of a decay-weighted operand (about 2e-3 relative) would
// move the fp32 state past ref.TOLERANCE. The warps take the chunk's
// 16-row blocks in turn for the scores and y (at chunk 128 each of the 8
// warps owns one; at 64 and 32 only 4 and 2 warps have rows), and each owns
// a 16 x 32 block of S at d_state 128 (at 16, two warps own 16 x 16 each),
// summed over the chunk's rows 16 at a time. C.B^T is
// recomputed by each p-block of each head (64 CTAs a chunk at h 32):
// sharing it would take a second hand-off through device memory. The
// scores' decays exp(a_cum[i] - a_cum[j]) go through the special-function
// unit (ex2.approx): at the model's decays most of them underflow, and
// there the accurate expf is slow (scripts/ssd_scan_variants.py times the
// scan with it); the approximation's 2 ulps reach only y, rounded to
// bf16. fp32 (ssd_scan_kernel) keeps the CUDA cores (no TF32) and the
// accurate expf on the same grid and hand-off: register blocks of fp32
// FMAs fed from shared memory.
//
// Ragged length: the chunk stays CHUNK rows and the last chunk is masked
// (rows past l load as x = 0, B = C = 0, a = 0: they neither decay nor feed
// the state, and are not stored). The reference wrapper instead shrinks
// the chunk to a divisor of l, down to 1 at a prime length.
//
// What bounds it on an H100. At chunk 128, p 64, n 128 the useful work is
// 2 * (chunk/2 * (n + p) + 2 * p * n) flops per row and head, 1.9 GFLOP at
// l 1024 and 32 heads (2 us at the bf16 peak), against 10 MB of traffic
// (3 us at 3.35 TB/s): bound by bytes. The kernel is far from either: each
// CTA is a short serial program (stage 72 KB; S; the hand-off; the
// triangular C.B^T, 16 rows a warp, so the last warp does 8 times the
// first's), two CTAs an SM, and the hand-off adds one round trip through
// L2 per chunk and (batch row, head, p-block), 8 in a row at l 1024 (32
// at chunk 32).
// A CTA does all of its chunk's work that needs no carried state before
// it waits.

#include "common.cuh"

namespace {

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::Elem;
using repro::fast_exp2;
using repro::ldsm_x4;
using repro::ldsm_x4_trans;
using repro::mma_bf16;
using repro::pack_bf16;
using repro::smem_u32;
using repro::split_bf16;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;   // 8 warps
constexpr int kPBlock = 32;     // rows of p (of one head) a CTA owns
constexpr int kRowBlock = 32;   // fp32 body: query rows per score block
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// The hand-off. `sync` holds two ints per (batch row, head, p-block): the
// next ticket and the number of chunk states published.
// ---------------------------------------------------------------------------

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// This CTA's (ticket, count) pair.
__device__ __forceinline__ int* sync_slot(int* sync) {
  return sync + 2 * ((int64_t)blockIdx.z * gridDim.x + blockIdx.x);
}

// The chunk this CTA scans: its start order among the CTAs of its (batch
// row, head, p-block). The last ticket resets the counter for the next
// launch (every CTA of the group has taken one by then).
__device__ int take_chunk(int* ticket) {
  __shared__ int chunk;
  if (threadIdx.x == 0) {
    chunk = atomicAdd(ticket, 1);
    if (chunk == (int)gridDim.y - 1) *ticket = 0;
  }
  __syncthreads();
  return chunk;
}

// Block until chunk - 1 has published its state. The chunk it waits on
// belongs to a CTA that started earlier, so the wait ends; a watchdog of
// 10 s turns a fault that would hang the card (a count left non-zero by a
// launch that never finished) into a launch error instead. Thread 0's
// acquire and the CTA barrier after it order every thread's reads of the
// state after chunk - 1's writes (with publish: the pattern of CUTLASS's
// Semaphore).
__device__ void wait_for_previous(const int* done, int chunk) {
  if (chunk > 0 && threadIdx.x == 0) {
    const uint64_t t0 = global_ns();
    while (ld_acquire(done) < chunk) {
      if (global_ns() - t0 > 10000000000ull) __trap();
    }
  }
  __syncthreads();
}

// Once every thread has stored its share of the chunk's state: publish it
// to chunk + 1 (the barrier orders every thread's stores before thread 0's
// release), or, as the last chunk (nobody waits on the count any more),
// reset the count for the next launch.
__device__ void publish(int* done, int chunk) {
  __syncthreads();
  if (threadIdx.x == 0) {
    if (chunk == (int)gridDim.y - 1) {
      *done = 0;
    } else {
      st_release(done, chunk + 1);
    }
  }
}

// Inclusive cumulative sum of the chunk's log decays (a[r * stride] for
// r < nv, 0 past it) into cum[0, CHUNK), by warp 0: CHUNK / 32 rows a
// lane, then a scan of the lanes' totals. The caller syncs before reading
// cum.
template <int CHUNK>
__device__ void chunk_cumsum(const float* __restrict__ a, int64_t stride,
                             int nv, float* __restrict__ cum) {
  constexpr int kPer = CHUNK / 32;
  static_assert(kPer >= 1 && kPer * 32 == CHUNK,
                "the chunk is whole rows a lane");
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  float v[kPer];
  float run = 0.f;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int r = lane * kPer + e;
    run += r < nv ? a[r * stride] : 0.f;
    v[e] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
#pragma unroll
  for (int e = 0; e < kPer; ++e) cum[lane * kPer + e] = v[e] + (incl - run);
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores. Shared-memory rows are padded by 8 elements: at
// 272 or 48 bytes (C, B, the state at d_state 128 or 16) and 80 bytes (x)
// the 8 row addresses of an ldmatrix fall on distinct banks.
// ---------------------------------------------------------------------------

template <int N, int CHUNK>
struct MmaSmem {
  static constexpr int kRowN = N + 8;          // C, B and state rows
  static constexpr int kRowX = kPBlock + 8;    // x rows
  static constexpr int kCBytes = CHUNK * kRowN * 2;
  static constexpr int kXBytes = CHUNK * kRowX * 2;
  static constexpr int kHBytes = kPBlock * kRowN * 2;
  static constexpr int kBytes =
      2 * kCBytes + kXBytes + 2 * kHBytes + 2 * CHUNK * 4;
};

template <int P, int N, int CHUNK>
__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_mma_kernel(const bf16* __restrict__ x,
                    const float* __restrict__ a_log,
                    const bf16* __restrict__ bm, const bf16* __restrict__ cm,
                    const float* __restrict__ h0, bf16* __restrict__ y,
                    float* hout, int* __restrict__ sync, int l, int h) {
  using S = MmaSmem<N, CHUNK>;
  constexpr int kRowN = S::kRowN;
  constexpr int kRowX = S::kRowX;
  constexpr int NB = kPBlock / 8;   // 8-column blocks of a y row block
  constexpr int kRB = CHUNK / 16;   // 16-row blocks of the chunk
  // The warps that own S (kPBlock x N), a 16 x SC block each, SC a
  // multiple of 16 (one ldmatrix.trans of B feeds two n8 products): at n
  // 128 all 8 warps own 16 x 32; at n 16 (jamba) S is 32 x 16, two warps
  // own 16 x 16 and the other six go straight to the hand-off's barrier.
  constexpr int kWarps = kThreads / 32;
  constexpr int kSTiles = kPBlock / 16 * N / 16;  // 16 x 16 tiles of S
  constexpr int SW = kSTiles < kWarps ? kSTiles : kWarps;
  constexpr int SC = kPBlock / 16 * N / SW;
  static_assert(P % kPBlock == 0 && SC % 16 == 0 && SW % (kPBlock / 16) == 0,
                "p and n tile the CTA");
  static_assert(N % 16 == 0, "C.B^T and C.h^T step over n by 16");
  static_assert(CHUNK % 16 == 0, "the chunk is whole 16-row blocks");
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t c_s = smem_u32(smem);
  const uint32_t b_s = c_s + S::kCBytes;
  const uint32_t x_s = b_s + S::kCBytes;
  const uint32_t hh_s = x_s + S::kXBytes;  // h_prev, bf16 high part
  const uint32_t hl_s = hh_s + S::kHBytes; // h_prev, bf16 residual
  bf16* hh = reinterpret_cast<bf16*>(smem + 2 * S::kCBytes + S::kXBytes);
  bf16* hl = hh + kPBlock * kRowN;
  float* cum_s = reinterpret_cast<float*>(hl + kPBlock * kRowN);
  float* w_s = cum_s + CHUNK;   // exp(a_cum[-1] - a_cum)
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int head = blockIdx.x / (P / kPBlock);
  const int p0 = (blockIdx.x % (P / kPBlock)) * kPBlock;
  int* ticket = sync_slot(sync);
  const int chunk = take_chunk(ticket);
  const int t0 = chunk * CHUNK;
  const int nv = min(CHUNK, l - t0);                // live rows
  const int64_t row0 = (int64_t)blockIdx.z * l + t0;  // (bt, t0) as a row

  // Stage C, B and x's p-block in their own dtype; rows past nv are zeros.
  for (int v = tid; v < CHUNK * (N / 8); v += kThreads) {
    const int r = v / (N / 8);
    const int c = (v % (N / 8)) * 8;
    const bool valid = r < nv;
    const int64_t off = valid ? (row0 + r) * N + c : 0;
    cp_async16(c_s + (r * kRowN + c) * 2, cm + off, valid);
    cp_async16(b_s + (r * kRowN + c) * 2, bm + off, valid);
  }
  for (int v = tid; v < CHUNK * (kPBlock / 8); v += kThreads) {
    const int r = v / (kPBlock / 8);
    const int c = (v % (kPBlock / 8)) * 8;
    const bool valid = r < nv;
    const int64_t off = valid ? ((row0 + r) * h + head) * P + p0 + c : 0;
    cp_async16(x_s + (r * kRowX + c) * 2, x + off, valid);
  }
  cp_async_commit();
  chunk_cumsum<CHUNK>(a_log + row0 * h + head, h, nv, cum_s);
  __syncthreads();
  const float cum_last = cum_s[CHUNK - 1];
  for (int r = tid; r < CHUNK; r += kThreads)
    w_s[r] = expf(cum_last - cum_s[r]);
  cp_async_wait<0>();
  __syncthreads();

  // S (kPBlock x N) = (x * w)^T . B over the chunk's rows: this warp's
  // p rows mt*16.. and n columns ng*SC... A = (x * w)^T from x by
  // ldmatrix.trans, weighted and split; B by ldmatrix.trans.
  const int mt = warp % (kPBlock / 16);
  const int ng = warp / (kPBlock / 16);
  const bool owns_s = warp < SW;
  const int nk = owns_s ? (nv + 15) / 16 : 0;  // k-steps with live rows
  float st[SC / 8][4];
#pragma unroll
  for (int j = 0; j < SC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[j][e] = 0.f;
  for (int kk = 0; kk < nk; ++kk) {
    uint32_t xa[4], hi[4], lo[4];
    ldsm_x4_trans(x_s + ((kk * 16 + (lane & 7) + 8 * (lane >> 4)) * kRowX +
                         mt * 16 + 8 * ((lane >> 3) & 1)) * 2, xa);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = kk * 16 + 8 * (i >> 1) + 2 * t4;
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xa[i]));
      split_bf16(f.x * w_s[j], f.y * w_s[j + 1], hi[i], lo[i]);
    }
#pragma unroll
    for (int np = 0; np < SC / 16; ++np) {
      uint32_t b[4];
      ldsm_x4_trans(b_s + ((kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                               kRowN + ng * SC + np * 16 + 8 * (lane >> 4)) * 2,
                    b);
      mma_bf16(st[2 * np], hi, b[0], b[1]);
      mma_bf16(st[2 * np], lo, b[0], b[1]);
      mma_bf16(st[2 * np + 1], hi, b[2], b[3]);
      mma_bf16(st[2 * np + 1], lo, b[2], b[3]);
    }
  }

  // The hand-off. st[nb][e] sits at p-block row mt*16 + g + 8*(e/2),
  // column ng*SC + 8*nb + 2*t4 + e%2. h_prev is read past L1 (another CTA
  // wrote it), kept in shared memory as two bf16 parts, and replaced by
  // h_next.
  int* done = ticket + 1;
  const float decay = expf(cum_last);
  const bool has_prev = chunk > 0 || h0 != nullptr;
  wait_for_previous(done, chunk);
  const int64_t sbase =
      (((int64_t)blockIdx.z * h + head) * P + p0) * N;
  float2 prev[SC / 8][2];
  if (owns_s) {
#pragma unroll
    for (int nb = 0; nb < SC / 8; ++nb)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int64_t at = sbase + (int64_t)(mt * 16 + g + 8 * hf) * N +
                           ng * SC + 8 * nb + 2 * t4;
        prev[nb][hf] =
            chunk > 0 ? __ldcg(reinterpret_cast<const float2*>(hout + at))
            : h0 != nullptr ? *reinterpret_cast<const float2*>(h0 + at)
                            : make_float2(0.f, 0.f);
      }
#pragma unroll
    for (int nb = 0; nb < SC / 8; ++nb)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = mt * 16 + g + 8 * hf;
        const int n = ng * SC + 8 * nb + 2 * t4;
        const float2 pv = prev[nb][hf];
        __stcg(reinterpret_cast<float2*>(hout + sbase + (int64_t)r * N + n),
               make_float2(fmaf(decay, pv.x, st[nb][2 * hf]),
                           fmaf(decay, pv.y, st[nb][2 * hf + 1])));
        uint32_t vh, vl;
        split_bf16(pv.x, pv.y, vh, vl);
        *reinterpret_cast<uint32_t*>(hh + r * kRowN + n) = vh;
        *reinterpret_cast<uint32_t*>(hl + r * kRowN + n) = vl;
      }
  }
  publish(done, chunk);  // its barrier also orders the hh/hl writes

  // y for the row blocks this warp takes in turn (one at most while CHUNK
  // <= 8 * 16), 16 rows i0.. each: scores C.B^T over columns up to the
  // block's last row, decayed and masked; then (scores) . x and
  // C . h_prev^T.
  for (int rb = warp; rb < kRB; rb += kWarps) {
    const int i0 = rb * 16;
    if (i0 >= nv) break;
    float s[2 * kRB][4];
#pragma unroll
    for (int j = 0; j < 2 * kRB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const uint32_t c_row =
        c_s + ((i0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * kRowN +
               8 * (lane >> 4)) * 2;
    // One branch per 16 key columns (rb is not known to be warp-uniform,
    // and a branch inside the k loop stalls the mma.sync stream at each
    // one).
#pragma unroll
    for (int jp = 0; jp < kRB; ++jp) {
      if (jp > rb) break;
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        uint32_t ca[4], b[4];
        ldsm_x4(c_row + kk * 32, ca);
        ldsm_x4(b_s + ((jp * 16 + (lane & 7) + 8 * (lane >> 4)) * kRowN +
                       kk * 16 + 8 * ((lane >> 3) & 1)) * 2, b);
        mma_bf16(s[2 * jp], ca, b[0], b[1]);
        mma_bf16(s[2 * jp + 1], ca, b[2], b[3]);
      }
    }
    // The decay by the special-function unit (see the note at the top):
    // most of these exponents are far below -126 at the model's decays.
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = i0 + g + 8 * hf;
      const float ci = cum_s[i];
#pragma unroll
      for (int jb = 0; jb < 2 * kRB; ++jb) {
        if (jb >= 2 * (rb + 1)) break;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 8 * jb + 2 * t4 + e;
          // exp of a sum of a_log over (j, i]: at most 1 for j <= i.
          s[jb][2 * hf + e] =
              j <= i ? s[jb][2 * hf + e] * fast_exp2((ci - cum_s[j]) * kLog2e)
                     : 0.f;
        }
      }
    }
    float o[NB][4], off[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = off[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kRB; ++kk) {
      if (kk > rb) break;
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* p = &s[2 * kk + (i >> 1)][2 * (i & 1)];
        split_bf16(p[0], p[1], hi[i], lo[i]);
      }
#pragma unroll
      for (int dp = 0; dp < NB / 2; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(x_s + ((kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                                 kRowX + dp * 16 + 8 * (lane >> 4)) * 2, b);
        mma_bf16(o[2 * dp], hi, b[0], b[1]);
        mma_bf16(o[2 * dp], lo, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], hi, b[2], b[3]);
        mma_bf16(o[2 * dp + 1], lo, b[2], b[3]);
      }
    }
    if (has_prev) {
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        uint32_t ca[4];
        ldsm_x4(c_row + kk * 32, ca);
#pragma unroll
        for (int pp = 0; pp < NB / 2; ++pp) {
          uint32_t bh[4], bl[4];
          const uint32_t at =
              ((pp * 16 + (lane & 7) + 8 * (lane >> 4)) * kRowN + kk * 16 +
               8 * ((lane >> 3) & 1)) * 2;
          ldsm_x4(hh_s + at, bh);
          ldsm_x4(hl_s + at, bl);
          mma_bf16(off[2 * pp], ca, bh[0], bh[1]);
          mma_bf16(off[2 * pp], ca, bl[0], bl[1]);
          mma_bf16(off[2 * pp + 1], ca, bh[2], bh[3]);
          mma_bf16(off[2 * pp + 1], ca, bl[2], bl[3]);
        }
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = i0 + g + 8 * hf;
      if (i >= nv) continue;
      const float e = expf(cum_s[i]);
      bf16* yr = y + ((row0 + i) * h + head) * P + p0 + 2 * t4;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        *reinterpret_cast<uint32_t*>(yr + 8 * nb) =
            pack_bf16(fmaf(e, off[nb][2 * hf], o[nb][2 * hf]),
                      fmaf(e, off[nb][2 * hf + 1], o[nb][2 * hf + 1]));
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores: the same grid and hand-off. The fp32 tiles of x's
// p-block (chunk x kPBlock) and B (chunk x n), and h_prev (kPBlock x n),
// stay in shared memory; query rows go in blocks of kRowBlock so that C
// and the score block take kRowBlock rows each. Each thread owns a
// register block of every product (2 x 8 scores, 2 x 2 outputs, 2 x 8
// state entries), with rows padded to n + 1 floats so that shared-memory
// reads are conflict-free.
// ---------------------------------------------------------------------------

// Rows [0, n_rows) of a (rows, W) tile with row stride `stride` into
// `dst` as fp32 (row stride dst_stride); rows at or past n_valid are 0.
template <typename T, int W>
__device__ void load_rows(const T* __restrict__ src, int64_t stride,
                          int n_valid, int n_rows, float* __restrict__ dst,
                          int dst_stride) {
  constexpr int kPer = Elem<T>::kPerVec;
  constexpr int kVecs = W / kPer;
  for (int v = threadIdx.x; v < n_rows * kVecs; v += kThreads) {
    const int r = v / kVecs;
    const int c = (v % kVecs) * kPer;
    float tmp[kPer];
    if (r < n_valid) {
      Elem<T>::load16(src + r * stride + c, tmp);
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e) tmp[e] = 0.f;
    }
    float* o = dst + r * dst_stride + c;
#pragma unroll
    for (int e = 0; e < kPer; ++e) o[e] = tmp[e];
  }
}

template <int N, int CHUNK>
struct FmaSmem {
  static constexpr int kFloats = CHUNK * kPBlock + CHUNK * (N + 1) +
                                 kRowBlock * (N + 1) +
                                 kRowBlock * (CHUNK + 1) +
                                 kPBlock * (N + 1) + 2 * CHUNK;
};

template <int P, int N, int CHUNK>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ a_log,
                const float* __restrict__ bm, const float* __restrict__ cm,
                const float* __restrict__ h0, float* __restrict__ y,
                float* hout, int* __restrict__ sync, int l, int h) {
  static_assert(P % kPBlock == 0 && N % 16 == 0, "p and n tile the CTA");
  static_assert(CHUNK % kRowBlock == 0, "the chunk is whole score blocks");
  constexpr int NP = N + 1;        // padded row of B, C and the state
  constexpr int QP = CHUNK + 1;    // padded row of the score block
  constexpr int JC = CHUNK / 16;   // score columns a thread owns
  constexpr int PC = kPBlock / 16; // y columns / state rows a thread owns
  constexpr int NC = N / 16;       // state columns a thread owns
  extern __shared__ float fsmem[];
  float* x_s = fsmem;                    // CHUNK x kPBlock
  float* b_s = x_s + CHUNK * kPBlock;    // CHUNK x NP
  float* c_s = b_s + CHUNK * NP;         // kRowBlock x NP
  float* s_s = c_s + kRowBlock * NP;     // kRowBlock x QP (decayed scores)
  float* st_s = s_s + kRowBlock * QP;    // kPBlock x NP (h_prev)
  float* cum_s = st_s + kPBlock * NP;    // CHUNK: a_cum
  float* w_s = cum_s + CHUNK;            // CHUNK: exp(a_cum[-1] - a_cum)
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int head = blockIdx.x / (P / kPBlock);
  const int p0 = (blockIdx.x % (P / kPBlock)) * kPBlock;
  int* ticket = sync_slot(sync);
  const int chunk = take_chunk(ticket);
  const int t0 = chunk * CHUNK;
  const int nv = min(CHUNK, l - t0);
  const int64_t row0 = (int64_t)blockIdx.z * l + t0;
  const int64_t x_row = (int64_t)h * P;  // stride between rows t of x, y

  load_rows<float, kPBlock>(x + row0 * x_row + (int64_t)head * P + p0,
                            x_row, nv, CHUNK, x_s, kPBlock);
  load_rows<float, N>(bm + row0 * N, N, nv, CHUNK, b_s, NP);
  chunk_cumsum<CHUNK>(a_log + row0 * h + head, h, nv, cum_s);
  __syncthreads();
  const float cum_last = cum_s[CHUNK - 1];
  for (int r = tid; r < CHUNK; r += kThreads)
    w_s[r] = expf(cum_last - cum_s[r]);
  __syncthreads();

  // S: rows ty + 16 r of the p-block, columns tx + 16 c.
  float upd[PC][NC];
#pragma unroll
  for (int r = 0; r < PC; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) upd[r][c] = 0.f;
#pragma unroll 2
  for (int j = 0; j < nv; ++j) {
    const float w = w_s[j];
    float xv[PC];
#pragma unroll
    for (int r = 0; r < PC; ++r) xv[r] = x_s[j * kPBlock + ty + 16 * r] * w;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float bv = b_s[j * NP + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < PC; ++r) upd[r][c] = fmaf(xv[r], bv, upd[r][c]);
    }
  }

  // The hand-off, as in the bf16 body; h_prev stays in st_s for y.
  int* done = ticket + 1;
  const float decay = expf(cum_last);
  const bool has_prev = chunk > 0 || h0 != nullptr;
  wait_for_previous(done, chunk);
  const int64_t sbase = (((int64_t)blockIdx.z * h + head) * P + p0) * N;
  float prev[PC][NC];
#pragma unroll
  for (int r = 0; r < PC; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int64_t at = sbase + (int64_t)(ty + 16 * r) * N + tx + 16 * c;
      prev[r][c] = chunk > 0 ? __ldcg(hout + at)
                   : h0 != nullptr ? h0[at] : 0.f;
    }
#pragma unroll
  for (int r = 0; r < PC; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int64_t at = sbase + (int64_t)(ty + 16 * r) * N + tx + 16 * c;
      __stcg(hout + at, fmaf(decay, prev[r][c], upd[r][c]));
      st_s[(ty + 16 * r) * NP + tx + 16 * c] = prev[r][c];
    }
  publish(done, chunk);

  for (int i0 = 0; i0 < nv; i0 += kRowBlock) {
    load_rows<float, N>(cm + (row0 + i0) * N, N, nv - i0, kRowBlock, c_s,
                        NP);
    __syncthreads();
    // Scores of rows ty and ty + 16 of the block against columns
    // tx + 16 jj; only columns up to the block's last row are needed.
    const int ncol = (i0 + kRowBlock) / 16;
    float s[2][JC];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int jj = 0; jj < JC; ++jj) s[r][jj] = 0.f;
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      const float a0 = c_s[ty * NP + n];
      const float a1 = c_s[(ty + 16) * NP + n];
#pragma unroll
      for (int jj = 0; jj < JC; ++jj) {
        if (jj < ncol) {
          const float bj = b_s[(tx + 16 * jj) * NP + n];
          s[0][jj] = fmaf(a0, bj, s[0][jj]);
          s[1][jj] = fmaf(a1, bj, s[1][jj]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = ty + 16 * r;
      const float ci = cum_s[i0 + i];
#pragma unroll
      for (int jj = 0; jj < JC; ++jj) {
        const int j = tx + 16 * jj;
        // exp of a sum of a_log over (j, i]: at most 1 for j <= i.
        s_s[i * QP + j] =
            (jj < ncol && j <= i0 + i) ? s[r][jj] * expf(ci - cum_s[j]) : 0.f;
      }
    }
    __syncthreads();
    float acc[2][PC];
    float off[2][PC];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < PC; ++c) acc[r][c] = off[r][c] = 0.f;
    const int jend = min(i0 + kRowBlock, nv);
#pragma unroll 4
    for (int j = 0; j < jend; ++j) {
      const float p0v = s_s[ty * QP + j];
      const float p1v = s_s[(ty + 16) * QP + j];
#pragma unroll
      for (int c = 0; c < PC; ++c) {
        const float xv = x_s[j * kPBlock + tx + 16 * c];
        acc[0][c] = fmaf(p0v, xv, acc[0][c]);
        acc[1][c] = fmaf(p1v, xv, acc[1][c]);
      }
    }
    if (has_prev) {
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        const float c0 = c_s[ty * NP + n];
        const float c1 = c_s[(ty + 16) * NP + n];
#pragma unroll
        for (int c = 0; c < PC; ++c) {
          const float sv = st_s[(tx + 16 * c) * NP + n];
          off[0][c] = fmaf(c0, sv, off[0][c]);
          off[1][c] = fmaf(c1, sv, off[1][c]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + ty + 16 * r;
      if (i >= nv) continue;
      const float e = expf(cum_s[i]);
      float* yr = y + (row0 + i) * x_row + (int64_t)head * P + p0;
#pragma unroll
      for (int c = 0; c < PC; ++c)
        yr[tx + 16 * c] = fmaf(e, off[r][c], acc[r][c]);
    }
    __syncthreads();  // c_s and s_s are reused by the next block
  }
}

template <int P, int N, int CHUNK>
cudaError_t launch_ssd(int dtype, const void* x, const void* a_log,
                       const void* b, const void* c, const void* h0, void* y,
                       void* hout, void* sync, int bt, int l, int h,
                       cudaStream_t stream) {
  const dim3 grid(h * (P / kPBlock), (l + CHUNK - 1) / CHUNK, bt);
  const float* a = static_cast<const float*>(a_log);
  const float* s0 = static_cast<const float*>(h0);
  float* so = static_cast<float*>(hout);
  int* sy = static_cast<int*>(sync);
  if (dtype == 1) {
    auto kernel = ssd_scan_mma_kernel<P, N, CHUNK>;
    const size_t smem = MmaSmem<N, CHUNK>::kBytes;
    cudaError_t err = repro::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const bf16*>(x), a, static_cast<const bf16*>(b),
        static_cast<const bf16*>(c), s0, static_cast<bf16*>(y), so, sy, l,
        h);
  } else {
    auto kernel = ssd_scan_kernel<P, N, CHUNK>;
    const size_t smem = sizeof(float) * FmaSmem<N, CHUNK>::kFloats;
    cudaError_t err = repro::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(x), a, static_cast<const float*>(b),
        static_cast<const float*>(c), s0, static_cast<float*>(y), so, sy, l,
        h);
  }
  return cudaGetLastError();
}

// The instantiated chunk equal to `chunk`; any other launches nothing.
template <int P, int N>
int launch_chunk(int chunk, int dtype, const void* x, const void* a_log,
                 const void* b, const void* c, const void* h0, void* y,
                 void* hout, void* sync, int bt, int l, int h,
                 cudaStream_t stream) {
  switch (chunk) {
    case 32:
      return static_cast<int>(launch_ssd<P, N, 32>(
          dtype, x, a_log, b, c, h0, y, hout, sync, bt, l, h, stream));
    case 64:
      return static_cast<int>(launch_ssd<P, N, 64>(
          dtype, x, a_log, b, c, h0, y, hout, sync, bt, l, h, stream));
    case 128:
      return static_cast<int>(launch_ssd<P, N, 128>(
          dtype, x, a_log, b, c, h0, y, hout, sync, bt, l, h, stream));
    default:
      return repro::kUnsupported;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, b, c and y); (p, n) = (64, 128)
// (mamba2-370m) or (64, 16) (jamba-v0.1); chunk in {32, 64, 128}.
// h0 may be null (a zero initial state). `sync` is 2 * bt * h * (p / 32)
// zeroed ints, left zeroed. Returns the cudaError_t of the launch (0 on
// success), or -1 for a dtype, shape or chunk this build does not
// instantiate.
extern "C" int ssd_scan(int dtype, int p, int n, int chunk, const void* x,
                        const void* a_log, const void* b, const void* c,
                        const void* h0, void* y, void* hout, void* sync,
                        int bt, int l, int h, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return repro::kUnsupported;
  if (p == 64 && n == 128)
    return launch_chunk<64, 128>(chunk, dtype, x, a_log, b, c, h0, y, hout,
                                 sync, bt, l, h, s);
  if (p == 64 && n == 16)
    return launch_chunk<64, 16>(chunk, dtype, x, a_log, b, c, h0, y, hout,
                                sync, bt, l, h, s);
  return repro::kUnsupported;
}
