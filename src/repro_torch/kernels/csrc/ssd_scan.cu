// Chunked Mamba-2 SSD scan, written by hand for Hopper (sm_90a).
//
// Replaces repro/kernels/ssd_scan.py ssd_scan (_ssd_kernel). Inputs:
// x (bt, l, h, p) dt-scaled, a_log (bt, l, h) fp32 log decays (<= 0),
// b and c (bt, l, n) shared by every head of a batch row (one group),
// optional h0 (bt, h, p, n) fp32. Outputs y (bt, l, h, p) in x's dtype and
// the final state (bt, h, p, n) fp32. Per chunk of kChunk rows, with
// a_cum the chunk's inclusive cumulative sum of a_log:
//
//   y[i]  = sum_{j <= i} (C[i] . B[j]) exp(a_cum[i] - a_cum[j]) x[j]
//         + exp(a_cum[i]) (state C[i])                 (carried state)
//   state = exp(a_cum[-1]) state
//         + sum_j exp(a_cum[-1] - a_cum[j]) x[j] B[j]^T
//
// all in fp32, y rounded once. The TPU kernel carries the state in VMEM
// scratch across a sequential grid axis over chunks; here one CTA per
// (batch row, head) loops over the chunks in order and keeps the (p, n)
// state in shared memory, so nothing crosses CTAs.
//
// Ragged length: the chunk stays kChunk rows and the last chunk is masked
// (rows past l load as x = 0, B = 0, a = 0: they neither decay nor feed
// the state, and are not stored). The reference wrapper instead shrinks
// the chunk to a divisor of l, down to 1 at a prime length.
//
// What bounds it on an H100. At chunk 128, p 64, n 128 the work is
// 4 * l * (chunk/2 * n + chunk/2 * p + 2 * p * n) flops per (row, head),
// about 2.7 GFLOP at l 1024 and 32 heads, against about 10 MB of traffic:
// the tensor cores would make it bound by bytes, but this first kernel
// runs fp32 FMAs on CUDA cores and reads its operands from shared memory,
// so it is bound by shared-memory bandwidth and FMA issue in each SM. Its
// design: 256 threads; the fp32 tiles of x (chunk x p) and B (chunk x n)
// and the state (p x n) stay in shared memory for the whole chunk; query
// rows go in blocks of 32 so that C and the score block take 32 rows each
// (about 166 KB in all, above the 48 KB static limit: dynamic shared
// memory is opted in). Each thread owns a register block of every
// product (2 x 8 scores, 2 x p/16 outputs, p/16 x n/16 state entries),
// with rows padded to n + 1 floats so that shared-memory reads are
// conflict-free. Batch-1 prefill gives h = 32 CTAs on 132 SMs, one CTA
// each: the card is underfilled, and C.B^T, which all heads share, is
// computed once per head. Both are later work.

#include "common.cuh"

namespace {

using repro::Elem;

constexpr int kThreads = 256;
constexpr int kChunk = 128;
constexpr int kRowBlock = 32;  // query rows per score block

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

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ a_log,
                const T* __restrict__ bm, const T* __restrict__ cm,
                const float* __restrict__ h0, T* __restrict__ y,
                float* __restrict__ hout, int l, int h) {
  static_assert(P % 16 == 0 && N % 16 == 0, "p and n are multiples of 16");
  static_assert(kChunk == 4 * 32, "the cumulative sum gives 4 rows a lane");
  constexpr int NP = N + 1;        // padded row of B, C and the state
  constexpr int QP = kChunk + 1;   // padded row of the score block
  constexpr int PC = P / 16;       // output columns a thread owns
  constexpr int NC = N / 16;       // state columns a thread owns
  const int head = blockIdx.x;
  const int bt = blockIdx.y;
  extern __shared__ float smem[];
  float* x_s = smem;                  // kChunk x P
  float* b_s = x_s + kChunk * P;      // kChunk x NP
  float* c_s = b_s + kChunk * NP;     // kRowBlock x NP
  float* s_s = c_s + kRowBlock * NP;  // kRowBlock x QP (decayed scores)
  float* st_s = s_s + kRowBlock * QP; // P x NP (the carried state)
  float* cum_s = st_s + P * NP;       // kChunk: a_cum
  float* ea_s = cum_s + kChunk;       // kChunk: exp(a_cum)
  float* ed_s = ea_s + kChunk;        // kChunk: exp(a_cum[-1] - a_cum)
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int lane = tid & 31;

  const int64_t st_base = ((int64_t)bt * h + head) * P * N;
  for (int e = tid; e < P * N; e += kThreads)
    st_s[(e / N) * NP + e % N] = h0 ? h0[st_base + e] : 0.f;
  const int64_t x_row = (int64_t)h * P;  // stride between rows t of x, y
  const T* xb = x + (int64_t)bt * l * x_row + (int64_t)head * P;
  T* yb = y + (int64_t)bt * l * x_row + (int64_t)head * P;
  const float* ab = a_log + (int64_t)bt * l * h + head;
  const T* bb = bm + (int64_t)bt * l * N;
  const T* cb = cm + (int64_t)bt * l * N;

  for (int t0 = 0; t0 < l; t0 += kChunk) {
    const int nv = min(kChunk, l - t0);  // live rows of this chunk
    __syncthreads();  // the last chunk's readers are done with every tile
    load_rows<T, P>(xb + t0 * x_row, x_row, nv, kChunk, x_s, P);
    load_rows<T, N>(bb + (int64_t)t0 * N, N, nv, kChunk, b_s, NP);
    if (tid < 32) {
      // Inclusive cumulative sum of a over the chunk: 4 rows a lane,
      // then a scan of the lanes' totals.
      float v[4];
      float run = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = lane * 4 + e;
        run += r < nv ? ab[(int64_t)(t0 + r) * h] : 0.f;
        v[e] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) cum_s[lane * 4 + e] = v[e] + (incl - run);
    }
    __syncthreads();
    const float cum_last = cum_s[kChunk - 1];
    for (int r = tid; r < kChunk; r += kThreads) {
      ea_s[r] = expf(cum_s[r]);
      ed_s[r] = expf(cum_last - cum_s[r]);
    }

    for (int i0 = 0; i0 < nv; i0 += kRowBlock) {
      load_rows<T, N>(cb + (int64_t)(t0 + i0) * N, N, nv - i0, kRowBlock,
                      c_s, NP);
      __syncthreads();
      // Scores of rows ty and ty + 16 of the block against columns
      // tx + 16 jj; only columns up to the block's last row are needed.
      const int ncol = (i0 + kRowBlock) / 16;
      float s[2][8];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) s[r][jj] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        const float a0 = c_s[ty * NP + n];
        const float a1 = c_s[(ty + 16) * NP + n];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
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
        for (int jj = 0; jj < 8; ++jj) {
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
        const float p0 = s_s[ty * QP + j];
        const float p1 = s_s[(ty + 16) * QP + j];
#pragma unroll
        for (int c = 0; c < PC; ++c) {
          const float xv = x_s[j * P + tx + 16 * c];
          acc[0][c] = fmaf(p0, xv, acc[0][c]);
          acc[1][c] = fmaf(p1, xv, acc[1][c]);
        }
      }
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
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + ty + 16 * r;
        if (i >= nv) continue;
        const float e = ea_s[i];
        T* yr = yb + (t0 + i) * x_row;
#pragma unroll
        for (int c = 0; c < PC; ++c)
          yr[tx + 16 * c] = Elem<T>::store(acc[r][c] + off[r][c] * e);
      }
      __syncthreads();  // c_s and s_s are reused by the next block
    }

    // Every row block has read the old state: carry it over the chunk.
    float upd[PC][NC];
#pragma unroll
    for (int r = 0; r < PC; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) upd[r][c] = 0.f;
#pragma unroll 2
    for (int j = 0; j < nv; ++j) {
      const float w = ed_s[j];
      float xv[PC];
#pragma unroll
      for (int r = 0; r < PC; ++r) xv[r] = x_s[j * P + ty + 16 * r] * w;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float bv = b_s[j * NP + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < PC; ++r) upd[r][c] = fmaf(xv[r], bv, upd[r][c]);
      }
    }
    const float g = expf(cum_last);
#pragma unroll
    for (int r = 0; r < PC; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float* sp = st_s + (ty + 16 * r) * NP + tx + 16 * c;
        *sp = *sp * g + upd[r][c];
      }
  }
  __syncthreads();
  for (int e = tid; e < P * N; e += kThreads)
    hout[st_base + e] = st_s[(e / N) * NP + e % N];
}

template <typename T, int P, int N>
cudaError_t launch_ssd(const void* x, const void* a_log, const void* b,
                       const void* c, const void* h0, void* y, void* hout,
                       int bt, int l, int h, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kChunk * P + kChunk * (N + 1) +
                                       kRowBlock * (N + 1) +
                                       kRowBlock * (kChunk + 1) +
                                       P * (N + 1) + 3 * kChunk);
  auto kernel = ssd_scan_kernel<T, P, N>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(h, bt), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(a_log),
      static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<const float*>(h0), static_cast<T*>(y),
      static_cast<float*>(hout), l, h);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, b, c and y); (p, n) = (64, 128).
// h0 may be null (a zero initial state). Returns the cudaError_t of the
// launch (0 on success), or -1 for a dtype or shape this build does not
// instantiate.
extern "C" int ssd_scan(int dtype, int p, int n, const void* x,
                        const void* a_log, const void* b, const void* c,
                        const void* h0, void* y, void* hout, int bt, int l,
                        int h, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p == 64 && n == 128) {
    if (dtype == 0)
      return static_cast<int>(
          launch_ssd<float, 64, 128>(x, a_log, b, c, h0, y, hout, bt, l, h, s));
    if (dtype == 1)
      return static_cast<int>(launch_ssd<__nv_bfloat16, 64, 128>(
          x, a_log, b, c, h0, y, hout, bt, l, h, s));
  }
  return repro::kUnsupported;
}
