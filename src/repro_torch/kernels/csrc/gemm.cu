// Blocked GEMM with an fp32 register tile, written by hand for Hopper
// (sm_90a): the paper's Ch.1 case study on the card.
//
// Replaces repro/kernels/gemm.py gemm (_gemm_kernel): out = x @ y with x
// (m, k) and y (k, n) row-major in fp32 or bf16, the sum in fp32 and the
// output rounded once to the input type. The TPU kernel walks k on a
// sequential grid axis with the (bm, bn) fp32 accumulator in VMEM scratch;
// here each CTA owns one (BM, BN) output tile and loops over k itself,
// with the accumulator in registers, so nothing crosses CTAs.
//
// Design (the paper's own): every thread holds an 8 x 8 fp32 register tile
// of the output and issues 64 FFMAs for each k, fed by two 16-byte
// shared-memory loads of A and two of B. A thread's 8 rows are two runs of
// 4 (ty*4 and BM/2 + ty*4) and so are its 8 columns, so that the float4
// loads of a warp hit consecutive addresses and no bank twice. The CTA
// stages (BM x kBK) of x, transposed, and (kBK x BN) of y in shared memory
// as fp32 (bf16 widens as it is stored), double-buffered: the next k tile
// is loaded into registers while the current one is multiplied, and stored
// to the other buffer after it, with one barrier a k tile.
//
// Any shape: rows, columns and the k tail past the matrix load as 0 (the
// FFMA adds 0), and stores are masked; offsets are 64-bit. 16-byte loads
// need every row start aligned, so they are used only when k and n are
// multiples of the elements in 16 bytes (4 fp32, 8 bf16) and both bases
// are aligned; otherwise each thread loads single elements.
//
// What bounds it on an H100: operations. At the qwen3-4b MLP shapes
// (2048 x 2560 x 9728) the bound is 0.103 ms at the tensor cores' 989
// TFLOP/s in bf16 and 1.52 ms at the CUDA cores' 67 TFLOP/s in fp32; this
// kernel runs FFMAs on the CUDA cores in both types, so 1.52 ms is its own
// engine's bound. Tensor cores (mma.sync, then wgmma with TMA) are later
// work.
//
// Tiles instantiated (kernels/gemm.py TILES, priced by core/autotune.py):
// 64 x 64 (64 threads) and 128 x 128 (256 threads), kBK = 16.

#include "common.cuh"

namespace {

using repro::Elem;

constexpr int kBK = 16;
constexpr int kTM = 8;  // register tile: kTM x kTN outputs a thread
constexpr int kTN = 8;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int BM, int BN, bool kVec>
struct Tile {
  static constexpr int kThreads = (BM / kTM) * (BN / kTN);
  static constexpr int kPer = kVec ? Elem<T>::kPerVec : 1;  // per load
  static constexpr int kARowVecs = kBK / kPer;  // loads along k, a row of A
  static constexpr int kBRowVecs = BN / kPer;   // loads along n, a row of B
  static constexpr int kALoads = BM * kARowVecs / kThreads;
  static constexpr int kBLoads = kBK * kBRowVecs / kThreads;
  static_assert(BM * kARowVecs % kThreads == 0, "A tile splits evenly");
  static_assert(kBK * kBRowVecs % kThreads == 0, "B tile splits evenly");
};

template <typename T, int kPer>
__device__ __forceinline__ void load_elems(const T* src, bool valid,
                                           float* dst) {
  if (!valid) {
#pragma unroll
    for (int e = 0; e < kPer; ++e) dst[e] = 0.f;
  } else if constexpr (kPer == 1) {
    dst[0] = to_float(*src);
  } else {
    Elem<T>::load16(src, dst);
  }
}

// k tile [k0, k0 + kBK) of x (rows m0..) and of y (columns n0..) into
// registers, zero past the matrix.
template <typename T, int BM, int BN, bool kVec>
__device__ __forceinline__ void load_tile(
    const T* __restrict__ x, const T* __restrict__ y, int m, int k, int n,
    int m0, int n0, int k0,
    float (&ra)[Tile<T, BM, BN, kVec>::kALoads][Tile<T, BM, BN, kVec>::kPer],
    float (&rb)[Tile<T, BM, BN, kVec>::kBLoads][Tile<T, BM, BN, kVec>::kPer]) {
  using C = Tile<T, BM, BN, kVec>;
#pragma unroll
  for (int i = 0; i < C::kALoads; ++i) {
    const int v = threadIdx.x + i * C::kThreads;
    const int row = m0 + v / C::kARowVecs;
    const int col = k0 + (v % C::kARowVecs) * C::kPer;
    load_elems<T, C::kPer>(x + static_cast<int64_t>(row) * k + col,
                           row < m && col < k, ra[i]);
  }
#pragma unroll
  for (int i = 0; i < C::kBLoads; ++i) {
    const int v = threadIdx.x + i * C::kThreads;
    const int row = k0 + v / C::kBRowVecs;
    const int col = n0 + (v % C::kBRowVecs) * C::kPer;
    load_elems<T, C::kPer>(y + static_cast<int64_t>(row) * n + col,
                           row < k && col < n, rb[i]);
  }
}

template <typename T, int BM, int BN, bool kVec>
__device__ __forceinline__ void store_tile(
    const float (&ra)[Tile<T, BM, BN, kVec>::kALoads]
                     [Tile<T, BM, BN, kVec>::kPer],
    const float (&rb)[Tile<T, BM, BN, kVec>::kBLoads]
                     [Tile<T, BM, BN, kVec>::kPer],
    float (*as)[BM], float (*bs)[BN]) {
  using C = Tile<T, BM, BN, kVec>;
#pragma unroll
  for (int i = 0; i < C::kALoads; ++i) {
    const int v = threadIdx.x + i * C::kThreads;
    const int r = v / C::kARowVecs;
    const int c = (v % C::kARowVecs) * C::kPer;
#pragma unroll
    for (int e = 0; e < C::kPer; ++e) as[c + e][r] = ra[i][e];
  }
#pragma unroll
  for (int i = 0; i < C::kBLoads; ++i) {
    const int v = threadIdx.x + i * C::kThreads;
    const int r = v / C::kBRowVecs;
    const int c = (v % C::kBRowVecs) * C::kPer;
#pragma unroll
    for (int e = 0; e < C::kPer; ++e) bs[r][c + e] = rb[i][e];
  }
}

template <typename T, int BM, int BN, bool kVec>
__global__ void __launch_bounds__(Tile<T, BM, BN, kVec>::kThreads)
gemm_kernel(const T* __restrict__ x, const T* __restrict__ y,
            T* __restrict__ out, int m, int k, int n) {
  using C = Tile<T, BM, BN, kVec>;
  __shared__ __align__(16) float as[2][kBK][BM];  // x tile, transposed
  __shared__ __align__(16) float bs[2][kBK][BN];
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % (BN / kTN);
  const int ty = threadIdx.x / (BN / kTN);

  float ra[C::kALoads][C::kPer];
  float rb[C::kBLoads][C::kPer];
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  const int n_tiles = (k + kBK - 1) / kBK;
  if (n_tiles > 0) {
    load_tile<T, BM, BN, kVec>(x, y, m, k, n, m0, n0, 0, ra, rb);
    store_tile<T, BM, BN, kVec>(ra, rb, as[0], bs[0]);
  }
  __syncthreads();
  for (int t = 0; t < n_tiles; ++t) {
    const int cur = t & 1;
    const bool more = t + 1 < n_tiles;
    if (more)  // in flight while this tile is multiplied
      load_tile<T, BM, BN, kVec>(x, y, m, k, n, m0, n0, (t + 1) * kBK, ra,
                                 rb);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[cur][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&as[cur][kk][BM / 2 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[cur][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&bs[cur][kk][BN / 2 + tx * 4]);
      const float a[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[kTN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) store_tile<T, BM, BN, kVec>(ra, rb, as[cur ^ 1], bs[cur ^ 1]);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + i - 4);
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = n0 + (j < 4 ? tx * 4 + j : BN / 2 + tx * 4 + j - 4);
      if (col < n)
        out[static_cast<int64_t>(row) * n + col] = Elem<T>::store(acc[i][j]);
    }
  }
}

template <typename T, int BM, int BN>
cudaError_t launch_gemm(const void* x, const void* y, void* out, int m,
                        int k, int n, cudaStream_t s) {
  constexpr int kPer = Elem<T>::kPerVec;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(y)) % 16) == 0;
  const T* xp = static_cast<const T*>(x);
  const T* yp = static_cast<const T*>(y);
  T* op = static_cast<T*>(out);
  constexpr int kThreads = Tile<T, BM, BN, true>::kThreads;
  if (aligned && k % kPer == 0 && n % kPer == 0)
    gemm_kernel<T, BM, BN, true><<<grid, kThreads, 0, s>>>(xp, yp, op, m, k, n);
  else
    gemm_kernel<T, BM, BN, false><<<grid, kThreads, 0, s>>>(xp, yp, op, m, k, n);
  return cudaGetLastError();
}

template <typename T>
int dispatch_tile(int bm, int bn, const void* x, const void* y, void* out,
                  int m, int k, int n, cudaStream_t s) {
  if (bm == 64 && bn == 64)
    return static_cast<int>(launch_gemm<T, 64, 64>(x, y, out, m, k, n, s));
  if (bm == 128 && bn == 128)
    return static_cast<int>(launch_gemm<T, 128, 128>(x, y, out, m, k, n, s));
  return repro::kUnsupported;
}

}  // namespace

// (bm, kBK, bn) names an instantiated tile; dtype 0 fp32, 1 bf16.
extern "C" int blocked_gemm(int dtype, int bm, int bk, int bn, const void* x,
                            const void* y, void* out, int m, int k, int n,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bk != kBK) return repro::kUnsupported;
  if (dtype == 0) return dispatch_tile<float>(bm, bn, x, y, out, m, k, n, s);
  if (dtype == 1)
    return dispatch_tile<__nv_bfloat16>(bm, bn, x, y, out, m, k, n, s);
  return repro::kUnsupported;
}
