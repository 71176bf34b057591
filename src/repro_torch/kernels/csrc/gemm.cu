// GEMM written by hand for Hopper (sm_90a): out = x @ y with x (m, k) and
// y (k, n) row-major, the sum in fp32 and the output rounded once to the
// input type.
//
// Replaces repro/kernels/gemm.py gemm (_gemm_kernel). The TPU kernel walks
// k on a sequential grid axis with the (bm, bn) fp32 accumulator in VMEM
// scratch; here each CTA owns one output tile and loops over k itself, with
// the accumulator in registers, so nothing crosses CTAs. Two engines, by
// input type:
//
// fp32: gemm_kernel, the paper's Ch.1 register-tile case study on the CUDA
// cores. Every thread holds an 8 x 8 fp32 register tile of the output and
// issues 64 FFMAs for each k, fed by two 16-byte shared-memory loads of A
// and two of B. A thread's 8 rows are two runs of 4 (ty*4 and BM/2 + ty*4)
// and so are its 8 columns, so that the float4 loads of a warp hit
// consecutive addresses and no bank twice. The CTA stages (BM x kBK) of x,
// transposed, and (kBK x BN) of y in shared memory, double-buffered: the
// next k tile is loaded into registers while the current one is
// multiplied, and stored to the other buffer after it, with one barrier a
// k tile. Tiles 64 x 64 (64 threads) and 128 x 128 (256 threads), kBK 16.
// fp32 stays off the tensor cores: they take fp32 only as TF32, about three
// decimal digits, where the fp32 checks hold the kernel to 1e-4.
//
// bf16: gemm_wgmma_kernel, on the tensor cores. A ring of kTcStages
// shared-memory stages each holds one (128 x 64) tile of x and one
// (64 x BN) tile of y, laid out in TMA's 128-byte swizzle. One producer
// warp fills the ring; each stage has a "full" and an "empty" mbarrier.
// Two consumer warpgroups (64 output rows each) run wgmma.mma_async
// m64nBNk16, bf16 into fp32, both operands read from shared memory through
// descriptors: x is K-major; y, (k, n) row-major, is an MN-major B operand
// (the transpose bit). A consumer keeps one k tile's products in flight
// and releases the stage before it. The producer loads by TMA (one
// cp.async.bulk.tensor per 64-column box, zeros past the matrix, so ragged
// m, n and k need no masks) where TMA can address the rows: k and n
// multiples of 8 (16-byte row strides) and k > 0. Otherwise the same
// kernel's producer warp loads elements, masked, into the same swizzled
// stages and fences them to the async proxy before it marks a stage full
// (template flag kTma). The TMA descriptors are encoded on the host by
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (no link
// to libcuda), and passed as __grid_constant__ parameters. CTAs walk the
// output in groups of kGroupM row blocks, so that a wave shares its A and
// B tiles in L2. Tiles (bm, bk, bn): (128, 64, 128) and (128, 64, 256), 4
// stages: 131,072 and 196,608 bytes of shared memory.
//
// Any shape: rows, columns and the k tail past the matrix load as 0, the
// epilogue's stores are masked, offsets are 64-bit; k = 0 gives zeros.
//
// What bounds it on an H100: operations. At the qwen3-4b MLP shapes
// (2048 x 2560 x 9728, 102 GFLOP) the bound is 0.103 ms at the tensor
// cores' 989 TFLOP/s in bf16, and 1.52 ms at the CUDA cores' 67 TFLOP/s
// in fp32.

#include <cuda.h>

#include "common.cuh"

namespace {

using repro::Elem;
using repro::smem_u32;

constexpr int kBK = 16;
constexpr int kTM = 8;  // register tile: kTM x kTN outputs a thread
constexpr int kTN = 8;

__device__ __forceinline__ float to_float(float v) { return v; }

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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: wgmma fed by TMA
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcBK = 64;         // k a stage: one 128-byte swizzled row
constexpr int kTcStages = 4;
constexpr int kTcConsumers = 2;   // warpgroups of 64 output rows
constexpr int kTcBM = 64 * kTcConsumers;
constexpr int kTcThreads = 128 * kTcConsumers + 32;  // + the producer warp
constexpr int kGroupM = 8;        // row blocks that walk the columns together
constexpr int kSwizzleRow = 128;  // bytes: 64 bf16
constexpr int kBoxBytes = kTcBK * kSwizzleRow;  // one 64 x 64 box of y

// Which engine and loader ran; the entry point reports it.
enum Path { kPathCudaCores = 0, kPathTma = 1, kPathLoads = 2 };
constexpr int kEncodeFailed = -2;  // cuTensorMapEncodeTiled refused a map

template <int BN>
struct TcTile {
  static constexpr int kABytes = kTcBM * kSwizzleRow;   // 16 KB
  static constexpr int kBBytes = kTcBK * BN * 2;        // 16 or 32 KB
  static constexpr int kStageBytes = kABytes + kBBytes;
  // The ring, 1 KB of slack to align it to the swizzle's 1024-byte atom,
  // and the full and empty barriers.
  static constexpr int kSmem = kTcStages * kStageBytes + 1024 +
                               2 * kTcStages * 8;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra LAB_WAIT;\n}\n"
      :: "r"(bar), "r"(parity) : "memory");
}

// One box of a 2-D map into shared memory; c0 is the inner (column)
// coordinate. The bytes complete a transaction on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1)
      : "memory");
}

// Byte offset of element (r, c) in a tile of 128-byte rows as TMA's
// 128-byte swizzle lays it out: the row's 16-byte chunk index XOR the
// row's index inside its 8-row (1024-byte) atom.
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return r * kSwizzleRow + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// Keeps the compiler from touching the accumulators while a wgmma that
// writes them is in flight.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// D (64 x N, fp32) += A (64 x 16) . B (16 x N), A K-major and B MN-major
// (transpose bit set), both bf16 in shared memory.
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n256(float (&d)[128], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN, bool kTma>
__global__ void __launch_bounds__(kTcThreads, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_y,
                  const bf16* __restrict__ x, const bf16* __restrict__ y,
                  bf16* __restrict__ out, int m, int k, int n) {
  using C = TcTile<BN>;
  extern __shared__ uint8_t smem_raw[];
  // The ring starts on a 1024-byte boundary of the shared window, where
  // the swizzle's atoms begin.
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t ring_s = smem_u32(ring);
  const uint32_t full0 = ring_s + kTcStages * C::kStageBytes;  // full[s]
  const uint32_t empty0 = full0 + 8 * kTcStages;               // empty[s]

  const int mb = (m + kTcBM - 1) / kTcBM;
  const int nb = (n + BN - 1) / BN;
  const int per_group = kGroupM * nb;
  const int first_m = static_cast<int>(blockIdx.x) / per_group * kGroupM;
  const int gm = min(mb - first_m, kGroupM);
  const int in_group = static_cast<int>(blockIdx.x) % per_group;
  const int m0 = (first_m + in_group % gm) * kTcBM;
  const int n0 = in_group / gm * BN;
  const int n_k = (k + kTcBK - 1) / kTcBK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(full0 + 8 * s, kTma ? 1 : 32);
      mbar_init(empty0 + 8 * s, 4 * kTcConsumers);  // one a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128 * kTcConsumers) {  // the producer warp
    const int lane = tid & 31;
    for (int kt = 0; kt < n_k; ++kt) {
      const int s = kt % kTcStages;
      const int k0 = kt * kTcBK;
      mbar_wait(empty0 + 8 * s, ((kt / kTcStages) & 1) ^ 1);
      if constexpr (kTma) {
        if (lane == 0) {
          const uint32_t a_s = ring_s + s * C::kStageBytes;
          mbar_expect_tx(full0 + 8 * s, C::kStageBytes);
          tma_load_2d(a_s, &map_x, full0 + 8 * s, k0, m0);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load_2d(a_s + C::kABytes + j * kBoxBytes, &map_y,
                        full0 + 8 * s, n0 + 64 * j, k0);
        }
      } else {
        uint8_t* a_p = ring + s * C::kStageBytes;
        uint8_t* b_p = a_p + C::kABytes;
        for (int e = lane; e < kTcBM * kTcBK; e += 32) {
          const int r = e / kTcBK, c = e % kTcBK;
          const int row = m0 + r, col = k0 + c;
          *reinterpret_cast<bf16*>(a_p + sw128(r, c)) =
              row < m && col < k ? x[static_cast<int64_t>(row) * k + col]
                                 : __float2bfloat16(0.f);
        }
        for (int e = lane; e < kTcBK * BN; e += 32) {
          const int r = e / BN, c = e % BN;
          const int row = k0 + r, col = n0 + c;
          *reinterpret_cast<bf16*>(b_p + (c / 64) * kBoxBytes +
                                   sw128(r, c % 64)) =
              row < k && col < n ? y[static_cast<int64_t>(row) * n + col]
                                 : __float2bfloat16(0.f);
        }
        // Generic-proxy stores, read next by wgmma through the async proxy.
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_arrive(full0 + 8 * s);
      }
    }
    return;
  }

  const int wg = tid / 128;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % kTcStages;
    const uint32_t a_s = ring_s + s * C::kStageBytes;
    // A: this warpgroup's 64 rows, 8-row atoms 1024 bytes apart. B: 64-column
    // boxes kBoxBytes apart (leading), 8-row atoms 1024 bytes apart.
    const uint64_t da = sw128_desc(a_s + wg * 64 * kSwizzleRow, 16, 1024);
    const uint64_t db = sw128_desc(a_s + C::kABytes, kBoxBytes, 1024);
    mbar_wait(full0 + 8 * s, (kt / kTcStages) & 1);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) {
      // k advances 32 bytes along A's rows, 16 rows (2 KB) down B's.
      if constexpr (BN == 128)
        wgmma_m64n128(acc, da + 2 * kk, db + 128 * kk);
      else
        wgmma_m64n256(acc, da + 2 * kk, db + 128 * kk);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the last stage's products are done: release it
    fence_acc(acc);
    if (kt > 0 && (tid & 31) == 0)
      mbar_arrive(empty0 + 8 * ((kt - 1) % kTcStages));
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // Accumulator layout: warp w of the warpgroup holds rows 16w + lane/4
  // (+8), and for each 8-column block j the columns 8j + 2 (lane % 4) + {0,
  // 1}: acc[4j + 2h + {0, 1}] at row + 8h.
  const int lane = tid & 31;
  const int row0 = m0 + wg * 64 + (tid % 128) / 32 * 16 + lane / 4;
  const bool pairs = n % 2 == 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
    if (col >= n) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= m) continue;
      bf16* o = out + static_cast<int64_t>(row) * n + col;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
      } else {
        o[0] = __float2bfloat16(v0);
        if (col + 1 < n) o[1] = __float2bfloat16(v1);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found once through the runtime.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A (rows, cols) row-major bf16 matrix as a TMA map of (box_rows x 64)
// boxes in the 128-byte swizzle, zeros past its edges.
bool encode(CUtensorMap* map, const void* base, int rows, int cols,
            int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
int launch_wgmma(const void* x, const void* y, void* out, int m, int k,
                 int n, int* path, cudaStream_t s) {
  const int64_t blocks = static_cast<int64_t>((m + kTcBM - 1) / kTcBM) *
                         ((n + BN - 1) / BN);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(y)) % 16) == 0;
  const bool tma = aligned && k > 0 && k % 8 == 0 && n % 8 == 0;
  CUtensorMap map_x{}, map_y{};  // unread by the element loader
  if (tma && !(encode(&map_x, x, m, k, kTcBM) &&
               encode(&map_y, y, k, n, kTcBK)))
    return kEncodeFailed;
  auto kernel = tma ? gemm_wgmma_kernel<BN, true>
                    : gemm_wgmma_kernel<BN, false>;
  const cudaError_t err = repro::allow_smem(kernel, TcTile<BN>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), kTcThreads, TcTile<BN>::kSmem, s>>>(
      map_x, map_y, static_cast<const bf16*>(x), static_cast<const bf16*>(y),
      static_cast<bf16*>(out), m, k, n);
  *path = tma ? kPathTma : kPathLoads;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (bm, bk, bn) names an instantiated tile of the dtype (0 fp32, 1 bf16):
// fp32 (64, 16, 64) and (128, 16, 128) on the CUDA cores, bf16 (128, 64,
// 128) and (128, 64, 256) on the tensor cores. *path reports the engine
// and loader that ran (Path). Returns the launch's cudaError_t, or a
// negative code for a tile this build lacks or a refused TMA map.
extern "C" int blocked_gemm(int dtype, int bm, int bk, int bn, const void* x,
                            const void* y, void* out, int m, int k, int n,
                            int* path, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && bk == kBK) {
    *path = kPathCudaCores;
    if (bm == 64 && bn == 64)
      return static_cast<int>(launch_gemm<float, 64, 64>(x, y, out, m, k, n,
                                                         s));
    if (bm == 128 && bn == 128)
      return static_cast<int>(launch_gemm<float, 128, 128>(x, y, out, m, k,
                                                           n, s));
  }
  if (dtype == 1 && bm == kTcBM && bk == kTcBK) {
    if (bn == 128) return launch_wgmma<128>(x, y, out, m, k, n, path, s);
    if (bn == 256) return launch_wgmma<256>(x, y, out, m, k, n, path, s);
  }
  return repro::kUnsupported;
}
