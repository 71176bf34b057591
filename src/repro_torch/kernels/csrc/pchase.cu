// Pointer chase, written by hand for Hopper (sm_90a): the paper's ch.3
// measurement primitive on the card.
//
// Replaces repro/kernels/pchase_probe.py pchase (_chase_kernel). One thread
// follows an int32 next-index chain from position 0 for `steps` dependent
// loads and writes each visited position: out[i] = pos; pos = chain[pos].
//
// What bounds it: latency, by design. Each load's address is the previous
// load's value, so exactly one load is in flight and the kernel's time over
// `steps` is the latency of one step of the level of the memory hierarchy
// that holds the chain: the L1, the L2, or device memory and its TLBs. The
// bytes it moves (4 per step each way) would take nanoseconds at 3.35 TB/s.
// Its design serves the measurement:
//   * the load is an ordinary global load, which Hopper caches in L1: no
//     `volatile` and no ld.cg, which would skip the L1 and erase that level
//     from the footprint curve. `chain` is not __restrict__, so the
//     compiler cannot turn it into a read-only (non-coherent) load either;
//   * each step's time includes the address arithmetic (a 64-bit multiply
//     and add on the loaded index), a few cycles on top of the load;
//   * the stores of the visited positions do not feed the chain, so they
//     leave the dependent path;
//   * one launch costs about 5 us, under 1 % of a launch of 65,536 steps.
// The wrapper (kernels/pchase_probe.py via kernels/ops.py) checks that
// every entry lies in [0, n) before the first launch over a chain: the
// kernel itself never reads outside the chain it is given.
//
// pchase_timed, beside it, is the paper's fine-grained p-chase (Mei & Chu):
// the same walk timed load by load, which is what separates the latency
// classes that a mean time per step blurs. It is what core/card.py's
// CardHierarchy runs for every scan the ch.3 detectors ask of the card.
//   * One thread walks a chain of int64 byte offsets in 8-byte slots (the
//     format of core/simulator.make_chain: slot pos / 8 holds the offset of
//     the next load). int64 because the TLB sweep's footprints pass the
//     8 GiB that int32 indices reach.
//   * `warm` steps are walked untimed first: a scan's replay of the scans
//     since the last flush, so that the timed steps find the caches, the L1
//     included, as those scans left them, inside one launch.
//   * Each timed step reads clock64() before the load and after an
//     instruction that needs the loaded value (the check of the next
//     offset and its branch): warps issue in order, so the second read
//     waits for the data. A step's cycles include the check and the
//     clock reads, a few cycles on top of the load.
//   * *total gets the cycles from just before the first timed step to just
//     after the last: the windows and everything between them (the record
//     stores, the loop), which is what a clock rate is read from.
//   * kBypassL1 picks ld.global.cg (cached in L2 only), as the paper does
//     for the L2 and the TLBs, over the ordinary L1-caching ld.global.ca.
//   * The record (4 bytes of cycles a step, and 8 of the offset when the
//     caller asks) is stored outside the timed window with
//     .L1::no_allocate and an L2 evict-first policy, so it takes no L1
//     line from the chain and is the first to leave the L2. The kernel uses
//     no shared memory; the caller's carveout (percent of the SM's 256 KB
//     given to shared memory, cudaFuncAttributePreferredSharedMemoryCarveout)
//     is set before each launch, since the L1 the walk meets is what the
//     carveout leaves.
//   * An offset that is negative, unaligned or past the chain stops the walk
//     and sets *status, which the wrapper reads and raises on: the kernel
//     never reads outside the chain, and a multi-GB chain needs no check on
//     the host first.
// What bounds it: latency, by design, as for pchase.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void pchase_kernel(const int* chain, int* out, int steps) {
  int pos = 0;
  for (int i = 0; i < steps; ++i) {
    out[i] = pos;
    pos = chain[pos];
  }
}

template <bool kBypassL1>
__device__ __forceinline__ long long load_slot(const long long* chain,
                                               long long pos) {
  long long v;
  if constexpr (kBypassL1) {
    asm volatile("ld.global.cg.s64 %0, [%1];"
                 : "=l"(v) : "l"(chain + (pos >> 3)) : "memory");
  } else {
    asm volatile("ld.global.ca.s64 %0, [%1];"
                 : "=l"(v) : "l"(chain + (pos >> 3)) : "memory");
  }
  return v;
}

__device__ __forceinline__ bool bad_offset(long long v, long long n_bytes) {
  return static_cast<unsigned long long>(v) >=
             static_cast<unsigned long long>(n_bytes) || (v & 7) != 0;
}

__device__ __forceinline__ void store_record(unsigned* p, unsigned v,
                                             unsigned long long policy) {
  asm volatile("st.global.L1::no_allocate.L2::cache_hint.b32 [%0], %1, %2;"
               :: "l"(p), "r"(v), "l"(policy) : "memory");
}

__device__ __forceinline__ void store_record(long long* p, long long v,
                                             unsigned long long policy) {
  asm volatile("st.global.L1::no_allocate.L2::cache_hint.b64 [%0], %1, %2;"
               :: "l"(p), "l"(v), "l"(policy) : "memory");
}

template <bool kBypassL1>
__global__ void pchase_timed_kernel(const long long* chain, long long n_bytes,
                                    long long start, long long warm,
                                    int steps, long long* offsets,
                                    unsigned* cycles, long long* total,
                                    int* status) {
  long long pos = start;
  for (long long i = 0; i < warm; ++i) {
    const long long v = load_slot<kBypassL1>(chain, pos);
    if (bad_offset(v, n_bytes)) {
      *status = 1;
      return;
    }
    pos = v;
  }
  unsigned long long policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(policy));
  const long long first = clock64();
  for (int i = 0; i < steps; ++i) {
    if (offsets != nullptr) store_record(offsets + i, pos, policy);
    const long long t0 = clock64();
    const long long v = load_slot<kBypassL1>(chain, pos);
    if (bad_offset(v, n_bytes)) {   // needs v: the clock read waits for it
      *status = 1;
      return;
    }
    const long long t1 = clock64();
    store_record(cycles + i, static_cast<unsigned>(t1 - t0), policy);
    pos = v;
  }
  *total = clock64() - first;
}

template <bool kBypassL1>
int launch_timed(const void* chain, long long n_bytes, long long start,
                 long long warm, int steps, void* offsets, void* cycles,
                 void* total, void* status, int carveout,
                 cudaStream_t stream) {
  auto kernel = pchase_timed_kernel<kBypassL1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, carveout);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<1, 1, 0, stream>>>(
      static_cast<const long long*>(chain), n_bytes, start, warm, steps,
      static_cast<long long*>(offsets), static_cast<unsigned*>(cycles),
      static_cast<long long*>(total), static_cast<int*>(status));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pchase(const void* chain, void* out, int steps, void* stream) {
  pchase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(chain), static_cast<int*>(out), steps);
  return static_cast<int>(cudaGetLastError());
}

// chain: n_bytes / 8 int64 slots; offsets (may be null): steps int64;
// cycles: steps uint32; total: one int64; status: one int32, zero before
// the launch. carveout: 0-100.
extern "C" int pchase_timed(const void* chain, void* offsets, void* cycles,
                            void* total, void* status, long long n_bytes,
                            long long start, long long warm, int steps,
                            int bypass_l1, int carveout, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return bypass_l1
      ? launch_timed<true>(chain, n_bytes, start, warm, steps, offsets,
                           cycles, total, status, carveout, s)
      : launch_timed<false>(chain, n_bytes, start, warm, steps, offsets,
                            cycles, total, status, carveout, s);
}
