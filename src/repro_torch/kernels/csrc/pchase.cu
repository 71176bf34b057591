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

}  // namespace

extern "C" int pchase(const void* chain, void* out, int steps, void* stream) {
  pchase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(chain), static_cast<int*>(out), steps);
  return static_cast<int>(cudaGetLastError());
}
