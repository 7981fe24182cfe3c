// The cross-block step of kernels 7-B and 8: the f32 slices that the blocks of
// a kernel write, each summed over that block's share of the work, added in
// block order in f64 and rounded once to f32. Kernel 7's backward writes dW3
// slices (C2 * C3 values a block), kernel 8 its (2, C) statistics.
//
// Replaces: no TPU kernel of its own; on the TPU the grid's steps run in order
// and accumulate into one output block (dl_biomass_tpu/ops/pallas_tail.py
// _bwd_kernel's dW3, tools/bn_stats_bench.py _stats_kernel's sums).
//
// Bound on the H100: bytes. The slices are read once and the sum written once
// (17.3 MB for kernel 7-B's 132 slices of 128 x 256 at SA2, 5 us); one add per
// value read.
//
// Design: one thread per output value runs over the slices in block order, so
// consecutive threads read consecutive values of a slice. No float atomics:
// the result repeats bit for bit on one card.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void sum_slices_kernel(const float* __restrict__ partial, int blocks, int n,
                                  float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  double s = 0.0;
  for (int g = 0; g < blocks; ++g) s += partial[static_cast<size_t>(g) * n + i];
  out[i] = static_cast<float>(s);
}

}  // namespace

// out (n) f32 = the sum of the first `blocks` slices of partial (blocks, n)
// f32, in block order (0 for no slice).
extern "C" int dlbt_sum_slices(const void* partial, void* out, int blocks, int n, void* stream) {
  if (blocks < 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  sum_slices_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(partial),
                                                           blocks, n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
