// Kernel 10: the block copy o = x + 1 over a (blocks, rows, 128) f32 tensor,
// one CUDA block per (rows, 128) block: the bandwidth probe of the tools.
//
// Replaces: tools/dma_probe.py pallas_bandwidth (its kernel o_ref[...] =
// x_ref[...] + 1.0 over a grid of `blocks` blocks of block_kb KB each).
//
// Bound on the H100: bytes. Each value is read once and written once: 2 x 32,
// 2 x 128 and 2 x 512 MB at 128 blocks of 256 KB, 1 MB and 4 MB (0.02, 0.08 and
// 0.32 ms at 3.35 TB/s); one add per value.
//
// Design: the grid is the TPU kernel's, one block per (rows, 128) block; its
// 1024 threads walk the block as 16-byte vectors, consecutive threads on
// consecutive vectors, four vectors' loads unrolled ahead of their stores.
// With 128 blocks on 132 SMs each SM streams one block, so the probe reads what
// one block per SM can move, as the TPU probe read what its block DMA could.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
    block_copy_kernel(const float4* __restrict__ x, float4* __restrict__ o, long long per_block) {
  const float4* src = x + blockIdx.x * per_block;
  float4* dst = o + blockIdx.x * per_block;
#pragma unroll 4
  for (long long i = threadIdx.x; i < per_block; i += kThreads) {
    float4 v = src[i];
    v.x += 1.0f;
    v.y += 1.0f;
    v.z += 1.0f;
    v.w += 1.0f;
    dst[i] = v;
  }
}

}  // namespace

// x and o (blocks, rows, 128) f32, 16-byte aligned.
extern "C" int dlbt_block_copy(const void* x, void* o, int blocks, int rows, void* stream) {
  if (blocks < 0 || rows < 0 || reinterpret_cast<unsigned long long>(x) % 16 ||
      reinterpret_cast<unsigned long long>(o) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (blocks == 0 || rows == 0) return 0;
  block_copy_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(o), static_cast<long long>(rows) * 32);
  return static_cast<int>(cudaGetLastError());
}
