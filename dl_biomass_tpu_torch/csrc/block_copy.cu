// Kernel 10: the block copy o = x + 1 over a (blocks, rows, 128) f32 tensor: the
// bandwidth probe of the tools.
//
// Replaces: tools/dma_probe.py pallas_bandwidth (its kernel o_ref[...] =
// x_ref[...] + 1.0 over a grid of `blocks` blocks of block_kb KB each).
//
// Bound on the H100: bytes. Each value is read once and written once: 2 x 32,
// 2 x 128 and 2 x 512 MB at 128 blocks of 256 KB, 1 MB and 4 MB (0.02, 0.08 and
// 0.32 ms at 3.35 TB/s); one add per value.
//
// Design: the TPU kernel's grid of (rows, 128) blocks stands for its DMA unit and
// means nothing here, so the kernel treats the tensor as one run of 16-byte
// vectors, cut into chunks of kThreads x kUnroll vectors, one CUDA block each: the
// grid follows the tensor's size and keeps every SM full of small blocks. Each
// thread issues its kUnroll independent loads (kThreads apart, so that a warp's
// load covers 512 contiguous bytes) before its kUnroll stores; loads and stores
// carry the streaming hint (ld.global.cs / st.global.cs: each value is touched
// once). The ragged end is masked per vector. (A grid-stride loop over a grid of
// resident blocks ran slower than torch.add at 1 and 4 MB: PERF.md.)

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 2;  // vectors in flight per thread: 32 bytes

__global__ void __launch_bounds__(kThreads)
    block_copy_kernel(const float4* __restrict__ x, float4* __restrict__ o, long long n) {
  const long long base = static_cast<long long>(blockIdx.x) * kThreads * kUnroll + threadIdx.x;
  float4 v[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (base + u * kThreads < n) v[u] = __ldcs(x + base + u * kThreads);
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (base + u * kThreads < n) {
      v[u].x += 1.0f;
      v[u].y += 1.0f;
      v[u].z += 1.0f;
      v[u].w += 1.0f;
      __stcs(o + base + u * kThreads, v[u]);
    }
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
  const long long n = static_cast<long long>(blocks) * rows * 32;  // 16-byte vectors
  const long long chunk = static_cast<long long>(kThreads) * kUnroll;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  block_copy_kernel<<<static_cast<unsigned>((n + chunk - 1) / chunk), kThreads, 0, s>>>(
      static_cast<const float4*>(x), static_cast<float4*>(o), n);
  return static_cast<int>(cudaGetLastError());
}
