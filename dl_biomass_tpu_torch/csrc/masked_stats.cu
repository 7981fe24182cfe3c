// Kernel 8: masked BatchNorm statistics of an edge tensor, per channel,
// s1 = sum(x m) and s2 = sum(x m x) over the (B, M, 64) rows of x (rows, C)
// bf16 with the row mask m, in f32.
//
// Replaces: tools/bn_stats_bench.py stats_pallas (_stats_kernel). The
// multiply-by-mask form of the TPU kernel is kept: xm = x * m with m 0.0 or
// 1.0, s1 += xm, s2 += xm * x; it is not a select (NaN or Inf at a masked row
// reaches the sums, as it does there).
//
// Bound on the H100: bytes. x is read once (B*M*64*C bf16: 604 MB at SA1's
// 36 x 2048 x 64 x 64, 0.18 ms), the mask once; 4 flop per value in f32 take a
// tenth of that.
//
// Design: a block of 256 threads; C/8 threads share a row, each loading its 8
// channels as one 16-byte vector, so a block covers 256*8/C rows per step and
// walks the rows with a grid stride, four rows' loads unrolled ahead of their
// adds. Each thread sums its channels over its rows in f32 in ascending order;
// the block adds its threads' sums in row-lane order in shared memory and
// writes its slice (2, C). No float atomics: a second launch (dlbt_sum_slices,
// csrc/sum_slices.cu) adds the slices in block order in f64, so the result
// repeats bit for bit on one card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;  // bf16 channels per 16-byte load

__global__ void __launch_bounds__(kThreads)
    masked_stats_kernel(const __nv_bfloat16* __restrict__ x, const unsigned char* __restrict__ m,
                        float* __restrict__ partial, long long rows, int c) {
  __shared__ float red[2][kThreads * kVec];  // [s1 | s2][row lane * C + channel]
  const int tpr = c / kVec;         // threads per row
  const int rps = kThreads / tpr;   // rows per step
  const int q = threadIdx.x / tpr, v = threadIdx.x - q * tpr;
  float s1[kVec], s2[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) s1[e] = s2[e] = 0.0f;
  if (q < rps) {
    const long long stride = static_cast<long long>(gridDim.x) * rps;
#pragma unroll 4
    for (long long r = static_cast<long long>(blockIdx.x) * rps + q; r < rows; r += stride) {
      const uint4 raw = *reinterpret_cast<const uint4*>(x + r * c + v * kVec);
      const float mf = m[r] ? 1.0f : 0.0f;
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < kVec / 2; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        const float xm0 = f.x * mf, xm1 = f.y * mf;
        s1[2 * e] += xm0;
        s2[2 * e] += xm0 * f.x;
        s1[2 * e + 1] += xm1;
        s2[2 * e + 1] += xm1 * f.y;
      }
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      red[0][q * c + v * kVec + e] = s1[e];
      red[1][q * c + v * kVec + e] = s2[e];
    }
  }
  __syncthreads();
  float* slice = partial + static_cast<size_t>(blockIdx.x) * 2 * c;
  for (int i = threadIdx.x; i < 2 * c; i += kThreads) {
    const int which = i / c, ch = i - which * c;
    float s = 0.0f;
    for (int qq = 0; qq < rps; ++qq) s += red[which][qq * c + ch];
    slice[i] = s;
  }
}

}  // namespace

// x (rows, C) bf16, 16-byte aligned, C a multiple of 8 and at most 2048; m
// (rows) bool. Writes each block's slice (2, C) f32, s1 then s2, into partial
// (max_grid, 2, C); *grid_out (host memory) is the number of slices written,
// for dlbt_sum_slices.
extern "C" int dlbt_masked_stats(const void* x, const void* m, void* partial, long long rows,
                                 int c, int max_grid, int* grid_out, void* stream) {
  *grid_out = 0;
  if (rows < 0 || c <= 0 || c % kVec || c > kThreads * kVec || max_grid < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, masked_stats_kernel, kThreads, 0);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long rps = kThreads / (c / kVec);
  long long grid = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (grid > (rows + rps - 1) / rps) grid = (rows + rps - 1) / rps;
  if (grid > max_grid) grid = max_grid;
  if (grid < 1) grid = 1;  // one (zero) slice even for no row
  masked_stats_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const unsigned char*>(m),
      static_cast<float*>(partial), rows, c);
  e = cudaGetLastError();
  if (e == cudaSuccess) *grid_out = static_cast<int>(grid);
  return static_cast<int>(e);
}
