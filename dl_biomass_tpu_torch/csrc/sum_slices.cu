// The cross-block step of kernels 7-B and 8: the f32 slices that the blocks of
// a kernel write, each summed over that block's share of the work, added in
// f64 in a fixed order and rounded once to f32. Kernel 7's backward writes dW3
// slices (C2 * C3 values a block), kernel 8 its (2, C) statistics.
//
// Replaces: no TPU kernel of its own; on the TPU the grid's steps run in order
// and accumulate into one output block (dl_biomass_tpu/ops/pallas_tail.py
// _bwd_kernel's dW3, tools/bn_stats_bench.py _stats_kernel's sums).
//
// Bound on the H100: bytes. The slices are read once and the sum written once
// (17.3 MB for kernel 7-B's 132 slices of 128 x 256 at SA2, 5 us); one add per
// value read. Kernel 8's slices (660 of 2 x 128 or 2 x 256 values) are below
// what one launch costs.
//
// Design: the slices are split into `groups` runs of consecutive slices (the
// first blocks % groups runs one slice longer), and the values into tiles of
// `cols`. A block takes one tile; its threads are (groups, cols / V): a thread
// adds its run's slices of its V consecutive values in slice order in f64,
// kAhead loads in flight (V = 4: one 16-byte load a slice, where n % 4 == 0).
// The block writes the runs' partial sums to shared memory; a thread adds
// kSpan of them in run order, and one thread a value adds those spans' sums in
// span order and rounds once (a chain of kSpan + groups / kSpan dependent adds
// where one of groups would hold narrow tiles). So the order is fixed: the
// result repeats bit for bit on one card, with no float atomics. Narrow n takes
// narrow tiles and many runs (kernel 8's 128 values: 16 blocks of 128 runs),
// wide n wide tiles of coalesced rows (7-B's 32768: 256 values a block);
// sum_slices_kernel.plan mirrors the launch. dlbt_sum_slices_empty launches an
// empty kernel on the same grid: the floor a launch sets.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kAhead = 16;  // slices a thread loads before it adds them
constexpr int kSpan = 8;  // runs' sums added by one thread before the last step

template <int V>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ void add(double* s, float x) { s[0] += x; }
};
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ void add(double* s, float4 x) {
    s[0] += x.x;
    s[1] += x.y;
    s[2] += x.z;
    s[3] += x.w;
  }
};

template <int V>
__global__ void __launch_bounds__(kMaxThreads)
sum_slices_kernel(const float* __restrict__ partial, int blocks, int n, int cols, int groups,
                  float* __restrict__ out) {
  using T = typename Vec<V>::T;
  extern __shared__ double part[];  // (groups, cols): each run's partial sums
  const int cx = cols / V;
  const int tx = threadIdx.x % cx, g = threadIdx.x / cx;
  const int c0 = blockIdx.x * cols;
  const int c = c0 + tx * V;  // the first of the thread's V values
  const int per = blocks / groups, extra = blocks % groups;
  const int lo = g * per + min(g, extra), hi = lo + per + (g < extra ? 1 : 0);
  double s[V];
#pragma unroll
  for (int v = 0; v < V; ++v) s[v] = 0.0;
  if (c < n) {  // V = 4 only where n % 4 == 0: the four values are in the row
    const float* p = partial + static_cast<size_t>(lo) * n + c;
    for (int j = lo; j < hi; j += kAhead, p += static_cast<size_t>(kAhead) * n) {
      T x[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        if (j + u < hi) x[u] = __ldg(reinterpret_cast<const T*>(p + static_cast<size_t>(u) * n));
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        if (j + u < hi) Vec<V>::add(s, x[u]);
      }
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) part[g * cols + tx * V + v] = s[v];
  __syncthreads();
  // the runs' sums of each value, kSpan at a time in run order, each span's
  // sum kept in place of its first run's
  const int spans = (groups + kSpan - 1) / kSpan;
  for (int i = threadIdx.x; i < spans * cols; i += blockDim.x) {
    const int q0 = i / cols * kSpan, col = i % cols;
    double t = 0.0;
    for (int q = q0; q < min(q0 + kSpan, groups); ++q) t += part[q * cols + col];
    part[q0 * cols + col] = t;
  }
  __syncthreads();
  // then the spans' sums in span order, rounded once
  for (int i = threadIdx.x; i < cols && c0 + i < n; i += blockDim.x) {
    double t = 0.0;
    for (int q = 0; q < groups; q += kSpan) t += part[q * cols + i];
    out[c0 + i] = static_cast<float>(t);
  }
}

__global__ void empty_kernel() {}

// The launch for (blocks, n) slices as sum_slices_kernel.plan names it: vec
// values a thread loads at once, cols values a block, groups runs of slices.
cudaError_t check(int blocks, int n, int vec, int cols, int groups) {
  if (blocks < 0 || n < 0 || (vec != 1 && vec != 4) || (vec == 4 && n % 4 != 0) || cols < 1 ||
      cols % vec != 0 || groups < 1 || groups * (cols / vec) > kMaxThreads) {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace

// out (n) f32 = the sum of the first `blocks` slices of partial (blocks, n)
// f32 (0 for no slice), by the plan (vec, cols, groups): n / cols blocks
// (rounded up) of groups * cols / vec threads; vec 4 needs n % 4 == 0 and
// partial on 16 bytes.
extern "C" int dlbt_sum_slices(const void* partial, void* out, int blocks, int n, int vec,
                               int cols, int groups, void* stream) {
  cudaError_t e = check(blocks, n, vec, cols, groups);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n == 0) return 0;
  const int grid = (n + cols - 1) / cols, threads = groups * (cols / vec);
  const size_t smem = sizeof(double) * groups * cols;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(partial);
  float* o = static_cast<float*>(out);
  if (vec == 4) {
    sum_slices_kernel<4><<<grid, threads, smem, st>>>(p, blocks, n, cols, groups, o);
  } else {
    sum_slices_kernel<1><<<grid, threads, smem, st>>>(p, blocks, n, cols, groups, o);
  }
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel on the grid and block that dlbt_sum_slices launches for the
// same arguments; it reads and writes nothing (a measurement: no path calls it).
extern "C" int dlbt_sum_slices_empty(int blocks, int n, int vec, int cols, int groups,
                                     void* stream) {
  cudaError_t e = check(blocks, n, vec, cols, groups);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n == 0) return 0;
  empty_kernel<<<(n + cols - 1) / cols, groups * (cols / vec), 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
