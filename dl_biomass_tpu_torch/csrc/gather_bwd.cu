// Scatter-add backward of the batched row gather: ct (B, M, K, C), idx (B, M, K)
// -> out (B, N, C), each out row the float32 sum of the ct rows whose index
// points at it, rounded once to ct's dtype (float32 or bfloat16).
//
// Replaces: dl_biomass_tpu/ops/pallas_mxu_gather.py mxu_gather, its backward
// (_gather_bwd / _bwd_kernel). The Pallas kernel builds a one-hot (N, CM*K)
// block per centroid tile and accumulates its product with the ct tile in a
// float32 VMEM accumulator across tiles. Here the float sum is taken row by
// row instead, in ascending flat-row order (k fastest, then m), with no float
// atomics: the result is deterministic and bit-identical to
// ops/gather_kernel.py scatter_rows_plain, which sums in the same order. An
// index outside [0, N) contributes nothing; a pad slot (index 0) contributes
// its ct, which is zero on the model's path.
//
// Bound on the H100: bytes. ct is read once (B*M*K*C values: 134 MB in bf16
// at B=16, M=512, K=64, C=128), idx once and the output written once; the
// float32 adds (one per ct value) are far below the card's rate.
//
// Design: two launches.
// 1. One block per cloud builds a CSR of the rows that point at each of its N
//    output rows, as a stable counting sort: each warp owns a contiguous range
//    of rows and counts its keys into its own shared-memory histogram
//    (__match_any_sync groups equal keys, integer adds only); a per-key pass
//    over the warps and a block scan turn the histograms into each warp's
//    first slot per key and the segment offsets; a second walk of the same
//    ranges writes each row id at its slot. Rows land in ascending order
//    inside every segment because warps own ascending ranges and a warp walks
//    its range in order.
// 2. One warp per output row walks its segment in order and accumulates the
//    C channels in float32 registers (4 channels per lane, one 8-byte bf16 or
//    16-byte f32 vector load per row, four rows' loads issued ahead of their
//    adds), then stores the row once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__global__ void csr_kernel(const int* __restrict__ idx, int* __restrict__ offsets,
                           int* __restrict__ rows, int r, int n) {
  extern __shared__ int smem[];
  __shared__ int wsum[32];
  const int nwarps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int* hist = smem;              // [nwarps][n]: keys counted by each warp
  int* tot = smem + nwarps * n;  // [n]: per-key totals, then segment starts
  const int b = blockIdx.x;
  const int* ix = idx + static_cast<long long>(b) * r;
  int* off = offsets + static_cast<long long>(b) * (n + 1);
  int* rw = rows + static_cast<long long>(b) * r;

  for (int i = threadIdx.x; i < nwarps * n; i += blockDim.x) hist[i] = 0;
  __syncthreads();

  const int per = (r + nwarps - 1) / nwarps;
  const int r0 = warp * per;
  const int r1 = min(r, r0 + per);
  int* h = hist + warp * n;

  // pass 1: count each warp's keys
  for (int base = r0; base < r1; base += 32) {
    const int t = base + lane;
    const int key = t < r1 ? ix[t] : -1;
    const bool valid = t < r1 && key >= 0 && key < n;
    const int k = valid ? key : -1;
    const unsigned peers = __match_any_sync(kFull, k);
    if (valid && lane == __ffs(peers) - 1) h[k] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // per key: each warp's first rank, and the key's total
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int running = 0;
    for (int w = 0; w < nwarps; ++w) {
      const int c = hist[w * n + i];
      hist[w * n + i] = running;
      running += c;
    }
    tot[i] = running;
  }
  __syncthreads();

  // exclusive block scan of the totals: each thread scans a contiguous chunk
  const int ch = (n + blockDim.x - 1) / blockDim.x;
  const int s0 = min(n, static_cast<int>(threadIdx.x) * ch);
  const int s1 = min(n, s0 + ch);
  int local = 0;
  for (int i = s0; i < s1; ++i) local += tot[i];
  int incl = local;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? wsum[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    wsum[lane] = w;
  }
  __syncthreads();
  int run = incl - local + (warp > 0 ? wsum[warp - 1] : 0);
  for (int i = s0; i < s1; ++i) {
    const int c = tot[i];
    tot[i] = run;
    off[i] = run;
    run += c;
  }
  if (threadIdx.x == blockDim.x - 1) off[n] = run;
  __syncthreads();
  for (int i = threadIdx.x; i < nwarps * n; i += blockDim.x) hist[i] += tot[i % n];
  __syncthreads();

  // pass 2: write each row id at its slot, in row order
  const unsigned below = (1u << lane) - 1u;
  for (int base = r0; base < r1; base += 32) {
    const int t = base + lane;
    const int key = t < r1 ? ix[t] : -1;
    const bool valid = t < r1 && key >= 0 && key < n;
    const int k = valid ? key : -1;
    const unsigned peers = __match_any_sync(kFull, k);
    int slot = 0;
    if (valid) slot = h[k] + __popc(peers & below);
    __syncwarp();
    if (valid) {
      rw[slot] = t;
      if (lane == __ffs(peers) - 1) h[k] += __popc(peers);
    }
    __syncwarp();
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

constexpr int kAhead = 4;  // rows whose loads are issued before their adds

template <typename T, int V>
__global__ void segment_sum_kernel(const T* __restrict__ ct, const int* __restrict__ offsets,
                                   const int* __restrict__ rows, T* __restrict__ out, int b,
                                   int r, int n, int c) {
  const long long gw = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (gw >= static_cast<long long>(b) * n) return;  // the whole warp leaves together
  const int bi = static_cast<int>(gw / n);
  const int ni = static_cast<int>(gw - static_cast<long long>(bi) * n);
  const int* off = offsets + static_cast<long long>(bi) * (n + 1);
  const int s = off[ni], e = off[ni + 1];
  const int* rw = rows + static_cast<long long>(bi) * r;
  const T* src = ct + static_cast<long long>(bi) * r * c;
  T* dst = out + (static_cast<long long>(bi) * n + ni) * c;
  using VT = Vec<T, V>;
  for (int c0 = lane * V; c0 < c; c0 += 32 * V) {
    float acc[V];
#pragma unroll
    for (int q = 0; q < V; ++q) acc[q] = 0.0f;
    int j = s;
    for (; j + kAhead <= e; j += kAhead) {
      VT vals[kAhead];
#pragma unroll
      for (int a = 0; a < kAhead; ++a) {
        const long long row = rw[j + a];
        vals[a] = *reinterpret_cast<const VT*>(src + row * c + c0);
      }
#pragma unroll
      for (int a = 0; a < kAhead; ++a) {
#pragma unroll
        for (int q = 0; q < V; ++q) acc[q] += to_f32(vals[a].v[q]);
      }
    }
    for (; j < e; ++j) {
      const long long row = rw[j];
      const VT val = *reinterpret_cast<const VT*>(src + row * c + c0);
#pragma unroll
      for (int q = 0; q < V; ++q) acc[q] += to_f32(val.v[q]);
    }
    VT o;
#pragma unroll
    for (int q = 0; q < V; ++q) o.v[q] = from_f32<T>(acc[q]);
    *reinterpret_cast<VT*>(dst + c0) = o;
  }
}

template <typename T>
cudaError_t launch_sum(const void* ct, const int* offsets, const int* rows, void* out, int b,
                       int r, int n, int c, cudaStream_t stream) {
  const auto aligned = [](const void* p, int bytes) {
    return reinterpret_cast<std::uintptr_t>(p) % bytes == 0;
  };
  const int threads = 256;
  const long long warps = static_cast<long long>(b) * n;
  const unsigned blocks = static_cast<unsigned>((warps * 32 + threads - 1) / threads);
  const int b4 = static_cast<int>(sizeof(T)) * 4, b2 = static_cast<int>(sizeof(T)) * 2;
  const T* src = static_cast<const T*>(ct);
  T* dst = static_cast<T*>(out);
  if (c % 4 == 0 && aligned(ct, b4) && aligned(out, b4)) {
    segment_sum_kernel<T, 4><<<blocks, threads, 0, stream>>>(src, offsets, rows, dst, b, r, n, c);
  } else if (c % 2 == 0 && aligned(ct, b2) && aligned(out, b2)) {
    segment_sum_kernel<T, 2><<<blocks, threads, 0, stream>>>(src, offsets, rows, dst, b, r, n, c);
  } else {
    segment_sum_kernel<T, 1><<<blocks, threads, 0, stream>>>(src, offsets, rows, dst, b, r, n, c);
  }
  return cudaGetLastError();
}

}  // namespace

// ct (B, R=M*K, C) of dtype 0 = float32 or 1 = bfloat16, idx (B, R) int32 ->
// out (B, N, C) of ct's dtype. offsets (B, N+1) and rows (B, R) int32 are
// scratch. warps: warps per block of the CSR pass; (warps + 1) * N * 4 bytes
// of shared memory.
extern "C" int dlbt_scatter_rows(const void* ct, const void* idx, void* offsets, void* rows,
                                 void* out, int b, int r, int n, int c, int dtype, int warps,
                                 void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (b < 1 || n < 1 || c < 1 || r < 0 || warps < 1 || warps > 32 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = (warps + 1) * n * static_cast<int>(sizeof(int));
  cudaError_t e = cudaFuncSetAttribute(csr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  csr_kernel<<<b, warps * 32, smem, s>>>(static_cast<const int*>(idx),
                                         static_cast<int*>(offsets), static_cast<int*>(rows),
                                         r, n);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int* off = static_cast<const int*>(offsets);
  const int* rw = static_cast<const int*>(rows);
  e = dtype == 0 ? launch_sum<float>(ct, off, rw, out, b, r, n, c, s)
                 : launch_sum<__nv_bfloat16>(ct, off, rw, out, b, r, n, c, s);
  return static_cast<int>(e);
}
