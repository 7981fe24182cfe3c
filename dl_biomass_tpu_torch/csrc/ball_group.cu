// Stratified ball query fused with the capture of the edge features.
//
// Replaces: dl_biomass_tpu/ops/pallas_group.py ball_group_pallas (kernel
// _kernel, rule stratified_pair_select).
// Semantics: the selection rule of stratified_select.cuh (slot j of 64 holds
// the smallest in-radius valid index whose residue mod 128 is j or j + 64;
// the in-radius test rounds every operation on its own, dlbt::in_ball). For
// each slot the kernel writes [feat_0 .. feat_{F-1}, x - cx, y - cy, z - cz]
// in the output type (bf16 or f32, rounded to nearest even), zeros for an
// invalid slot, the validity byte and, when asked, the index (0 where
// invalid), as the plain version (ops/ball_group_kernel.py) does.
//
// Bound on the H100: the distance tests. A test is 9 instructions with no
// FMA (3 sub, 3 mul, 2 add, a compare), so the CUDA cores' issue rate, not
// the 67 TFLOP/s FMA peak, sets the floor: 14.2 tests per SM cycle. The
// output (B*M*64*(F+3) values) is the only sizeable traffic.
//
// The one-centroid design this replaces (one 128-thread block per centroid,
// thread g scanning bucket g to its first hit): a warp runs to its slowest
// lane, so its early exit saved about what its capture cost, and each test
// paid four loads for nine instructions; it ran 4.2 lane-tests per SM cycle,
// 3.4x the floor of a full scan (PERF.md, kernel 2).
//
// Design: blocked over centroids.
// - A block is 128 threads and kC centroids of one cloud. Thread g owns
//   bucket g (points g, g + 128, ...) and keeps the kC centroids in
//   registers, so each point it loads is tested against all of them: one
//   16-byte load per kC tests.
// - The points come as one float4 each (x, y, z, 0; NaN where masked, which
//   fails every test), from the (B, N, 4) copy the wrapper makes. Measured
//   against x, y, z and the mask byte read from (B, N, 3) and (B, N) through
//   L1, and against that copy staged through shared memory by cp.async for
//   blocks of 2 and 4 groups of 128 threads, it was as fast or faster at
//   every shape of the paths.
// - The first hit needs no atomics. A thread takes its points in chunks of
//   kT (128 * kT points a block) and tests a chunk's points in descending
//   order, so a hit is one select: 10 instructions a test. Chunks ascend,
//   so the chunk's hits merge into the thread's by a min.
// - A masked centroid and the tail of M beyond the last tile start at first
//   = -1, which the min never raises and the scan counts as done. A thread
//   stops when all its centroids have their hit (checked once a chunk); a
//   warp runs to its slowest lane, so this saves little on sparse balls.
// - The capture: the block writes its kC x 128 bucket minima to shared
//   memory; slot j of centroid k is the smaller of buckets j and j + 64
//   (dlbt::pair_select), and consecutive threads write consecutive slots,
//   so a warp's edge rows are contiguous (one 8- or 16-byte store a slot
//   where F = 1).
// ops/ball_group_kernel.plan picks kC and kT (chip_compare.py grouptune).
// mode 1 (scan only: no capture, no stores) and 2 (the same with no early
// exit) are measurements: they store only where a bucket minimum equals
// -2, which none does, so that the scan is not removed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "stratified_select.cuh"

namespace {

using dlbt::kBuckets;
using dlbt::kSlots;

constexpr int kMaxF = 4;
constexpr int kSentinel = -2;

struct Args {
  const float* centers;        // (B, M, 3)
  const unsigned char* cmask;  // (B, M)
  const float4* pts;           // (B, N): x, y, z, 0; NaN where masked
  const float* feat;           // (B, N, F) or null
  void* edges;                 // (B, M, 64, F+3) bf16 or f32
  unsigned char* nbr_mask;     // (B, M, 64)
  int* idx;                    // (B, M, 64) or null
  int m, n, f, bf16, mode;
  float r2;
};

__device__ __forceinline__ float4 nan4() {
  const float q = __int_as_float(0x7fc00000);
  return make_float4(q, q, q, q);
}

// Tests point i (p) against the thread's kC centroids; a chunk's points go
// in descending order, so the last hit is the chunk's first.
template <int kC>
__device__ __forceinline__ void test_point(float4 p, int i, const float (&c)[kC][3], float r2,
                                           int (&cand)[kC]) {
#pragma unroll
  for (int k = 0; k < kC; ++k) {
    if (dlbt::in_ball(p.x, p.y, p.z, c[k][0], c[k][1], c[k][2], r2)) cand[k] = i;
  }
}

// One chunk of the thread's bucket, points cb + g + 128 t (t < kT), loaded
// first so that their loads are in flight together (kTail: i < n checked),
// then merged into first: chunks ascend, so the smaller stays, and a masked
// centroid's -1 stays -1. cand restarts at n.
template <int kC, int kT, bool kTail>
__device__ __forceinline__ void scan_chunk(const float4* __restrict__ pts, int n, int cb, int g,
                                           const float (&c)[kC][3], float r2, int (&first)[kC],
                                           int (&cand)[kC]) {
  float4 p[kT];
#pragma unroll
  for (int t = 0; t < kT; ++t) {
    const int i = cb + g + t * kBuckets;
    p[t] = (!kTail || i < n) ? __ldg(pts + i) : nan4();
  }
#pragma unroll
  for (int t = kT - 1; t >= 0; --t) test_point<kC>(p[t], cb + g + t * kBuckets, c, r2, cand);
#pragma unroll
  for (int k = 0; k < kC; ++k) {
    first[k] = min(first[k], cand[k]);
    cand[k] = n;
  }
}

template <int kC>
__device__ __forceinline__ bool live(const int (&first)[kC], int n) {
  bool any = false;
#pragma unroll
  for (int k = 0; k < kC; ++k) any |= first[k] == n;
  return any;
}

__device__ __forceinline__ void put(float* e, float v) { *e = v; }
__device__ __forceinline__ void put(__nv_bfloat16* e, float v) { *e = __float2bfloat16_rn(v); }

// Slot `slot`'s edge row [feat_0 .. feat_{f-1}, rx, ry, rz] in T, features
// from fp (null: zeros): one 8- or 16-byte store where f = 1.
template <typename T>
__device__ __forceinline__ void write_row(void* edges, size_t slot, int f, const float* fp,
                                          float rx, float ry, float rz) {
  T* e = static_cast<T*>(edges) + slot * (f + 3);
  if (f == 1) {
    const float f0 = fp != nullptr ? __ldg(fp) : 0.0f;
    if (sizeof(T) == 2) {
      __nv_bfloat162 lo = __floats2bfloat162_rn(f0, rx);
      __nv_bfloat162 hi = __floats2bfloat162_rn(ry, rz);
      uint2 w;
      w.x = *reinterpret_cast<unsigned*>(&lo);
      w.y = *reinterpret_cast<unsigned*>(&hi);
      *reinterpret_cast<uint2*>(e) = w;
    } else {
      *reinterpret_cast<float4*>(e) = make_float4(f0, rx, ry, rz);
    }
    return;
  }
  for (int q = 0; q < f; ++q) put(e + q, fp != nullptr ? __ldg(fp + q) : 0.0f);
  put(e + f, rx);
  put(e + f + 1, ry);
  put(e + f + 2, rz);
}

template <int kC, int kT>
__global__ void __launch_bounds__(kBuckets, 4) ball_group_kernel(const Args a) {
  __shared__ int s_first[kC * kBuckets];
  const int b = blockIdx.y, g = threadIdx.x, c0 = blockIdx.x * kC;
  const int n = a.n;
  const size_t bn = static_cast<size_t>(b) * n, bm = static_cast<size_t>(b) * a.m;
  const float4* pts = a.pts + bn;

  float c[kC][3];
  int first[kC], cand[kC];
#pragma unroll
  for (int k = 0; k < kC; ++k) {
    const int ci = c0 + k;
    const bool ok = ci < a.m && a.cmask[bm + ci];
    const float* p = a.centers + 3 * (bm + (ci < a.m ? ci : 0));
    c[k][0] = __ldg(p);
    c[k][1] = __ldg(p + 1);
    c[k][2] = __ldg(p + 2);
    first[k] = ok ? n : -1;
    cand[k] = n;
  }

  constexpr int kChunk = kT * kBuckets;
  const bool early = a.mode != 2;
  const int full = n / kChunk;
  int ch = 0;
  for (; ch < full && (!early || live<kC>(first, n)); ++ch)
    scan_chunk<kC, kT, false>(pts, n, ch * kChunk, g, c, a.r2, first, cand);
  if (ch == full && full * kChunk < n && (!early || live<kC>(first, n)))
    scan_chunk<kC, kT, true>(pts, n, full * kChunk, g, c, a.r2, first, cand);

  if (a.mode != 0) {
#pragma unroll
    for (int k = 0; k < kC; ++k)
      if (first[k] == kSentinel) a.nbr_mask[0] = 1;
    return;
  }
#pragma unroll
  for (int k = 0; k < kC; ++k) s_first[k * kBuckets + g] = first[k];
  __syncthreads();

  // the capture: thread g takes slot j = g % 64 of centroids k = g / 64, g / 64 + 2, ...
  const int j = g % kSlots;
  for (int k = g / kSlots; k < kC; k += kBuckets / kSlots) {
    const int ci = c0 + k;
    if (ci >= a.m) break;
    const int sel = dlbt::pair_select(s_first + k * kBuckets, j);
    const bool ok = static_cast<unsigned>(sel) < static_cast<unsigned>(n);
    const size_t slot = (bm + ci) * kSlots + j;
    a.nbr_mask[slot] = ok;
    if (a.idx != nullptr) a.idx[slot] = ok ? sel : 0;
    float rx = 0.0f, ry = 0.0f, rz = 0.0f;
    const float* fp = nullptr;
    if (ok) {
      const float* cc = a.centers + 3 * (bm + ci);
      const float4 p = __ldg(pts + sel);
      rx = __fsub_rn(p.x, __ldg(cc));
      ry = __fsub_rn(p.y, __ldg(cc + 1));
      rz = __fsub_rn(p.z, __ldg(cc + 2));
      if (a.f > 0) fp = a.feat + (bn + sel) * a.f;
    }
    if (a.bf16) {
      write_row<__nv_bfloat16>(a.edges, slot, a.f, fp, rx, ry, rz);
    } else {
      write_row<float>(a.edges, slot, a.f, fp, rx, ry, rz);
    }
  }
}

// The instantiations ops/ball_group_kernel.py's plan and sweep may name:
// kC in {4, 8, 16} centroids a block, kT in {4, 8, 16} points a thread a chunk.
const void* kernel_for(int kc, int kt) {
  switch (kc * 100 + kt) {
    case 404: return reinterpret_cast<const void*>(&ball_group_kernel<4, 4>);
    case 408: return reinterpret_cast<const void*>(&ball_group_kernel<4, 8>);
    case 416: return reinterpret_cast<const void*>(&ball_group_kernel<4, 16>);
    case 804: return reinterpret_cast<const void*>(&ball_group_kernel<8, 4>);
    case 808: return reinterpret_cast<const void*>(&ball_group_kernel<8, 8>);
    case 816: return reinterpret_cast<const void*>(&ball_group_kernel<8, 16>);
    case 1604: return reinterpret_cast<const void*>(&ball_group_kernel<16, 4>);
    case 1608: return reinterpret_cast<const void*>(&ball_group_kernel<16, 8>);
    case 1616: return reinterpret_cast<const void*>(&ball_group_kernel<16, 16>);
    default: return nullptr;
  }
}

}  // namespace

// centers (B, M, 3) f32, cmask (B, M) bool, pts (B, N, 4) f32 (x, y, z, 0; NaN where
// masked), feat (B, N, F) f32 or null -> edges (B, M, 64, F+3) bf16 (bf16 != 0) or f32,
// nbr_mask (B, M, 64) bool, idx (B, M, 64) int32 or null; kc centroids a block and kt
// points a thread a chunk, as ops/ball_group_kernel.plan names them. mode 0 is the
// kernel; 1 and 2 its measurements. A plan the kernel does not take returns
// cudaErrorInvalidValue.
extern "C" int dlbt_ball_group(const void* centers, const void* cmask, const void* pts,
                               const void* feat, void* edges, void* nbr_mask, void* idx, int b,
                               int m, int n, int f, float r2, int bf16, int kc, int kt, int mode,
                               void* stream) {
  const void* fn = kernel_for(kc, kt);
  if (fn == nullptr || f < 0 || f > kMaxF || (f > 0 && feat == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const float*>(centers), static_cast<const unsigned char*>(cmask),
         static_cast<const float4*>(pts), static_cast<const float*>(feat), edges,
         static_cast<unsigned char*>(nbr_mask), static_cast<int*>(idx), m, n, f, bf16, mode,
         r2};
  void* args[] = {&a};
  const cudaError_t e = cudaLaunchKernel(fn, dim3((m + kc - 1) / kc, b), dim3(kBuckets), args, 0,
                                         static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Blocks per SM of a plan's launch (128 threads, kc * 512 bytes of shared memory each).
extern "C" int dlbt_ball_group_occupancy(int kc, int kt, int* per_sm) {
  const void* fn = kernel_for(kc, kt);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, kBuckets, 0));
}
