// Stratified ball query fused with the capture of the edge features.
//
// Replaces: dl_biomass_tpu/ops/pallas_group.py ball_group_pallas (kernel
// _kernel, rule stratified_pair_select).
// Semantics: the selection rule of stratified_select.cuh (slot j of 64 holds
// the smallest in-radius valid index whose residue mod 128 is j or j + 64).
// For each slot the kernel writes [feat_0 .. feat_{F-1}, x - cx, y - cy,
// z - cz] in the output type (bf16 or f32, rounded to nearest even), zeros for
// an invalid slot, the validity byte and, when asked, the index (0 where
// invalid), as the plain version (ops/ball_group_kernel.py) does.
//
// Bound on the H100: operations, the distance tests (at worst B*M*N, each 8
// flops plus a compare); the early exit below cuts them to what the data
// needs. The output (B*M*64*(F+3) values) is the only sizeable traffic.
//
// Design: one 128-thread block per centroid. Thread g finds its bucket's
// minimum with dlbt::bucket_first (a scan of points g, g+128, ... of the
// point planes x, y, z, features, each (B, N) f32, that stops at the first
// in-radius valid point). Slot j is the smaller of threads j's and j+64's
// results, written by thread j; a slot's F+3 values are contiguous, so a
// warp's stores are too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "stratified_select.cuh"

namespace {

using dlbt::kBuckets;
using dlbt::kSlots;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(kBuckets)
ball_group_kernel(const float* __restrict__ centers, const unsigned char* __restrict__ cmask,
                  const float* __restrict__ planes, const unsigned char* __restrict__ mask,
                  T* __restrict__ edges, unsigned char* __restrict__ nbr_mask,
                  int* __restrict__ idx, int m, int n, int f, float r2) {
  __shared__ int first[kBuckets];
  const int b = blockIdx.y, c = blockIdx.x, g = threadIdx.x;
  const size_t ci = static_cast<size_t>(b) * m + c;
  const float* px = planes + static_cast<size_t>(b) * (3 + f) * n;
  const float* py = px + n;
  const float* pz = py + n;
  const float cx = centers[3 * ci], cy = centers[3 * ci + 1], cz = centers[3 * ci + 2];
  first[g] = cmask[ci] ? dlbt::bucket_first(px, py, pz, mask + static_cast<size_t>(b) * n, n,
                                            cx, cy, cz, r2, g)
                      : n;
  __syncthreads();
  if (g >= kSlots) return;
  const int sel = dlbt::pair_select(first, g);
  const bool ok = sel < n;
  const size_t slot = ci * kSlots + g;
  nbr_mask[slot] = ok;
  if (idx != nullptr) idx[slot] = ok ? sel : 0;
  T* e = edges + slot * (f + 3);
  for (int q = 0; q < f; ++q) store(e + q, ok ? px[(3 + q) * static_cast<size_t>(n) + sel] : 0.0f);
  store(e + f, ok ? __fsub_rn(px[sel], cx) : 0.0f);
  store(e + f + 1, ok ? __fsub_rn(py[sel], cy) : 0.0f);
  store(e + f + 2, ok ? __fsub_rn(pz[sel], cz) : 0.0f);
}

}  // namespace

// centers (B, M, 3) f32, cmask (B, M) bool, planes (B, 3+F, N) f32 [x, y, z, features],
// mask (B, N) bool -> edges (B, M, 64, F+3) bf16 (bf16 != 0) or f32, nbr_mask (B, M, 64)
// bool, idx (B, M, 64) int32 or null.
extern "C" int dlbt_ball_group(const void* centers, const void* cmask, const void* planes,
                               const void* mask, void* edges, void* nbr_mask, void* idx,
                               int b, int m, int n, int f, float r2, int bf16, void* stream) {
  const dim3 grid(m, b);
  auto s = static_cast<cudaStream_t>(stream);
  auto c = static_cast<const float*>(centers);
  auto cm = static_cast<const unsigned char*>(cmask);
  auto p = static_cast<const float*>(planes);
  auto mk = static_cast<const unsigned char*>(mask);
  auto nm = static_cast<unsigned char*>(nbr_mask);
  auto ix = static_cast<int*>(idx);
  if (bf16) {
    ball_group_kernel<__nv_bfloat16><<<grid, kBuckets, 0, s>>>(
        c, cm, p, mk, static_cast<__nv_bfloat16*>(edges), nm, ix, m, n, f, r2);
  } else {
    ball_group_kernel<float><<<grid, kBuckets, 0, s>>>(
        c, cm, p, mk, static_cast<float*>(edges), nm, ix, m, n, f, r2);
  }
  return static_cast<int>(cudaGetLastError());
}
