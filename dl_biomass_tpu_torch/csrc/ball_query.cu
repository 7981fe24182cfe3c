// Exact ball query: the first K in-radius neighbours of each centroid by index.
//
// Replaces: dl_biomass_tpu/ops/pallas_ballquery.py ball_query_pallas (kernel
// _bq_kernel).
// Semantics: those of the exact jnp path, dl_biomass_tpu/ops/ballquery.py
// ball_query(method="exact"): for a valid centroid, the K smallest indices of
// valid points with dx*dx + dy*dy + dz*dz <= r2 (inclusive, every operation
// rounded on its own), ascending; the remaining slots hold index 0 and are
// masked off. The Pallas kernel matches this except when one residue bucket
// holds more than R=8 of the first 64; this kernel has no such cap.
//
// Bound on the H100: operations, the distance tests the data needs (a scan
// stops at the K-th hit, so a centroid tests the index of its K-th neighbour
// plus one points, or all N), at 8 flops each; the (B, M, K) output is small.
//
// Design: one warp per centroid, four per block. The warp scans 32 points at a
// time in index order from the point planes (x, y, z, each (B, N) f32: one
// coalesced load per plane), __ballot_sync collects the hits, and a lane's
// slot is the count so far plus the __popc of the hits below it. The scan
// stops when K slots are filled; the lanes then fill the rest with index 0.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
ball_query_kernel(const float* __restrict__ centers, const unsigned char* __restrict__ cmask,
                  const float* __restrict__ planes, const unsigned char* __restrict__ mask,
                  int* __restrict__ idx, unsigned char* __restrict__ nbr_mask,
                  int m, int n, int k, float r2) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  if (c >= m) return;  // whole warps leave together; no block barrier follows
  const size_t ci = static_cast<size_t>(b) * m + c;
  int* o = idx + ci * k;
  unsigned char* om = nbr_mask + ci * k;
  int cnt = 0;
  if (cmask[ci]) {
    const float* px = planes + static_cast<size_t>(b) * 3 * n;
    const float* py = px + n;
    const float* pz = py + n;
    const unsigned char* mk = mask + static_cast<size_t>(b) * n;
    const float cx = centers[3 * ci], cy = centers[3 * ci + 1], cz = centers[3 * ci + 2];
    for (int base = 0; base < n && cnt < k; base += 32) {
      const int i = base + lane;
      bool ok = false;
      if (i < n && mk[i]) {
        const float dx = __fsub_rn(px[i], cx);
        const float dy = __fsub_rn(py[i], cy);
        const float dz = __fsub_rn(pz[i], cz);
        const float d2 =
            __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        ok = d2 <= r2;
      }
      const unsigned hits = __ballot_sync(kFull, ok);
      if (ok) {
        const int slot = cnt + __popc(hits & ((1u << lane) - 1u));
        if (slot < k) {
          o[slot] = i;
          om[slot] = 1;
        }
      }
      cnt += __popc(hits);
    }
  }
  for (int s = min(cnt, k) + lane; s < k; s += 32) {
    o[s] = 0;
    om[s] = 0;
  }
}

}  // namespace

// centers (B, M, 3) f32, cmask (B, M) bool, planes (B, 3, N) f32 [x, y, z], mask (B, N)
// bool -> idx (B, M, K) int32, nbr_mask (B, M, K) bool.
extern "C" int dlbt_ball_query(const void* centers, const void* cmask, const void* planes,
                               const void* mask, void* idx, void* nbr_mask, int b, int m,
                               int n, int k, float r2, void* stream) {
  const dim3 grid((m + kWarpsPerBlock - 1) / kWarpsPerBlock, b);
  ball_query_kernel<<<grid, 32 * kWarpsPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(centers), static_cast<const unsigned char*>(cmask),
      static_cast<const float*>(planes), static_cast<const unsigned char*>(mask),
      static_cast<int*>(idx), static_cast<unsigned char*>(nbr_mask), m, n, k, r2);
  return static_cast<int>(cudaGetLastError());
}
