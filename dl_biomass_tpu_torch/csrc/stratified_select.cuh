// Stratified neighbour selection, shared by csrc/ball_group.cu (kernel 2) and
// csrc/sa1_fused_eval.cu (kernel 5, which scans for several centroids at once with
// bucket_first_multi) so that the two cannot drift apart; the
// JAX package shares stratified_pair_select (dl_biomass_tpu/ops/pallas_group.py)
// between its two kernels for the same reason.
//
// Rule: points fall into 128 residue buckets (index mod 128). Output slot j of
// 64 holds the smallest in-radius valid point index whose residue is j or
// j + 64; a slot with no such point is invalid (index n). The in-radius test
// is dx*dx + dy*dy + dz*dz <= r2 with every operation rounded on its own, as
// in the Pallas kernels and the plain versions: a contracted FMA would flip
// points on the ball's boundary.
#pragma once

namespace dlbt {

constexpr int kBuckets = 128;  // residue buckets, one thread each
constexpr int kSlots = 64;     // output slots: buckets j and j + 64 pair up
constexpr int kScanUnroll = 4;  // points each thread loads before it tests them

// The rule's in-radius test: every operation rounded on its own.
__device__ __forceinline__ bool in_ball(float x, float y, float z, float cx, float cy, float cz,
                                        float r2) {
  const float dx = __fsub_rn(x, cx);
  const float dy = __fsub_rn(y, cy);
  const float dz = __fsub_rn(z, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz)) <= r2;
}

// Thread g of a 128-thread group scans points g, g + 128, ... in ascending
// order and returns its bucket's minimum: the first valid point within r2 of
// (cx, cy, cz), or n. The points come from (B, N) f32 planes, so a warp's
// loads are coalesced; each round loads kScanUnroll points before testing
// them, so that their loads are in flight together.
__device__ __forceinline__ int bucket_first(const float* __restrict__ px,
                                            const float* __restrict__ py,
                                            const float* __restrict__ pz,
                                            const unsigned char* __restrict__ mask, int n,
                                            float cx, float cy, float cz, float r2, int g) {
  for (int base = g; base < n; base += kScanUnroll * kBuckets) {
    float x[kScanUnroll], y[kScanUnroll], z[kScanUnroll];
    bool ok[kScanUnroll];
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u) {
      const int i = base + u * kBuckets;
      ok[u] = i < n;
      if (ok[u]) {
        x[u] = px[i];
        y[u] = py[i];
        z[u] = pz[i];
        ok[u] = mask[i] != 0;
      }
    }
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u) {
      if (ok[u] && in_ball(x[u], y[u], z[u], cx, cy, cz, r2)) return base + u * kBuckets;
    }
  }
  return n;
}

// bucket_first for kK centroids of one cloud at once, each point loaded once for
// all of them: first[k] gets the bucket's minimum for centroid c[k] (n where it
// has none, or where bit k of live is clear). The scan ends when every live
// centroid has its minimum, so it runs as far as the farthest of them; each
// round loads kUnroll points before testing them.
template <int kK, int kUnroll>
__device__ __forceinline__ void bucket_first_multi(const float* __restrict__ px,
                                                   const float* __restrict__ py,
                                                   const float* __restrict__ pz,
                                                   const unsigned char* __restrict__ mask,
                                                   int n, const float (&c)[kK][3], float r2,
                                                   unsigned live, int g, int (&first)[kK]) {
#pragma unroll
  for (int k = 0; k < kK; ++k) first[k] = n;
  unsigned need = live;
  for (int base = g; need != 0 && base < n; base += kUnroll * kBuckets) {
    float x[kUnroll], y[kUnroll], z[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kBuckets;
      ok[u] = i < n;
      if (ok[u]) {
        x[u] = px[i];
        y[u] = py[i];
        z[u] = pz[i];
        ok[u] = mask[i] != 0;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int k = 0; k < kK; ++k) {  // points ascend: the first hit of a centroid stays
        if (ok[u] && (need >> k & 1u) &&
            in_ball(x[u], y[u], z[u], c[k][0], c[k][1], c[k][2], r2)) {
          first[k] = base + u * kBuckets;
          need &= ~(1u << k);
        }
      }
    }
  }
}

// Slot j's point from the 128 bucket minima in shared memory: n if invalid.
__device__ __forceinline__ int pair_select(const int* first, int j) {
  return min(first[j], first[j + kSlots]);
}

}  // namespace dlbt
