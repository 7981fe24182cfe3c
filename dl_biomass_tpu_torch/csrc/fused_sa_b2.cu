// Kernel 6-B2 in bf16, on the tensor cores: the second recomputing pass of the
// fused SA-layer MLP's backward (csrc/fused_sa_bwd.cu holds all three passes
// and runs this one in f32). Per edge row it recomputes h1, a1 and h2, routes
// the pooled output's cotangent g to F3's argmax slots (gs: g[c] at row
// amax[c] of column c), and forms
//   da2 = gs W3^T, db2n = da2 act'(z2) mask,
//   dh2 = sc2 (db2n - t2a - xhat2 t2b) mask, dW2 = a1^T dh2, db2 = sum(dh2),
//   da1 = dh2 W2^T, db1n = da1 act'(z1) mask, sdb1 = sum(db1n),
//   sdb1x = sum(db1n xhat1), xhat = (h - mean) inv,
// the sums over every edge row of the batch.
//
// Replaces: dl_biomass_tpu/ops/pallas_sa_train.py fused_sa_mlp, its backward's second
// pass (_b2_kernel), in bf16.
// Semantics: those of fused_sa_bwd_stage_plain(2, ..., bf16=True). Every product
// takes bf16 operands (the weights, the edge rows with the planes rounded, a1, gs,
// dh2) with f32 sums; db2 sums dh2 before its rounding; the hidden values, the
// BatchNorm terms and the derivatives stay f32.
//
// Bound on the H100: operations. Per valid edge row 2 (KP C1 + C1 C2) flop of
// recompute and 4 C1 C2 for dW2 and da1, and 2 C2 C3 per centroid for the routed
// da2, at the bf16 tensor cores' 989 TFLOP/s: 0.070 ms at SA2 of a 16 x 10240
// training step. The bytes are fewer: SA2's bf16 dense block read once (134 MB),
// 0.04 ms. da2 runs as a dense product over the 64 slots, 64 times the routed work,
// which the tensor cores absorb.
//
// Design: bf16 B3's front half (csrc/fused_sa_b3.cu; the shared pieces in
// csrc/fused_sa_mma.cuh). A persistent block of 8 warps copies the bf16 weights
// (W1^T, W2^T, W3: 138 KiB at SA2) and the per-column vectors into shared memory
// once, and walks centroids with a grid stride while cp.async fills the other of two
// input buffers with the next one's. Warp w takes row tile w % 4 and half w / 4 of
// the columns: h1 stays in its accumulators; layer 2 runs 32 columns at a time, h2
// and the routed da2 side by side, so that dh2 is formed in registers, summed over
// the tile's rows in f32 for db2 and written once to shared memory as bf16. dW2
// (C1 x C2) is contracted over the 64 slots on mma.sync, with ldmatrix.trans
// fragments of the bf16 a1 and dh2 rows, into 16 x 16 tiles that stay in the warps'
// registers for all of a block's centroids (64 floats a thread at SA2); da1 comes
// from the same W2^T copy (ldmatrix.trans), and db1n from the h1 still in registers.
// The row tiles' column sums land in the edge rows' buffer, dead once h1 is formed
// (a region of their own where they do not fit there), and one thread per element
// adds the 4 tiles in their order in f64 into registers it keeps across centroids.
// Shared memory at SA2: 224 KiB of 227, one block per SM; SA1: 61 KiB, two blocks
// (SA1's 16 dW2 tiles, two a warp, leave room for it in 128 registers). No float
// atomics: each block writes its dW2 slice (f32) and its db2, sdb1, sdb1x slice
// (f64), and the entry's second launch (csrc/fused_sa_bwd.cu, reduce_blocks) adds
// the slices in block order in f64, so two launches agree bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "fused_sa_mma.cuh"

namespace {

using namespace fused_sa_mma;

constexpr int kMaxDwTiles = 8;  // dW2's 16 x 16 tiles a warp holds at most
constexpr int kOwned = 2;       // elements of the vector slice a thread adds up

// Byte offsets of one block's shared memory: the bf16 weights (W1^T, W2^T, W3), the
// per-column vectors of both layers (Vec order), two input buffers (Inputs), the bf16
// cotangent and 16-bit argmax, the a1 and dh2 rows, and the row tiles' column sums
// of dh2, db1n and db1n xhat1 (C2 + 2 C1 each) where the edge rows cannot hold them.
struct Layout {
  Inputs in;
  size_t w3, vec, buf, gb, am16, a1, dh2, red, total;
  bool red_in_x;
  __host__ __device__ Layout(int kx, int cp, int c1, int c2, int c3) : in(kx, cp, c3) {
    size_t at = w1t_bytes(kx, c1) + w2t_bytes(c1, c2);
    w3 = at;
    at += w3_bytes(c2, c3);
    vec = take(at, vec_bytes(c1, c2));
    buf = take(at, 2 * in.stride);
    gb = take(at, 2ull * c3);
    am16 = take(at, 2ull * c3);
    a1 = take(at, 2ull * kSlots * (c1 + kSkewH));
    dh2 = take(at, 2ull * kSlots * (c2 + kSkewH));
    const size_t red_bytes = 4ull * kRowTiles * (c2 + 2 * c1);
    red_in_x = red_bytes <= 2ull * kSlots * (kx + kSkewH);
    red = red_in_x ? 0 : take(at, red_bytes);
    total = at;
  }
};

// kT1: layer 1's n-tiles per warp (C1 / 16); kDw: dW2's 16 x 16 tiles per warp. w holds
// the per-column vectors (Vec order, layer 1's then layer 2's), wb the bf16 weights.
template <int kT1, int kDw>
__global__ void __launch_bounds__(kThreads, kT1 == 4 && kDw == 2 ? 2 : 1)
    fused_sa_b2_kernel(const bf16* __restrict__ dense, const float* __restrict__ planes,
                       const unsigned char* __restrict__ mask, const float* __restrict__ w,
                       const bf16* __restrict__ wb, const float* __restrict__ gout,
                       const int* __restrict__ amax, float* __restrict__ partial,
                       double* __restrict__ partial_v, long long total, int cd, int cp, int c1,
                       int c2, int c3, int c_out, int act) {
  extern __shared__ __align__(16) char smem[];
  const int cd16 = round16(cd), kx = cd16 + round16(cp);
  const Layout L(kx, cp, c1, c2, c3);
  const bf16* const w1t = reinterpret_cast<const bf16*>(smem);
  const bf16* const w2t = reinterpret_cast<const bf16*>(smem + w1t_bytes(kx, c1));
  const bf16* const w3 = reinterpret_cast<const bf16*>(smem + L.w3);
  const float* const v1 = reinterpret_cast<const float*>(smem + L.vec);
  const float* const v2 = v1 + kVecs * c1;
  bf16* const gb = reinterpret_cast<bf16*>(smem + L.gb);
  unsigned short* const am16 = reinterpret_cast<unsigned short*>(smem + L.am16);
  bf16* const a1 = reinterpret_cast<bf16*>(smem + L.a1);
  bf16* const dh2 = reinterpret_cast<bf16*>(smem + L.dh2);
  const int ldx = kx + kSkewH, ld1 = c1 + kSkewH, ld2 = c2 + kSkewH, ld3 = c3 + kSkewH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int tile = warp % kRowTiles, r0 = 16 * tile, half = warp / kRowTiles;
  const int n1 = half * 8 * kT1;  // the warp's first column of layer 1
  const int nv = c2 + 2 * c1;     // the vector slice: db2, sdb1, sdb1x
  const bool dense_vec = cd % 8 == 0 && reinterpret_cast<uintptr_t>(dense) % 16 == 0;

  copy_async(smem, wb, L.vec);  // the weights and the vectors, once per block
  copy_async(smem + L.vec, w, vec_bytes(c1, c2));
  const auto prefetch = [&](long long ci, int b) {
    prefetch_inputs(smem + L.buf + b * L.in.stride, L.in, ci, dense, planes, mask, gout, amax,
                    cd, cp, ldx, c_out, dense_vec);
  };
  if (blockIdx.x < total) prefetch(blockIdx.x, 0);
  dlbt::cp_async_commit();

  const int dw_tiles = (c1 / 16) * (c2 / 16), pairs = c2 / 16;
  float dw[kDw][2][4];
#pragma unroll
  for (int s = 0; s < kDw; ++s) dlbt::zero_acc(dw[s]);
  double sums[kOwned] = {};  // elements tid + kThreads k of the vector slice

  int b = 0;
  for (long long ci = blockIdx.x; ci < total; ci += gridDim.x, b ^= 1) {
    if (ci + gridDim.x < total) prefetch(ci + gridDim.x, b ^ 1);
    dlbt::cp_async_commit();
    dlbt::cp_async_wait<1>();  // this centroid's copies (and the weights) have landed
    __syncthreads();           // ... for every thread
    const long long row0 = ci * kSlots;
    char* const in = smem + L.buf + b * L.in.stride;
    const unsigned char* const mk = reinterpret_cast<const unsigned char*>(in + L.in.mask);
    if (!__syncthreads_or(tid < kSlots && mk[tid] != 0)) continue;  // no valid slot
    bf16* const x = reinterpret_cast<bf16*>(in + L.in.x);
    stage_inputs(in, L.in, gb, am16, 0, c3, c_out, dense, row0, cd, cp, kx, ldx, dense_vec);
    __syncthreads();

    float h1[kT1][4];  // kept to the end
    layer1<kT1>(x, ldx, w1t, cd16, kx, cp, v1, c1, act, a1, ld1, r0, n1, h1);
    __syncthreads();  // from here the edge rows are dead: their room takes the sums
    float* const red = reinterpret_cast<float*>(L.red_in_x ? in + L.in.x : smem + L.red);

    // layer 2: dh2 in bf16, and its column sums (db2) before the rounding
    const float m_lo = mk[r0 + g] ? 1.0f : 0.0f, m_hi = mk[r0 + g + 8] ? 1.0f : 0.0f;
    layer2(a1, ld1, w2t, c1, c2, gb, am16, c3, w3, ld3, r0, half,
           [&](int col, const float (&h2)[4], const float (&d2)[4]) {
             const float2 bias = at2(v2 + kBias * c2, col);
             float hv[4], db[4], xh[4], d[4];
#pragma unroll
             for (int e = 0; e < 4; ++e) hv[e] = h2[e] + lane2(bias, e);
             bn_backward(hv, d2, v2, c2, col, act, m_lo, m_hi, db, xh);
             bn_dh(db, xh, v2, c2, col, m_lo, m_hi, d);
             put2(dh2, ld2, r0 + g, col, d[0], d[1]);
             put2(dh2, ld2, r0 + g + 8, col, d[2], d[3]);
#pragma unroll
             for (int p = 0; p < 2; ++p) {
               const float s = tile_colsum(d[p], d[p + 2]);
               if (g == 0) red[tile * nv + col + p] = s;
             }
           });
    __syncthreads();

    // dW2 += a1^T dh2
#pragma unroll
    for (int s = 0; s < kDw; ++s) {
      const int tau = s * kWarps + warp;
      if (tau < dw_tiles) {
        dlbt::warp_mma_tn<1>(a1, ld1, dh2, ld2, kSlots, (tau / pairs) * 16, (tau % pairs) * 16,
                             dw[s]);
      }
    }
    // layer 1: da1 = dh2 W2^T on h1's columns; the column sums of db1n and db1n xhat1
    {
      float d1[kT1][4];
      dlbt::zero_acc(d1);
      dlbt::warp_mma_tb<kT1 / 2>(dh2, ld2, w2t, ld1, c2, r0, n1, d1);
#pragma unroll
      for (int nt = 0; nt < kT1; ++nt) {
        const int col = n1 + 8 * nt + 2 * t;
        float db[4], xh[4];
        bn_backward(h1[nt], d1[nt], v1, c1, col, act, m_lo, m_hi, db, xh);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const float s = tile_colsum(db[p], db[p + 2]);
          const float sx = tile_colsum(db[p] * xh[p], db[p + 2] * xh[p + 2]);
          if (g == 0) {
            red[tile * nv + c2 + col + p] = s;
            red[tile * nv + c2 + c1 + col + p] = sx;
          }
        }
      }
    }
    __syncthreads();

    // each element's 4 row tiles, in their order, in f64
#pragma unroll
    for (int k = 0; k < kOwned; ++k) {
      const int j = tid + k * kThreads;
      if (j < nv) {
        double s = 0.0;
#pragma unroll
        for (int q = 0; q < kRowTiles; ++q) s += red[q * nv + j];
        sums[k] += s;
      }
    }
    __syncthreads();  // the buffer, the rows and the column sums are consumed
  }
  dlbt::cp_async_wait<0>();
  // this block's slices: dW2 (C1 x C2), then db2, sdb1, sdb1x
  float* const part = partial + static_cast<size_t>(blockIdx.x) * c1 * c2;
#pragma unroll
  for (int s = 0; s < kDw; ++s) {
    const int tau = s * kWarps + warp;
    if (tau >= dw_tiles) continue;
    const int j0 = (tau / pairs) * 16, c0 = (tau % pairs) * 16;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + g + 8 * (e >> 1), col = c0 + 8 * nt + 2 * t + (e & 1);
        part[static_cast<size_t>(j) * c2 + col] = dw[s][nt][e];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kOwned; ++k) {
    const int j = tid + k * kThreads;
    if (j < nv) partial_v[static_cast<size_t>(blockIdx.x) * nv + j] = sums[k];
  }
}

template <int kT1, int kDw>
cudaError_t launch(const void* dense, const void* planes, const void* mask, const void* w,
                   const void* wb, const void* g, const void* amax, void* partial,
                   void* partial_v, int centroids, int cd, int cp, int c1, int c2, int c3,
                   int c_out, int act, int max_grid, cudaStream_t stream, int* grid) {
  const auto kernel = fused_sa_b2_kernel<kT1, kDw>;
  const size_t smem = Layout(round16(cd) + round16(cp), cp, c1, c2, c3).total;
  int blocks = 0;
  cudaError_t e = persistent_grid(kernel, smem, centroids, max_grid, 1, &blocks);
  if (e != cudaSuccess) return e;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const bf16*>(dense), static_cast<const float*>(planes),
      static_cast<const unsigned char*>(mask), static_cast<const float*>(w),
      static_cast<const bf16*>(wb), static_cast<const float*>(g), static_cast<const int*>(amax),
      static_cast<float*>(partial), static_cast<double*>(partial_v), centroids, cd, cp, c1, c2,
      c3, c_out, act);
  e = cudaGetLastError();
  if (e == cudaSuccess) grid[0] = grid[1] = blocks;
  return e;
}

}  // namespace

// B2 in bf16 over B*M = centroids centroids, the arguments of dlbt_fused_sa_b2
// (csrc/fused_sa_bwd.cu, which checks the shared ones and adds the slices) but w, here
// the per-column vectors (7 (C1 + C2) f32: b, sc, sh, mean, inv, ta, tb of layer 1,
// then of layer 2; t1a and t1b unread), and wb, the bf16 weight block (W1^T, W2^T, W3
// as fused_sa_mma.cuh lays them out); mask, w and wb 16-byte aligned; kp and d_dense
// unread. Writes each block's dW2 slice (C1 x C2 f32) into partial and its db2, sdb1,
// sdb1x slice (C2 + 2 C1 f64) into partial_v; grid (host memory) gets the number of
// slices of each, grid[0] and grid[1]. C1 64 or 128, C2 and C3 multiples of 64, at
// most 8 x kMaxDwTiles of dW2's 16 x 16 tiles, and C2 + 2 C1 at most kOwned x 256.
extern "C" int dlbt_fused_sa_b2_mma(const void* dense, const void* planes, const void* mask,
                                    const void* w, const void* wb, const void* g,
                                    const void* amax, void* partial, void* partial_v,
                                    void* d_dense, int centroids, int cd, int cp, int kp, int c1,
                                    int c2, int c3, int c_out, int act, int max_grid,
                                    void* stream, int* grid) {
  (void)d_dense;
  (void)kp;
  grid[0] = grid[1] = 0;
  const int dw_tiles = (c1 / 16) * (c2 / 16);
  if ((c1 != 64 && c1 != 128) || c2 % 64 || c3 % 64 || dw_tiles > kWarps * kMaxDwTiles ||
      c2 + 2 * c1 > kOwned * kThreads || wb == nullptr ||
      reinterpret_cast<uintptr_t>(wb) % 16 || reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(mask) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool few = dw_tiles <= kWarps * 4;
  cudaError_t e;
  if (c1 == 64) {  // SA1's 16 tiles: two a warp, and two blocks an SM
    e = dw_tiles <= kWarps * 2
            ? launch<4, 2>(dense, planes, mask, w, wb, g, amax, partial, partial_v, centroids,
                           cd, cp, c1, c2, c3, c_out, act, max_grid, s, grid)
            : launch<4, kMaxDwTiles>(dense, planes, mask, w, wb, g, amax, partial, partial_v,
                                     centroids, cd, cp, c1, c2, c3, c_out, act, max_grid, s,
                                     grid);
  } else {
    e = few ? launch<8, 4>(dense, planes, mask, w, wb, g, amax, partial, partial_v, centroids,
                           cd, cp, c1, c2, c3, c_out, act, max_grid, s, grid)
            : launch<8, kMaxDwTiles>(dense, planes, mask, w, wb, g, amax, partial, partial_v,
                                     centroids, cd, cp, c1, c2, c3, c_out, act, max_grid, s,
                                     grid);
  }
  return static_cast<int>(e);
}
