// Kernel 6-B1 in bf16, on the tensor cores: the first recomputing pass of the
// fused SA-layer MLP's backward (csrc/fused_sa_bwd.cu holds all three passes
// and runs this one in f32). Per edge row it recomputes h1, a1, h2 and a2,
// routes the pooled output's cotangent g to F3's argmax slots (gs: g[c] at row
// amax[c] of column c), and forms
//   dW3 = a2^T gs, db3 = sum(gs), da2 = gs W3^T, db2n = da2 act'(z2) mask,
//   sdb2 = sum(db2n), sdb2x = sum(db2n xhat2), xhat2 = (h2 - mean2) inv2,
// the sums over every edge row of the batch.
//
// Replaces: dl_biomass_tpu/ops/pallas_sa_train.py fused_sa_mlp, its backward's first
// pass (_b1_kernel), in bf16.
// Semantics: those of fused_sa_bwd_stage_plain(1, ..., bf16=True). Every product
// takes bf16 operands (the weights, the edge rows with the planes rounded, a1, a2,
// gs) with f32 sums; db3 sums the unrounded f32 cotangent; the hidden values and
// the derivatives stay f32.
//
// Bound on the H100: bytes. SA2's bf16 dense block read once (134 MB at a 16 x 10240
// training step) and the planes, 0.047 ms; the products, 2 (KP C1 + C1 C2) flop of
// recompute per valid edge row and 4 C2 C3 per centroid for the routed dW3 and da2,
// take less at the bf16 tensor cores' 989 TFLOP/s. This kernel runs dW3 and da2 as
// dense products over the 64 slots, 64 times the routed work.
//
// Design: bf16 B3's front half (csrc/fused_sa_b3.cu; the shared pieces in
// csrc/fused_sa_mma.cuh), with C3 split into column groups of up to 256 over the
// grid's second dimension. dW3 (C2 x C3, 128 KiB in f32 at SA2) does not fit shared
// memory beside the weights and the input buffers, so it lives in the warps'
// registers, contracted on mma.sync: 128 floats a thread at SA2 (245 registers, no
// spill). Where C3 is wider, each group of blocks holds its columns of dW3 and only
// its W3 columns in shared memory; da2 is linear in gs, so each group forms its
// columns' share of da2, db2n and the two sums, and the second launch adds the
// groups' slices, but the h1 and h2 recompute repeats per group: groups of 128
// (SA2 in two) ran 1.36 times as long as one group of 256 on an H100. The other
// design, dW3 routed on the CUDA cores with each thread owning a column slice,
// needs that slice in registers too, or in device memory once per centroid. A
// persistent block of 8 warps copies the bf16 W1^T, W2^T and its W3 columns and the
// per-column vectors into shared memory once, and walks centroids with a grid
// stride while cp.async fills the other of two input buffers. Warp w takes row tile
// w % 4 and half w / 4 of the columns: layer 2 runs 32 columns at a time, h2 and the
// routed da2 side by side; a2 goes to shared memory once, in bf16, and db2n and
// db2n xhat2 are summed over the tile's rows in registers. dW3^T = gs^T a2 is
// contracted over the 64 slots on mma.sync: the A fragments of gs^T are built in
// registers from the bf16 cotangent and the 16-bit argmax (one pair compare per
// register, as for da2), the B fragments of a2 come by ldmatrix.trans. The row tiles'
// column sums land in the edge rows' buffer, dead once h1 is formed (a region of
// their own where they do not fit there); one thread per element adds them (and db3
// its column's cotangent) in f64 into registers it keeps across centroids. Shared
// memory at SA2: 223 KiB, one block per SM; SA1: 61 KiB, two. No float atomics: each
// block writes its dW3 columns into its slice (f32) and its db3, sdb2, sdb2x slice
// (f64; other groups' db3 columns 0), and the entry's second launch
// (csrc/fused_sa_bwd.cu, reduce_blocks) adds the slices in block order in f64, so two
// launches agree bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "fused_sa_mma.cuh"

namespace {

using namespace fused_sa_mma;

constexpr int kGroup = 256;      // C3's columns per group of blocks
constexpr int kMaxDwTiles = 16;  // dW3's 16 x 16 tiles a warp holds at most
constexpr int kOwned = 2;        // elements of the vector slice a thread adds up

__host__ __device__ __forceinline__ int group_width(int c3) { return c3 < kGroup ? c3 : kGroup; }

// Byte offsets of one block's shared memory: the bf16 W1^T and W2^T, the group's
// columns of W3 (rows n3 + kSkewH apart, n3 the widest group), the per-column vectors
// of both layers (Vec order), two input buffers (Inputs), the group's bf16 cotangent
// and 16-bit argmax, the a1 and a2 rows, and the row tiles' column sums of db2n and
// db2n xhat2 (2 C2) where the edge rows cannot hold them.
struct Layout {
  Inputs in;
  size_t w3, vec, buf, gb, am16, a1, a2, red, total;
  bool red_in_x;
  __host__ __device__ Layout(int kx, int cp, int c1, int c2, int c3) : in(kx, cp, c3) {
    const int n3 = group_width(c3);
    size_t at = w1t_bytes(kx, c1) + w2t_bytes(c1, c2);
    w3 = at;
    at += w3_bytes(c2, n3);
    vec = take(at, vec_bytes(c1, c2));
    buf = take(at, 2 * in.stride);
    gb = take(at, 2ull * n3);
    am16 = take(at, 2ull * n3);
    a1 = take(at, 2ull * kSlots * (c1 + kSkewH));
    a2 = take(at, 2ull * kSlots * (c2 + kSkewH));
    const size_t red_bytes = 4ull * kRowTiles * 2 * c2;
    red_in_x = red_bytes <= 2ull * kSlots * (kx + kSkewH);
    red = red_in_x ? 0 : take(at, red_bytes);
    total = at;
  }
};

// acc[nt] += (gs^T a2)[m0 .. m0 + 15][n0 + 8 nt .. n0 + 8 nt + 7] over the 64 slots.
// gs^T's A fragments: column m's bf16 cotangent where its argmax (am16, 0xffff for
// none) is the fragment's slot, else 0 (one pair compare per register); a2's B
// fragments (slots as its rows) by ldmatrix.trans.
__device__ __forceinline__ void routed_tn(const bf16* gb, const unsigned short* am16, int m0,
                                          const bf16* a2, int ld2, int n0, float (&acc)[2][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint32_t g_lo = static_cast<uint32_t>(__bfloat16_as_ushort(gb[m0 + g])) * 0x10001u;
  const uint32_t g_hi = static_cast<uint32_t>(__bfloat16_as_ushort(gb[m0 + g + 8])) * 0x10001u;
  const uint32_t a_lo = static_cast<uint32_t>(am16[m0 + g]) * 0x10001u;
  const uint32_t a_hi = static_cast<uint32_t>(am16[m0 + g + 8]) * 0x10001u;
#pragma unroll
  for (int k0 = 0; k0 < kSlots; k0 += 16) {
    const uint32_t k = static_cast<uint32_t>(k0 + 2 * t) * 0x10001u + 0x10000u, k8 = k + 0x80008u;
    const uint32_t af[4] = {g_lo & __vcmpeq2(a_lo, k), g_hi & __vcmpeq2(a_hi, k),
                            g_lo & __vcmpeq2(a_lo, k8), g_hi & __vcmpeq2(a_hi, k8)};
    uint32_t b0[2], b1[2];
    dlbt::load_b_trans(b0, b1, a2, ld2, k0, n0);
    dlbt::mma_bf16(acc[0], af, b0);
    dlbt::mma_bf16(acc[1], af, b1);
  }
}

// kT1: layer 1's n-tiles per warp (C1 / 16); kDw: dW3's 16 x 16 tiles per warp. w holds
// the per-column vectors (Vec order, layer 1's then layer 2's), wb the bf16 weights.
// Block (x, y) takes C3's columns y kGroup .. and every gridDim.x-th centroid from x.
template <int kT1, int kDw>
__global__ void __launch_bounds__(kThreads, kT1 == 4 && kDw == 4 ? 2 : 1)
    fused_sa_b1_kernel(const bf16* __restrict__ dense, const float* __restrict__ planes,
                       const unsigned char* __restrict__ mask, const float* __restrict__ w,
                       const bf16* __restrict__ wb, const float* __restrict__ gout,
                       const int* __restrict__ amax, float* __restrict__ partial,
                       double* __restrict__ partial_v, long long total, int cd, int cp, int c1,
                       int c2, int c3, int c_out, int act) {
  extern __shared__ __align__(16) char smem[];
  const int cd16 = round16(cd), kx = cd16 + round16(cp);
  const Layout L(kx, cp, c1, c2, c3);
  const int c0 = blockIdx.y * kGroup, n3 = c3 - c0 < kGroup ? c3 - c0 : kGroup;
  const bf16* const w1t = reinterpret_cast<const bf16*>(smem);
  const bf16* const w2t = reinterpret_cast<const bf16*>(smem + w1t_bytes(kx, c1));
  const bf16* const w3 = reinterpret_cast<const bf16*>(smem + L.w3);
  const float* const v1 = reinterpret_cast<const float*>(smem + L.vec);
  const float* const v2 = v1 + kVecs * c1;
  bf16* const gb = reinterpret_cast<bf16*>(smem + L.gb);
  unsigned short* const am16 = reinterpret_cast<unsigned short*>(smem + L.am16);
  bf16* const a1 = reinterpret_cast<bf16*>(smem + L.a1);
  bf16* const a2 = reinterpret_cast<bf16*>(smem + L.a2);
  const int ldx = kx + kSkewH, ld1 = c1 + kSkewH, ld2 = c2 + kSkewH;
  const int ld3 = group_width(c3) + kSkewH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int tile = warp % kRowTiles, r0 = 16 * tile, half = warp / kRowTiles;
  const int n1 = half * 8 * kT1;  // the warp's first column of layer 1
  const int nv = n3 + 2 * c2;     // the group's vector: its db3 columns, sdb2, sdb2x
  const bool dense_vec = cd % 8 == 0 && reinterpret_cast<uintptr_t>(dense) % 16 == 0;

  // W1^T and W2^T, the group's columns of W3 and the vectors, once per block
  const size_t w12 = L.w3;
  copy_async(smem, wb, w12);
  {
    const char* const src = reinterpret_cast<const char*>(wb) + w12;
    const int vecs = n3 / 8;
    for (int i = tid; i < c2 * vecs; i += kThreads) {
      const int k = i / vecs, v = i - k * vecs;
      dlbt::cp_async16(smem + L.w3 + 2ull * (k * ld3 + 8 * v),
                       src + 2ull * (static_cast<size_t>(k) * (c3 + kSkewH) + c0 + 8 * v));
    }
  }
  copy_async(smem + L.vec, w, vec_bytes(c1, c2));
  const auto prefetch = [&](long long ci, int b) {
    prefetch_inputs(smem + L.buf + b * L.in.stride, L.in, ci, dense, planes, mask, gout, amax,
                    cd, cp, ldx, c_out, dense_vec);
  };
  if (blockIdx.x < total) prefetch(blockIdx.x, 0);
  dlbt::cp_async_commit();

  const int dw_tiles = (n3 / 16) * (c2 / 16), pairs = c2 / 16;
  float dw[kDw][2][4];  // tiles of dW3^T (the group's columns x C2)
#pragma unroll
  for (int s = 0; s < kDw; ++s) dlbt::zero_acc(dw[s]);
  double sums[kOwned] = {};  // elements tid + kThreads k of the group's vector

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
    stage_inputs(in, L.in, gb, am16, c0, n3, c_out, dense, row0, cd, cp, kx, ldx, dense_vec);
    __syncthreads();

    {
      float h1[kT1][4];
      layer1<kT1>(x, ldx, w1t, cd16, kx, cp, v1, c1, act, a1, ld1, r0, n1, h1);
    }
    __syncthreads();  // from here the edge rows are dead: their room takes the sums
    float* const red = reinterpret_cast<float*>(L.red_in_x ? in + L.in.x : smem + L.red);

    // layer 2: a2 in bf16, the column sums of db2n and db2n xhat2 (this group's share)
    const float m_lo = mk[r0 + g] ? 1.0f : 0.0f, m_hi = mk[r0 + g + 8] ? 1.0f : 0.0f;
    layer2(a1, ld1, w2t, c1, c2, gb, am16, n3, w3, ld3, r0, half,
           [&](int col, const float (&h2)[4], const float (&d2)[4]) {
             const float2 bias = at2(v2 + kBias * c2, col), sc = at2(v2 + kScale * c2, col),
                          sh = at2(v2 + kShift * c2, col);
             float hv[4], db[4], xh[4], a[4];
#pragma unroll
             for (int e = 0; e < 4; ++e) {
               hv[e] = h2[e] + lane2(bias, e);
               a[e] = activate(hv[e] * lane2(sc, e) + lane2(sh, e), act);
             }
             put2(a2, ld2, r0 + g, col, a[0], a[1]);
             put2(a2, ld2, r0 + g + 8, col, a[2], a[3]);
             bn_backward(hv, d2, v2, c2, col, act, m_lo, m_hi, db, xh);
#pragma unroll
             for (int p = 0; p < 2; ++p) {
               const float s = tile_colsum(db[p], db[p + 2]);
               const float sx = tile_colsum(db[p] * xh[p], db[p + 2] * xh[p + 2]);
               if (g == 0) {
                 red[tile * 2 * c2 + col + p] = s;
                 red[tile * 2 * c2 + c2 + col + p] = sx;
               }
             }
           });
    __syncthreads();

    // dW3^T += gs^T a2 over the group's columns
#pragma unroll
    for (int s = 0; s < kDw; ++s) {
      const int tau = s * kWarps + warp;
      if (tau < dw_tiles) routed_tn(gb, am16, (tau / pairs) * 16, a2, ld2, (tau % pairs) * 16, dw[s]);
    }
    // db3: the column's cotangent where it routes; sdb2, sdb2x: the 4 row tiles in order
    const float* const gf = reinterpret_cast<const float*>(in + L.in.g);
    const int* const am = reinterpret_cast<const int*>(in + L.in.am);
#pragma unroll
    for (int k = 0; k < kOwned; ++k) {
      const int j = tid + k * kThreads;
      if (j < n3) {
        if (c0 + j < c_out && am[c0 + j] >= 0) sums[k] += gf[c0 + j];
      } else if (j < nv) {
        double s = 0.0;
#pragma unroll
        for (int q = 0; q < kRowTiles; ++q) s += red[q * 2 * c2 + (j - n3)];
        sums[k] += s;
      }
    }
    __syncthreads();  // the buffer, the rows and the column sums are consumed
  }
  dlbt::cp_async_wait<0>();
  // this block's slices: its columns of dW3 (C2 x C3) in slice x; in slice
  // y gridDim.x + x, db3 (its columns; 0 at the others), sdb2, sdb2x
  float* const part = partial + static_cast<size_t>(blockIdx.x) * c2 * c3;
#pragma unroll
  for (int s = 0; s < kDw; ++s) {
    const int tau = s * kWarps + warp;
    if (tau >= dw_tiles) continue;
    const int m0 = (tau / pairs) * 16, k0 = (tau % pairs) * 16;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + g + 8 * (e >> 1), k = k0 + 8 * nt + 2 * t + (e & 1);
        part[static_cast<size_t>(k) * c3 + c0 + m] = dw[s][nt][e];
      }
    }
  }
  double* const pv = partial_v + static_cast<size_t>(blockIdx.y * gridDim.x + blockIdx.x) *
                                     (c3 + 2 * c2);
  for (int c = tid; c < c3; c += kThreads) {
    if (c < c0 || c >= c0 + n3) pv[c] = 0.0;
  }
#pragma unroll
  for (int k = 0; k < kOwned; ++k) {
    const int j = tid + k * kThreads;
    if (j < nv) pv[j < n3 ? c0 + j : c3 + (j - n3)] = sums[k];
  }
}

template <int kT1, int kDw>
cudaError_t launch(const void* dense, const void* planes, const void* mask, const void* w,
                   const void* wb, const void* g, const void* amax, void* partial,
                   void* partial_v, int centroids, int cd, int cp, int c1, int c2, int c3,
                   int c_out, int act, int max_grid, cudaStream_t stream, int* grid) {
  const auto kernel = fused_sa_b1_kernel<kT1, kDw>;
  const size_t smem = Layout(round16(cd) + round16(cp), cp, c1, c2, c3).total;
  const int groups = (c3 + kGroup - 1) / kGroup;
  int blocks = 0;
  cudaError_t e = persistent_grid(kernel, smem, centroids, max_grid, groups, &blocks);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(groups)), kThreads, smem,
           stream>>>(
      static_cast<const bf16*>(dense), static_cast<const float*>(planes),
      static_cast<const unsigned char*>(mask), static_cast<const float*>(w),
      static_cast<const bf16*>(wb), static_cast<const float*>(g), static_cast<const int*>(amax),
      static_cast<float*>(partial), static_cast<double*>(partial_v), centroids, cd, cp, c1, c2,
      c3, c_out, act);
  e = cudaGetLastError();
  if (e == cudaSuccess) {
    grid[0] = blocks;
    grid[1] = blocks * groups;
  }
  return e;
}

}  // namespace

// B1 in bf16 over B*M = centroids centroids, the arguments of dlbt_fused_sa_b1
// (csrc/fused_sa_bwd.cu, which checks the shared ones and adds the slices) but w, here
// the per-column vectors (7 (C1 + C2) f32: b, sc, sh, mean, inv, ta, tb of layer 1,
// then of layer 2; the t-terms unread), and wb, the bf16 weight block (W1^T, W2^T, W3
// as fused_sa_mma.cuh lays them out); mask, w and wb 16-byte aligned; kp and d_dense
// unread. Writes the dW3 slices (C2 x C3 f32) into partial, grid[0] of them, and the
// db3, sdb2, sdb2x slices (C3 + 2 C2 f64) into partial_v, grid[1] of them (grid in
// host memory). C1 64 or 128, C2 at most 128, C2 and C3 multiples of 64.
extern "C" int dlbt_fused_sa_b1_mma(const void* dense, const void* planes, const void* mask,
                                    const void* w, const void* wb, const void* g,
                                    const void* amax, void* partial, void* partial_v,
                                    void* d_dense, int centroids, int cd, int cp, int kp, int c1,
                                    int c2, int c3, int c_out, int act, int max_grid,
                                    void* stream, int* grid) {
  (void)d_dense;
  (void)kp;
  grid[0] = grid[1] = 0;
  const int dw_tiles = (group_width(c3) / 16) * (c2 / 16);
  if ((c1 != 64 && c1 != 128) || c2 % 64 || c3 % 64 || dw_tiles > kWarps * kMaxDwTiles ||
      group_width(c3) + 2 * c2 > kOwned * kThreads || wb == nullptr ||
      reinterpret_cast<uintptr_t>(wb) % 16 || reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(mask) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool few = dw_tiles <= kWarps * 4;
  cudaError_t e;
  if (c1 == 64) {
    e = few ? launch<4, 4>(dense, planes, mask, w, wb, g, amax, partial, partial_v, centroids,
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
