// Kernel 6-B3 in bf16, on the tensor cores: the last recomputing pass of the
// fused SA-layer MLP's backward (csrc/fused_sa_bwd.cu holds all three passes
// and runs this one in f32). Per edge row it recomputes h1, a1 and h2, routes
// the pooled output's cotangent g to F3's argmax slots (gs: g[c] at row
// amax[c] of column c), and forms
//   da2 = gs W3^T, dh2 = sc2 (da2 act'(z2) mask - t2a - xhat2 t2b) mask,
//   da1 = dh2 W2^T, dh1 = sc1 (da1 act'(z1) mask - t1a - xhat1 t1b) mask,
//   dW1 = [dense..., planes...]^T dh1, db1 = sum(dh1), d(dense) = dh1 W1d^T,
// d(dense) 0 on every row of a centroid with no valid slot.
//
// Replaces: dl_biomass_tpu/ops/pallas_sa_train.py fused_sa_mlp, its backward's last
// pass (_b3_kernel), in bf16.
// Semantics: those of fused_sa_bwd_stage_plain(3, ..., bf16=True). Every product
// takes bf16 operands (the weights, the edge rows with the planes rounded, a1, gs,
// dh2, dh1) with f32 sums; h1 is the dense rows' product plus the planes', then b1;
// the hidden values, the BatchNorm terms and the derivatives stay f32.
//
// Bound on the H100: operations. Per valid edge row 2 (KP C1 + C1 C2) flop of
// recompute, 2 C1 C2 for da1, 2 KP C1 for dW1 and 2 CD C1 for d(dense), and 2 C2 C3
// per centroid for the routed da2, at the bf16 tensor cores' 989 TFLOP/s: 0.088 ms
// at SA2 of a 16 x 10240 training step. The bytes are fewer: SA2's bf16 dense block
// read once (134 MB) and d(dense) written once (as much), 0.08 ms. This kernel takes
// da2 as a dense product over the 64 slots, 64 times the routed work (4.2 MFLOP a
// centroid at SA2), which the tensor cores absorb.
//
// Design: kernels 5's and 7's, with the pieces B1 and B2 share in
// csrc/fused_sa_mma.cuh. A persistent block of 8 warps walks centroids with a grid
// stride. It copies the bf16 weights into shared memory once, with cp.async,
// as the wrapper packs them: W1^T (C1 x KX, the dense rows' columns at 0, the planes'
// at CD rounded up to 16), W2^T (C2 x C1) and W3 (C2 x C3), each row kSkewH values
// longer (mma_bf16.cuh), and the per-column vectors in f32. A centroid's inputs
// (its bf16 dense rows, straight into the edge rows' columns, its mask, f32
// cotangent, argmax and f32 planes) arrive by cp.async in one of two buffers while
// the block works on the other centroid. Warp w takes the 16 slots of row tile w % 4
// and half w / 4 of the columns of every row-wise product, all on mma.sync m16n8k16
// with f32 accumulators and fragments loaded by ldmatrix: h1 stays in the warp's
// accumulators from its product to dh1; layer 2 runs 32 columns at a time, h2 and
// da2 side by side, so that dh2 is formed in registers and enters shared memory
// once, rounded to bf16. gs never exists: each lane builds its A fragments of da2
// from the centroid's cotangent in bf16 and argmax in 16 bits (a column's value where
// its argmax is the fragment's row, else 0: one pair compare per register). W2^T
// serves both h2 = a1 W2 and da1 = dh2 W2^T (fragments by ldmatrix.trans), W1^T both
// h1 and d(dense). dW1 (KX x C1) is contracted over the 64 slots on the tensor cores
// (ldmatrix.trans of the edge rows and of dh1) into 16 x 16 tiles that stay in each
// warp's registers for all its block's centroids (9 tiles, 72 floats a thread, at
// SA2). Shared memory holds no f32
// row buffer: the weights (138 KiB at SA2), two input buffers (44 KiB), the bf16 a1
// (then dh1) and dh2 rows (34 KiB) and the vectors, 226.6 of the 227 KiB a block may
// have, one block per SM (SA1: 63 KiB, two blocks by registers). No float atomics: db1
// adds the 4 row tiles' f32 column sums in f64 in their order, each block writes its
// dW1 and db1 slices, and the entry's second launch (csrc/fused_sa_bwd.cu,
// reduce_blocks) adds the slices in block order in f64, so two launches agree bit for
// bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "fused_sa_mma.cuh"

namespace {

using namespace fused_sa_mma;

constexpr int kMaxDwTiles = 9;  // dW1's 16 x 16 tiles a warp holds at most

// Byte offsets of one block's shared memory: the bf16 weights (W1^T, W2^T, W3: the
// wrapper's packing), the per-column vectors of layer 1 and of layer 2 (Vec order),
// two buffers of a centroid's inputs (Inputs: one filled by cp.async while the other
// is used), the bf16 cotangent and 16-bit argmax, the a1 (then dh1) and dh2 rows, the
// row tiles' column sums of dh1 and the block's f64 db1.
struct Layout {
  Inputs in;
  size_t w3, vec, buf, gb, am16, a1, dh2, red, db1, total;
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
    red = take(at, 4ull * kRowTiles * c1);
    db1 = take(at, 8ull * c1);
    total = at;
  }
};

// kT1: layer 1's n-tiles per warp (C1 / 16); kDw: dW1's 16 x 16 tiles per warp. w holds
// the per-column vectors (Vec order, layer 1's then layer 2's), wb the bf16 weights.
template <int kT1, int kDw>
__global__ void __launch_bounds__(kThreads, kT1 == 4 && kDw == 1 ? 2 : 1)
    fused_sa_b3_kernel(const bf16* __restrict__ dense, const float* __restrict__ planes,
                       const unsigned char* __restrict__ mask, const float* __restrict__ w,
                       const bf16* __restrict__ wb, const float* __restrict__ gout,
                       const int* __restrict__ amax, float* __restrict__ partial,
                       double* __restrict__ partial_v, bf16* __restrict__ d_dense,
                       long long total, int cd, int cp, int kp, int c1, int c2, int c3,
                       int c_out, int act) {
  extern __shared__ __align__(16) char smem[];
  const int cd16 = round16(cd), kx = cd16 + round16(cp);
  const Layout L(kx, cp, c1, c2, c3);
  const bf16* const w1t = reinterpret_cast<const bf16*>(smem);
  const bf16* const w2t = reinterpret_cast<const bf16*>(smem + w1t_bytes(kx, c1));
  const bf16* const w3 = reinterpret_cast<const bf16*>(smem + L.w3);
  const float* const vec = reinterpret_cast<const float*>(smem + L.vec);
  bf16* const gb = reinterpret_cast<bf16*>(smem + L.gb);
  unsigned short* const am16 = reinterpret_cast<unsigned short*>(smem + L.am16);
  bf16* const a1 = reinterpret_cast<bf16*>(smem + L.a1);
  bf16* const dh1 = a1;  // a1's rows die with the last h2 product
  bf16* const dh2 = reinterpret_cast<bf16*>(smem + L.dh2);
  float* const red = reinterpret_cast<float*>(smem + L.red);
  double* const db1 = reinterpret_cast<double*>(smem + L.db1);
  const float* const v1 = vec;
  const float* const v2 = vec + kVecs * c1;
  const int ldx = kx + kSkewH, ld1 = c1 + kSkewH, ld2 = c2 + kSkewH, ld3 = c3 + kSkewH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int tile = warp % kRowTiles, r0 = 16 * tile, half = warp / kRowTiles;
  const int n1 = half * 8 * kT1;  // the warp's first column of layer 1
  const bool dense_vec = cd % 8 == 0 && reinterpret_cast<uintptr_t>(dense) % 16 == 0;

  // the weights and the vectors, once per block
  copy_async(smem, wb, L.vec);
  copy_async(smem + L.vec, w, vec_bytes(c1, c2));
  for (int i = tid; i < c1; i += kThreads) db1[i] = 0.0;

  const auto prefetch = [&](long long ci, int b) {
    prefetch_inputs(smem + L.buf + b * L.in.stride, L.in, ci, dense, planes, mask, gout, amax,
                    cd, cp, ldx, c_out, dense_vec);
  };
  if (blockIdx.x < total) prefetch(blockIdx.x, 0);
  dlbt::cp_async_commit();

  const int dw_tiles = (kx / 16) * (c1 / 16), pairs = c1 / 16;
  float dw[kDw][2][4];
#pragma unroll
  for (int s = 0; s < kDw; ++s) dlbt::zero_acc(dw[s]);

  int b = 0;
  for (long long ci = blockIdx.x; ci < total; ci += gridDim.x, b ^= 1) {
    if (ci + gridDim.x < total) prefetch(ci + gridDim.x, b ^ 1);
    dlbt::cp_async_commit();
    dlbt::cp_async_wait<1>();  // this centroid's copies (and the weights) have landed
    __syncthreads();           // ... for every thread
    const long long row0 = ci * kSlots;
    char* const in = smem + L.buf + b * L.in.stride;
    const unsigned char* const mk = reinterpret_cast<const unsigned char*>(in + L.in.mask);
    if (!__syncthreads_or(tid < kSlots && mk[tid] != 0)) {
      // no valid slot: no gradient, and rows of 0 in d(dense)
      for (int i = tid; i < kSlots * cd; i += kThreads) {
        d_dense[row0 * cd + i] = __float2bfloat16_rn(0.0f);
      }
      continue;
    }
    bf16* const x = reinterpret_cast<bf16*>(in + L.in.x);
    stage_inputs(in, L.in, gb, am16, 0, c3, c_out, dense, row0, cd, cp, kx, ldx, dense_vec);
    __syncthreads();

    // h1, kept to the end; a1 rows
    float h1[kT1][4];
    layer1<kT1>(x, ldx, w1t, cd16, kx, cp, v1, c1, act, a1, ld1, r0, n1, h1);
    __syncthreads();

    // layer 2, 32 columns at a time: h2 and da2, then dh2 in bf16
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
           });
    __syncthreads();

    // layer 1: da1 = dh2 W2^T on h1's columns, dh1 in bf16, its column sums
    {
      float d1[kT1][4];
      dlbt::zero_acc(d1);
      dlbt::warp_mma_tb<kT1 / 2>(dh2, ld2, w2t, ld1, c2, r0, n1, d1);
#pragma unroll
      for (int nt = 0; nt < kT1; ++nt) {
        const int col = n1 + 8 * nt + 2 * t;
        float db[4], xh[4];
        bn_backward(h1[nt], d1[nt], v1, c1, col, act, m_lo, m_hi, db, xh);
        bn_dh(db, xh, v1, c1, col, m_lo, m_hi, d1[nt]);
        put2(dh1, ld1, r0 + g, col, d1[nt][0], d1[nt][1]);
        put2(dh1, ld1, r0 + g + 8, col, d1[nt][2], d1[nt][3]);
#pragma unroll
        for (int p = 0; p < 2; ++p) {  // the tile's column sums
          const float s = tile_colsum(d1[nt][p], d1[nt][p + 2]);
          if (g == 0) red[tile * c1 + col + p] = s;
        }
      }
    }
    __syncthreads();

    // db1 (thread c alone adds column c), dW1 += x^T dh1, d(dense) = dh1 W1d^T
    for (int c = tid; c < c1; c += kThreads) {
      double s = 0.0;
#pragma unroll
      for (int q = 0; q < kRowTiles; ++q) s += red[q * c1 + c];
      db1[c] += s;
    }
#pragma unroll
    for (int s = 0; s < kDw; ++s) {
      const int tau = s * kWarps + warp;
      if (tau < dw_tiles) {
        dlbt::warp_mma_tn<1>(x, ldx, dh1, ld1, kSlots, (tau / pairs) * 16, (tau % pairs) * 16,
                             dw[s]);
      }
    }
    for (int n0 = half * 8 * kSub; n0 < cd16; n0 += 2 * 8 * kSub) {
      float dd[kSub][4];
      dlbt::zero_acc(dd);
      const int live = (cd16 - n0) / 16 < kSub / 2 ? (cd16 - n0) / 16 : kSub / 2;
      dlbt::warp_mma_tb<kSub / 2>(dh1, ld1, w1t, ldx, c1, r0, n0, dd, live);
#pragma unroll
      for (int nt = 0; nt < kSub; ++nt) {
        const int col = n0 + 8 * nt + 2 * t;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          bf16* o = d_dense + (row0 + r0 + g + 8 * hr) * cd;
          if (col + 1 < cd && cd % 2 == 0) {
            *reinterpret_cast<__nv_bfloat162*>(o + col) =
                __floats2bfloat162_rn(dd[nt][2 * hr], dd[nt][2 * hr + 1]);
          } else {
            if (col < cd) o[col] = __float2bfloat16_rn(dd[nt][2 * hr]);
            if (col + 1 < cd) o[col + 1] = __float2bfloat16_rn(dd[nt][2 * hr + 1]);
          }
        }
      }
    }
    __syncthreads();  // the buffer, the rows and the column sums are consumed
  }
  dlbt::cp_async_wait<0>();
  // this block's slices: dW1 rows [dense..., planes..., zero padding to KP], db1
  float* const part = partial + static_cast<size_t>(blockIdx.x) * kp * c1;
  for (int i = (cd + cp) * c1 + tid; i < kp * c1; i += kThreads) part[i] = 0.0f;
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
        const int row = j < cd ? j : j >= cd16 && j < cd16 + cp ? cd + (j - cd16) : -1;
        if (row >= 0) part[static_cast<size_t>(row) * c1 + col] = dw[s][nt][e];
      }
    }
  }
  for (int c = tid; c < c1; c += kThreads) {
    partial_v[static_cast<size_t>(blockIdx.x) * c1 + c] = db1[c];
  }
}

template <int kT1, int kDw>
cudaError_t launch(const void* dense, const void* planes, const void* mask, const void* w,
                   const void* wb, const void* g, const void* amax, void* partial,
                   void* partial_v, void* d_dense, int centroids, int cd, int cp, int kp, int c1,
                   int c2, int c3, int c_out, int act, int max_grid, cudaStream_t stream,
                   int* grid) {
  const auto kernel = fused_sa_b3_kernel<kT1, kDw>;
  const size_t smem = Layout(round16(cd) + round16(cp), cp, c1, c2, c3).total;
  int blocks = 0;
  cudaError_t e = persistent_grid(kernel, smem, centroids, max_grid, 1, &blocks);
  if (e != cudaSuccess) return e;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const bf16*>(dense), static_cast<const float*>(planes),
      static_cast<const unsigned char*>(mask), static_cast<const float*>(w),
      static_cast<const bf16*>(wb), static_cast<const float*>(g), static_cast<const int*>(amax),
      static_cast<float*>(partial), static_cast<double*>(partial_v), static_cast<bf16*>(d_dense),
      centroids, cd, cp, kp, c1, c2, c3, c_out, act);
  e = cudaGetLastError();
  if (e == cudaSuccess) grid[0] = grid[1] = blocks;
  return e;
}

}  // namespace

// B3 in bf16 over B*M = centroids centroids, the arguments of dlbt_fused_sa_b3
// (csrc/fused_sa_bwd.cu, which checks the shared ones and adds the slices) but w, here
// the per-column vectors (7 (C1 + C2) f32: b, sc, sh, mean, inv, ta, tb of layer 1,
// then of layer 2), and wb, the bf16 weight block (W1^T, W2^T, W3 as fused_sa_mma.cuh
// lays them out); mask, w and wb 16-byte aligned.
// Writes each block's dW1 slice (KP x C1 f32) into partial and its db1 slice (C1 f64)
// into partial_v, and d_dense (B, M, 64, CD) bf16 where CD > 0; grid (host memory)
// gets the number of slices of each, grid[0] and grid[1]. C1 64 or 128, C2 and C3
// multiples of 64, and at most 8 x kMaxDwTiles of dW1's 16 x 16 tiles.
extern "C" int dlbt_fused_sa_b3_mma(const void* dense, const void* planes, const void* mask,
                                    const void* w, const void* wb, const void* g,
                                    const void* amax, void* partial, void* partial_v,
                                    void* d_dense, int centroids, int cd, int cp, int kp, int c1,
                                    int c2, int c3, int c_out, int act, int max_grid,
                                    void* stream, int* grid) {
  grid[0] = grid[1] = 0;
  const int dw_tiles = (round16(cd) + round16(cp)) / 16 * (c1 / 16);
  if ((c1 != 64 && c1 != 128) || c2 % 64 || c3 % 64 || dw_tiles > kWarps * kMaxDwTiles ||
      wb == nullptr || reinterpret_cast<uintptr_t>(wb) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 || reinterpret_cast<uintptr_t>(mask) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool few = dw_tiles <= kWarps;
  cudaError_t e;
  if (c1 == 64) {
    e = few ? launch<4, 1>(dense, planes, mask, w, wb, g, amax, partial, partial_v, d_dense,
                           centroids, cd, cp, kp, c1, c2, c3, c_out, act, max_grid, s, grid)
            : launch<4, kMaxDwTiles>(dense, planes, mask, w, wb, g, amax, partial, partial_v,
                                     d_dense, centroids, cd, cp, kp, c1, c2, c3, c_out, act,
                                     max_grid, s, grid);
  } else {
    e = few ? launch<8, 1>(dense, planes, mask, w, wb, g, amax, partial, partial_v, d_dense,
                           centroids, cd, cp, kp, c1, c2, c3, c_out, act, max_grid, s, grid)
            : launch<8, kMaxDwTiles>(dense, planes, mask, w, wb, g, amax, partial, partial_v,
                                     d_dense, centroids, cd, cp, kp, c1, c2, c3, c_out, act,
                                     max_grid, s, grid);
  }
  return static_cast<int>(e);
}
