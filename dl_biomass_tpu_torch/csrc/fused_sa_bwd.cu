// Kernel 6's backward: the three recomputing passes B1, B2, B3 of the fused
// SA-layer MLP (Linear -> BatchNorm -> act, twice, then Linear and the masked
// max over the 64 neighbour slots). No (B, M, 64, C) hidden tensor reaches
// device memory; d(dense) is the one per-edge output.
//
// Replaces: dl_biomass_tpu/ops/pallas_sa_train.py fused_sa_mlp, its backward (_b1_kernel,
// _b2_kernel, _b3_kernel).
// Semantics: each pass recomputes h1, a1, h2 (and a2) of every edge row exactly as
// csrc/fused_sa_fwd.cu does, routes the cotangent g of the pooled output to F3's argmax
// slot (gs: g[c] at row amax[c] of column c, nothing where amax is -1), then
//   B1: dW3 = a2^T gs, db3 = sum(gs); da2 = gs W3^T; db2n = da2 act'(z2) mask;
//       sdb2 = sum(db2n), sdb2x = sum(db2n xhat2), xhat2 = (h2 - mean2) inv2;
//   B2: dh2 = sc2 (db2n - t2a - xhat2 t2b) mask; dW2 = a1^T dh2, db2 = sum(dh2);
//       da1 = dh2 W2^T; db1n, sdb1, sdb1x as in B1 for layer 1;
//   B3: dh1 as dh2 for layer 1; dW1 = x^T dh1 over the [dense..., planes...] rows,
//       db1 = sum(dh1); d(dense) = dh1 W1d^T per edge row (0 for every row of a
//       centroid with no valid slot).
// The sums run over every centroid of the batch. In bf16 mode each product takes bf16
// operands (a1, a2, gs, dh2, dh1, the rows and the weights) with f32 accumulation while
// the hidden values and the sums stay f32; in f32 mode plain f32 products. This file's
// kernel runs every f32 pass, and the bf16 passes at the widths their tensor-core
// kernels (csrc/fused_sa_b1.cu, csrc/fused_sa_b2.cu, csrc/fused_sa_b3.cu, which the
// same entries launch) do not take, such as SA2 at neuron_multiplier 2 and both
// layers at 3: the wrapper's routing rule (sa_train_kernel.mma_takes) decides from
// the widths and hands a weight block only to a pass it sends to the tensor cores.
//
// Bound on the H100: operations. Per edge row the recompute costs 2 (KP C1 + C1 C2)
// flop, B2 adds 4 C1 C2 (dW2, da1) and B3 4 C1 C2 + 4 KP C1 (da1, dW1, d(dense)); B1's
// routed products cost 2 C2 C3 per centroid, not per row, since gs has one nonzero per
// column, all as f32 FMAs on the CUDA cores (67 TFLOP/s). The inputs are read once
// per pass (SA2's f32 dense block: 268 MB at 16 x 10240), and B3 writes d(dense) (as
// much again).
//
// Design: the forward's walk (csrc/fused_sa_tile.cuh): a block of 128 threads takes one
// centroid at a time with a grid stride, loads its rows into shared memory and
// recomputes the layers as 64-column passes of 4 x 8 thread tiles. Per pass the block
// keeps two (B1) or four (B2, B3) 64-row buffers in shared memory, reused as the
// values die: B1 x -> h2 and a1 -> a2; B2 x -> h2, a1, h1, dh2; B3 x, a1 -> dh2, h1,
// h2 -> dh1 (B2, B3: 139 KiB at SA2, one block per SM, and 71 KiB at SA1, three; B1:
// 73 KiB at SA2, three, and 37 KiB at SA1, four by registers). Where the four buffers
// do not fit a block's 227 KiB (B2 and B3 from SA2 at neuron_multiplier 2: 276 KiB;
// 407 KiB at 3), the last of them live in the block's slice of a device scratch
// buffer instead (one block per SM: 132 slices of up to 194 KiB at
// neuron_multiplier 3, 25 MiB, which the 50 MB L2 can hold), in kernels of their own
// (kScratch) so that the others keep shared-memory addressing; the host picks the
// split from the widths (Layout::fit), and the arithmetic, and so each f32 result,
// is the same bit for bit wherever a buffer lies. gs is never formed:
// da2 adds, in ascending column order, g[c] W3^T[c] into row amax[c] only, and dW3
// adds a2[amax[c]] g[c] into column c, C2 C3 work per centroid. The contractions over
// the 64 rows (dW2, dW1) give each thread a 4 x 8 tile of (in, out) channels summed
// over the rows in ascending order. Weight gradients do not fit shared memory at SA2
// (dW3 alone is 128 KiB in f32), so each block owns a slice of an f32 buffer in device
// memory for them, and of an f64 buffer for the bias gradients and the sums (their
// terms cancel: SA1's db3 is 0 but for rounding), one element per owning thread,
// added to in centroid order; a second launch adds the slices in block order in
// f64. No float atomics: a backward repeats bit for bit on one card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "fused_sa_tile.cuh"

// csrc/fused_sa_b1.cu, _b2.cu, _b3.cu: the passes in bf16 on the tensor cores, each
// kernel alone (grid[0], grid[1]: the weight and the vector slices it wrote); wb is
// their bf16 weight block.
#define DLBT_MMA_PASS(name)                                                                 \
  extern "C" int name(const void* dense, const void* planes, const void* mask, const void* w, \
                      const void* wb, const void* g, const void* amax, void* partial,       \
                      void* partial_v, void* d_dense, int centroids, int cd, int cp, int kp, \
                      int c1, int c2, int c3, int c_out, int act, int max_grid, void* stream, \
                      int* grid);
DLBT_MMA_PASS(dlbt_fused_sa_b1_mma)
DLBT_MMA_PASS(dlbt_fused_sa_b2_mma)
DLBT_MMA_PASS(dlbt_fused_sa_b3_mma)
#undef DLBT_MMA_PASS

namespace {

using namespace fused_sa;

// Byte offsets of one block's shared memory: four 64-row buffers (see Design; the
// last two only for B2 and B3), the centroid's cotangent and argmax (C3), the
// per-warp column partials (2 x 4 warps x the wider hidden layer), the slot flags.
// Buffers from in_smem on lie instead at their offsets in the block's slice of the
// scratch buffer, slice bytes each.
struct Layout {
  size_t buf[4], g, am, red, valid, total, slice;
  int in_smem;
  __host__ __device__ Layout(int stage, int kp, int c1, int c2, int c3, int in_smem)
      : in_smem(in_smem) {
    size_t at = 0, sl = 0;
    const int wide = imax(c1, c2);
    const size_t bytes[4] = {4ull * kSlots * (imax(kp, c2) + kSkew),
                             4ull * kSlots * (wide + kSkew),
                             stage >= 2 ? 4ull * kSlots * (c1 + kSkew) : 0,
                             stage >= 2 ? 4ull * kSlots * (wide + kSkew) : 0};
    for (int i = 0; i < 4; ++i) buf[i] = i < in_smem ? take(at, bytes[i]) : take(sl, bytes[i]);
    g = take(at, 4ull * c3);
    am = take(at, 4ull * c3);
    red = take(at, 4ull * 2 * kWarps * wide);
    valid = take(at, 4ull * kSlots);
    total = at;
    slice = sl;
  }

  // The layout that keeps the most buffers, in order, within max_smem bytes.
  static Layout fit(int stage, int kp, int c1, int c2, int c3, size_t max_smem) {
    for (int n = 4; n > 0; --n) {
      const Layout l(stage, kp, c1, c2, c3, n);
      if (l.total <= max_smem) return l;
    }
    return Layout(stage, kp, c1, c2, c3, 0);
  }
};

// The thread's tile of gs @ W3^T (da2; columns of C2), where gs holds g[c] at row
// am[c] of column c alone (rounded to bf16 when kBf16): the terms of each element in
// ascending c.
template <bool kBf16>
__device__ __forceinline__ void routed_dot(const float* g, const int* am, int c3,
                                           const float* __restrict__ w3t, int c2, int col0,
                                           int rg, int cg, float (&acc)[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  for (int c = 0; c < c3; ++c) {
    const int d = am[c] - rg;  // the thread's rows are rg + 16 i
    if (d < 0 || (d & 15)) continue;
    const float gv = kBf16 ? round_bf16(g[c]) : g[c];
    const float* wr = w3t + static_cast<size_t>(c) * c2 + col0 + cg * 4;
    const float4 lo = __ldg(reinterpret_cast<const float4*>(wr));
    const float4 hi = __ldg(reinterpret_cast<const float4*>(wr + 32));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (d >> 4 != i) continue;
      acc[i][0] = fmaf(gv, lo.x, acc[i][0]);
      acc[i][1] = fmaf(gv, lo.y, acc[i][1]);
      acc[i][2] = fmaf(gv, lo.z, acc[i][2]);
      acc[i][3] = fmaf(gv, lo.w, acc[i][3]);
      acc[i][4] = fmaf(gv, hi.x, acc[i][4]);
      acc[i][5] = fmaf(gv, hi.y, acc[i][5]);
      acc[i][6] = fmaf(gv, hi.z, acc[i][6]);
      acc[i][7] = fmaf(gv, hi.w, acc[i][7]);
    }
  }
}

// The warp's column sums of a (and of b when kTwo) over its rows:
// red[warp * cw + col] (and red[(kWarps + warp) * cw + col]).
template <bool kTwo>
__device__ __forceinline__ void tile_colsums(const float (&a)[4][8], const float (&b)[4][8],
                                             int col0, int cg, int lane, int warp, float* red,
                                             int cw) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float s = 0.0f, t = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s += a[i][j];
      if (kTwo) t += b[i][j];
    }
    // the warp's 4 row groups differ in lane bits 3 and 4
    s += __shfl_xor_sync(0xffffffffu, s, 8);
    s += __shfl_xor_sync(0xffffffffu, s, 16);
    if (kTwo) {
      t += __shfl_xor_sync(0xffffffffu, t, 8);
      t += __shfl_xor_sync(0xffffffffu, t, 16);
    }
    if (lane < 8) {
      red[warp * cw + tile_col(col0, cg, j)] = s;
      if (kTwo) red[(kWarps + warp) * cw + tile_col(col0, cg, j)] = t;
    }
  }
}

// out[col] += the 4 warps' partials red[q * cw + col] in warp order, for n of them
// (n = 1 or 2 arrays of cw columns, the second at out + cw).
__device__ __forceinline__ void flush_colsums(const float* red, int cw, int n, double* out) {
  for (int i = threadIdx.x; i < n * cw; i += kThreads) {
    const int which = i / cw, col = i - which * cw;
    double s = 0.0;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) s += red[(which * kWarps + q) * cw + col];
    out[i] += s;
  }
}

// out (a_dim x out_cols, device memory, this block's slice) += x^T y over the 64 rows, for
// every 64 x 64 tile of (in, out) channels: thread (rg, cg) holds in-channels a0 + rg*4 +
// {0..3} and out-channels tile_col(b0, cg, j), summed over the rows in ascending order.
// x (64 x a_dim, a_dim a multiple of 4) and y (64 x b_dim) are in shared memory.
__device__ __forceinline__ void edge_dot_add(const float* x, int x_stride, int a_dim,
                                             const float* y, int y_stride, int b_dim, int rg,
                                             int cg, float* __restrict__ out) {
  for (int a0 = 0; a0 < a_dim; a0 += 64) {
    const int a = a0 + rg * 4;
    if (a >= a_dim) continue;
    for (int b0 = 0; b0 < b_dim; b0 += 64) {
      float acc[4][8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[q][j] = 0.0f;
      }
      for (int r = 0; r < kSlots; ++r) {
        const float4 xv = *reinterpret_cast<const float4*>(x + r * x_stride + a);
        const float* yr = y + r * y_stride + b0 + cg * 4;
        const float4 lo = *reinterpret_cast<const float4*>(yr);
        const float4 hi = *reinterpret_cast<const float4*>(yr + 32);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float xq = lane_of(xv, q);
          acc[q][0] = fmaf(xq, lo.x, acc[q][0]);
          acc[q][1] = fmaf(xq, lo.y, acc[q][1]);
          acc[q][2] = fmaf(xq, lo.z, acc[q][2]);
          acc[q][3] = fmaf(xq, lo.w, acc[q][3]);
          acc[q][4] = fmaf(xq, hi.x, acc[q][4]);
          acc[q][5] = fmaf(xq, hi.y, acc[q][5]);
          acc[q][6] = fmaf(xq, hi.z, acc[q][6]);
          acc[q][7] = fmaf(xq, hi.w, acc[q][7]);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float* o = out + static_cast<size_t>(a + q) * b_dim + b0 + cg * 4;
        float4 lo = *reinterpret_cast<float4*>(o);
        float4 hi = *reinterpret_cast<float4*>(o + 32);
        lo.x += acc[q][0];
        lo.y += acc[q][1];
        lo.z += acc[q][2];
        lo.w += acc[q][3];
        hi.x += acc[q][4];
        hi.y += acc[q][5];
        hi.z += acc[q][6];
        hi.w += acc[q][7];
        *reinterpret_cast<float4*>(o) = lo;
        *reinterpret_cast<float4*>(o + 32) = hi;
      }
    }
  }
}

// The elements of one pass's output vector, the weight gradient first: B1 dW3
// (C2 x C3), then db3 (C3), sdb2, sdb2x (C2); B2 dW2 (C1 x C2), then db2 (C2), sdb1,
// sdb1x (C1); B3 dW1 (KP x C1), then db1 (C1).
__host__ __device__ __forceinline__ int weight_size(int stage, int kp, int c1, int c2, int c3) {
  return stage == 1 ? c2 * c3 : stage == 2 ? c1 * c2 : kp * c1;
}

__host__ __device__ __forceinline__ int vector_size(int stage, int c1, int c2, int c3) {
  return stage == 1 ? c3 + 2 * c2 : stage == 2 ? c2 + 2 * c1 : c1;
}

// kStage 1: B1, 2: B2, 3: B3. w packs, each part zero-padded: the forward's block (w1
// (KP, C1), b1, sc1, sh1 (C1), w2 (C1, C2), b2, sc2, sh2 (C2), w3 (C2, C3), b3 (C3)),
// then mean1, inv1 (C1), mean2, inv2 (C2), t2a, t2b (C2), t1a, t1b (C1), w3^T (C3, C2),
// w2^T (C2, C1) and w1's dense rows transposed (C1, CDP). kScratch: the layout puts
// buffers in_smem.. in scratch, one slice per block (a template flag, so that every
// buffer of the other instantiations is a shared-memory address the compiler sees).
template <int kStage, bool kBf16, bool kScratch>
__global__ void __launch_bounds__(kThreads)
fused_sa_bwd_kernel(const void* __restrict__ dense, const float* __restrict__ planes,
                    const unsigned char* __restrict__ mask, const float* __restrict__ w,
                    const float* __restrict__ gout, const int* __restrict__ amax,
                    float* __restrict__ partial, double* __restrict__ partial_v,
                    void* __restrict__ d_dense, char* __restrict__ scratch, long long total,
                    int cd, int cp, int kp, int cdp, int c1, int c2, int c3, int c_out,
                    int act, int in_smem) {
  extern __shared__ float4 smem4[];
  char* const smem = reinterpret_cast<char*>(smem4);
  const Layout L(kStage, kp, c1, c2, c3, kScratch ? in_smem : 4);
  char* const slice = scratch + static_cast<size_t>(blockIdx.x) * L.slice;
  const auto buffer = [&](int i) {
    return reinterpret_cast<float*>((kScratch && i >= L.in_smem ? slice : smem) + L.buf[i]);
  };
  float* const buf0 = buffer(0);
  float* const buf1 = buffer(1);
  float* const buf2 = buffer(2);
  float* const buf3 = buffer(3);
  float* const gs = reinterpret_cast<float*>(smem + L.g);
  int* const am = reinterpret_cast<int*>(smem + L.am);
  float* const red = reinterpret_cast<float*>(smem + L.red);
  int* const valid = reinterpret_cast<int*>(smem + L.valid);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = lane & 7, rg = warp * 4 + (lane >> 3);
  const int ldx = kp + kSkew, ld1 = c1 + kSkew, ld2 = c2 + kSkew;

  const float* const w1 = w;
  const float* const b1 = w1 + static_cast<size_t>(kp) * c1;
  const float* const sc1 = b1 + c1;
  const float* const sh1 = sc1 + c1;
  const float* const w2 = sh1 + c1;
  const float* const b2 = w2 + static_cast<size_t>(c1) * c2;
  const float* const sc2 = b2 + c2;
  const float* const sh2 = sc2 + c2;
  const float* const b3_end = sh2 + c2 + static_cast<size_t>(c2) * c3 + c3;  // after w3, b3
  const float* const mean1 = b3_end;
  const float* const inv1 = mean1 + c1;
  const float* const mean2 = inv1 + c1;
  const float* const inv2 = mean2 + c2;
  const float* const t2a = inv2 + c2;
  const float* const t2b = t2a + c2;
  const float* const t1a = t2b + c2;
  const float* const t1b = t1a + c1;
  const float* const w3t = t1b + c1;
  const float* const w2t = w3t + static_cast<size_t>(c3) * c2;
  const float* const w1dt = w2t + static_cast<size_t>(c2) * c1;

  // this block's slices of the output vector, zeroed before any thread adds to them
  const int n_w = weight_size(kStage, kp, c1, c2, c3), n_v = vector_size(kStage, c1, c2, c3);
  float* const part = partial + static_cast<size_t>(blockIdx.x) * n_w;
  double* const part_v = partial_v + static_cast<size_t>(blockIdx.x) * n_v;
  for (int i = tid; i < n_w; i += kThreads) part[i] = 0.0f;
  for (int i = tid; i < n_v; i += kThreads) part_v[i] = 0.0;
  __syncthreads();

  // buffers by pass (see Design)
  float* const x = buf0;
  float* const a1 = buf1;
  float* const h1 = buf2;
  float* const h2 = kStage == 3 ? buf3 : buf0;
  float* const a2 = buf1;                          // B1
  float* const dh2 = kStage == 3 ? buf1 : buf3;    // B2, B3
  float* const dh1 = buf3;                         // B3

  for (long long ci = blockIdx.x; ci < total; ci += gridDim.x) {
    const long long row0 = ci * kSlots;
    int ok = 0;
    if (tid < kSlots) {
      ok = mask[row0 + tid] != 0;
      valid[tid] = ok;
    }
    if (!__syncthreads_or(ok)) {  // no valid slot: no gradient, and rows of 0 in d(dense)
      if (kStage == 3) {
        for (int i = tid; i < kSlots * cd; i += kThreads) {
          if (kBf16) {
            static_cast<__nv_bfloat16*>(d_dense)[row0 * cd + i] = __float2bfloat16_rn(0.0f);
          } else {
            static_cast<float*>(d_dense)[row0 * cd + i] = 0.0f;
          }
        }
      }
      continue;
    }
    for (int c = tid; c < c3; c += kThreads) {
      const bool real = c < c_out;
      gs[c] = real ? gout[ci * c_out + c] : 0.0f;
      am[c] = real ? amax[ci * c_out + c] : -1;
    }
    load_rows<kBf16>(dense, planes, row0, cd, cp, kp, x);
    __syncthreads();

    // recompute: h1 (B2, B3) and a1, then h2
    float h[4][8], d[4][8], e[4][8];
    for (int col0 = 0; col0 < c1; col0 += 64) {
      tile_layer(x, ldx, kp, w1, b1, c1, col0, rg, cg, h);
      if (kStage >= 2) store_tile<false>(h, col0, rg, cg, h1, ld1);
      store_act<kBf16>(h, sc1, sh1, act, col0, rg, cg, a1, ld1);
    }
    __syncthreads();
    for (int col0 = 0; col0 < c2; col0 += 64) {  // B1, B2: h2 takes the rows' place
      tile_layer(a1, ld1, c1, w2, b2, c2, col0, rg, cg, h);
      store_tile<false>(h, col0, rg, cg, h2, ld2);
    }
    __syncthreads();

    if (kStage == 1) {  // a2 takes a1's place; then dW3 and db3 at the argmax rows
      for (int i = tid; i < kSlots * c2; i += kThreads) {
        const int r = i / c2, k = i - r * c2;
        const float v = activate(h2[r * ld2 + k] * sc2[k] + sh2[k], act);
        a2[r * ld2 + k] = kBf16 ? round_bf16(v) : v;
      }
      __syncthreads();
      for (int i = tid; i < c2 * c3; i += kThreads) {
        const int k = i / c3, c = i - k * c3;
        const int r = am[c];
        if (r >= 0) part[i] += a2[r * ld2 + k] * (kBf16 ? round_bf16(gs[c]) : gs[c]);
      }
      for (int c = tid; c < c3; c += kThreads) {
        if (am[c] >= 0) part_v[c] += gs[c];
      }
    }

    // layer 2's backward: db2n and xhat2 (B1: their sums), dh2 (B2, B3)
    for (int col0 = 0; col0 < c2; col0 += 64) {
      routed_dot<kBf16>(gs, am, c3, w3t, c2, col0, rg, cg, d);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = tile_col(col0, cg, j);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = rg + 16 * i;
          const float hv = h2[r * ld2 + k];
          const float m = valid[r] ? 1.0f : 0.0f;
          const float db = d[i][j] * activate_deriv(hv * sc2[k] + sh2[k], act) * m;
          const float xh = (hv - mean2[k]) * inv2[k];
          if (kStage == 1) {
            d[i][j] = db;
            e[i][j] = db * xh;
          } else {
            d[i][j] = sc2[k] * (db - t2a[k] - xh * t2b[k]) * m;
          }
        }
      }
      if (kStage == 1) {
        tile_colsums<true>(d, e, col0, cg, lane, warp, red, c2);
      } else {
        if (kStage == 2) tile_colsums<false>(d, e, col0, cg, lane, warp, red, c2);
        store_tile<kBf16>(d, col0, rg, cg, dh2, ld2);
      }
    }
    __syncthreads();
    if (kStage == 1) {
      flush_colsums(red, c2, 2, part_v + c3);
      __syncthreads();
      continue;
    }
    if (kStage == 2) {
      flush_colsums(red, c2, 1, part_v);
      __syncthreads();
      edge_dot_add(a1, ld1, c1, dh2, ld2, c2, rg, cg, part);  // dW2
    }

    // layer 1's backward: db1n and xhat1 (B2: their sums), dh1 (B3)
    for (int col0 = 0; col0 < c1; col0 += 64) {
      tile_dot(dh2, ld2, c2, w2t, c1, col0, rg, cg, d);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = tile_col(col0, cg, j);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = rg + 16 * i;
          const float hv = h1[r * ld1 + k];
          const float m = valid[r] ? 1.0f : 0.0f;
          const float db = d[i][j] * activate_deriv(hv * sc1[k] + sh1[k], act) * m;
          const float xh = (hv - mean1[k]) * inv1[k];
          if (kStage == 2) {
            d[i][j] = db;
            e[i][j] = db * xh;
          } else {
            d[i][j] = sc1[k] * (db - t1a[k] - xh * t1b[k]) * m;
          }
        }
      }
      tile_colsums<kStage == 2>(d, e, col0, cg, lane, warp, red, c1);
      if (kStage == 3) store_tile<kBf16>(d, col0, rg, cg, dh1, ld1);
    }
    __syncthreads();
    if (kStage == 2) {
      flush_colsums(red, c1, 2, part_v + c2);
      __syncthreads();
      continue;
    }

    // B3: db1, dW1 = x^T dh1, d(dense) = dh1 W1d^T
    flush_colsums(red, c1, 1, part_v);
    edge_dot_add(x, ldx, kp, dh1, ld1, c1, rg, cg, part);
    for (int col0 = 0; col0 < cdp; col0 += 64) {
      tile_dot(dh1, ld1, c1, w1dt, cdp, col0, rg, cg, d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long row = row0 + rg + 16 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int k = tile_col(col0, cg, j);
          if (k >= cd) continue;
          if (kBf16) {
            static_cast<__nv_bfloat16*>(d_dense)[row * cd + k] = __float2bfloat16_rn(d[i][j]);
          } else {
            static_cast<float*>(d_dense)[row * cd + k] = d[i][j];
          }
        }
      }
    }
    __syncthreads();
  }
}

// out[i] = f32 of the blocks' partial[g][i] added in block order in f64.
template <typename T>
__global__ void reduce_blocks(const T* __restrict__ partial, int blocks, int n,
                              float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  double s = 0.0;
  for (int g = 0; g < blocks; ++g) s += partial[static_cast<size_t>(g) * n + i];
  out[i] = static_cast<float>(s);
}

// The device's shared memory a block may opt in to.
cudaError_t max_block_smem(int* max_smem) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return e;
}

// Launches this file's kernel of a pass; *grid_out = its blocks. scratch: at least
// max_grid slices of Layout::fit's slice bytes where that is not 0.
template <int kStage>
cudaError_t launch_fma(const void* dense, const void* planes, const void* mask, const void* w,
                       const void* g, const void* amax, void* partial, void* partial_v,
                       void* d_dense, void* scratch, int centroids, int cd, int cp, int kp,
                       int cdp, int c1, int c2, int c3, int c_out, int act, int bf16,
                       int max_grid, cudaStream_t s, int* grid_out) {
  int dev = 0, max_smem = 0, sms = 0, per_sm = 0;
  cudaError_t e = max_block_smem(&max_smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const Layout L = Layout::fit(kStage, kp, c1, c2, c3, static_cast<size_t>(max_smem));
  if (L.total > static_cast<size_t>(max_smem) || (L.slice > 0 && scratch == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const auto kernel = L.slice > 0 ? (bf16 ? fused_sa_bwd_kernel<kStage, true, true>
                                          : fused_sa_bwd_kernel<kStage, false, true>)
                                  : (bf16 ? fused_sa_bwd_kernel<kStage, true, false>
                                          : fused_sa_bwd_kernel<kStage, false, false>);
  const size_t smem = L.total;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  }
  if (e != cudaSuccess) return e;
  long long grid = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (grid > centroids) grid = centroids;
  if (grid > max_grid) grid = max_grid;
  if (grid < 1) grid = 1;  // one block's (zero) slice even for no centroid
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, s>>>(
      dense, static_cast<const float*>(planes), static_cast<const unsigned char*>(mask),
      static_cast<const float*>(w), static_cast<const float*>(g), static_cast<const int*>(amax),
      static_cast<float*>(partial), static_cast<double*>(partial_v), d_dense,
      static_cast<char*>(scratch), centroids, cd, cp, kp, cdp, c1, c2, c3, c_out, act,
      L.in_smem);
  e = cudaGetLastError();
  if (e == cudaSuccess) *grid_out = static_cast<int>(grid);
  return e;
}

template <int kStage>
int launch_stage(const void* dense, const void* planes, const void* mask, const void* w,
                 const void* wb, const void* g, const void* amax, void* partial,
                 void* partial_v, void* sums, void* d_dense, void* scratch, int centroids,
                 int cd, int cp, int kp, int cdp, int c1, int c2, int c3, int c_out, int act,
                 int bf16, int max_grid, void* stream) {
  if (centroids < 0 || cd < 0 || cp < 0 || cd + cp < 1 || kp < cd + cp || kp % 4 || c1 <= 0 ||
      c2 <= 0 || c3 <= 0 || c1 % 64 || c2 % 64 || c3 % 64 || cdp % 64 || cdp < cd ||
      c_out > c3 || act < kNone || act > kElu || max_grid < 1 ||
      (kStage == 3 && cd > 0 && d_dense == nullptr) || (wb != nullptr && !bf16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int grid[2] = {0, 0};  // the weight and the vector slices
  cudaError_t e;
  if (wb != nullptr) {  // bf16 on the tensor cores
    const auto mma = kStage == 1 ? dlbt_fused_sa_b1_mma
                     : kStage == 2 ? dlbt_fused_sa_b2_mma
                                   : dlbt_fused_sa_b3_mma;
    e = static_cast<cudaError_t>(mma(dense, planes, mask, w, wb, g, amax, partial, partial_v,
                                     d_dense, centroids, cd, cp, kp, c1, c2, c3, c_out, act,
                                     max_grid, stream, grid));
  } else {
    e = launch_fma<kStage>(dense, planes, mask, w, g, amax, partial, partial_v, d_dense,
                           scratch, centroids, cd, cp, kp, cdp, c1, c2, c3, c_out, act, bf16,
                           max_grid, s, &grid[0]);
    grid[1] = grid[0];
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_w = weight_size(kStage, kp, c1, c2, c3), n_v = vector_size(kStage, c1, c2, c3);
  reduce_blocks<float><<<(n_w + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(partial), grid[0], n_w, static_cast<float*>(sums));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  reduce_blocks<double><<<(n_v + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const double*>(partial_v), grid[1], n_v,
      static_cast<float*>(sums) + n_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One pass of kernel 6's backward over B*M = centroids centroids of 64 slots. dense,
// planes, mask and w as for the forward (csrc/fused_sa_fwd.cu), w packed as
// fused_sa_bwd_kernel reads it, CDP = CD rounded up to 64; g (B, M, c_out) f32 the
// cotangent of the pooled output and amax (B, M, c_out) int32 F3's argmax. Writes
// sums: the pass's output vector (see weight_size), f32; partial and partial_v are its
// scratch, (max_grid, weight_size) f32 and (max_grid, vector_size) f64. B3 with CD > 0
// also writes d_dense (B, M, 64, CD) in the dense block's type. wb: null, or in bf16
// the bf16 weight block that sends the pass to its tensor-core kernel
// (csrc/fused_sa_b1.cu, csrc/fused_sa_b2.cu, csrc/fused_sa_b3.cu), w then being its
// per-column vectors alone; that kernel raises at widths it does not take. scratch:
// max_grid slices of dlbt_fused_sa_bwd_slice_bytes each (null where that is 0) for
// this file's kernel.
#define DLBT_BWD_ENTRY(name, stage)                                                         \
  extern "C" int name(const void* dense, const void* planes, const void* mask, const void* w, \
                      const void* wb, const void* g, const void* amax, void* partial,        \
                      void* partial_v, void* sums, void* d_dense, void* scratch,            \
                      int centroids, int cd, int cp, int kp, int cdp, int c1, int c2, int c3, \
                      int c_out, int act, int bf16, int max_grid, void* stream) {            \
    return launch_stage<stage>(dense, planes, mask, w, wb, g, amax, partial, partial_v, sums, \
                               d_dense, scratch, centroids, cd, cp, kp, cdp, c1, c2, c3,     \
                               c_out, act, bf16, max_grid, stream);                          \
  }
DLBT_BWD_ENTRY(dlbt_fused_sa_b1, 1)
DLBT_BWD_ENTRY(dlbt_fused_sa_b2, 2)
DLBT_BWD_ENTRY(dlbt_fused_sa_b3, 3)
#undef DLBT_BWD_ENTRY

// The bytes of one block's scratch slice that this file's kernel of pass `stage` needs
// at these widths on the current device (0: all its buffers fit shared memory), or -1
// if the device cannot be queried. A host function: it launches nothing.
extern "C" long long dlbt_fused_sa_bwd_slice_bytes(int stage, int kp, int c1, int c2, int c3) {
  int max_smem = 0;
  if (stage < 1 || stage > 3 || max_block_smem(&max_smem) != cudaSuccess) return -1;
  return static_cast<long long>(
      Layout::fit(stage, kp, c1, c2, c3, static_cast<size_t>(max_smem)).slice);
}
