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
// Design: kernels 5's and 7's. A persistent block of 8 warps walks centroids with
// a grid stride. It copies the bf16 weights into shared memory once, with cp.async,
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

#include "fused_sa_tile.cuh"
#include "mma_bf16.cuh"

namespace {

using dlbt::kSkewH;
using fused_sa::activate;
using fused_sa::activate_deriv;
using fused_sa::kSlots;
using fused_sa::take;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowTiles = kSlots / 16;   // the 16-slot row tiles of a centroid
constexpr int kSub = 4;                  // n-tiles (8 columns) per pass of layer 2 and d(dense)
constexpr int kMaxDwTiles = 9;           // dW1's 16 x 16 tiles a warp holds at most
constexpr int kVecs = 7;                 // per-column vectors of a layer (see Vec)
enum Vec { kBias = 0, kScale, kShift, kMean, kInv, kTa, kTb };

__host__ __device__ __forceinline__ int round16(int v) { return (v + 15) / 16 * 16; }

// Byte offsets of one block's shared memory: the bf16 weights (W1^T, W2^T, W3: the
// wrapper's packing), the per-column vectors of layer 1 and of layer 2 (Vec order),
// two buffers of a centroid's inputs (its bf16 edge rows, mask bytes, f32 cotangent,
// argmax and f32 planes: one filled by cp.async while the other is used), the a1
// (then dh1) and dh2 rows, the row tiles' column sums of dh1 and the block's f64 db1.
struct Layout {
  // buffer b starts at buf + b * stride; x, mask, g, am and pl are offsets in a buffer
  size_t w1t, w2t, w3, vec, buf, stride, x, mask, g, am, pl, gb, am16, a1, dh2, red, db1, total;
  __host__ __device__ Layout(int kx, int cp, int c1, int c2, int c3) {
    size_t at = 0;
    w1t = take(at, 2ull * c1 * (kx + kSkewH));
    w2t = take(at, 2ull * c2 * (c1 + kSkewH));
    w3 = take(at, 2ull * c2 * (c3 + kSkewH));
    vec = take(at, 4ull * kVecs * (c1 + c2));
    size_t in = 0;
    x = take(in, 2ull * kSlots * (kx + kSkewH));
    mask = take(in, kSlots);
    g = take(in, 4ull * c3);
    am = take(in, 4ull * c3);
    pl = take(in, 4ull * kSlots * cp);
    stride = in;
    buf = take(at, 2 * in);
    gb = take(at, 2ull * c3);
    am16 = take(at, 2ull * c3);
    a1 = take(at, 2ull * kSlots * (c1 + kSkewH));
    dh2 = take(at, 2ull * kSlots * (c2 + kSkewH));
    red = take(at, 4ull * kRowTiles * c1);
    db1 = take(at, 8ull * c1);
    total = at;
  }
};

// acc[nt] += gs @ W3^T for rows r0..r0+15 and columns n0 + 8 nt. The A fragments are
// the bf16 cotangent gb where the column's argmax (am16, 16 bits, 0xffff for none)
// is the fragment's row, else 0: one 16-bit pair compare (__vcmpeq2) per register;
// W3 (C2 rows of C3) gives the B fragments by ldmatrix.
template <int NP>
__device__ __forceinline__ void routed_mma(const bf16* gb, const unsigned short* am16, int c3,
                                           int r0, const bf16* w3, int ld3, int n0,
                                           float (&acc)[2 * NP][4]) {
  const int lane = threadIdx.x & 31;
  const uint32_t ra = static_cast<uint32_t>(r0 + (lane >> 2)) * 0x10001u, rb = ra + 0x80008u;
#pragma unroll 2
  for (int k0 = 0; k0 < c3; k0 += 16) {
    const int c = k0 + 2 * (lane & 3);
    const uint32_t a_lo = *reinterpret_cast<const uint32_t*>(am16 + c);
    const uint32_t a_hi = *reinterpret_cast<const uint32_t*>(am16 + c + 8);
    const uint32_t g_lo = dlbt::ld32(gb + c), g_hi = dlbt::ld32(gb + c + 8);
    const uint32_t af[4] = {g_lo & __vcmpeq2(a_lo, ra), g_lo & __vcmpeq2(a_lo, rb),
                            g_hi & __vcmpeq2(a_hi, ra), g_hi & __vcmpeq2(a_hi, rb)};
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      uint32_t b0[2], b1[2];
      dlbt::load_b_ldm(b0, b1, w3, ld3, k0, n0 + 16 * np);
      dlbt::mma_bf16(acc[2 * np], af, b0);
      dlbt::mma_bf16(acc[2 * np + 1], af, b1);
    }
  }
}

// An accumulator tile's two values of row r at columns col, col + 1, as bf16.
__device__ __forceinline__ void put2(bf16* rows, int ld, int r, int col, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(rows + r * ld + col) = __floats2bfloat162_rn(v0, v1);
}

// Columns col, col + 1 of per-column vector v (col even).
__device__ __forceinline__ float2 at2(const float* v, int col) {
  return *reinterpret_cast<const float2*>(v + col);
}

__device__ __forceinline__ float lane2(float2 v, int e) { return (e & 1) ? v.y : v.x; }

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
  const bf16* const w1t = reinterpret_cast<const bf16*>(smem + L.w1t);
  const bf16* const w2t = reinterpret_cast<const bf16*>(smem + L.w2t);
  const bf16* const w3 = reinterpret_cast<const bf16*>(smem + L.w3);
  const float* const vec = reinterpret_cast<const float*>(smem + L.vec);
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
  for (int i = tid; i < static_cast<int>(L.vec / 16); i += kThreads) {
    dlbt::cp_async16(smem + 16 * i, reinterpret_cast<const char*>(wb) + 16ll * i);
  }
  for (int i = tid; i < kVecs * (c1 + c2) / 4; i += kThreads) {
    dlbt::cp_async16(smem + L.vec + 16 * i, reinterpret_cast<const char*>(w) + 16ll * i);
  }
  for (int i = tid; i < c1; i += kThreads) db1[i] = 0.0;
  // what the copies never fill: the edge rows' zero columns, and the padded
  // columns of the cotangent (0) and the argmax (-1)
  for (int b = 0; b < 2; ++b) {
    char* const in = smem + L.buf + b * L.stride;
    bf16* const x = reinterpret_cast<bf16*>(in + L.x);
    for (int i = tid; i < kSlots * (kx - cd); i += kThreads) {
      const int r = i / (kx - cd), k = cd + (i - r * (kx - cd));
      x[r * ldx + k] = __float2bfloat16_rn(0.0f);
    }
    for (int c = c_out + tid; c < c3; c += kThreads) {
      reinterpret_cast<float*>(in + L.g)[c] = 0.0f;
      reinterpret_cast<int*>(in + L.am)[c] = -1;
    }
  }

  // starts the copies of centroid ci's inputs into buffer b
  auto prefetch = [&](long long ci, int b) {
    const long long row0 = ci * kSlots;
    char* const in = smem + L.buf + b * L.stride;
    if (tid < kSlots / 16) dlbt::cp_async16(in + L.mask + 16 * tid, mask + row0 + 16 * tid);
    for (int c = tid; c < c_out; c += kThreads) {
      dlbt::cp_async4(in + L.g + 4 * c, gout + ci * c_out + c);
      dlbt::cp_async4(in + L.am + 4 * c, amax + ci * c_out + c);
    }
    for (int i = tid; i < kSlots * cp; i += kThreads) {
      dlbt::cp_async4(in + L.pl + 4 * i, planes + row0 * cp + i);
    }
    if (dense_vec) {
      bf16* const x = reinterpret_cast<bf16*>(in + L.x);
      const int vecs = cd / 8;
      for (int i = tid; i < kSlots * vecs; i += kThreads) {
        const int r = i / vecs, v = i - r * vecs;
        dlbt::cp_async16(x + r * ldx + 8 * v, dense + (row0 + r) * cd + 8 * v);
      }
    }
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
    char* const in = smem + L.buf + b * L.stride;
    const unsigned char* const mk = reinterpret_cast<const unsigned char*>(in + L.mask);
    if (!__syncthreads_or(tid < kSlots && mk[tid] != 0)) {
      // no valid slot: no gradient, and rows of 0 in d(dense)
      for (int i = tid; i < kSlots * cd; i += kThreads) {
        d_dense[row0 * cd + i] = __float2bfloat16_rn(0.0f);
      }
      continue;
    }
    bf16* const x = reinterpret_cast<bf16*>(in + L.x);
    bf16* const gb = reinterpret_cast<bf16*>(smem + L.gb);
    unsigned short* const am16 = reinterpret_cast<unsigned short*>(smem + L.am16);
    {  // the cotangent in bf16 and the argmax in 16 bits; the planes rounded to bf16 at
       // columns CD16.., and the dense rows the copies could not take
      const float* const gf = reinterpret_cast<const float*>(in + L.g);
      const int* const am = reinterpret_cast<const int*>(in + L.am);
      for (int c = tid; c < c3; c += kThreads) {
        gb[c] = __float2bfloat16_rn(gf[c]);
        am16[c] = static_cast<unsigned short>(am[c]);  // -1: 0xffff, no slot's row
      }
      const float* const pl = reinterpret_cast<const float*>(in + L.pl);
      for (int i = tid; i < kSlots * cp; i += kThreads) {
        const int r = i / cp;
        x[r * ldx + cd16 + (i - r * cp)] = __float2bfloat16_rn(pl[i]);
      }
      if (!dense_vec) {
        for (int i = tid; i < kSlots * cd; i += kThreads) {
          const int r = i / cd;
          x[r * ldx + (i - r * cd)] = dense[row0 * cd + i];
        }
      }
    }
    __syncthreads();

    // h1 = (dense rows' product + planes' product) + b1, kept to the end; a1 rows
    float h1[kT1][4];
    dlbt::zero_acc(h1);
    dlbt::warp_mma_ldm<kT1 / 2>(x, ldx, w1t, ldx, 0, cd16, r0, n1, h1);
    if (cp > 0) {
#pragma unroll
      for (int np = 0; np < kT1 / 2; ++np) {
        float hp[2][4];
        dlbt::zero_acc(hp);
        dlbt::warp_mma_ldm<1>(x, ldx, w1t, ldx, cd16, kx, r0, n1 + 16 * np, hp);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          h1[2 * np][e] += hp[0][e];
          h1[2 * np + 1][e] += hp[1][e];
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < kT1; ++nt) {
      const int col = n1 + 8 * nt + 2 * t;
      const float2 bias = at2(v1 + kBias * c1, col), sc = at2(v1 + kScale * c1, col),
                   sh = at2(v1 + kShift * c1, col);
      float a[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        h1[nt][e] += lane2(bias, e);
        a[e] = activate(h1[nt][e] * lane2(sc, e) + lane2(sh, e), act);
      }
      put2(a1, ld1, r0 + g, col, a[0], a[1]);
      put2(a1, ld1, r0 + g + 8, col, a[2], a[3]);
    }
    __syncthreads();

    // layer 2, 32 columns at a time: h2 and da2, then dh2 in bf16
    const float m_lo = mk[r0 + g] ? 1.0f : 0.0f, m_hi = mk[r0 + g + 8] ? 1.0f : 0.0f;
    for (int n0 = half * (c2 / 2); n0 < (half + 1) * (c2 / 2); n0 += 8 * kSub) {
      float h2[kSub][4], d2[kSub][4];
      dlbt::zero_acc(h2);
      dlbt::zero_acc(d2);
      dlbt::warp_mma_ldm<kSub / 2>(a1, ld1, w2t, ld1, 0, c1, r0, n0, h2);
      routed_mma<kSub / 2>(gb, am16, c3, r0, w3, ld3, n0, d2);
#pragma unroll
      for (int nt = 0; nt < kSub; ++nt) {
        const int col = n0 + 8 * nt + 2 * t;
        const float2 bias = at2(v2 + kBias * c2, col), sc = at2(v2 + kScale * c2, col),
                     sh = at2(v2 + kShift * c2, col), mean = at2(v2 + kMean * c2, col),
                     inv = at2(v2 + kInv * c2, col), ta = at2(v2 + kTa * c2, col),
                     tb = at2(v2 + kTb * c2, col);
        float d[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float m = e < 2 ? m_lo : m_hi;
          const float hv = h2[nt][e] + lane2(bias, e);
          const float db =
              d2[nt][e] * activate_deriv(hv * lane2(sc, e) + lane2(sh, e), act) * m;
          const float xh = (hv - lane2(mean, e)) * lane2(inv, e);
          d[e] = lane2(sc, e) * (db - lane2(ta, e) - xh * lane2(tb, e)) * m;
        }
        put2(dh2, ld2, r0 + g, col, d[0], d[1]);
        put2(dh2, ld2, r0 + g + 8, col, d[2], d[3]);
      }
    }
    __syncthreads();

    // layer 1: da1 = dh2 W2^T on h1's columns, dh1 in bf16, its column sums
    {
      float d1[kT1][4];
      dlbt::zero_acc(d1);
      dlbt::warp_mma_tb<kT1 / 2>(dh2, ld2, w2t, ld1, c2, r0, n1, d1);
#pragma unroll
      for (int nt = 0; nt < kT1; ++nt) {
        const int col = n1 + 8 * nt + 2 * t;
        const float2 sc = at2(v1 + kScale * c1, col), sh = at2(v1 + kShift * c1, col),
                     mean = at2(v1 + kMean * c1, col), inv = at2(v1 + kInv * c1, col),
                     ta = at2(v1 + kTa * c1, col), tb = at2(v1 + kTb * c1, col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float m = e < 2 ? m_lo : m_hi;
          const float hv = h1[nt][e];
          const float db =
              d1[nt][e] * activate_deriv(hv * lane2(sc, e) + lane2(sh, e), act) * m;
          const float xh = (hv - lane2(mean, e)) * lane2(inv, e);
          d1[nt][e] = lane2(sc, e) * (db - lane2(ta, e) - xh * lane2(tb, e)) * m;
        }
        put2(dh1, ld1, r0 + g, col, d1[nt][0], d1[nt][1]);
        put2(dh1, ld1, r0 + g + 8, col, d1[nt][2], d1[nt][3]);
#pragma unroll
        for (int p = 0; p < 2; ++p) {  // the tile's column sums: rows g, g + 8, then over g
          float s = d1[nt][p] + d1[nt][p + 2];
          s += __shfl_xor_sync(0xffffffffu, s, 4);
          s += __shfl_xor_sync(0xffffffffu, s, 8);
          s += __shfl_xor_sync(0xffffffffu, s, 16);
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
                   int* grid_out) {
  const auto kernel = fused_sa_b3_kernel<kT1, kDw>;
  const size_t smem = Layout(round16(cd) + round16(cp), cp, c1, c2, c3).total;
  int dev = 0, max_smem = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (smem > static_cast<size_t>(max_smem)) return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  }
  if (e != cudaSuccess) return e;
  long long grid = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (grid > centroids) grid = centroids;
  if (grid > max_grid) grid = max_grid;
  if (grid < 1) grid = 1;  // one block's (zero) slices even for no centroid
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
      static_cast<const bf16*>(dense), static_cast<const float*>(planes),
      static_cast<const unsigned char*>(mask), static_cast<const float*>(w),
      static_cast<const bf16*>(wb), static_cast<const float*>(g), static_cast<const int*>(amax),
      static_cast<float*>(partial), static_cast<double*>(partial_v), static_cast<bf16*>(d_dense),
      centroids, cd, cp, kp, c1, c2, c3, c_out, act);
  e = cudaGetLastError();
  if (e == cudaSuccess) *grid_out = static_cast<int>(grid);
  return e;
}

}  // namespace

// B3 in bf16 over B*M = centroids centroids, the arguments of dlbt_fused_sa_b3
// (csrc/fused_sa_bwd.cu, which checks the shared ones and adds the slices) but w, here
// the per-column vectors (7 (C1 + C2) f32: b, sc, sh, mean, inv, ta, tb of layer 1,
// then of layer 2), and wb, the bf16 weight block (laid out as Layout's first three
// parts); mask, w and wb 16-byte aligned.
// Writes each block's dW1 slice (KP x C1 f32) into partial and its db1 slice (C1 f64)
// into partial_v, and d_dense (B, M, 64, CD) bf16 where CD > 0; *grid (host memory) is
// the number of slices. C1 64 or 128, C2 and C3 multiples of 64, and at most
// 8 x kMaxDwTiles of dW1's 16 x 16 tiles.
extern "C" int dlbt_fused_sa_b3_mma(const void* dense, const void* planes, const void* mask,
                                    const void* w, const void* wb, const void* g,
                                    const void* amax, void* partial, void* partial_v,
                                    void* d_dense, int centroids, int cd, int cp, int kp, int c1,
                                    int c2, int c3, int c_out, int act, int max_grid,
                                    void* stream, int* grid) {
  *grid = 0;
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
