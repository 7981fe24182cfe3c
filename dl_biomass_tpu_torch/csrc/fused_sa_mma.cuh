// The tensor-core pieces that kernel 6's bf16 passes share (the backward's
// csrc/fused_sa_b1.cu, csrc/fused_sa_b2.cu, csrc/fused_sa_b3.cu and the forward's
// csrc/fused_sa_f1.cu, csrc/fused_sa_f2.cu, csrc/fused_sa_f3.cu): the bf16 weight block
// as the wrapper packs it (sa_train_kernel._packed_bf16) and the kernels hold it in
// shared memory, the per-column vectors, the double buffer of a centroid's inputs
// filled by cp.async, the recompute of h1 and a1 and of layer 2 (beside the routed
// da2 in the backward), and the BatchNorm backward of an accumulator tile. A
// persistent block of 8 warps walks the centroids; warp w takes the 16 slots of row
// tile w % 4 and half w / 4 of the columns of every row-wise product, on mma.sync
// m16n8k16 (csrc/mma_bf16.cuh) with f32 accumulators.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "fused_sa_tile.cuh"
#include "mma_bf16.cuh"

namespace fused_sa_mma {

using bf16 = __nv_bfloat16;
using dlbt::kSkewH;
using fused_sa::activate;
using fused_sa::activate_deriv;
using fused_sa::kSlots;
using fused_sa::take;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowTiles = kSlots / 16;  // the 16-slot row tiles of a centroid
constexpr int kSub = 4;                 // n-tiles (8 columns) per pass of layer 2 and d(dense)
constexpr int kVecs = 7;                // per-column vectors of a layer (see Vec)
enum Vec { kBias = 0, kScale, kShift, kMean, kInv, kTa, kTb };

__host__ __device__ __forceinline__ int round16(int v) { return (v + 15) / 16 * 16; }

// Bytes of the weight block's parts: W1^T (C1 x KX, the dense rows' columns at 0, the
// planes' at CD rounded up to 16), W2^T (C2 x C1) and W3 (C2 x C3), each row kSkewH
// values longer; each a whole number of 16-byte pieces.
__host__ __device__ __forceinline__ size_t w1t_bytes(int kx, int c1) {
  return 2ull * c1 * (kx + kSkewH);
}
__host__ __device__ __forceinline__ size_t w2t_bytes(int c1, int c2) {
  return 2ull * c2 * (c1 + kSkewH);
}
__host__ __device__ __forceinline__ size_t w3_bytes(int c2, int c3) {
  return 2ull * c2 * (c3 + kSkewH);
}
__host__ __device__ __forceinline__ size_t vec_bytes(int c1, int c2) {
  return 4ull * kVecs * (c1 + c2);
}
// The forward's vectors: the backward's, then b3 (C3).
__host__ __device__ __forceinline__ size_t fwd_vec_bytes(int c1, int c2, int c3) {
  return vec_bytes(c1, c2) + 4ull * c3;
}

// Offsets within one buffer of a centroid's inputs: its bf16 edge rows (KX columns,
// rows kx + kSkewH apart), mask bytes, f32 cotangent, argmax and f32 planes.
struct Inputs {
  size_t x, mask, g, am, pl, stride;
  __host__ __device__ Inputs(int kx, int cp, int c3) {
    size_t in = 0;
    x = take(in, 2ull * kSlots * (kx + kSkewH));
    mask = take(in, kSlots);
    g = take(in, 4ull * c3);
    am = take(in, 4ull * c3);
    pl = take(in, 4ull * kSlots * cp);
    stride = in;
  }
};

// Starts this thread's 16-byte copies of n bytes from src to dst (shared memory).
__device__ __forceinline__ void copy_async(char* dst, const void* src, size_t n) {
  for (size_t i = threadIdx.x; i < n / 16; i += kThreads) {
    dlbt::cp_async16(dst + 16 * i, static_cast<const char*>(src) + 16 * i);
  }
}

// Starts the copies of centroid ci's inputs into the buffer at in: mask, cotangent,
// argmax, planes, and the bf16 dense rows straight into the edge rows' columns where
// they come in 16-byte pieces (dense_vec).
__device__ __forceinline__ void prefetch_inputs(char* in, const Inputs& I, long long ci,
                                                const bf16* dense, const float* planes,
                                                const unsigned char* mask, const float* gout,
                                                const int* amax, int cd, int cp, int ldx,
                                                int c_out, bool dense_vec) {
  const int tid = threadIdx.x;
  const long long row0 = ci * kSlots;
  if (tid < kSlots / 16) dlbt::cp_async16(in + I.mask + 16 * tid, mask + row0 + 16 * tid);
  for (int c = tid; c < c_out; c += kThreads) {
    dlbt::cp_async4(in + I.g + 4 * c, gout + ci * c_out + c);
    dlbt::cp_async4(in + I.am + 4 * c, amax + ci * c_out + c);
  }
  for (int i = tid; i < kSlots * cp; i += kThreads) {
    dlbt::cp_async4(in + I.pl + 4 * i, planes + row0 * cp + i);
  }
  if (dense_vec) {
    bf16* const x = reinterpret_cast<bf16*>(in + I.x);
    const int vecs = cd / 8;
    for (int i = tid; i < kSlots * vecs; i += kThreads) {
      const int r = i / vecs, v = i - r * vecs;
      dlbt::cp_async16(x + r * ldx + 8 * v, dense + (row0 + r) * cd + 8 * v);
    }
  }
}

// Once the copies have landed: the cotangent's columns c0 .. c0 + n - 1 in bf16 (gb)
// and their argmax in 16 bits (am16; 0 and 0xffff, no slot's row, past c_out), and
// the edge rows' columns CD.. : the planes rounded to bf16 at CD16 .. CD16 + CP - 1,
// zeros elsewhere; the dense rows the copies could not take.
__device__ __forceinline__ void stage_inputs(char* in, const Inputs& I, bf16* gb,
                                             unsigned short* am16, int c0, int n, int c_out,
                                             const bf16* dense, long long row0, int cd, int cp,
                                             int kx, int ldx, bool dense_vec) {
  const int tid = threadIdx.x, cd16 = round16(cd), tail = kx - cd;
  const float* const gf = reinterpret_cast<const float*>(in + I.g);
  const int* const am = reinterpret_cast<const int*>(in + I.am);
  for (int j = tid; j < n; j += kThreads) {
    const bool real = c0 + j < c_out;
    gb[j] = __float2bfloat16_rn(real ? gf[c0 + j] : 0.0f);
    am16[j] = real ? static_cast<unsigned short>(am[c0 + j]) : 0xffff;  // -1: 0xffff
  }
  bf16* const x = reinterpret_cast<bf16*>(in + I.x);
  const float* const pl = reinterpret_cast<const float*>(in + I.pl);
  for (int i = tid; i < kSlots * tail; i += kThreads) {
    const int r = i / tail, k = cd + (i - r * tail), p = k - cd16;
    x[r * ldx + k] = __float2bfloat16_rn(p >= 0 && p < cp ? pl[r * cp + p] : 0.0f);
  }
  if (!dense_vec) {
    for (int i = tid; i < kSlots * cd; i += kThreads) {
      const int r = i / cd;
      x[r * ldx + (i - r * cd)] = dense[row0 * cd + i];
    }
  }
}

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

// The sum over a 16-row accumulator tile of one column: v_lo and v_hi are the lane's
// values of rows g and g + 8; every lane with the same t holds the column's sum.
__device__ __forceinline__ float tile_colsum(float v_lo, float v_hi) {
  float s = v_lo + v_hi;
  s += __shfl_xor_sync(0xffffffffu, s, 4);
  s += __shfl_xor_sync(0xffffffffu, s, 8);
  s += __shfl_xor_sync(0xffffffffu, s, 16);
  return s;
}

// h1 = (dense rows' product + planes' product) + b1 for the warp's rows r0.. and its
// kT1 n-tiles from column n1, kept in h1 (b1: C1 f32).
template <int kT1>
__device__ __forceinline__ void layer1_h1(const bf16* x, int ldx, const bf16* w1t, int cd16,
                                          int kx, int cp, const float* b1, int n1,
                                          int r0, float (&h1)[kT1][4]) {
  const int t = threadIdx.x & 3;
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
    const float2 bias = at2(b1, n1 + 8 * nt + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) h1[nt][e] += lane2(bias, e);
  }
}

// layer1_h1, then a1 = act(h1 sc1 + sh1) into rows a1 as bf16. v1: layer 1's
// per-column vectors (Vec order, C1 apart).
template <int kT1>
__device__ __forceinline__ void layer1(const bf16* x, int ldx, const bf16* w1t, int cd16, int kx,
                                       int cp, const float* v1, int c1, int act, bf16* a1,
                                       int ld1, int r0, int n1, float (&h1)[kT1][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  layer1_h1<kT1>(x, ldx, w1t, cd16, kx, cp, v1 + kBias * c1, n1, r0, h1);
#pragma unroll
  for (int nt = 0; nt < kT1; ++nt) {
    const int col = n1 + 8 * nt + 2 * t;
    const float2 sc = at2(v1 + kScale * c1, col), sh = at2(v1 + kShift * c1, col);
    float a[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) a[e] = activate(h1[nt][e] * lane2(sc, e) + lane2(sh, e), act);
    put2(a1, ld1, r0 + g, col, a[0], a[1]);
    put2(a1, ld1, r0 + g + 8, col, a[2], a[3]);
  }
}

// Layer 2 for the warp's rows r0.. and half `half` of C2, 32 columns at a time:
// h2 = a1 W2 (without b2) beside the routed da2 = gs W3^T over gb's n3 columns, each
// n-tile handed to epi(col, h2, da2) (the lane's columns col, col + 1).
template <class Epi>
__device__ __forceinline__ void layer2(const bf16* a1, int ld1, const bf16* w2t, int c1, int c2,
                                       const bf16* gb, const unsigned short* am16, int n3,
                                       const bf16* w3, int ld3, int r0, int half, Epi&& epi) {
  const int t = threadIdx.x & 3;
  for (int n0 = half * (c2 / 2); n0 < (half + 1) * (c2 / 2); n0 += 8 * kSub) {
    float h2[kSub][4], d2[kSub][4];
    dlbt::zero_acc(h2);
    dlbt::zero_acc(d2);
    dlbt::warp_mma_ldm<kSub / 2>(a1, ld1, w2t, ld1, 0, c1, r0, n0, h2);
    routed_mma<kSub / 2>(gb, am16, n3, r0, w3, ld3, n0, d2);
#pragma unroll
    for (int nt = 0; nt < kSub; ++nt) epi(n0 + 8 * nt + 2 * t, h2[nt], d2[nt]);
  }
}

// Layer 2 of the forward for the warp's rows r0.. and half `half` of C2, 32 columns
// at a time: h2 = a1 W2 (without b2), each n-tile handed to epi(col, h2).
template <class Epi>
__device__ __forceinline__ void layer2_fwd(const bf16* a1, int ld1, const bf16* w2t, int c1,
                                           int c2, int r0, int half, Epi&& epi) {
  const int t = threadIdx.x & 3;
  for (int n0 = half * (c2 / 2); n0 < (half + 1) * (c2 / 2); n0 += 8 * kSub) {
    float h2[kSub][4];
    dlbt::zero_acc(h2);
    dlbt::warp_mma_ldm<kSub / 2>(a1, ld1, w2t, ld1, 0, c1, r0, n0, h2);
#pragma unroll
    for (int nt = 0; nt < kSub; ++nt) epi(n0 + 8 * nt + 2 * t, h2[nt]);
  }
}

// A layer's BatchNorm backward on one accumulator tile (columns col, col + 1 of rows
// g, g + 8; m_lo, m_hi those rows' masks), h its pre-BatchNorm values with the bias
// and da the derivative of its activation's output: db = da act'(h sc + sh) m and
// xhat = (h - mean) inv. v: the layer's per-column vectors (Vec order, c apart).
__device__ __forceinline__ void bn_backward(const float (&h)[4], const float (&da)[4],
                                            const float* v, int c, int col, int act, float m_lo,
                                            float m_hi, float (&db)[4], float (&xh)[4]) {
  const float2 sc = at2(v + kScale * c, col), sh = at2(v + kShift * c, col),
               mean = at2(v + kMean * c, col), inv = at2(v + kInv * c, col);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float m = e < 2 ? m_lo : m_hi;
    db[e] = da[e] * activate_deriv(h[e] * lane2(sc, e) + lane2(sh, e), act) * m;
    xh[e] = (h[e] - lane2(mean, e)) * lane2(inv, e);
  }
}

// dh = sc (db - ta - xhat tb) m on the same tile.
__device__ __forceinline__ void bn_dh(const float (&db)[4], const float (&xh)[4], const float* v,
                                      int c, int col, float m_lo, float m_hi, float (&dh)[4]) {
  const float2 sc = at2(v + kScale * c, col), ta = at2(v + kTa * c, col),
               tb = at2(v + kTb * c, col);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float m = e < 2 ? m_lo : m_hi;
    dh[e] = lane2(sc, e) * (db[e] - lane2(ta, e) - xh[e] * lane2(tb, e)) * m;
  }
}

// The grid of a persistent kernel run over `groups` column groups (gridDim.y): as many
// blocks as fit on the card at once, spread over the groups, at most one per centroid
// and max_grid / groups per group (the rows of the scratch), at least one. *grid_x
// is the blocks per group.
template <class Kernel>
cudaError_t persistent_grid(Kernel kernel, size_t smem, long long centroids, int max_grid,
                            int groups, int* grid_x) {
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
  long long grid = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1) / groups;
  if (grid > centroids) grid = centroids;
  if (grid > max_grid / groups) grid = max_grid / groups;
  if (grid < 1) grid = 1;  // one block's (zero) slices even for no centroid
  *grid_x = static_cast<int>(grid);
  return cudaSuccess;
}

}  // namespace fused_sa_mma
