// The whole SA1 eval layer in one kernel: stratified selection, capture of the
// edge features, the folded three-layer MLP and the masked max over the 64
// neighbour slots. No (B, M, 64, C) edge tensor reaches device memory.
//
// Replaces: dl_biomass_tpu/ops/pallas_sa_eval.py sa1_fused_eval (_sa1_kernel).
// Semantics: slot j of centroid i holds the point that stratified_select.cuh
// picks (the rule of kernel 2). Its edge row is [feat_0 .. feat_{F-1},
// x - cx, y - cy, z - cz], each value rounded once to the compute type, zeros
// for an invalid slot. Then three folded layers: each a dot product with f32
// accumulation plus an f32 bias; the two hidden layers take a ReLU and are
// rounded to the compute type, the last stays f32. The output row is the max
// of the last layer over the valid slots (0 where no slot is valid, so a
// masked centroid gives 0), in the output type. With the compute type bf16
// the products are of bf16 values, which are exact in f32: the sums differ
// from a GEMM's only in how they are ordered and rounded. The Pallas kernel
// leaves unmasked sums in invalid slots (its aliasing contract); the max
// discards them, so they are not reproduced here.
//
// Bound on the H100: operations. The MLP is 2*(P*H1 + H1*H2 + H2*C) flops per
// valid edge (25,088 at P=4, 64, 64, 128), on the bf16 tensor cores at best,
// plus the distance tests of the selection (8 flops each, f32); the output is
// the only sizeable traffic (B*M*C values).
//
// Widths: any hidden and output widths that are multiples of 64, and any F (layer 1's
// depth is F + 3 in whole MMA steps: 16 in bf16, 8 in f32). SA1's at neuron_multiplier
// 1, 2 and 3, (64, 64, 128), (128, 128, 256) and (192, 192, 384), run the resident
// kernels below (bf16 at F <= 13, f32 at F <= 5); every other width runs the wide
// kernel at the end (sa_eval_kernel.plan mirrors plan_of below).
//
// Design: in bf16 the scan dominates. Each of a centroid's 128 residue buckets is
// walked until its first in-radius point, most of the way through a cloud: point
// loads, in chains a thread cannot shorten. So a group of 128 threads (one per
// bucket) scans for kQuad centroids of one cloud at once (bucket_first_multi), each
// point loaded once and tested against all four, kScanDepth points in flight per
// thread. Threads then capture the 4 x 64 slots' edge rows, each centroid's valid
// slots packed to its first rows (a ballot per warp), so the MLP runs only
// ceil(valid / 16) row tiles of 16. Warp k of the group takes centroid k: per row
// tile the three layers on mma.sync m16n8k16 (bf16 in, f32 accumulators), a1 and a2
// never leaving registers (an accumulator tile, biased, rectified and rounded, is
// the A fragment of the next product), the last layer's tiles folded into a running
// max over the rows the lane holds; one shuffle reduction per centroid, then the
// bias (max(h + b) = max(h) + b, rounding being monotone). A persistent block of
// kGroups groups copies the weight block, packed once per engine in the layout it
// keeps (sa_eval_kernel.pack_sa1_eval: each matrix transposed in bf16, rows 8 values
// longer so that ldmatrix hits 32 banks, the biases f32), into shared memory once
// with cp.async; each group walks its own quads with its own buffers and named
// barrier, so one group's scan runs beside another's MLP. Shared memory at the
// production widths: 31 KiB of weights and 14 KiB per group, four groups a block (at
// twice and three times the widths a1, a2 and the running max spill some of their
// registers: four groups still beat two, whose 255 registers spill less). Three times
// the widths' weights (237 KiB) do not fit a block, so layer 3's 384 columns are
// split in two over gridDim.y: each block holds W1, W2 and its 192 columns of W3 and
// recomputes the selection, a1 and a2 for them. Columns are independent and the max
// is per column, so every output is the same value as from one block.
// In f32 a block of 128 threads takes one centroid at a time (bucket_first, then the
// capture), and runs the layers as 64-column passes of f32 FMAs on the CUDA cores,
// every thread holding a 4-row x 8-column tile and reading 16-byte vectors, a1 and
// a2 in shared memory. Where the whole weight block does not fit beside them (at
// twice and three times the production widths: 278 and 532 KiB), W1 and the biases
// stay in shared memory and W2 and W3 stream through two buffers, 64 columns at a
// time (cp.async, the next chunk in flight while one is used): each pass reads the
// same columns in the same order as from a resident block, so the sums are the same.
// The wide kernel (bf16 on mma.sync, f32 on FMAs) takes the widths and inputs those
// do not: a block of 128 threads takes one centroid at a time (the f32 kernel's scan and
// capture), then streams all three weight matrices through two cp.async buffers in
// tiles of 64 output columns by at most 64 depths, in one sequence over the layers,
// each output column's sum built over its tiles in ascending depth in registers. A
// hidden layer's 64 columns go biased, rectified and rounded into a1 or a2, layer 3's
// into a running max over the valid slots that is written out column chunk by column
// chunk, so h3 is never stored. a1 and a2 (64 rows each) stay in shared memory where
// they fit beside the buffers, else in the block's slice of a scratch tensor in device
// memory, which L2 holds (bf16 from H = 1024, f32 from H = 512).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "mma_bf16.cuh"
#include "stratified_select.cuh"

namespace {

using bf16 = __nv_bfloat16;
using dlbt::kBuckets;
using dlbt::kSkewH;  // bf16 rows are (depth + 8) values apart (mma_bf16.cuh)
using dlbt::kSlots;

constexpr int kGroup = kBuckets;  // threads of a group: one per residue bucket
constexpr int kGroupWarps = kGroup / 32;
constexpr int kQuad = kGroupWarps;  // centroids a group scans together, one per warp after
constexpr int kGroups = 4;          // groups per block of the bf16 kernel, one block per SM
constexpr int kScanDepth = 4;       // points a bf16 scan thread loads before it tests them
constexpr int kInPad = 8;   // f32 layer-1 input: [feat..., dx, dy, dz] padded with zeros to 8
constexpr int kInMma = 16;  // bf16 layer-1 input: padded to one MMA step
constexpr int kEdgeLd = kInMma + kSkewH;  // bf16 edge rows' stride
constexpr int kSkew = 4;    // f32 rows are (width + 4) floats apart: 16-byte aligned, and
                            // the 4 row groups of a warp fall in other banks

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

__host__ __device__ __forceinline__ size_t take(size_t& at, size_t bytes) {
  const size_t offset = at;
  at += (bytes + 15) / 16 * 16;
  return offset;
}

// Layer 1's depth at f features: F + 3 in whole MMA steps (16 in bf16, 8 in f32).
__host__ __device__ __forceinline__ int in_depth(int f, bool bf16) {
  const int step = bf16 ? kInMma : kInPad;
  return (f + 3 + step - 1) / step * step;
}

// The weight block, as sa_eval_kernel.pack_sa1_eval packs it and the resident kernels
// keep it at the start of their shared memory. bf16: W1^T (H1, D1 + 8), b1 (H1 f32),
// W2^T (H2, H1 + 8), b2, W3^T (C, H2 + 8), b3, the matrices bf16. f32: w1 (D1, H1), b1,
// w2 (H1, H2), b2, w3 (H2, C), b3. D1 = in_depth(F) (d1 0: the resident kernels' 16 in
// bf16, 8 in f32). Each part a whole number of 16-byte pieces.
struct Weights {
  size_t w1, b1, w2, b2, w3, b3, total;
  __host__ __device__ Weights(bool bf16, int h1, int h2, int c, int d1 = 0) {
    size_t at = 0;
    const size_t e = bf16 ? 2 : 4;
    if (d1 == 0) d1 = bf16 ? kInMma : kInPad;
    w1 = take(at, bf16 ? e * h1 * (d1 + kSkewH) : e * d1 * h1);
    b1 = take(at, 4ull * h1);
    w2 = take(at, bf16 ? e * h2 * (h1 + kSkewH) : e * h1 * h2);
    b2 = take(at, 4ull * h2);
    w3 = take(at, bf16 ? e * c * (h2 + kSkewH) : e * h2 * c);
    b3 = take(at, 4ull * c);
    total = at;
  }
};

// Starts a cp.async copy of bytes (a multiple of 16) from global w to shared smem.
__device__ __forceinline__ void copy_async(char* smem, const char* w, size_t bytes) {
  for (size_t i = threadIdx.x; i < bytes / 16; i += blockDim.x) {
    dlbt::cp_async16(smem + 16 * i, w + 16 * i);
  }
}

// Copies the weight block into shared memory with cp.async, and waits for it.
__device__ __forceinline__ void load_weights(char* smem, const char* w, size_t bytes) {
  copy_async(smem, w, bytes);
  dlbt::cp_async_commit();
  dlbt::cp_async_wait<0>();
  __syncthreads();
}

// Slot j's edge row (depth values: the features, the offsets, zeros) of point sel
// of the planes at px, or zeros.
template <typename E>
__device__ __forceinline__ void capture(E* e, const float* px, int n, int f, int sel, bool ok,
                                        float cx, float cy, float cz, int depth) {
  const float* py = px + n;
  const float* pz = py + n;
  for (int q = 0; q < f; ++q) {
    put(e + q, ok ? px[(3 + q) * static_cast<long long>(n) + sel] : 0.0f);
  }
  put(e + f, ok ? __fsub_rn(px[sel], cx) : 0.0f);
  put(e + f + 1, ok ? __fsub_rn(py[sel], cy) : 0.0f);
  put(e + f + 2, ok ? __fsub_rn(pz[sel], cz) : 0.0f);
  for (int q = f + 3; q < depth; ++q) put(e + q, 0.0f);
}

__device__ __forceinline__ void store_out(void* out, long long at, float v, int out_bf16) {
  if (out_bf16) {
    static_cast<bf16*>(out)[at] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(out)[at] = v;
  }
}

// ---- bf16: tensor-core MMA, a1 and a2 in registers ----------------------------

// The group's barrier: named barrier `bar` over its 128 threads.
__device__ __forceinline__ void group_sync(int bar) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "n"(kGroup) : "memory");
}

__device__ __forceinline__ uint32_t pack_relu(float v0, float b0, float v1, float b1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(fmaxf(v0 + b0, 0.0f), fmaxf(v1 + b1, 0.0f));
  return *reinterpret_cast<const uint32_t*>(&h);
}

// A hidden layer's 64 columns from 64q, accumulator tiles (8 n-tiles, the lane's
// rows g and g + 8), biased, rectified and rounded to bf16, as the A fragments of the
// next product's k-steps 4q .. 4q + 3: tile nt's C fragment (columns 2t, 2t + 1) is
// the A fragment's half at columns 8 (nt % 2) + 2t of step nt / 2.
template <int kSteps>
__device__ __forceinline__ void to_fragments(const float (&acc)[8][4], const float* bias, int q,
                                             uint32_t (&af)[kSteps][4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int nt = 2 * s + h, col = 64 * q + 8 * nt + 2 * t;
      const float b0 = bias[col], b1 = bias[col + 1];
      af[4 * q + s][2 * h] = pack_relu(acc[nt][0], b0, acc[nt][1], b1);
      af[4 * q + s][2 * h + 1] = pack_relu(acc[nt][2], b0, acc[nt][3], b1);
    }
  }
}

// acc = 16 rows, A as kSteps k-steps of fragments, @ columns n0 .. n0 + 63 of the
// transposed weights wt (rows ldw apart), B fragments by ldmatrix.
template <int kSteps>
__device__ __forceinline__ void mma_from_regs(const uint32_t (&af)[kSteps][4], const bf16* wt,
                                              int ldw, int n0, float (&acc)[8][4]) {
  dlbt::zero_acc(acc);
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b0[2], b1[2];
      dlbt::load_b_ldm(b0, b1, wt, ldw, 16 * s, n0 + 16 * np);
      dlbt::mma_bf16(acc[2 * np], af[s], b0);
      dlbt::mma_bf16(acc[2 * np + 1], af[s], b1);
    }
  }
}

// One warp's centroid: the three layers over its first nv edge rows (valid ones,
// packed), ceil(nv / 16) row tiles, then the max over those rows of each of the
// block's columns of the last layer, plus b3, into row ci of out (c_out columns; the
// block's start at col0). kK = H1 / 16 = H2 / 16 (the k-steps of layers 2 and 3),
// kN3 = the block's columns of layer 3 / 64.
template <int kK, int kN3>
__device__ __forceinline__ void warp_mlp(const char* smem, const Weights& W, const bf16* edge,
                                         int nv, void* out, long long ci, int c_out, int col0,
                                         int out_bf16) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const auto h = [smem](size_t off) { return reinterpret_cast<const bf16*>(smem + off); };
  const auto f = [smem](size_t off) { return reinterpret_cast<const float*>(smem + off); };
  float mx[8 * kN3][2];  // the lane's max over its rows so far: n-tile j, columns 2t, 2t + 1
#pragma unroll
  for (int j = 0; j < 8 * kN3; ++j) mx[j][0] = mx[j][1] = neg_inf();
  for (int r0 = 0; r0 < nv; r0 += 16) {
    uint32_t a2[kK][4];
    {
      uint32_t a1[kK][4];
      uint32_t ae[1][4];  // the edge rows: one k-step
      dlbt::load_a_ldm(ae[0], edge, kEdgeLd, r0, 0);
#pragma unroll
      for (int q = 0; q < kK / 4; ++q) {
        float acc[8][4];
        mma_from_regs<1>(ae, h(W.w1), kEdgeLd, 64 * q, acc);
        to_fragments<kK>(acc, f(W.b1), q, a1);
      }
#pragma unroll
      for (int q = 0; q < kK / 4; ++q) {
        float acc[8][4];
        mma_from_regs<kK>(a1, h(W.w2), 16 * kK + kSkewH, 64 * q, acc);
        to_fragments<kK>(acc, f(W.b2), q, a2);
      }
    }
    const bool v0 = r0 + g < nv, v1 = r0 + g + 8 < nv;  // the packed rows past nv are stale
#pragma unroll
    for (int q = 0; q < kN3; ++q) {
      float acc[8][4];
      mma_from_regs<kK>(a2, h(W.w3), 16 * kK + kSkewH, 64 * q, acc);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          mx[8 * q + nt][e] = fmaxf(mx[8 * q + nt][e], fmaxf(v0 ? acc[nt][e] : neg_inf(),
                                                             v1 ? acc[nt][e + 2] : neg_inf()));
        }
      }
    }
  }
  const float* b3 = f(W.b3);
#pragma unroll
  for (int j = 0; j < 8 * kN3; ++j) {
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {  // over the 8 row pairs (lane bits 2..4)
      mx[j][0] = fmaxf(mx[j][0], __shfl_xor_sync(0xffffffffu, mx[j][0], off));
      mx[j][1] = fmaxf(mx[j][1], __shfl_xor_sync(0xffffffffu, mx[j][1], off));
    }
    if ((j & 7) == g) {  // every lane of a t holds the column's max: lane g writes n-tile j
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t + e;
        if (col0 + col < c_out) {
          store_out(out, ci * c_out + col0 + col, mx[j][e] + b3[col], out_bf16);
        }
      }
    }
  }
}

// Byte offsets of one group's buffers after the weights: its quad's bucket minima
// (kQuad x 128), the ballots of valid slots (two per centroid) and the edge rows
// (kQuad x 64, bf16, kEdgeLd apart).
struct Group {
  size_t first, ballot, edge, stride;
  __host__ __device__ Group() {
    size_t at = 0;
    first = take(at, 4ull * kQuad * kBuckets);
    ballot = take(at, 4ull * 2 * kQuad);
    edge = take(at, 2ull * kQuad * kSlots * kEdgeLd);
    stride = at;
  }
};

// The block's kN3 * 64 columns of layer 3 start at blockIdx.y * kN3 * 64. kSelectOnly:
// the selection and the capture alone, each row of the output the count of its
// centroid's valid slots (a measurement of the scan's share; no path runs it).
template <int kK, int kN3, bool kSelectOnly>
__global__ void __launch_bounds__(kGroups * kGroup, 1)
    sa1_eval_mma_kernel(const float* __restrict__ centers,
                        const unsigned char* __restrict__ cmask,
                        const float* __restrict__ planes, const unsigned char* __restrict__ mask,
                        const char* __restrict__ weights, void* __restrict__ out, int b, int m,
                        int n, int f, int c, int c_out, float r2, int out_bf16) {
  extern __shared__ __align__(16) char smem[];
  constexpr int kCols = 64 * kN3, kH = 16 * kK;
  const Weights W(true, kH, kH, kCols);  // the block's: W1, b1, W2, b2, its columns of W3, b3
  const Weights P(true, kH, kH, c);      // the packed block's
  const int col0 = blockIdx.y * kCols;
  const Group G;
  const int group = threadIdx.x / kGroup, tg = threadIdx.x % kGroup, bar = 1 + group;
  const int lane = tg & 31, warp = tg >> 5;
  char* const mine = smem + W.total + group * G.stride;
  int* const first = reinterpret_cast<int*>(mine + G.first);  // [kQuad][128]
  unsigned* const ballot = reinterpret_cast<unsigned*>(mine + G.ballot);
  bf16* const edge = reinterpret_cast<bf16*>(mine + G.edge);  // [kQuad][64][kEdgeLd]

  // once per block: W1, b1, W2 and b2 lie at the same offsets in both layouts
  copy_async(smem, weights, W.w3);
  copy_async(smem + W.w3, weights + P.w3 + 2ull * col0 * (kH + kSkewH), W.b3 - W.w3);
  load_weights(smem + W.b3, weights + P.b3 + 4ull * col0, W.total - W.b3);

  const int quads = (m + kQuad - 1) / kQuad;  // per cloud
  const long long total = static_cast<long long>(b) * quads;
  for (long long qi = static_cast<long long>(blockIdx.x) * kGroups + group; qi < total;
       qi += static_cast<long long>(gridDim.x) * kGroups) {
    const long long bi = qi / quads;
    const int m0 = static_cast<int>(qi - bi * quads) * kQuad;  // the quad's first centroid
    const float* px = planes + bi * (3 + f) * static_cast<long long>(n);
    const long long c0 = bi * m + m0;  // its index in centers and out
    float cen[kQuad][3];
    unsigned live = 0;
#pragma unroll
    for (int k = 0; k < kQuad; ++k) {
      const bool there = m0 + k < m;
#pragma unroll
      for (int d = 0; d < 3; ++d) cen[k][d] = there ? centers[3 * (c0 + k) + d] : 0.0f;
      if (there && cmask[c0 + k]) live |= 1u << k;
    }
    int fk[kQuad];
    dlbt::bucket_first_multi<kQuad, kScanDepth>(px, px + n, px + 2 * n, mask + bi * n, n, cen,
                                                r2, live, tg, fk);
#pragma unroll
    for (int k = 0; k < kQuad; ++k) first[k * kBuckets + tg] = fk[k];
    group_sync(bar);

    // slots (k, j) = (s / 64, s % 64), s = tg and tg + 128: the ballots of valid
    // ones, then each valid slot's edge row at its rank among its centroid's
    int sel[2];
    bool ok[2];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int s = tg + p * kGroup;
      sel[p] = dlbt::pair_select(first + (s / kSlots) * kBuckets, s % kSlots);
      ok[p] = sel[p] < n;
      const unsigned bits = __ballot_sync(0xffffffffu, ok[p]);
      if (lane == 0) ballot[s / 32] = bits;
    }
    group_sync(bar);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int s = tg + p * kGroup, k = s / kSlots;
      if (ok[p]) {
        const unsigned below = ballot[s / 32] & ((1u << lane) - 1u);
        const int row = __popc(below) + (s % kSlots >= 32 ? __popc(ballot[s / 32 - 1]) : 0);
        capture(edge + (k * kSlots + row) * kEdgeLd, px, n, f, sel[p], true, cen[k][0],
                cen[k][1], cen[k][2], kInMma);
      }
    }
    group_sync(bar);

    // warp k: centroid k of the quad
    if (m0 + warp >= m) continue;
    const int nv = __popc(ballot[2 * warp]) + __popc(ballot[2 * warp + 1]);
    if (kSelectOnly || nv == 0) {  // no valid slot (or a masked centroid): the row is 0
      for (int col = col0 + lane; col < min(c_out, col0 + kCols); col += 32) {
        store_out(out, (c0 + warp) * c_out + col, static_cast<float>(kSelectOnly ? nv : 0),
                  out_bf16);
      }
      continue;
    }
    warp_mlp<kK, kN3>(smem, W, edge + warp * kSlots * kEdgeLd, nv, out, c0 + warp, c_out, col0,
                      out_bf16);
  }
}

// ---- f32: CUDA-core FMAs --------------------------------------------------------

__device__ __forceinline__ float lane_of(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Thread (rg, cg) of the 16 x 8 thread grid: rows rg + 16 i (i < 4) and columns
// col0 + cg*4 + {0..3}, col0 + 32 + cg*4 + {0..3} of in (64 x in_dim, rows
// in_stride apart) @ w (in_dim x w_cols), summed over k in ascending order.
// tile_acc adds to acc what tile_dot sets it to (in may lie in shared or device memory).
__device__ __forceinline__ void tile_acc(const float* in, int in_stride, int in_dim,
                                         const float* __restrict__ w, int w_cols, int col0,
                                         int rg, int cg, float (&acc)[4][8]) {
  for (int k = 0; k < in_dim; k += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = *reinterpret_cast<const float4*>(in + (rg + 16 * i) * in_stride + k);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* wr = w + (k + kk) * w_cols + col0 + cg * 4;
      const float4 lo = *reinterpret_cast<const float4*>(wr);
      const float4 hi = *reinterpret_cast<const float4*>(wr + 32);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av = lane_of(a[i], kk);
        acc[i][0] = fmaf(av, lo.x, acc[i][0]);
        acc[i][1] = fmaf(av, lo.y, acc[i][1]);
        acc[i][2] = fmaf(av, lo.z, acc[i][2]);
        acc[i][3] = fmaf(av, lo.w, acc[i][3]);
        acc[i][4] = fmaf(av, hi.x, acc[i][4]);
        acc[i][5] = fmaf(av, hi.y, acc[i][5]);
        acc[i][6] = fmaf(av, hi.z, acc[i][6]);
        acc[i][7] = fmaf(av, hi.w, acc[i][7]);
      }
    }
  }
}

__device__ __forceinline__ void tile_dot(const float* __restrict__ in, int in_stride, int in_dim,
                                         const float* __restrict__ w, int w_cols, int col0,
                                         int rg, int cg, float (&acc)[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  tile_acc(in, in_stride, in_dim, w, w_cols, col0, rg, cg, acc);
}

__device__ __forceinline__ int tile_col(int col0, int cg, int j) {
  return col0 + (j < 4 ? cg * 4 + j : 32 + cg * 4 + (j - 4));
}

// Columns col0 .. col0 + 63 of relu(in @ w + bias), 64 rows, into out (rows out_stride
// apart): w's row k holds those columns from wcol on, w_cols apart.
__device__ __forceinline__ void hidden_block(const float* in, int in_stride, int in_dim,
                                             const float* w, int w_cols, int wcol,
                                             const float* bias, int col0, float* out,
                                             int out_stride, int rg, int cg) {
  float acc[4][8];
  tile_dot(in, in_stride, in_dim, w, w_cols, wcol, rg, cg, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = fmaxf(acc[i][j] + bias[tile_col(col0, cg, j)], 0.0f);
    float* o = out + (rg + 16 * i) * out_stride + col0 + cg * 4;
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(o + 32) = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// Columns col0 .. col0 + 63 of the last layer (w as in hidden_block): red[warp * c +
// col] = the warp's max of in @ w + b3 over its valid rows.
__device__ __forceinline__ void last_block(const float* in, int in_stride, int in_dim,
                                           const float* w, int w_cols, int wcol, const float* b3,
                                           int col0, const int* valid, float* red, int c, int rg,
                                           int cg) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[4][8];
  tile_dot(in, in_stride, in_dim, w, w_cols, wcol, rg, cg, acc);
  float mx[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float bias = b3[tile_col(col0, cg, j)];
    mx[j] = neg_inf();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (valid[rg + 16 * i]) mx[j] = fmaxf(mx[j], acc[i][j] + bias);
    }
    // the warp's 4 row groups differ in lane bits 3 and 4
    mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 8));
    mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 16));
  }
  if (lane < 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j) red[warp * c + tile_col(col0, cg, j)] = mx[j];
  }
}

// Byte offsets of the f32 kernel's shared memory. Resident (the whole weight block
// first, as packed): the weights, then the edge rows, a1, a2 (rows (width + 4) floats
// apart), the warps' column maxima, the slots' flags and the bucket minima. Streamed:
// w1, b1, b2, b3, two buffers of 64 columns of W2 or W3 (max(H1, H2) rows of 64
// floats), then the same.
struct Fma {
  size_t w1, b1, b2, b3, buf0, buf1, edge, a1, a2, red, valid, first, total;
  __host__ __device__ Fma(int h1, int h2, int c, bool stream) {
    size_t at = 0;
    if (stream) {
      w1 = take(at, 4ull * kInPad * h1);
      b1 = take(at, 4ull * h1);
      b2 = take(at, 4ull * h2);
      b3 = take(at, 4ull * c);
      buf0 = take(at, 4ull * (h1 > h2 ? h1 : h2) * 64);
      buf1 = take(at, 4ull * (h1 > h2 ? h1 : h2) * 64);
    } else {
      const Weights W(false, h1, h2, c);
      w1 = W.w1, b1 = W.b1, b2 = W.b2, b3 = W.b3, buf0 = buf1 = 0;
      at = W.total;
    }
    edge = take(at, 4ull * kSlots * (kInPad + kSkew));
    a1 = take(at, 4ull * kSlots * (h1 + kSkew));
    a2 = take(at, 4ull * kSlots * (h2 + kSkew));
    red = take(at, 4ull * kGroupWarps * c);
    valid = take(at, 4ull * kSlots);
    first = take(at, 4ull * kBuckets);
    total = at;
  }
};

// The three layers in f32 on a resident weight block; red[warp * c + col] = the
// warp's max over its valid rows.
__device__ void fma_mlp(char* smem, const Weights& W, const Fma& L, const int* valid, float* red,
                        int h1, int h2, int c) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cg = lane & 7, rg = warp * 4 + (lane >> 3);
  const auto at = [smem](size_t off) { return reinterpret_cast<float*>(smem + off); };
  for (int col0 = 0; col0 < h1; col0 += 64) {
    hidden_block(at(L.edge), kInPad + kSkew, kInPad, at(W.w1), h1, col0, at(W.b1), col0,
                 at(L.a1), h1 + kSkew, rg, cg);
  }
  __syncthreads();
  for (int col0 = 0; col0 < h2; col0 += 64) {
    hidden_block(at(L.a1), h1 + kSkew, h1, at(W.w2), h2, col0, at(W.b2), col0, at(L.a2),
                 h2 + kSkew, rg, cg);
  }
  __syncthreads();
  for (int col0 = 0; col0 < c; col0 += 64) {
    last_block(at(L.a2), h2 + kSkew, h2, at(W.w3), c, col0, at(W.b3), col0, valid, red, c, rg,
               cg);
  }
}

// Starts the copy of chunk j of the streamed weights into buf: j < H2 / 64 the 64
// columns of W2 from 64 j (H1 rows), after them those of W3 (H2 rows), from the
// packed block w (layout P).
__device__ __forceinline__ void stream_chunk(float* buf, const char* w, const Weights& P, int j,
                                             int h1, int h2, int c) {
  const bool second = j >= h2 / 64;
  const int rows = second ? h2 : h1, cols = second ? c : h2;
  const int col0 = 64 * (second ? j - h2 / 64 : j);
  const float* src = reinterpret_cast<const float*>(w + (second ? P.w3 : P.w2)) + col0;
  for (int i = threadIdx.x; i < rows * 16; i += blockDim.x) {  // 16 pieces of 16 bytes a row
    const int k = i / 16, q = i % 16;
    dlbt::cp_async16(buf + 64 * k + 4 * q, src + static_cast<size_t>(k) * cols + 4 * q);
  }
  dlbt::cp_async_commit();
}

// The three layers in f32 with W2 and W3 streamed 64 columns at a time through two
// buffers; the same sums and maxima as fma_mlp.
__device__ void fma_mlp_stream(char* smem, const char* w, const Weights& P, const Fma& L,
                               const int* valid, float* red, int h1, int h2, int c) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cg = lane & 7, rg = warp * 4 + (lane >> 3);
  const auto at = [smem](size_t off) { return reinterpret_cast<float*>(smem + off); };
  const int n2 = h2 / 64, chunks = n2 + c / 64;
  stream_chunk(at(L.buf0), w, P, 0, h1, h2, c);
  for (int col0 = 0; col0 < h1; col0 += 64) {
    hidden_block(at(L.edge), kInPad + kSkew, kInPad, at(L.w1), h1, col0, at(L.b1), col0,
                 at(L.a1), h1 + kSkew, rg, cg);
  }
  for (int j = 0; j < chunks; ++j) {
    if (j + 1 < chunks) {  // the next chunk into the buffer the last pass freed
      stream_chunk(at((j + 1) & 1 ? L.buf1 : L.buf0), w, P, j + 1, h1, h2, c);
      dlbt::cp_async_wait<1>();
    } else {
      dlbt::cp_async_wait<0>();
    }
    __syncthreads();  // chunk j in place; a1 (j = 0) or a2 (j = n2) complete
    const float* buf = at(j & 1 ? L.buf1 : L.buf0);
    if (j < n2) {
      hidden_block(at(L.a1), h1 + kSkew, h1, buf, 64, 0, at(L.b2), 64 * j, at(L.a2),
                   h2 + kSkew, rg, cg);
    } else {
      last_block(at(L.a2), h2 + kSkew, h2, buf, 64, 0, at(L.b3), 64 * (j - n2), valid,
                 red, c, rg, cg);
    }
    __syncthreads();  // before the buffer is filled again
  }
}

template <bool kStream>
__global__ void __launch_bounds__(kGroup)
    sa1_eval_fma_kernel(const float* __restrict__ centers,
                        const unsigned char* __restrict__ cmask,
                        const float* __restrict__ planes, const unsigned char* __restrict__ mask,
                        const char* __restrict__ weights, void* __restrict__ out, int b, int m,
                        int n, int f, int h1, int h2, int c, int c_out, float r2, int out_bf16) {
  extern __shared__ __align__(16) char smem[];
  const Weights W(false, h1, h2, c);  // the packed block's layout (resident: also the block's)
  const Fma L(h1, h2, c, kStream);
  float* const edge = reinterpret_cast<float*>(smem + L.edge);
  float* const red = reinterpret_cast<float*>(smem + L.red);
  int* const valid = reinterpret_cast<int*>(smem + L.valid);
  int* const first = reinterpret_cast<int*>(smem + L.first);
  const int tid = threadIdx.x;

  if (kStream) {  // once per block: w1 and b1 (contiguous in the packed block), b2, b3
    copy_async(smem + L.w1, weights + W.w1, W.w2 - W.w1);
    copy_async(smem + L.b2, weights + W.b2, W.w3 - W.b2);
    load_weights(smem + L.b3, weights + W.b3, W.total - W.b3);
  } else {
    load_weights(smem, weights, W.total);
  }

  const long long total = static_cast<long long>(b) * m;
  for (long long ci = blockIdx.x; ci < total; ci += gridDim.x) {
    const long long bi = ci / m;
    const float* px = planes + bi * (3 + f) * static_cast<long long>(n);
    const float cx = centers[3 * ci], cy = centers[3 * ci + 1], cz = centers[3 * ci + 2];
    first[tid] = cmask[ci] ? dlbt::bucket_first(px, px + n, px + 2 * n, mask + bi * n, n, cx, cy,
                                                cz, r2, tid)
                           : n;
    __syncthreads();
    bool ok = false;
    if (tid < kSlots) {
      const int sel = dlbt::pair_select(first, tid);
      ok = sel < n;
      capture(edge + tid * (kInPad + kSkew), px, n, f, sel, ok, cx, cy, cz, kInPad);
      valid[tid] = ok;
    }
    if (!__syncthreads_or(ok)) {  // no valid slot (or a masked centroid): the row is 0
      for (int col = tid; col < c_out; col += kGroup) {
        store_out(out, ci * c_out + col, 0.0f, out_bf16);
      }
      continue;
    }
    if (kStream) {
      fma_mlp_stream(smem, weights, W, L, valid, red, h1, h2, c);
    } else {
      fma_mlp(smem, W, L, valid, red, h1, h2, c);
    }
    __syncthreads();
    for (int col = tid; col < c_out; col += kGroup) {
      float v = red[col];
#pragma unroll
      for (int w = 1; w < kGroupWarps; ++w) v = fmaxf(v, red[w * c + col]);
      store_out(out, ci * c_out + col, v, out_bf16);
    }
  }
}

// ---- wide: any widths and inputs, the weights streamed in tiles -----------------

constexpr int kTile = 64;                // a weight tile: 64 output columns, at most 64 deep
constexpr int kTileLd = kTile + kSkewH;  // bf16 tile rows (an output column each) 72 apart

// Byte offsets of the wide kernel's shared memory: the bucket minima, the slots' flags,
// the edge rows (64 rows, D1 + skew apart), the warps' maxima of a 64-column chunk, two
// weight tiles, then a1 and a2 (64 rows, width + skew apart) unless they go to the
// block's slice of the scratch tensor (slice: its bytes, 0 where they stay here).
struct Wide {
  size_t first, valid, edge, red, tile0, tile1, a1, a2, total, slice;
  __host__ __device__ Wide(bool bf16, int d1, int h1, int h2, bool scratch) {
    const size_t e = bf16 ? 2 : 4, skew = bf16 ? kSkewH : kSkew;
    size_t at = 0, s = 0;
    first = take(at, 4ull * kBuckets);
    valid = take(at, 4ull * kSlots);
    edge = take(at, e * kSlots * (d1 + skew));
    red = take(at, 4ull * kGroupWarps * kTile);
    const size_t tile = bf16 ? 2ull * kTile * kTileLd : 4ull * kTile * kTile;
    tile0 = take(at, tile);
    tile1 = take(at, tile);
    size_t& acts = scratch ? s : at;
    a1 = take(acts, e * kSlots * (h1 + skew));
    a2 = take(acts, e * kSlots * (h2 + skew));
    total = at;
    slice = s;
  }
};

// Tile t of a centroid's stream: the layers in order, each layer's 64-column chunks in
// order, each chunk's depths in steps of 64 (kd of them from k0).
struct TileAt {
  int layer, n0, k0, kd;
  bool last_k;  // the chunk's last tile: its columns are complete after it
};

__device__ __forceinline__ TileAt tile_at(int t, const int (&kdim)[3], const int (&ndim)[3]) {
  TileAt a{2, 0, 0, 0, false};
  for (int l = 0; l < 3; ++l) {
    const int kt = (kdim[l] + kTile - 1) / kTile, count = kt * (ndim[l] / kTile);
    if (t < count) {
      a.layer = l;
      a.n0 = t / kt * kTile;
      a.k0 = t % kt * kTile;
      a.kd = min(kTile, kdim[l] - a.k0);
      a.last_k = t % kt == kt - 1;
      return a;
    }
    t -= count;
  }
  return a;
}

// Starts the cp.async copy of tile a of the packed block w (layout P) into dst, as one
// group. bf16: W^T rows n0.. (a row an output column, kdim + 8 values apart), depths
// k0..k0+kd-1, into rows kTileLd apart; f32: w rows k0..k0+kd-1 (ndim apart), columns
// n0..n0+63, into rows 64 apart.
template <bool kBf16>
__device__ __forceinline__ void copy_tile(char* dst, const char* w, const Weights& P,
                                          const TileAt& a, const int (&kdim)[3],
                                          const int (&ndim)[3]) {
  const size_t off = a.layer == 0 ? P.w1 : a.layer == 1 ? P.w2 : P.w3;
  if constexpr (kBf16) {
    const int ld = kdim[a.layer] + kSkewH, pieces = a.kd / 8;  // 16 bytes a piece
    const bf16* src =
        reinterpret_cast<const bf16*>(w + off) + static_cast<size_t>(a.n0) * ld + a.k0;
    bf16* d = reinterpret_cast<bf16*>(dst);
    for (int i = threadIdx.x; i < kTile * pieces; i += blockDim.x) {
      const int r = i / pieces, q = i % pieces;
      dlbt::cp_async16(d + r * kTileLd + 8 * q, src + static_cast<size_t>(r) * ld + 8 * q);
    }
  } else {
    const int ld = ndim[a.layer];
    const float* src =
        reinterpret_cast<const float*>(w + off) + static_cast<size_t>(a.k0) * ld + a.n0;
    float* d = reinterpret_cast<float*>(dst);
    for (int i = threadIdx.x; i < a.kd * 16; i += blockDim.x) {
      const int r = i / 16, q = i % 16;
      dlbt::cp_async16(d + r * kTile + 4 * q, src + static_cast<size_t>(r) * ld + 4 * q);
    }
  }
  dlbt::cp_async_commit();
}

// The A fragment of rows r0..r0+15, depths k0..k0+15 of a (rows lda apart), by 32-bit
// loads: a may lie in shared or device memory.
__device__ __forceinline__ void load_a_any(uint32_t (&af)[4], const bf16* a, int lda, int r0,
                                           int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf16* p = a + static_cast<size_t>(r0 + g) * lda + k0 + 2 * t;
  af[0] = dlbt::ld32(p);
  af[1] = dlbt::ld32(p + 8 * lda);
  af[2] = dlbt::ld32(p + 8);
  af[3] = dlbt::ld32(p + 8 * lda + 8);
}

// bf16: warp w's rows 16w..16w+15; acc[nt] holds columns n0 + 8 nt + 2t, + 1 of rows g
// and g + 8 (the mma C fragment).
__device__ __forceinline__ void wide_acc(const bf16* a, int lda, const TileAt& at,
                                         const char* tile, float (&acc)[8][4]) {
  const int r0 = 16 * (threadIdx.x >> 5);
  const bf16* wt = reinterpret_cast<const bf16*>(tile);
  for (int s = 0; s < at.kd / 16; ++s) {
    uint32_t af[4];
    load_a_any(af, a, lda, r0, at.k0 + 16 * s);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b0[2], b1[2];
      dlbt::load_b_ldm(b0, b1, wt, kTileLd, 16 * s, 16 * np);
      dlbt::mma_bf16(acc[2 * np], af, b0);
      dlbt::mma_bf16(acc[2 * np + 1], af, b1);
    }
  }
}

// f32: thread (rg, cg) of the 16 x 8 grid, rows rg + 16 i, columns tile_col(n0, cg, j).
__device__ __forceinline__ void wide_acc(const float* a, int lda, const TileAt& at,
                                         const char* tile, float (&acc)[4][8]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  tile_acc(a + at.k0, lda, at.kd, reinterpret_cast<const float*>(tile), kTile, 0,
           warp * 4 + (lane >> 3), lane & 7, acc);
}

// A hidden layer's chunk: relu(acc + bias), rounded to the compute type, into columns
// n0..n0+63 of out (rows ldo apart).
__device__ __forceinline__ void wide_hidden(const float (&acc)[8][4], const float* bias, int n0,
                                            bf16* out, int ldo) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r = 16 * (threadIdx.x >> 5) + g;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = n0 + 8 * nt + 2 * t;
    const float b0 = bias[col], b1 = bias[col + 1];
    *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(r) * ldo + col) =
        pack_relu(acc[nt][0], b0, acc[nt][1], b1);
    *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(r + 8) * ldo + col) =
        pack_relu(acc[nt][2], b0, acc[nt][3], b1);
  }
}

__device__ __forceinline__ void wide_hidden(const float (&acc)[4][8], const float* bias, int n0,
                                            float* out, int ldo) {
  const int lane = threadIdx.x & 31, cg = lane & 7, rg = (threadIdx.x >> 5) * 4 + (lane >> 3);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = fmaxf(acc[i][j] + bias[tile_col(n0, cg, j)], 0.0f);
    float* o = out + static_cast<size_t>(rg + 16 * i) * ldo + n0 + cg * 4;
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(o + 32) = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// Layer 3's chunk: red[warp * 64 + col] = the warp's max of its valid rows' acc.
__device__ __forceinline__ void wide_last(const float (&acc)[8][4], const int* valid, float* red) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, warp = threadIdx.x >> 5;
  const bool v0 = valid[16 * warp + g], v1 = valid[16 * warp + g + 8];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float mx = fmaxf(v0 ? acc[nt][e] : neg_inf(), v1 ? acc[nt][e + 2] : neg_inf());
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {  // over the 8 row pairs (lane bits 2..4)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      if (g == 0) red[warp * kTile + 8 * nt + 2 * t + e] = mx;
    }
  }
}

__device__ __forceinline__ void wide_last(const float (&acc)[4][8], const int* valid, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, cg = lane & 7;
  const int rg = warp * 4 + (lane >> 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float mx = neg_inf();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (valid[rg + 16 * i]) mx = fmaxf(mx, acc[i][j]);
    }
    // the warp's 4 row groups differ in lane bits 3 and 4
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
    if (lane < 8) red[warp * kTile + tile_col(0, cg, j)] = mx;
  }
}

// One centroid a block at a time; a1 and a2 in shared memory, or (kScratch) in the
// block's slice of scratch. The last layer's bias is added after the max: max(h + b) =
// max(h) + b, rounding being monotone.
template <bool kBf16, bool kScratch>
__global__ void __launch_bounds__(kGroup)
    sa1_eval_wide_kernel(const float* __restrict__ centers,
                         const unsigned char* __restrict__ cmask,
                         const float* __restrict__ planes, const unsigned char* __restrict__ mask,
                         const char* __restrict__ weights, void* __restrict__ out, char* scratch,
                         int b, int m, int n, int f, int h1, int h2, int c, int c_out, float r2,
                         int out_bf16) {
  using T = std::conditional_t<kBf16, bf16, float>;
  constexpr int kSkewT = kBf16 ? kSkewH : kSkew;
  extern __shared__ __align__(16) char smem[];
  const int d1 = in_depth(f, kBf16);
  const Weights P(kBf16, h1, h2, c, d1);
  const Wide L(kBf16, d1, h1, h2, kScratch);
  const int kdim[3] = {d1, h1, h2}, ndim[3] = {h1, h2, c};
  const int lda[3] = {d1 + kSkewT, h1 + kSkewT, h2 + kSkewT};
  char* const acts = kScratch ? scratch + blockIdx.x * L.slice : smem;
  T* const edge = reinterpret_cast<T*>(smem + L.edge);
  T* const act[2] = {reinterpret_cast<T*>(acts + L.a1), reinterpret_cast<T*>(acts + L.a2)};
  float* const red = reinterpret_cast<float*>(smem + L.red);
  int* const valid = reinterpret_cast<int*>(smem + L.valid);
  int* const first = reinterpret_cast<int*>(smem + L.first);
  char* const tiles[2] = {smem + L.tile0, smem + L.tile1};
  const float* const bias[3] = {reinterpret_cast<const float*>(weights + P.b1),
                                reinterpret_cast<const float*>(weights + P.b2),
                                reinterpret_cast<const float*>(weights + P.b3)};
  const int tid = threadIdx.x;
  int count = 0;
  for (int l = 0; l < 3; ++l) count += (kdim[l] + kTile - 1) / kTile * (ndim[l] / kTile);

  const long long total = static_cast<long long>(b) * m;
  for (long long ci = blockIdx.x; ci < total; ci += gridDim.x) {
    const long long bi = ci / m;
    const float* px = planes + bi * (3 + f) * static_cast<long long>(n);
    const float cx = centers[3 * ci], cy = centers[3 * ci + 1], cz = centers[3 * ci + 2];
    first[tid] = cmask[ci] ? dlbt::bucket_first(px, px + n, px + 2 * n, mask + bi * n, n, cx, cy,
                                                cz, r2, tid)
                           : n;
    __syncthreads();
    bool ok = false;
    if (tid < kSlots) {
      const int sel = dlbt::pair_select(first, tid);
      ok = sel < n;
      capture(edge + tid * lda[0], px, n, f, sel, ok, cx, cy, cz, d1);
      valid[tid] = ok;
    }
    if (!__syncthreads_or(ok)) {  // no valid slot (or a masked centroid): the row is 0
      for (int col = tid; col < c_out; col += kGroup) {
        store_out(out, ci * c_out + col, 0.0f, out_bf16);
      }
      continue;
    }
    float acc[kBf16 ? 8 : 4][kBf16 ? 4 : 8];
    copy_tile<kBf16>(tiles[0], weights, P, tile_at(0, kdim, ndim), kdim, ndim);
    for (int t = 0; t < count; ++t) {
      const TileAt at = tile_at(t, kdim, ndim);
      if (t + 1 < count) {  // the next tile into the buffer the last one freed
        copy_tile<kBf16>(tiles[(t + 1) & 1], weights, P, tile_at(t + 1, kdim, ndim), kdim, ndim);
        dlbt::cp_async_wait<1>();
      } else {
        dlbt::cp_async_wait<0>();
      }
      __syncthreads();  // tile t in place; the layer before complete
      if (at.k0 == 0) {
#pragma unroll
        for (auto& row : acc) {
#pragma unroll
          for (float& v : row) v = 0.0f;
        }
      }
      wide_acc(at.layer == 0 ? edge : act[at.layer - 1], lda[at.layer], at, tiles[t & 1], acc);
      if (at.last_k && at.layer < 2) {
        wide_hidden(acc, bias[at.layer], at.n0, act[at.layer], lda[at.layer + 1]);
      } else if (at.last_k) {
        wide_last(acc, valid, red);
        __syncthreads();
        if (tid < kTile && at.n0 + tid < c_out) {
          float v = red[tid];
#pragma unroll
          for (int w = 1; w < kGroupWarps; ++w) v = fmaxf(v, red[w * kTile + tid]);
          store_out(out, ci * c_out + at.n0 + tid, v + bias[2][at.n0 + tid], out_bf16);
        }
      }
      __syncthreads();  // before the buffer, or red, is filled again
    }
  }
}

// ---- launch ----------------------------------------------------------------------

using Kernel = void (*)(const float*, const unsigned char*, const float*, const unsigned char*,
                        const char*, void*, int, int, int, int, int, int, float, int);
using FmaKernel = void (*)(const float*, const unsigned char*, const float*, const unsigned char*,
                           const char*, void*, int, int, int, int, int, int, int, int, float, int);

// The launch of these widths (sa_eval_kernel.plan mirrors it): kind 0 none, 1 the
// bf16 kernel (layer 3's columns in col_groups over gridDim.y), 2 the f32 kernel on a
// resident weight block, 3 the f32 kernel with W2 and W3 streamed, 4 the wide kernel
// (scratch: a1 and a2 in device memory, slice bytes a block); smem its shared memory,
// which must fit max_smem.
struct Plan {
  int kind = 0, col_groups = 1;
  bool scratch = false;
  size_t smem = 0, slice = 0;
};

Plan plan_of(int f, int h1, int h2, int c, int c_out, int bf16, size_t max_smem) {
  Plan p;
  if (f < 0 || c <= 0 || c % 64 || c_out < 0 || c_out > c || h1 <= 0 || h2 <= 0 || h1 % 64 ||
      h2 % 64) {
    return p;
  }
  const int d1 = in_depth(f, bf16);
  if (bf16 && d1 == kInMma && h2 == h1 && c == 2 * h1 && (h1 == 64 || h1 == 128 || h1 == 192)) {
    const int groups = h1 == 192 ? 2 : 1;
    const size_t smem = Weights(true, h1, h2, c / groups).total + kGroups * Group().stride;
    if (smem <= max_smem) {
      p.kind = 1;
      p.col_groups = groups;
      p.smem = smem;
      return p;
    }
  }
  if (!bf16 && d1 == kInPad && Fma(h1, h2, c, false).total <= max_smem) {
    p.kind = 2;
    p.smem = Fma(h1, h2, c, false).total;
    return p;
  }
  if (!bf16 && d1 == kInPad && Fma(h1, h2, c, true).total <= max_smem) {
    p.kind = 3;
    p.smem = Fma(h1, h2, c, true).total;
    return p;
  }
  p.scratch = Wide(bf16, d1, h1, h2, false).total > max_smem;
  const Wide L(bf16, d1, h1, h2, p.scratch);
  p.smem = L.total;
  p.slice = L.slice;
  p.kind = p.smem <= max_smem ? 4 : 0;
  return p;
}

// The bf16 kernel of these widths: SA1's at neuron_multiplier 1, 2 and 3; the
// selection-only one at the first.
template <bool kSelectOnly>
Kernel mma_kernel(int h) {
  if (kSelectOnly) return sa1_eval_mma_kernel<4, 2, true>;
  if (h == 64) return sa1_eval_mma_kernel<4, 2, false>;
  return h == 128 ? sa1_eval_mma_kernel<8, 4, false> : sa1_eval_mma_kernel<12, 3, false>;
}

FmaKernel fma_kernel(const Plan& p) {
  return p.kind == 2 ? sa1_eval_fma_kernel<false> : sa1_eval_fma_kernel<true>;
}

using WideKernel = void (*)(const float*, const unsigned char*, const float*,
                            const unsigned char*, const char*, void*, char*, int, int, int, int,
                            int, int, int, int, float, int);

WideKernel wide_kernel(const Plan& p, int bf16) {
  if (bf16) return p.scratch ? sa1_eval_wide_kernel<true, true> : sa1_eval_wide_kernel<true, false>;
  return p.scratch ? sa1_eval_wide_kernel<false, true> : sa1_eval_wide_kernel<false, false>;
}

template <bool kSelectOnly>
const void* kernel_of(const Plan& p, int h1, int bf16) {
  if (p.kind == 1) return reinterpret_cast<const void*>(mma_kernel<kSelectOnly>(h1));
  if (p.kind == 4) return reinterpret_cast<const void*>(wide_kernel(p, bf16));
  return reinterpret_cast<const void*>(fma_kernel(p));
}

// The card's SMs and the shared memory a block may opt in to.
cudaError_t card(int* sms, size_t* max_smem) {
  int dev = 0, smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  *max_smem = static_cast<size_t>(smem);
  return e;
}

// Opts the kernel in to smem bytes of shared memory; *per_sm its blocks one SM holds
// at once with `threads` each.
cudaError_t prepare(const void* kernel, size_t smem, int threads, int* per_sm) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, smem);
  }
  return e;
}

int threads_of(const Plan& p) { return p.kind == 1 ? kGroups * kGroup : kGroup; }

// The grid of a launch: every SM's blocks (per_sm), at most one block a centroid (for
// the bf16 kernel a group a quad, over its column groups), and where a1 and a2 go to
// scratch at most max_grid blocks.
long long grid_of(const Plan& p, int sms, int per_sm, int b, int m, int max_grid) {
  long long grid = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (p.kind == 1) {  // the column groups run side by side, each over every quad
    grid = grid / p.col_groups > 0 ? grid / p.col_groups : 1;
    const long long quads = b * static_cast<long long>((m + kQuad - 1) / kQuad);
    return grid < (quads + kGroups - 1) / kGroups ? grid : (quads + kGroups - 1) / kGroups;
  }
  const long long total = static_cast<long long>(b) * m;
  if (p.kind == 4 && p.scratch && grid > max_grid) grid = max_grid;
  return grid < total ? grid : total;
}

template <bool kSelectOnly>
int launch(const void* centers, const void* cmask, const void* planes, const void* mask,
           const void* weights, void* out, void* scratch, long long scratch_bytes, int b, int m,
           int n, int f, int h1, int h2, int c, int c_out, float r2, int bf16, int out_bf16,
           int max_grid, void* stream) {
  int sms = 0, per_sm = 0;
  size_t max_smem = 0;
  cudaError_t e = card(&sms, &max_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Plan p = plan_of(f, h1, h2, c, c_out, bf16, max_smem);
  if (p.kind == 0 || (kSelectOnly && (p.kind != 1 || out_bf16 || h1 != 64)) ||
      reinterpret_cast<uintptr_t>(weights) % 16 || max_grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total = static_cast<long long>(b) * m;
  if (total == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* cen = static_cast<const float*>(centers);
  const auto* cm = static_cast<const unsigned char*>(cmask);
  const auto* pl = static_cast<const float*>(planes);
  const auto* mk = static_cast<const unsigned char*>(mask);
  const auto* w = static_cast<const char*>(weights);
  e = prepare(kernel_of<kSelectOnly>(p, h1, bf16), p.smem, threads_of(p), &per_sm);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long grid = grid_of(p, sms, per_sm, b, m, max_grid);
  if (p.kind == 1) {
    const dim3 blocks(static_cast<unsigned>(grid), p.col_groups);
    mma_kernel<kSelectOnly>(h1)<<<blocks, threads_of(p), p.smem, s>>>(cen, cm, pl, mk, w, out, b,
                                                                       m, n, f, c, c_out, r2,
                                                                       out_bf16);
  } else if (p.kind == 4) {
    if (p.scratch && (scratch == nullptr || reinterpret_cast<uintptr_t>(scratch) % 16 ||
                      scratch_bytes < grid * static_cast<long long>(p.slice))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    wide_kernel(p, bf16)<<<static_cast<unsigned>(grid), kGroup, p.smem, s>>>(
        cen, cm, pl, mk, w, out, static_cast<char*>(scratch), b, m, n, f, h1, h2, c, c_out, r2,
        out_bf16);
  } else {
    fma_kernel(p)<<<static_cast<unsigned>(grid), kGroup, p.smem, s>>>(
        cen, cm, pl, mk, w, out, b, m, n, f, h1, h2, c, c_out, r2, out_bf16);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// centers (B, M, 3) f32, cmask (B, M) bool, planes (B, 3+F, N) f32 [x, y, z, features],
// mask (B, N) bool, weights the weight block (Weights at D1 = in_depth(F); bf16 != 0: the
// bf16 layout, else the f32 one), 16-byte aligned -> out (B, M, c_out) bf16 (out_bf16 !=
// 0) or f32. H1, H2 and C are multiples of 64 (zero-padded by the caller), c_out <= C.
// Where plan_of puts a1 and a2 in scratch, scratch holds scratch_bytes (at least
// dlbt_sa1_fused_eval_launch's slice bytes times its grid, which max_grid caps).
extern "C" int dlbt_sa1_fused_eval(const void* centers, const void* cmask, const void* planes,
                                   const void* mask, const void* weights, void* out,
                                   void* scratch, long long scratch_bytes, int b, int m, int n,
                                   int f, int h1, int h2, int c, int c_out, float r2, int bf16,
                                   int out_bf16, int max_grid, void* stream) {
  return launch<false>(centers, cmask, planes, mask, weights, out, scratch, scratch_bytes, b, m,
                       n, f, h1, h2, c, c_out, r2, bf16, out_bf16, max_grid, stream);
}

// The bf16 kernel's selection and capture alone, with dlbt_sa1_fused_eval's arguments
// at the production widths (out f32: each row the count of its centroid's valid
// slots, 0 where none; the weight block copied, not read): a measurement of the
// scan's share, which no path launches.
extern "C" int dlbt_sa1_fused_eval_select(const void* centers, const void* cmask,
                                          const void* planes, const void* mask,
                                          const void* weights, void* out, void* scratch,
                                          long long scratch_bytes, int b, int m, int n, int f,
                                          int h1, int h2, int c, int c_out, float r2, int bf16,
                                          int out_bf16, int max_grid, void* stream) {
  return launch<true>(centers, cmask, planes, mask, weights, out, scratch, scratch_bytes, b, m,
                      n, f, h1, h2, c, c_out, r2, bf16, out_bf16, max_grid, stream);
}

// A host query: the launch of dlbt_sa1_fused_eval at these widths and F on the current
// card: its kind (1 bf16, 2 f32 resident, 3 f32 streamed, 4 wide), column groups
// (gridDim.y), threads and shared memory per block, the blocks one SM holds at once
// (*per_sm), the scratch bytes a block (*slice, 0 where a1 and a2 stay in shared
// memory), and the kernel's registers a thread and local memory a thread (the build's
// spill) as cudaFuncGetAttributes reports them.
extern "C" int dlbt_sa1_fused_eval_occupancy(int f, int bf16, int h1, int h2, int c, int* kind,
                                             int* col_groups, int* per_sm, int* threads,
                                             int* smem_bytes, int* slice, int* regs,
                                             int* local_bytes) {
  *kind = *col_groups = *per_sm = *threads = *smem_bytes = *slice = *regs = *local_bytes = 0;
  int sms = 0;
  size_t max_smem = 0;
  cudaError_t e = card(&sms, &max_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Plan p = plan_of(f, h1, h2, c, c, bf16, max_smem);
  if (p.kind == 0) return static_cast<int>(cudaErrorInvalidValue);
  *kind = p.kind;
  *col_groups = p.col_groups;
  *threads = threads_of(p);
  *smem_bytes = static_cast<int>(p.smem);
  *slice = static_cast<int>(p.slice);
  const void* k = kernel_of<false>(p, h1, bf16);
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, k);
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(prepare(k, p.smem, *threads, per_sm));
}
