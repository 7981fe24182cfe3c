// Kernel 7: the fused tail of an SA layer, forward and backward. Forward: the
// last Linear of the edge MLP and the masked max over the 64 neighbour slots,
// z = bf16(bf16(a2) bf16(W3) [f32 sum] + b3), out = max over the valid slots,
// with the first slot that holds the max. Backward: the cotangent routed to
// that slot and contracted at once into da2 and dW3. The (B, M, 64, C3) tensor
// z and its cotangent never reach device memory.
//
// Replaces: dl_biomass_tpu/ops/pallas_tail.py fused_tail (_fwd_kernel, _bwd_kernel).
// Semantics of the forward: masking is a true select, where(valid, z, -inf), so
// NaN or Inf junk in a2 at an invalid slot never leaks; the max is over the
// bf16 values and propagates NaN; the argmax is the smallest slot whose value
// equals the max (-0.0 and +0.0 equal), and 64 where none does (a NaN max) or
// the max is -inf (no valid slot); the output is 0 where no slot is valid.
// Backward: gs holds gb (the cotangent in bf16) at row amax[c] of column c (nothing for
// 64); da2 = bf16(gs W3^T) and dW3 = a2^T gs with f32 sums, which the TPU kernel
// takes densely over the 64 slots. Here only the routed terms are formed, and
// what the dense sums make of non-finite values is added back: 0 x NaN and
// 0 x Inf are NaN, so a non-finite a2 value at a slot that column c does not
// route to makes dW3[:, c] NaN on that feature, and a non-finite bf16(W3)
// value of a column routed to another slot (or to none) makes that feature of
// a slot's da2 NaN. da2 and dW3 are thus non-finite exactly where the dense
// sums are. db3 is summed from the f32 cotangent outside the kernel.
//
// Bound on the H100: bytes. The forward reads a2 once (B*M*64*C2 bf16: 604 MB
// at SA1's 36 x 2048 x 64 x 64) and the mask, and writes (B, M, C3) bf16; its
// 2*B*M*64*C2*C3 flop (77.3 G at SA1) take 0.078 ms on the bf16 tensor cores
// against 0.187 ms of bytes. The backward reads a2, the argmax and the
// cotangent once and writes da2 (1.26 GB at SA1, 0.378 ms); its routed work,
// 4*C2 flop per routed column (2.4 GFLOP at SA1, 0.036 ms at the f32 rate), is
// about 2 flop a byte: a streaming pass, on the CUDA cores, no tensor cores.
//
// Design: the forward, redesigned for the H100: a persistent grid; each block keeps
// a ring of `stages` centroids in shared memory (a2's 64 rows and the 64 slot
// flags), copied by cp.async stages - 1 centroids ahead, one barrier a
// centroid. Two launches (ops/tail_kernel.plan names one; with and without
// the argmax it is of the same kind, so the two give the same bits):
//  - wgmma, at (C2, C3) = (64, 128) and (128, 256), tail_bench's SA1 and SA2:
//    the product taken transposed, z^T = W3^T a2^T, so that the 64 slots are
//    the N of a wgmma.m64n64k16 and each lane holds 16 slots of each of its
//    two columns. Two warpgroups share each centroid, one 64-column block of
//    W3^T each (two at SA2); W3^T and the tile sit K-major in the 128-byte
//    swizzle, the tile copied 16 bytes a thread into it. The max of z over a
//    column's valid slots is bf16(max(acc) + b3), rounding and adding a
//    finite b3 being monotone (a b3 of +inf takes acc + b3 first): a fold of
//    16 predicated max.NaN.f32 in four chains, two shuffles, one add.
//  - mma.sync at every other width: each warp owns 32 output columns at a
//    time, W3^T in shared memory and A by ldmatrix.x4; the accumulators start
//    at b3 (the first step's C operand, one more order of the same f32 sum).
//    Each lane folds its 8 valid rows into a max in f32 (max.NaN.f32, the
//    row's flag a predicate), rounds once a column pair, and the 8 lanes of a
//    column merge with 3 shuffles and max.NaN.bf16x2.
// The argmax, an instantiation of each, is formed as the TPU kernel forms it:
// the column's max is known to the lanes that hold it, each finds its first
// valid slot whose bf16 z equals it (set.eq.u32.bf16x2 on z rounded a pair at
// a time), the lanes take the min, and a max of -inf gives 64 (a NaN max
// equals nothing: 64). Measurement instantiations (staging only; staging and
// products; products and epilogue on a ring filled once) exist for both.
//
// The backward, redesigned for the H100 as a routed contraction whose speed
// should be set by bytes: a persistent block of 256 threads keeps a ring of
// `stages` centroids in shared memory (its features of a2's 64 rows, the
// argmax and the cotangent), copied by cp.async stages - 1 centroids ahead;
// bf16(W3)^T goes into shared memory once a block, held as f32. Two barriers a
// centroid:
//  - buckets: each column sets its bit in its slot's 32-bit mask for its 32
//    columns (an integer atomicOr: the same masks in any order), in one of two
//    tables used in turn, the other zeroed for the next centroid;
//  - da2: a thread takes a slot and 8 features, walks the slot's masks in
//    ascending column order, sums gb[c] W3[j, c] in f32, rounds once and
//    writes 16 bytes (zeros where no column routes to the slot);
//  - dW3: a thread keeps 8 features of up to 8 columns in registers across
//    its block's centroids and adds a2[am[c], j] gb[c] from the staged tile
//    each centroid; no float atomics: each block writes its slice, summed over
//    its centroids in order, and a second launch (dlbt_sum_slices,
//    csrc/sum_slices.cu) adds the slices in block order in f64, so a backward
//    repeats bit for bit on one card;
//  - the non-finite rule: each thread tests its 16-byte chunks of the tile
//    (one OR'd add a word) and a block vote says whether any value is NaN or
//    Inf; only then are N_j (the slots whose a2 is non-finite, per feature)
//    counted, and a compact pass marks dW3[j, c] NaN where N_j less the routed
//    slot's own is above 0 (a bit mask a thread, applied when the slice is
//    written). bf16(W3)'s non-finite values are counted per feature once a
//    block, and a slot's da2 made NaN where that count less its bucket's is
//    above 0.
// gridDim.y splits each centroid over groups_j x groups_c blocks (ops/
// tail_kernel.bwd_plan): by features where a thread would keep more than 8
// columns (tail_bench's SA2: two groups of 64 features, two blocks an SM), and
// by dW3's columns, with the slots of da2, where features alone do not do
// (C2 = 16 at C3 = 4320). The measured limit is issue, not bytes: the bucket
// walk of da2 (a warp's four slots walk their masks in step, each 32-column
// chunk costing the longest of the four) and a block's instruction stream per
// centroid; see PERF.md. Measurement instantiations (staging only; staging and
// da2; staging and dW3) exist behind the same entry.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "mma_bf16.cuh"

namespace {

using dlbt::kSkewH;

constexpr int kSlots = 64;
constexpr int kRowGroups = kSlots / 16;  // the 16-row tiles of a centroid's slots
constexpr int kFwdCols = 32;             // the forward's columns per warp task
constexpr int kFwdMaxWarps = 8;
constexpr int kFwdMaxStages = 6;         // centroids in the forward's ring
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ __forceinline__ size_t take(size_t& at, size_t bytes) {
  const size_t offset = at;
  at += (bytes + 15) / 16 * 16;
  return offset;
}

// Start the copies of centroid `cen`'s 64 rows of a2 (C2 bf16 each) into a
// tile of rows lda apart.
__device__ __forceinline__ void stage_rows(__nv_bfloat16* tile, int lda,
                                           const __nv_bfloat16* __restrict__ a2, long long cen,
                                           int c2) {
  const int vecs = c2 / 8;  // 16-byte vectors per row
  const char* src = reinterpret_cast<const char*>(a2 + cen * kSlots * c2);
  for (int i = threadIdx.x; i < kSlots * vecs; i += blockDim.x) {
    const int r = i / vecs, v = i - r * vecs;
    dlbt::cp_async16(tile + r * lda + v * 8, src + 16ll * i);
  }
}

// W3 (C2, C3) f32 rounded to bf16 in shared memory, rows ld apart: C3 rows of
// C2 values when `transposed`, else as it is.
__device__ __forceinline__ void load_w3(__nv_bfloat16* w, const float* __restrict__ w3, int c2,
                                        int c3, int ld, bool transposed) {
  for (int i = threadIdx.x; i < c2 * c3; i += blockDim.x) {  // coalesced reads
    const int j = i / c3, c = i - j * c3;
    w[transposed ? c * ld + j : j * ld + c] = __float2bfloat16_rn(w3[i]);
  }
}

// The mma.sync forward's shared memory: W3^T in bf16 (C3 rows of C2 + 8), b3,
// and a ring of `stages` buffers, each one centroid's a2 rows (64 rows of C2 + 8
// bf16) followed by its 64 slot flags.
struct FwdLayout {
  size_t wt, bias, ring, stage_bytes, flags, total;
  __host__ __device__ FwdLayout(int c2, int c3, int stages) {
    size_t at = 0;
    wt = take(at, 2ull * c3 * (c2 + kSkewH));
    bias = take(at, 4ull * c3);
    flags = 2ull * kSlots * (c2 + kSkewH);  // within a buffer
    stage_bytes = flags + kSlots;
    ring = take(at, stages * stage_bytes);
    total = at;
  }
};

// The forward's instantiations: the kernel, and three measurements of it (no
// path launches them): the staging and the writing of the outputs alone (every
// output 0); the staging with the products, a checksum of the accumulators
// written in place of the max; and the products and the max with the ring
// filled once and never refilled (no device-memory reads after the first
// centroids: each block recomputes on stale buffers).
enum FwdMode { kFwdFull = 0, kFwdStageOnly = 1, kFwdMmaOnly = 2, kFwdComputeOnly = 3 };

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ uint32_t max_nan_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.NaN.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// 0xffff in each half where a's bf16 equals b's (so -0 == +0, NaN equals nothing).
__device__ __forceinline__ uint32_t eq_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("set.eq.u32.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// d = a b + (c0, c1, c0, c1): mma.m16n8k16 whose accumulators start at a bias (c0
// for the even column of the lane's pair, c1 for the odd), so nothing zeroes them
// and no add follows the product.
__device__ __forceinline__ void mma_bf16_bias(float (&d)[4], const uint32_t (&a)[4],
                                              const uint32_t (&b)[2], float c0, float c1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(c0), "f"(c1),
        "f"(c0), "f"(c1));
}

// lo and hi rounded to bf16 by one cvt.rn.bf16x2.f32: lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Wait until at most n (< kFwdMaxStages - 1) of this thread's newest copy groups
// are in flight.
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: dlbt::cp_async_wait<0>(); break;
    case 1: dlbt::cp_async_wait<1>(); break;
    case 2: dlbt::cp_async_wait<2>(); break;
    case 3: dlbt::cp_async_wait<3>(); break;
    default: dlbt::cp_async_wait<4>(); break;
  }
}

// The mma.sync forward, at any C2 and C3: W3^T in shared memory, read by
// ldmatrix at every step, the warps taking the 32-column slices in turn.
// kArgmax: also the argmax (its own instantiation).
template <bool kArgmax, int kMode>
__global__ void __launch_bounds__(32 * kFwdMaxWarps)
    fused_tail_fwd_kernel(const __nv_bfloat16* __restrict__ a2,
                          const unsigned char* __restrict__ mask, const float* __restrict__ w3,
                          const float* __restrict__ b3, __nv_bfloat16* __restrict__ out,
                          int* __restrict__ amax, int centroids, int c2, int c3, int stages) {
  extern __shared__ __align__(16) char smem[];
  const FwdLayout L(c2, c3, stages);
  __nv_bfloat16* wt = reinterpret_cast<__nv_bfloat16*>(smem + L.wt);
  float* bias = reinterpret_cast<float*>(smem + L.bias);
  const int lda = c2 + kSkewH;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int warps = blockDim.x >> 5;

  auto buffer = [&](int s) { return smem + L.ring + s * L.stage_bytes; };
  auto stage = [&](long long cen, int s) {
    char* buf = buffer(s);
    stage_rows(reinterpret_cast<__nv_bfloat16*>(buf), lda, a2, cen, c2);
    if (threadIdx.x < kSlots / 16) {
      dlbt::cp_async16(buf + L.flags + 16 * threadIdx.x, mask + cen * kSlots + 16 * threadIdx.x);
    }
  };
  // the first stages - 1 centroids in flight, one copy group each
  for (int s = 0; s < stages - 1; ++s) {
    const long long cen = blockIdx.x + static_cast<long long>(s) * gridDim.x;
    if (cen < centroids) stage(cen, s);
    dlbt::cp_async_commit();
  }
  if (kMode != kFwdStageOnly) load_w3(wt, w3, c2, c3, lda, true);
  for (int i = threadIdx.x; i < c3; i += blockDim.x) bias[i] = b3[i];

  int s = 0;
  for (long long cen = blockIdx.x; cen < centroids; cen += gridDim.x) {
    cp_async_wait_upto(stages - 2);  // this centroid's copies (this thread's) have landed
    __syncthreads();  // ... every thread's, and the buffer refilled below has been consumed
    {
      const long long next = cen + static_cast<long long>(stages - 1) * gridDim.x;
      const int sn = s == 0 ? stages - 1 : s - 1;
      if (next < centroids && kMode != kFwdComputeOnly) stage(next, sn);
      dlbt::cp_async_commit();
    }
    const char* buf = buffer(s);
    if (++s == stages) s = 0;
    const __nv_bfloat16* a = reinterpret_cast<const __nv_bfloat16*>(buf);
    const unsigned char* flag = reinterpret_cast<const unsigned char*>(buf + L.flags);
    // slot r is valid where bit r of (hi:lo) is set
    const uint32_t lo = __ballot_sync(kFull, flag[lane] != 0);
    const uint32_t hi = __ballot_sync(kFull, flag[lane + 32] != 0);
    const bool any = (lo | hi) != 0u;
    // row rg 16 + h 8 + g of the lane valid: bit (rg & 1) 16 + h 8 of vb[rg >> 1]
    const uint32_t vb[2] = {lo >> g, hi >> g};
    for (int n0 = warp * kFwdCols; n0 < c3; n0 += warps * kFwdCols) {
      uint32_t* out_pair = reinterpret_cast<uint32_t*>(out + cen * c3 + n0 + 8 * (g & 3) + 2 * t);
      if (kMode == kFwdStageOnly) {
        if (g < 4) *out_pair = 0u;
        continue;
      }
      float2 bl[4];  // b3 at the lane's column pairs
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        bl[nt] = *reinterpret_cast<const float2*>(bias + n0 + nt * 8 + 2 * t);
      }
      // z in f32 for all 64 rows x the 32 columns, b3 + the product (the first
      // step's accumulators start at b3: one more order of the same f32 sum):
      // acc[rg][nt] holds rows rg 16 + g (j = 0, 1) and rg 16 + g + 8 (j = 2, 3),
      // columns n0 + 8 nt + 2t (+1)
      float acc[kRowGroups][4][4];
      for (int k0 = 0; k0 < c2; k0 += 16) {
        uint32_t bf[4][2];
        dlbt::load_b_ldm(bf[0], bf[1], wt, lda, k0, n0);
        dlbt::load_b_ldm(bf[2], bf[3], wt, lda, k0, n0 + 16);
#pragma unroll
        for (int rg = 0; rg < kRowGroups; ++rg) {
          uint32_t af[4];
          dlbt::load_a_ldm(af, a, lda, rg * 16, k0);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            if (k0 == 0) {
              mma_bf16_bias(acc[rg][nt], af, bf[nt], bl[nt].x, bl[nt].y);
            } else {
              dlbt::mma_bf16(acc[rg][nt], af, bf[nt]);
            }
          }
        }
      }
      if (kMode == kFwdMmaOnly) {
        float sum = 0.0f;
#pragma unroll
        for (int rg = 0; rg < kRowGroups; ++rg) {
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) sum += acc[rg][nt][0];
        }
        if (g < 4) *out_pair = pack_bf16x2(sum, sum);
        continue;
      }
      // the max of z over the lane's valid rows in f32, NaN-propagating: rounding
      // to bf16 is monotone, so the bf16 of this max is the max of the bf16 z
      float mx[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mx[nt][0] = mx[nt][1] = -__int_as_float(0x7f800000);
#pragma unroll
      for (int rg = 0; rg < kRowGroups; ++rg) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if ((vb[rg >> 1] >> ((rg & 1) * 16 + h * 8)) & 1u) {
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              mx[nt][0] = max_nan(mx[nt][0], acc[rg][nt][2 * h]);
              mx[nt][1] = max_nan(mx[nt][1], acc[rg][nt][2 * h + 1]);
            }
          }
        }
      }
      // rounded once a column pair, then merged over the 8 lanes of a column
      uint32_t zmax[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        zmax[nt] = pack_bf16x2(mx[nt][0], mx[nt][1]);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          zmax[nt] = max_nan_bf16x2(zmax[nt], __shfl_xor_sync(kFull, zmax[nt], off));
        }
      }
      // lanes g < 4 write columns n0 + 8 g + 2t, 2t + 1: 64 bytes a warp
      const int q = g & 3;
      const uint32_t mine = q == 0 ? zmax[0] : q == 1 ? zmax[1] : q == 2 ? zmax[2] : zmax[3];
      if (g < 4) *out_pair = any ? mine : 0u;
      if (kArgmax) {
        // the first slot whose z equals the column's max, as the TPU kernel forms
        // it: the lane's rows in descending order, a 16-bit slot a column
        uint32_t first[4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) first[nt] = kSlots * 0x10001u;
#pragma unroll
        for (int rg = kRowGroups - 1; rg >= 0; --rg) {
#pragma unroll
          for (int h = 1; h >= 0; --h) {
            const uint32_t r = rg * 16 + h * 8 + g;
            if ((vb[rg >> 1] >> ((rg & 1) * 16 + h * 8)) & 1u) {
#pragma unroll
              for (int nt = 0; nt < 4; ++nt) {
                const uint32_t eq =
                    eq_bf16x2(pack_bf16x2(acc[rg][nt][2 * h], acc[rg][nt][2 * h + 1]), zmax[nt]);
                first[nt] = (r * 0x10001u & eq) | (first[nt] & ~eq);
              }
            }
          }
        }
        int am[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          am[nt][0] = static_cast<int>(first[nt] & 0xffffu);
          am[nt][1] = static_cast<int>(first[nt] >> 16);
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            am[nt][0] = min(am[nt][0], __shfl_xor_sync(kFull, am[nt][0], off));
            am[nt][1] = min(am[nt][1], __shfl_xor_sync(kFull, am[nt][1], off));
          }
          // a max of -inf (no valid slot, or -inf at every valid one) routes nothing
          if ((zmax[nt] & 0xffffu) == 0xff80u) am[nt][0] = kSlots;
          if ((zmax[nt] >> 16) == 0xff80u) am[nt][1] = kSlots;
        }
        // lanes g >= 4 write columns n0 + 8 (g - 4) + 2t, 2t + 1: 128 bytes a warp
        const int2 pair = q == 0 ? make_int2(am[0][0], am[0][1])
                          : q == 1 ? make_int2(am[1][0], am[1][1])
                          : q == 2 ? make_int2(am[2][0], am[2][1])
                                   : make_int2(am[3][0], am[3][1]);
        if (g >= 4) *reinterpret_cast<int2*>(amax + cen * c3 + n0 + 8 * q + 2 * t) = pair;
      }
    }
  }
  dlbt::cp_async_wait<0>();
}

// d (64 x 64 f32, the warpgroup's fragment: d[4 j + i] at row 16 w + g + 8 (i / 2),
// column 8 j + 2 t + i % 2) = A B (+ d where accumulate), A 64 x 16 and B 16 x 64
// bf16 from shared memory, both K-major, by their descriptors.
__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[32], uint64_t da, uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// The wgmma forward, at C2 = 16 KS and C3 = 128 MB (tail_bench's SA1: KS 4, MB 1;
// SA2: KS 8, MB 2). The product is taken transposed, z^T = W3^T a2^T: a block's
// kWgGroups warpgroups share each centroid, warpgroup q the output columns
// 64 (q MB + mb) .. + 63 for mb < MB, one wgmma.m64n64k16 each a 16-deep step.
// W3^T (the M operand) and the centroid's a2 tile (the N operand: its 64 slots)
// sit in shared memory, K-major in the 128-byte swizzle (atoms of 8 rows x 128
// bytes, 64 depths; the 16-byte chunk c of row r at chunk c ^ (r % 8)), from a
// 1024-byte-aligned base; then the ring's slot flags and b3. A lane holds 16
// slots of each of its two columns a block, so the max is a fold in registers
// and two shuffles.
constexpr int kWgThreads = 128;
constexpr int kWgGroups = 2;

struct WgLayout {
  size_t wt, tiles, flags, bias, total;
  __host__ __device__ WgLayout(int c2, int c3, int stages) {
    size_t at = 0;
    wt = take(at, 2ull * c3 * c2);  // a multiple of 1024 bytes: the tiles stay aligned
    tiles = take(at, 2ull * stages * kSlots * c2);
    flags = take(at, 1ull * stages * kSlots);
    bias = take(at, 4ull * c3);
    total = at + 1024;  // the base is aligned up to 1024 bytes inside the allocation
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c (depths 8 c .. 8 c + 7) of row r of a K-major
// operand of `rows` rows in the 128-byte swizzle.
__device__ __forceinline__ int swizzled(int r, int c, int rows) {
  return (c >> 3) * (rows * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// The wgmma descriptor of a K-major operand in the 128-byte swizzle at p
// (1024-byte-aligned atoms; 8-row groups 1024 bytes apart).
__device__ __forceinline__ uint64_t wg_desc(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3ffff) >> 4) | 1ull << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | 1ull << 62;
}

// Keeps the compiler from moving accesses of d across the wgmma fences.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The least float whose bf16 rounding (to nearest, ties to even) equals the
// finite or +inf bf16 value z (bits zb), -0.0 and +0.0 equal: past the midpoint
// to the next value toward -inf, or on it where z is even.
__device__ __forceinline__ float least_rounding_to(uint32_t zb) {
  if ((zb & 0x7fffu) == 0u) return -__uint_as_float(0x00008000u);  // half the least subnormal
  const uint32_t f = zb << 16;
  return __uint_as_float(zb & 0x8000u ? f + 0x8000u - (zb & 1u) : f - 0x8000u + (zb & 1u));
}

template <int KS, int MB, bool kArgmax, int kMode>
__global__ void __launch_bounds__(kWgThreads * kWgGroups, 2)
    fused_tail_fwd_wgmma_kernel(const __nv_bfloat16* __restrict__ a2,
                                const unsigned char* __restrict__ mask,
                                const float* __restrict__ w3, const float* __restrict__ b3,
                                __nv_bfloat16* __restrict__ out, int* __restrict__ amax,
                                int centroids, int stages) {
  constexpr int C2 = 16 * KS, C3 = 128 * MB, CH = C2 / 8;  // CH: 16-byte chunks of a row
  constexpr int kTileBytes = kSlots * 2 * C2;
  constexpr int kThreads = kWgThreads * kWgGroups;
  extern __shared__ __align__(16) char smem_raw[];
  char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const WgLayout L(C2, C3, stages);
  char* wt = smem + L.wt;
  const float* bias = reinterpret_cast<const float*>(smem + L.bias);
  const int q = threadIdx.x / kWgThreads, warp = (threadIdx.x % kWgThreads) >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  auto tile = [&](int s) { return smem + L.tiles + s * kTileBytes; };
  auto flags = [&](int s) { return smem + L.flags + s * kSlots; };
  // 8 threads copy a 128-byte piece of a row, written as one swizzled row of an atom
  auto stage = [&](long long cen, int s) {
#pragma unroll
    for (int j = 0; j < kSlots * CH / kThreads; ++j) {
      const int i = threadIdx.x + j * kThreads, r = i / CH, c = i % CH;
      dlbt::cp_async16(tile(s) + swizzled(r, c, kSlots), a2 + (cen * kSlots + r) * C2 + c * 8);
    }
    if (threadIdx.x < kSlots / 16) {
      dlbt::cp_async16(flags(s) + 16 * threadIdx.x, mask + cen * kSlots + 16 * threadIdx.x);
    }
  };
  for (int s = 0; s < stages - 1; ++s) {
    const long long cen = blockIdx.x + static_cast<long long>(s) * gridDim.x;
    if (cen < centroids) stage(cen, s);
    dlbt::cp_async_commit();
  }
  if (kMode != kFwdStageOnly) {
    for (int i = threadIdx.x; i < C2 * C3; i += kThreads) {  // coalesced reads of W3
      const int k = i / C3, n = i % C3;
      *reinterpret_cast<__nv_bfloat16*>(wt + swizzled(n, k >> 3, C3) + (k & 7) * 2) =
          __float2bfloat16_rn(w3[i]);
    }
  }
  for (int i = threadIdx.x; i < C3; i += kThreads) {
    reinterpret_cast<float*>(smem + L.bias)[i] = b3[i];
  }

  int s = 0;
  for (long long cen = blockIdx.x; cen < centroids; cen += gridDim.x) {
    cp_async_wait_upto(stages - 2);  // this centroid's copies (this thread's) have landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    __syncthreads();  // ... every thread's, and the buffer refilled below has been consumed
    {
      const long long next = cen + static_cast<long long>(stages - 1) * gridDim.x;
      const int sn = s == 0 ? stages - 1 : s - 1;
      if (next < centroids && kMode != kFwdComputeOnly) stage(next, sn);
      dlbt::cp_async_commit();
    }
    const char* tl = tile(s);
    const unsigned char* flag = reinterpret_cast<const unsigned char*>(flags(s));
    if (++s == stages) s = 0;
    __nv_bfloat16* y = out + cen * C3;
    if (kMode == kFwdStageOnly) {
      for (int j = threadIdx.x; j < C3 / 2; j += kThreads) {
        reinterpret_cast<uint32_t*>(y)[j] = 0u;
      }
      continue;
    }
    // d[mb]: output columns (rows of z^T) 64 (q MB + mb) + 16 warp + g (d[4 j], d[4 j + 1])
    // and + 8 (d[4 j + 2], d[4 j + 3]), slots 8 j + 2t, 2t + 1
    float d[MB][32];
    const uint64_t db = wg_desc(tl);
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) fence_regs(d[mb]);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
      const uint64_t da = wg_desc(wt + (q * MB + mb) * 64 * 128);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {  // 32 bytes a step within an atom, then the next atom
        const int a_off = (ks >> 2) * (C3 * 128) + (ks & 3) * 32;
        const int b_off = (ks >> 2) * (kSlots * 128) + (ks & 3) * 32;
        wgmma_bf16_n64(d[mb], da + (a_off >> 4), db + (b_off >> 4), ks > 0);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) fence_regs(d[mb]);
    if (kMode == kFwdMmaOnly) {
      float sum = 0.0f;
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
#pragma unroll
        for (int i = 0; i < 32; i += 4) sum += d[mb][i];
      }
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        if (t < 2) y[(q * MB + mb) * 64 + 16 * warp + g + 8 * t] = __float2bfloat16_rn(sum);
      }
      continue;
    }
    const uint32_t lo = __ballot_sync(kFull, flag[lane] != 0);
    const uint32_t hi = __ballot_sync(kFull, flag[lane + 32] != 0);
    const bool any = (lo | hi) != 0u;
    // the lane's slots 8 j + 2t + e valid: bit 8 (j % 4) + e of vw[j / 4]
    const uint32_t vw[2] = {(lo >> (2 * t)) & 0x03030303u, (hi >> (2 * t)) & 0x03030303u};
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
      const int c0 = (q * MB + mb) * 64 + 16 * warp + g, c1 = c0 + 8;
      const float b0 = bias[c0], b1 = bias[c1];
      // the max of z over the valid slots: rounding and adding a finite b3 are
      // monotone, so it is bf16(max(acc) + b3); a b3 of +inf turns an acc of
      // -inf into NaN, so there b3 is added to each acc first. Four partial
      // maxima a column keep the chain of dependent max short.
      const bool exact = __float_as_uint(b0) == 0x7f800000u || __float_as_uint(b1) == 0x7f800000u;
      float m0[4], m1[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) m0[p] = m1[p] = -__int_as_float(0x7f800000);
      auto fold = [&](auto with_bias) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if ((vw[j >> 2] >> (8 * (j & 3) + e)) & 1u) {
              const int p = (j & 1) * 2 + e;
              float x0 = d[mb][4 * j + e], x1 = d[mb][4 * j + 2 + e];
              if constexpr (decltype(with_bias)::value) {
                x0 += b0;
                x1 += b1;
              }
              m0[p] = max_nan(m0[p], x0);
              m1[p] = max_nan(m1[p], x1);
            }
          }
        }
      };
      if (exact) {
        fold(std::true_type());
      } else {
        fold(std::false_type());
      }
      float r0 = max_nan(max_nan(m0[0], m0[1]), max_nan(m0[2], m0[3]));
      float r1 = max_nan(max_nan(m1[0], m1[1]), max_nan(m1[2], m1[3]));
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {  // the column's 4 lanes
        r0 = max_nan(r0, __shfl_xor_sync(kFull, r0, off));
        r1 = max_nan(r1, __shfl_xor_sync(kFull, r1, off));
      }
      if (!exact) {
        r0 += b0;
        r1 += b1;
      }
      const __nv_bfloat16 z0 = __float2bfloat16_rn(r0), z1 = __float2bfloat16_rn(r1);
      if (t == 0) y[c0] = any ? z0 : __float2bfloat16_rn(0.0f);
      if (t == 1) y[c1] = any ? z1 : __float2bfloat16_rn(0.0f);
      if (kArgmax) {
        // the first slot whose z equals the column's max: its bf16 equals the
        // max's exactly where acc + b3 is at least the least float that rounds
        // to the max (every valid z is at most the max); the lane's slots in
        // descending order, then the 4 lanes
        const float l0 = least_rounding_to(__bfloat16_as_ushort(z0));
        const float l1 = least_rounding_to(__bfloat16_as_ushort(z1));
        int f0 = kSlots, f1 = kSlots;
#pragma unroll
        for (int j = 7; j >= 0; --j) {
#pragma unroll
          for (int e = 1; e >= 0; --e) {
            const bool valid = (vw[j >> 2] >> (8 * (j & 3) + e)) & 1u;
            const int slot = 8 * j + 2 * t + e;
            f0 = valid && d[mb][4 * j + e] + b0 >= l0 ? slot : f0;
            f1 = valid && d[mb][4 * j + 2 + e] + b1 >= l1 ? slot : f1;
          }
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          f0 = min(f0, __shfl_xor_sync(kFull, f0, off));
          f1 = min(f1, __shfl_xor_sync(kFull, f1, off));
        }
        // a max of -inf (no valid slot, or -inf at every valid one) routes nothing
        if (t == 0) amax[cen * C3 + c0] = __bfloat16_as_ushort(z0) == 0xff80u ? kSlots : f0;
        if (t == 1) amax[cen * C3 + c1] = __bfloat16_as_ushort(z1) == 0xff80u ? kSlots : f1;
      }
    }
  }
  dlbt::cp_async_wait<0>();
}

// The backward, a routed contraction on the CUDA cores. A block walks its
// centroids with a grid stride, a ring of `stages` of them in shared memory
// (its features of a2's 64 rows, the argmax and the cotangent), copied by
// cp.async stages - 1 centroids ahead. gridDim.y splits each centroid over
// groups_j x groups_c blocks: group (fj, fc) takes the features J0 .. J0 + J - 1
// (J = C2 / groups_j: its columns of da2 and rows of dW3), the slots r with
// r % groups_c == fc (its rows of da2) and a range of C3 / groups_c columns
// (its columns of dW3). Where groups_c is 1, as at tail_bench's widths, each
// a2 byte is read once. The loop is issue-bound before it is bound by bytes,
// so it is kept lean: J / 8 (the lanes of a slot) is a power of two, and every
// index in the loop is a shift, a mask or an add.
constexpr int kBwdThreads = 256;
constexpr int kBwdMaxStages = 4;

// The backward's instantiations: the kernel, and three measurements of it (no
// path launches them): the staging alone (da2 written as zeros, no products);
// the staging with da2 (no dW3); the staging with dW3 (da2 written as zeros).
enum BwdMode { kBwdFull = 0, kBwdStageOnly = 1, kBwdStageDa2 = 2, kBwdStageDw3 = 3 };

// The backward's shared memory: bf16(W3)^T on the group's features in f32 (C3
// rows of J), the count of W3's non-finite values on each feature, the count
// of a centroid's non-finite a2 values on each feature, two bucket tables
// (32-bit masks of the columns routed to each of the group's slots, per 32
// columns), and the ring, each buffer a centroid's 64 rows of J + 8 bf16, its
// argmax (C3 int32) and its cotangent (C3 bf16).
struct BwdLayout {
  size_t wt, wn, nj, table, ring, stage_bytes, am, g, total;
  int j, rows, chunks, lda;
  __host__ __device__ BwdLayout(int c2, int c3, int groups_j, int groups_c, int stages) {
    j = c2 / groups_j;
    rows = ((kSlots + groups_c - 1) / groups_c + 3) / 4 * 4;  // a group's slots, padded
    chunks = c3 / 32;
    lda = j + kSkewH;
    size_t at = 0;
    wt = take(at, 4ull * c3 * j);
    wn = take(at, 4ull * j);
    nj = take(at, 4ull * j);
    table = take(at, 2ull * 4 * chunks * rows);
    am = 2ull * kSlots * lda;  // within a buffer
    g = am + 4ull * c3;
    stage_bytes = g + 2ull * c3;
    ring = take(at, stages * stage_bytes);
    total = at;
  }
};

// 8 bf16 (16 bytes) as 8 floats.
__device__ __forceinline__ void unpack8(const uint4& v, float (&x)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ bool nonfinite_bf16(uint32_t h) { return (h & 0x7f80u) == 0x7f80u; }
__device__ __forceinline__ bool nonfinite_f32(float x) {
  return (__float_as_uint(x) & 0x7f800000u) == 0x7f800000u;
}

// Bit 15 of a half set where that bf16 is NaN or +-Inf (its exponent all ones).
__device__ __forceinline__ uint32_t nonfinite_bits(uint32_t w) {
  return ((w & 0x7f807f80u) + 0x00800080u) & 0x80008000u;
}

// The dense da2's 0 x (a non-finite bf16(W3) value of a column routed to
// another slot, or to none): bit e set where W3's count on feature e (wn) less
// the slot's bucket's (its masks mk, `rows` apart, a chunk of 32 columns each)
// is above 0. w: W3^T at the thread's features, rows J apart.
__device__ __noinline__ uint32_t da2_nan(const uint32_t* mk, int rows, int chunks,
                                         const float* w, int J, const int* wn) {
  int cnt[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int k = 0; k < chunks; ++k, mk += rows) {
    for (uint32_t m = *mk; m; m &= m - 1) {
      const float* wr = w + (32 * k + __ffs(m) - 1) * J;
#pragma unroll
      for (int e = 0; e < 8; ++e) cnt[e] += nonfinite_f32(wr[e]);
    }
  }
  uint32_t bits = 0;
#pragma unroll
  for (int e = 0; e < 8; ++e) bits |= static_cast<uint32_t>(wn[e] - cnt[e] > 0) << e;
  return bits;
}

// The dense dW3's 0 x (a non-finite a2 value at a slot other than the routed
// one): for the thread's columns c = c_first + k P < c_end (k < NC) and
// features e, bit 8 k + e set where N_j (nbad[e]) less the routed slot's own
// non-finite value is above 0.
template <int NC>
__device__ __noinline__ unsigned long long dw3_nan(const __nv_bfloat16* tile, int lda,
                                                   const int* am, const int* nbad, int q,
                                                   int c_first, int c_end, int P) {
  unsigned long long bits = 0;
#pragma unroll 1
  for (int k = 0; k < NC; ++k) {
    const int c = c_first + k * P;
    if (c >= c_end) break;
    const int r = am[c];
    const bool routed = r >= 0 && r < kSlots;
    for (int e = 0; e < 8; ++e) {
      const int own = routed && nonfinite_bf16(__bfloat16_as_ushort(tile[r * lda + 8 * q + e]));
      if (nbad[e] - own > 0) bits |= 1ull << (8 * k + e);
    }
  }
  return bits;
}

// NC: the most dW3 columns a thread accumulates (8 features each), C3 /
// groups_c over the threads of a feature chunk (kBwdThreads / (J / 8)).
template <int NC, int kMode>
__global__ void __launch_bounds__(kBwdThreads, NC <= 4 ? 3 : 2)
    fused_tail_bwd_kernel(const __nv_bfloat16* __restrict__ a2,
                          const __nv_bfloat16* __restrict__ gb, const int* __restrict__ amax,
                          const float* __restrict__ w3, float* __restrict__ partial,
                          __nv_bfloat16* __restrict__ da2, int centroids, int c2, int c3,
                          int groups_j, int groups_c, int stages) {
  extern __shared__ __align__(16) char smem[];
  constexpr bool kDa2 = kMode == kBwdFull || kMode == kBwdStageDa2;
  constexpr bool kDw3 = kMode == kBwdFull || kMode == kBwdStageDw3;
  const BwdLayout L(c2, c3, groups_j, groups_c, stages);
  const int J = L.j, lda = L.lda, chunks = L.chunks, rows = L.rows;
  const int jc_log = __ffs(J / 8) - 1, jc = 1 << jc_log;  // J / 8 chunks of 8 features
  const int fj = blockIdx.y % groups_j, fc = blockIdx.y / groups_j;
  const int j0 = fj * J;
  const int cw = (c3 + groups_c - 1) / groups_c, col0 = fc * cw;
  const int col1 = min(c3, col0 + cw);
  const int my_rows = (kSlots - fc + groups_c - 1) / groups_c;  // slots fc, fc + groups_c, ...
  const int tid = threadIdx.x;
  const int q = tid & (jc - 1), p = tid >> jc_log;  // this thread's feature chunk, its lane group
  const int P = kBwdThreads >> jc_log;              // lane groups: rows (or columns) a pass
  float* wt = reinterpret_cast<float*>(smem + L.wt);
  int* wn = reinterpret_cast<int*>(smem + L.wn);
  int* nj = reinterpret_cast<int*>(smem + L.nj);
  uint32_t* tables = reinterpret_cast<uint32_t*>(smem + L.table);
  const int table_words = chunks * rows;

  auto buffer = [&](int s) { return smem + L.ring + s * L.stage_bytes; };
  // a centroid's J features of its 64 rows (thread: chunk q of rows p, p + P, ...),
  // argmax and cotangent, 16 bytes a copy
  auto stage = [&](long long cen, int s) {
    char* buf = buffer(s);
    const __nv_bfloat16* src = a2 + (cen * kSlots + p) * c2 + j0 + 8 * q;
    char* dst = buf + 2 * (p * lda + 8 * q);
    for (int r = p; r < kSlots; r += P, src += P * c2, dst += 2 * P * lda) {
      dlbt::cp_async16(dst, src);
    }
    const char* am_src = reinterpret_cast<const char*>(amax + cen * c3);
    const char* g_src = reinterpret_cast<const char*>(gb + cen * c3);
    for (int i = tid; i < c3 / 4; i += kBwdThreads) {
      dlbt::cp_async16(buf + L.am + 16 * i, am_src + 16 * i);
    }
    for (int i = tid; i < c3 / 8; i += kBwdThreads) {
      dlbt::cp_async16(buf + L.g + 16 * i, g_src + 16 * i);
    }
  };
  for (int s = 0; s < stages - 1; ++s) {
    const long long cen = blockIdx.x + static_cast<long long>(s) * gridDim.x;
    if (cen < centroids) stage(cen, s);
    dlbt::cp_async_commit();
  }
  // bf16(W3)^T on the group's features, held as f32, and its non-finite values per feature
  for (int i = tid; i < J; i += kBwdThreads) wn[i] = 0;
  for (int i = tid; i < 2 * table_words; i += kBwdThreads) tables[i] = 0u;
  __syncthreads();
  bool w_bad = false;
  for (int i = tid; i < J * (c3 / 4); i += kBwdThreads) {  // 4 columns a thread, lanes on j
    const int cq = i / J, jj = i - cq * J;
    const float4 w4 = *reinterpret_cast<const float4*>(w3 + static_cast<size_t>(j0 + jj) * c3 +
                                                       4 * cq);
    const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float w = __bfloat162float(__float2bfloat16_rn(wv[e]));
      wt[(4 * cq + e) * J + jj] = w;
      if (nonfinite_f32(w)) {
        atomicAdd(&wn[jj], 1);
        w_bad = true;
      }
    }
  }
  const bool w_any = __syncthreads_or(w_bad) != 0;

  // dW3: thread (p, q) keeps features j0 + 8q .. + 7 of columns col0 + p + k P
  float acc[NC][8];
#pragma unroll
  for (int k = 0; k < NC; ++k) {
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[k][e] = 0.0f;
  }
  unsigned long long nan_bits = 0;  // bit 8 k + e: acc[k][e] is NaN (the non-finite rule)

  int s = 0, par = 0;
  for (long long cen = blockIdx.x; cen < centroids; cen += gridDim.x, par ^= 1) {
    cp_async_wait_upto(stages - 2);  // this centroid's copies (this thread's) have landed
    __syncthreads();  // ... every thread's; the buffer refilled below and the other table are free
    {
      const long long next = cen + static_cast<long long>(stages - 1) * gridDim.x;
      const int sn = s == 0 ? stages - 1 : s - 1;
      if (next < centroids) stage(next, sn);
      dlbt::cp_async_commit();
    }
    const char* buf = buffer(s);
    if (++s == stages) s = 0;
    const __nv_bfloat16* tile = reinterpret_cast<const __nv_bfloat16*>(buf);
    const int* am = reinterpret_cast<const int*>(buf + L.am);
    const unsigned short* g = reinterpret_cast<const unsigned short*>(buf + L.g);
    uint32_t* table = tables + par * table_words;
    if (kDa2) {
      // the other table, read last centroid, zeroed for the next
      uint4* other = reinterpret_cast<uint4*>(tables + (par ^ 1) * table_words);
      for (int i = tid; i < table_words / 4; i += kBwdThreads) other[i] = make_uint4(0, 0, 0, 0);
      // the buckets: column c sets bit c % 32 of its slot's mask for columns
      // 32 (c / 32) .. + 31 (an integer OR: the same masks in any order)
      for (int c = tid; c < c3; c += kBwdThreads) {
        const int r = am[c];
        if (r >= 0 && r < kSlots) {
          if (groups_c == 1) {
            atomicOr(&table[(c >> 5) * rows + r], 1u << (c & 31));
          } else if (r % groups_c == fc) {
            atomicOr(&table[(c >> 5) * rows + r / groups_c], 1u << (c & 31));
          }
        }
      }
    }
    // a non-finite a2 value anywhere in the tile (then counted per feature)
    uint32_t bad = 0u;
    if (kDw3) {
      for (int r = p; r < kSlots; r += P) {
        const uint4 v = *reinterpret_cast<const uint4*>(tile + r * lda + 8 * q);
        bad |= nonfinite_bits(v.x) | nonfinite_bits(v.y) | nonfinite_bits(v.z) |
               nonfinite_bits(v.w);
      }
    }
    const bool a_any = __syncthreads_or(bad != 0u) != 0;
    if (a_any) {  // N_j: the slots whose a2 is non-finite, per feature
      for (int jj = tid; jj < J; jj += kBwdThreads) {
        int n = 0;
        for (int r = 0; r < kSlots; ++r) {
          n += nonfinite_bf16(__bfloat16_as_ushort(tile[r * lda + jj]));
        }
        nj[jj] = n;
      }
      __syncthreads();
    }

    // da2, slot r and features 8q .. + 7 (thread (p, q): the group's slots p,
    // p + P, ...): the sum over its bucket in ascending column order of gb[c]
    // W3[:, c] in f32, rounded once and written in 16 bytes (zeros where no
    // column routes to the slot)
    for (int i = p; i < my_rows; i += P) {
      float d[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (kDa2) {
        const uint32_t* mk = table + i;
        for (int k = 0; k < chunks; ++k, mk += rows) {
          for (uint32_t m = *mk; m; m &= m - 1) {
            const int c = 32 * k + __ffs(m) - 1;
            const float gv = __uint_as_float(static_cast<uint32_t>(g[c]) << 16);
            const float4* wr = reinterpret_cast<const float4*>(wt + c * J + 8 * q);
            const float4 w0 = wr[0], w1 = wr[1];
            const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
            for (int e = 0; e < 8; ++e) d[e] = fmaf(gv, w[e], d[e]);
          }
        }
        if (w_any) {
          const uint32_t bits = da2_nan(table + i, rows, chunks, wt + 8 * q, J, wn + 8 * q);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            if ((bits >> e) & 1u) d[e] = __int_as_float(0x7fffffff);
          }
        }
      }
      uint4 out;
      out.x = pack_bf16x2(d[0], d[1]);
      out.y = pack_bf16x2(d[2], d[3]);
      out.z = pack_bf16x2(d[4], d[5]);
      out.w = pack_bf16x2(d[6], d[7]);
      const int r = fc + i * groups_c;
      *reinterpret_cast<uint4*>(da2 + (cen * kSlots + r) * c2 + j0 + 8 * q) = out;
    }

    // dW3 += a2[am[c], j] gb[c] on the thread's columns, in the block's centroid order
    if (kDw3) {
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const int c = col0 + p + k * P;
        const int r = c < col1 ? am[c] : kSlots;
        if (r >= 0 && r < kSlots) {
          float x[8];
          unpack8(*reinterpret_cast<const uint4*>(tile + r * lda + 8 * q), x);
          const float gv = __uint_as_float(static_cast<uint32_t>(g[c]) << 16);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[k][e] = fmaf(x[e], gv, acc[k][e]);
        }
      }
      if (a_any) {
        nan_bits |= dw3_nan<NC>(tile, lda, am, nj + 8 * q, q, col0 + p, col1, P);
      }
    }
  }
  dlbt::cp_async_wait<0>();
  float* slice = partial + static_cast<size_t>(blockIdx.x) * c2 * c3;
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int c = col0 + p + k * P;
    if (c < col1) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const bool nan = (nan_bits >> (8 * k + e)) & 1u;
        slice[static_cast<size_t>(j0 + 8 * q + e) * c3 + c] =
            nan ? __int_as_float(0x7fffffff) : acc[k][e];
      }
    }
  }
}

// Grid of a kernel that loops over centroids: as many blocks as fit on the card
// at once, at most `cap`; sets the shared memory it asks for.
template <typename Kernel>
cudaError_t grid_for(Kernel kernel, int threads, size_t smem, long long cap, int* grid) {
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
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  }
  if (e != cudaSuccess) return e;
  long long n = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (n > cap) n = cap;
  *grid = static_cast<int>(n);
  return cudaSuccess;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

using FwdKernel = void (*)(const __nv_bfloat16*, const unsigned char*, const float*, const float*,
                           __nv_bfloat16*, int*, int, int, int, int);
using WgKernel = void (*)(const __nv_bfloat16*, const unsigned char*, const float*, const float*,
                          __nv_bfloat16*, int*, int, int);

// The forward's launches: mma.sync, or wgmma at tail_bench's widths.
enum FwdKind { kMma = 0, kWgmma = 1 };

// The mma.sync instantiation of (argmax, mode).
FwdKernel fwd_kernel(bool argmax, int mode) {
  switch (mode) {
    case kFwdStageOnly: return fused_tail_fwd_kernel<false, kFwdStageOnly>;
    case kFwdMmaOnly: return fused_tail_fwd_kernel<false, kFwdMmaOnly>;
    case kFwdComputeOnly: return fused_tail_fwd_kernel<false, kFwdComputeOnly>;
    default:
      return argmax ? fused_tail_fwd_kernel<true, kFwdFull>
                    : fused_tail_fwd_kernel<false, kFwdFull>;
  }
}

template <int KS, int MB>
WgKernel wg_kernel_of(bool argmax, int mode) {
  switch (mode) {
    case kFwdStageOnly: return fused_tail_fwd_wgmma_kernel<KS, MB, false, kFwdStageOnly>;
    case kFwdMmaOnly: return fused_tail_fwd_wgmma_kernel<KS, MB, false, kFwdMmaOnly>;
    case kFwdComputeOnly: return fused_tail_fwd_wgmma_kernel<KS, MB, false, kFwdComputeOnly>;
    default:
      return argmax ? fused_tail_fwd_wgmma_kernel<KS, MB, true, kFwdFull>
                    : fused_tail_fwd_wgmma_kernel<KS, MB, false, kFwdFull>;
  }
}

// The launch (warps, stages, kind) at widths (C2, C3), as ops/tail_kernel.plan
// names it: stages 2-kFwdMaxStages; wgmma at (C2, C3) = (64, 128) and (128, 256)
// (its instantiations), two warpgroups; mma.sync warps 1-8 and at most C3 / 32;
// the argmax only with the kernel itself.
bool fwd_launch_ok(int c2, int c3, int warps, int stages, int kind, int mode, bool argmax) {
  if (c2 <= 0 || c3 <= 0 || c2 % 16 || c3 % kFwdCols || stages < 2 || stages > kFwdMaxStages ||
      mode < kFwdFull || mode > kFwdComputeOnly || (argmax && mode != kFwdFull)) {
    return false;
  }
  if (kind == kWgmma) {
    return ((c2 == 64 && c3 == 128) || (c2 == 128 && c3 == 256)) &&
           warps == kWgGroups * kWgThreads / 32;
  }
  return kind == kMma && warps >= 1 && warps <= kFwdMaxWarps && warps * kFwdCols <= c3;
}

// A launch's kernel and shared memory.
struct FwdLaunch {
  const void* fn;
  size_t smem;
  FwdLaunch(int c2, int c3, int stages, int kind, int mode, bool argmax) {
    if (kind == kWgmma) {
      fn = reinterpret_cast<const void*>(c2 == 64 ? wg_kernel_of<4, 1>(argmax, mode)
                                                  : wg_kernel_of<8, 2>(argmax, mode));
      smem = WgLayout(c2, c3, stages).total;
    } else {
      fn = reinterpret_cast<const void*>(fwd_kernel(argmax, mode));
      smem = FwdLayout(c2, c3, stages).total;
    }
  }
};

using BwdKernel = void (*)(const __nv_bfloat16*, const __nv_bfloat16*, const int*, const float*,
                           float*, __nv_bfloat16*, int, int, int, int, int, int);

template <int NC>
BwdKernel bwd_kernel_of(int mode) {
  switch (mode) {
    case kBwdStageOnly: return fused_tail_bwd_kernel<NC, kBwdStageOnly>;
    case kBwdStageDa2: return fused_tail_bwd_kernel<NC, kBwdStageDa2>;
    case kBwdStageDw3: return fused_tail_bwd_kernel<NC, kBwdStageDw3>;
    default: return fused_tail_bwd_kernel<NC, kBwdFull>;
  }
}

// The backward's launch (threads, groups_j, groups_c, stages) at widths (C2,
// C3), as ops/tail_kernel.bwd_plan names it: C2 a multiple of 16 and C3 of 32;
// J = C2 / groups_j, J / 8 a power of two up to 32; each thread at most 8 dW3
// columns of 8 features. Returns its kernel, or null.
BwdKernel bwd_launch(int c2, int c3, int threads, int groups_j, int groups_c, int stages,
                     int mode) {
  if (c2 <= 0 || c3 <= 0 || c2 % 16 || c3 % 32 || threads != kBwdThreads || groups_j < 1 ||
      groups_c < 1 || groups_c > kSlots || c2 % (8 * groups_j) || stages < 2 ||
      stages > kBwdMaxStages || mode < kBwdFull || mode > kBwdStageDw3) {
    return nullptr;
  }
  const int jc = c2 / groups_j / 8;  // a power of two, at most 32
  if (jc > 32 || (jc & (jc - 1))) return nullptr;
  const int per_pass = kBwdThreads / jc, cw = (c3 + groups_c - 1) / groups_c;
  const int nc = (cw + per_pass - 1) / per_pass;
  if (nc <= 2) return bwd_kernel_of<2>(mode);
  if (nc <= 4) return bwd_kernel_of<4>(mode);
  if (nc <= 8) return bwd_kernel_of<8>(mode);
  return nullptr;
}

}  // namespace

// Forward over B*M = centroids centroids: a2 (centroids, 64, C2) bf16 and mask
// (centroids, 64) bool, both 16-byte aligned; w3 (C2, C3) and b3 (C3) f32.
// Writes out (centroids, C3) bf16 and, unless amax is null, amax (centroids,
// C3) int32. C2 a multiple of 16, C3 of 32; (warps, stages, kind) the launch
// (fwd_launch_ok); mode: FwdMode (0 on every path; the others write no amax).
extern "C" int dlbt_fused_tail_fwd(const void* a2, const void* mask, const void* w3,
                                   const void* b3, void* out, void* amax, int centroids, int c2,
                                   int c3, int warps, int stages, int kind, int mode,
                                   void* stream) {
  const bool argmax = amax != nullptr;
  if (centroids < 0 || !fwd_launch_ok(c2, c3, warps, stages, kind, mode, argmax) ||
      !aligned16(a2) || !aligned16(mask)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (centroids == 0) return 0;
  const FwdLaunch launch(c2, c3, stages, kind, mode, argmax);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const __nv_bfloat16*>(a2);
  const auto* m = static_cast<const unsigned char*>(mask);
  const auto* w = static_cast<const float*>(w3);
  const auto* b = static_cast<const float*>(b3);
  auto* y = static_cast<__nv_bfloat16*>(out);
  auto* am = static_cast<int*>(amax);
  int grid = 0;
  cudaError_t e;
  if (kind == kWgmma) {
    const auto kernel = reinterpret_cast<WgKernel>(const_cast<void*>(launch.fn));
    e = grid_for(kernel, 32 * warps, launch.smem, centroids, &grid);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<grid, 32 * warps, launch.smem, st>>>(x, m, w, b, y, am, centroids, stages);
  } else {
    const auto kernel = reinterpret_cast<FwdKernel>(const_cast<void*>(launch.fn));
    e = grid_for(kernel, 32 * warps, launch.smem, centroids, &grid);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<grid, 32 * warps, launch.smem, st>>>(x, m, w, b, y, am, centroids, c2, c3, stages);
  }
  return static_cast<int>(cudaGetLastError());
}

// The full forward's launch (warps, stages, kind, with or without the argmax)
// at widths (C2, C3) on the current card: out[0] blocks per SM, out[1] threads
// a block, out[2] shared memory a block (bytes), out[3] registers a thread,
// out[4] local memory a thread (bytes: spills).
extern "C" int dlbt_fused_tail_fwd_occupancy(int c2, int c3, int warps, int stages, int kind,
                                             int argmax, int* out) {
  if (!fwd_launch_ok(c2, c3, warps, stages, kind, kFwdFull, argmax != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const FwdLaunch launch(c2, c3, stages, kind, kFwdFull, argmax != 0);
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, launch.fn);
  int grid = 0, dev = 0, sms = 1;
  if (e == cudaSuccess) {
    e = kind == kWgmma
            ? grid_for(reinterpret_cast<WgKernel>(const_cast<void*>(launch.fn)), 32 * warps,
                       launch.smem, 1 << 30, &grid)
            : grid_for(reinterpret_cast<FwdKernel>(const_cast<void*>(launch.fn)), 32 * warps,
                       launch.smem, 1 << 30, &grid);
  }
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = grid / sms;
  out[1] = 32 * warps;
  out[2] = static_cast<int>(launch.smem);
  out[3] = attr.numRegs;
  out[4] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

// Backward over B*M = centroids centroids: a2 (centroids, 64, C2) bf16, gb
// (centroids, C3) bf16 and amax (centroids, C3) int32, the forward's argmax,
// w3 (C2, C3) f32 and da2 all 16-byte aligned. Writes da2 (centroids, 64, C2)
// bf16 and each of the grid's gridDim.x slices of dW3, (C2, C3) f32, into
// partial (max_grid, C2 * C3); *grid_out (host memory) is the number of slices
// written, for dlbt_sum_slices (csrc/sum_slices.cu). (threads, groups_j,
// groups_c, stages): the launch (bwd_launch); mode: BwdMode (0 on every path).
extern "C" int dlbt_fused_tail_bwd(const void* a2, const void* gb, const void* amax,
                                   const void* w3, void* partial, void* da2, int centroids,
                                   int c2, int c3, int threads, int groups_j, int groups_c,
                                   int stages, int max_grid, int mode, int* grid_out,
                                   void* stream) {
  *grid_out = 0;
  const BwdKernel kernel = bwd_launch(c2, c3, threads, groups_j, groups_c, stages, mode);
  if (centroids < 0 || kernel == nullptr || max_grid < 1 || !aligned16(a2) || !aligned16(gb) ||
      !aligned16(amax) || !aligned16(w3) || !aligned16(da2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (centroids == 0) return 0;
  const size_t smem = BwdLayout(c2, c3, groups_j, groups_c, stages).total;
  // the full kernel's blocks on the card at once, shared by the groups of each
  // centroid: every mode then writes the same slices
  int resident = 0, mode_resident = 0;
  cudaError_t e = grid_for(bwd_launch(c2, c3, threads, groups_j, groups_c, stages, kBwdFull),
                           threads, smem, 1 << 30, &resident);
  if (e == cudaSuccess) e = grid_for(kernel, threads, smem, 1 << 30, &mode_resident);
  if (e != cudaSuccess) return static_cast<int>(e);
  long long grid = resident / (groups_j * groups_c);
  if (grid < 1) grid = 1;
  if (grid > centroids) grid = centroids;
  if (grid > max_grid) grid = max_grid;
  kernel<<<dim3(static_cast<unsigned>(grid), groups_j * groups_c), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a2), static_cast<const __nv_bfloat16*>(gb),
      static_cast<const int*>(amax), static_cast<const float*>(w3),
      static_cast<float*>(partial), static_cast<__nv_bfloat16*>(da2), centroids, c2, c3,
      groups_j, groups_c, stages);
  e = cudaGetLastError();
  if (e == cudaSuccess) *grid_out = static_cast<int>(grid);
  return static_cast<int>(e);
}

// The full backward's launch at widths (C2, C3) on the current card, as
// dlbt_fused_tail_fwd_occupancy gives the forward's: out[0] blocks per SM,
// out[1] threads a block, out[2] shared memory a block (bytes), out[3]
// registers a thread, out[4] local memory a thread (bytes: spills).
extern "C" int dlbt_fused_tail_bwd_occupancy(int c2, int c3, int threads, int groups_j,
                                             int groups_c, int stages, int* out) {
  const BwdKernel kernel = bwd_launch(c2, c3, threads, groups_j, groups_c, stages, kBwdFull);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = BwdLayout(c2, c3, groups_j, groups_c, stages).total;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(kernel));
  int resident = 0, dev = 0, sms = 1;
  if (e == cudaSuccess) e = grid_for(kernel, threads, smem, 1 << 30, &resident);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = resident / sms;
  out[1] = threads;
  out[2] = static_cast<int>(smem);
  out[3] = attr.numRegs;
  out[4] = static_cast<int>(attr.localSizeBytes);
  return 0;
}
