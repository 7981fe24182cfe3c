// bf16 tensor-core products of one warp (mma.sync m16n8k16, bf16 in, f32
// accumulators) and asynchronous copies into shared memory, shared by
// csrc/sa1_fused_eval.cu (kernel 5), csrc/fused_tail.cu (kernel 7) and kernel 6's
// bf16 backward passes (csrc/fused_sa_mma.cuh). In warp_mma_ldm the right-hand
// operand is stored transposed in shared memory, each of its rows (depth +
// kSkewH) values apart, so that a warp's fragment loads hit 32 banks;
// warp_mma_tb reads it untransposed, with ldmatrix.trans, so that one copy of
// a weight matrix serves both x W and x W^T. Fragment layouts of
// mma.m16n8k16 (g = lane / 4, t = lane % 4): A holds rows g and g + 8, depths
// 2t, 2t+1 and 2t+8, 2t+9; B depths 2t, 2t+1 and 2t+8, 2t+9 of column g; C
// rows g and g + 8, columns 2t, 2t+1.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace dlbt {

constexpr int kSkewH = 8;  // bf16 rows are (depth + 8) values apart: 16-byte aligned, and a
                           // fragment load's 8 rows x 4 words fall in 32 banks

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8x8 bf16 matrices from shared memory: lanes 8q..8q+7 give the addresses of
// matrix q's 8 rows (16 bytes each, 16-byte aligned), and r[q] holds its fragment
// (thread 4g + t: row g, values 2t and 2t + 1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Four 8x8 bf16 matrices from shared memory, transposed: lanes 8q..8q+7 give
// the addresses of matrix q's 8 rows (16 bytes each, 16-byte aligned), and
// r[q] holds the fragment of its transpose.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The B fragments of n-tiles n0..n0+7 and n0+8..n0+15 at depths k0..k0+15 of y,
// which holds the depth index as its row (rows ldy apart, 16-byte aligned).
__device__ __forceinline__ void load_b_trans(uint32_t (&b0)[2], uint32_t (&b1)[2],
                                             const __nv_bfloat16* y, int ldy, int k0, int n0) {
  const int lane = threadIdx.x & 31, q = lane >> 3, i = lane & 7;
  uint32_t bf[4];  // two 8-column blocks: (k 0-7, k 8-15) of each
  ldmatrix_x4_trans(bf, y + (k0 + i + (q & 1) * 8) * ldy + n0 + (q >> 1) * 8);
  b0[0] = bf[0];
  b0[1] = bf[1];
  b1[0] = bf[2];
  b1[1] = bf[3];
}

template <int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[nt][j] = 0.0f;
  }
}

// The A fragment of rows r0..r0+15, depths k0..k0+15 of a (rows lda apart and
// 16-byte aligned) by one ldmatrix.
__device__ __forceinline__ void load_a_ldm(uint32_t (&af)[4], const __nv_bfloat16* a, int lda,
                                           int r0, int k0) {
  const int lane = threadIdx.x & 31, q = lane >> 3, i = lane & 7;
  ldmatrix_x4(af, a + (r0 + i + (q & 1) * 8) * lda + k0 + (q >> 1) * 8);
}

// The B fragments of n-tiles n0..n0+7 and n0+8..n0+15 at depths k0..k0+15 of wt,
// stored transposed (a row an n, rows ldw apart, 16-byte aligned).
__device__ __forceinline__ void load_b_ldm(uint32_t (&b0)[2], uint32_t (&b1)[2],
                                           const __nv_bfloat16* wt, int ldw, int k0, int n0) {
  const int lane = threadIdx.x & 31, q = lane >> 3, i = lane & 7;
  uint32_t r[4];  // (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15)
  ldmatrix_x4(r, wt + (n0 + i + (q >> 1) * 8) * ldw + k0 + (q & 1) * 8);
  b0[0] = r[0];
  b0[1] = r[1];
  b1[0] = r[2];
  b1[1] = r[3];
}

// acc[nt] += rows r0..r0+15 of a @ columns n0 + 8 nt .. n0 + 8 nt + 7 of the
// transposed weights wt (rows ldw apart) over depths k_begin..k_end - 1
// (multiples of 16), for NP pairs of n-tiles, every fragment by ldmatrix.
template <int NP>
__device__ __forceinline__ void warp_mma_ldm(const __nv_bfloat16* a, int lda,
                                             const __nv_bfloat16* wt, int ldw, int k_begin,
                                             int k_end, int r0, int n0,
                                             float (&acc)[2 * NP][4]) {
#pragma unroll 2
  for (int k0 = k_begin; k0 < k_end; k0 += 16) {
    uint32_t af[4];
    load_a_ldm(af, a, lda, r0, k0);
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      uint32_t b0[2], b1[2];
      load_b_ldm(b0, b1, wt, ldw, k0, n0 + np * 16);
      mma_bf16(acc[2 * np], af, b0);
      mma_bf16(acc[2 * np + 1], af, b1);
    }
  }
}

// acc[nt] += rows r0..r0+15 of a (rows lda apart) @ columns n0 + 8 nt .. n0 + 8 nt + 7
// of y (depth x N, the depth index as the row, rows ldy apart), over depths 0..depth-1,
// for the first `live` of the NP pairs of n-tiles.
template <int NP>
__device__ __forceinline__ void warp_mma_tb(const __nv_bfloat16* a, int lda,
                                            const __nv_bfloat16* y, int ldy, int depth, int r0,
                                            int n0, float (&acc)[2 * NP][4], int live = NP) {
#pragma unroll 2
  for (int k0 = 0; k0 < depth; k0 += 16) {
    uint32_t af[4];
    load_a_ldm(af, a, lda, r0, k0);
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      if (np < live) {
        uint32_t b0[2], b1[2];
        load_b_trans(b0, b1, y, ldy, k0, n0 + np * 16);
        mma_bf16(acc[2 * np], af, b0);
        mma_bf16(acc[2 * np + 1], af, b1);
      }
    }
  }
}

// acc[nt] += (x^T y)[j0 .. j0 + 15][n0 + 8 nt .. n0 + 8 nt + 7], summed over the
// depth rows 0 .. depth - 1 of x (rows ldx apart) and y (rows ldy apart): both
// operands are stored with the summed index as the row, so their fragments
// are loaded transposed. ldx and ldy keep rows 16-byte aligned and 8 rows in
// other banks (a width plus kSkewH).
template <int NP>
__device__ __forceinline__ void warp_mma_tn(const __nv_bfloat16* x, int ldx,
                                            const __nv_bfloat16* y, int ldy, int depth, int j0,
                                            int n0, float (&acc)[2 * NP][4]) {
  const int lane = threadIdx.x & 31, q = lane >> 3, i = lane & 7;
  for (int k0 = 0; k0 < depth; k0 += 16) {
    uint32_t af[4];  // matrices: (j 0-7, k 0-7), (j 8-15, k 0-7), (j 0-7, k 8-15), (j 8-15, k 8-15)
    ldmatrix_x4_trans(af, x + (k0 + i + (q >> 1) * 8) * ldx + j0 + (q & 1) * 8);
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      uint32_t b0[2], b1[2];
      load_b_trans(b0, b1, y, ldy, k0, n0 + np * 16);
      mma_bf16(acc[2 * np], af, b0);
      mma_bf16(acc[2 * np + 1], af, b1);
    }
  }
}

// Asynchronous 16-byte copy from device to shared memory (both 16-byte
// aligned), in the calling thread's current group.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(src) : "memory");
}

// The same for 4 bytes (both 4-byte aligned).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(addr), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `n` of the thread's newest groups are still in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

}  // namespace dlbt
