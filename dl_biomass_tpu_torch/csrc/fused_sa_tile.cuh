// The per-centroid tile arithmetic of kernel 6, shared by its forward
// (csrc/fused_sa_fwd.cu) and its backward (csrc/fused_sa_bwd.cu), so that the
// backward recomputes exactly the hidden values the forward computed (the bf16
// backward passes, csrc/fused_sa_mma.cuh, take the slot count and the activations
// from here and recompute on the tensor cores).
//
// A block of 128 threads takes one centroid (its 64 edge rows) at a time. Each
// thread holds a 4-row x 8-column tile of a 64-column pass: thread (rg, cg) of
// the 16 x 8 thread grid has rows rg + 16 i (i < 4) and columns col0 + cg*4 +
// {0..3}, col0 + 32 + cg*4 + {0..3}. Rows live in shared memory as f32, (width
// + kSkew) floats apart.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fused_sa {

constexpr int kSlots = 64;  // neighbour slots: the rows of one centroid
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSkew = 4;  // rows are (width + 4) floats apart: 16-byte aligned, and the 4
                          // row groups of a warp fall in other banks
enum Act { kNone = 0, kRelu = 1, kLeakyRelu = 2, kElu = 3 };

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float activate(float z, int act) {
  switch (act) {
    case kRelu:
      return fmaxf(z, 0.0f);
    case kLeakyRelu:
      return z > 0.0f ? z : 0.01f * z;
    case kElu:
      return z > 0.0f ? z : expf(fminf(z, 0.0f)) - 1.0f;
    default:
      return z;
  }
}

// act'(z), the derivative the backward passes take.
__device__ __forceinline__ float activate_deriv(float z, int act) {
  switch (act) {
    case kRelu:
      return z > 0.0f ? 1.0f : 0.0f;
    case kLeakyRelu:
      return z > 0.0f ? 1.0f : 0.01f;
    case kElu:
      return z > 0.0f ? 1.0f : expf(fminf(z, 0.0f));
    default:
      return 1.0f;
  }
}

__host__ __device__ __forceinline__ size_t take(size_t& at, size_t bytes) {
  const size_t offset = at;
  at += (bytes + 15) / 16 * 16;
  return offset;
}

__host__ __device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

__device__ __forceinline__ float lane_of(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

__device__ __forceinline__ int tile_col(int col0, int cg, int j) {
  return col0 + (j < 4 ? cg * 4 + j : 32 + cg * 4 + (j - 4));
}

// The thread's tile of in (64 x in_dim, rows in_stride apart, shared memory) @ w
// (in_dim x w_cols, device memory), summed over k in ascending order.
__device__ __forceinline__ void tile_dot(const float* __restrict__ in, int in_stride, int in_dim,
                                         const float* __restrict__ w, int w_cols, int col0,
                                         int rg, int cg, float (&acc)[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  for (int k = 0; k < in_dim; k += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = *reinterpret_cast<const float4*>(in + (rg + 16 * i) * in_stride + k);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* wr = w + static_cast<size_t>(k + kk) * w_cols + col0 + cg * 4;
      const float4 lo = __ldg(reinterpret_cast<const float4*>(wr));
      const float4 hi = __ldg(reinterpret_cast<const float4*>(wr + 32));
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

// h = in @ w + bias for the thread's tile (one 64-column pass).
__device__ __forceinline__ void tile_layer(const float* in, int in_stride, int in_dim,
                                           const float* w, const float* bias, int w_cols,
                                           int col0, int rg, int cg, float (&h)[4][8]) {
  tile_dot(in, in_stride, in_dim, w, w_cols, col0, rg, cg, h);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float b = __ldg(bias + tile_col(col0, cg, j));
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i][j] += b;
  }
}

// The thread's tile into out (rows out_stride apart), rounded to bf16 when kRound.
template <bool kRound>
__device__ __forceinline__ void store_tile(const float (&v)[4][8], int col0, int rg, int cg,
                                           float* out, int out_stride) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float r[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) r[j] = kRound ? round_bf16(v[i][j]) : v[i][j];
    float* o = out + (rg + 16 * i) * out_stride + col0 + cg * 4;
    *reinterpret_cast<float4*>(o) = make_float4(r[0], r[1], r[2], r[3]);
    *reinterpret_cast<float4*>(o + 32) = make_float4(r[4], r[5], r[6], r[7]);
  }
}

// out rows = act(h * scale + shift), rounded to bf16 when kBf16: the next product's
// operand.
template <bool kBf16>
__device__ __forceinline__ void store_act(const float (&h)[4][8], const float* scale,
                                          const float* shift, int act, int col0, int rg, int cg,
                                          float* out, int out_stride) {
  float sc[8], sh[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    sc[j] = __ldg(scale + tile_col(col0, cg, j));
    sh[j] = __ldg(shift + tile_col(col0, cg, j));
  }
  float v[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[i][j] = activate(h[i][j] * sc[j] + sh[j], act);
  }
  store_tile<kBf16>(v, col0, rg, cg, out, out_stride);
}

template <bool kBf16>
__device__ __forceinline__ float dense_at(const void* dense, long long i) {
  if constexpr (kBf16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(dense)[i]);
  } else {
    return static_cast<const float*>(dense)[i];
  }
}

// The 64 edge rows of the centroid whose first row is row0, [dense..., planes...]
// zero-padded to kp, into rows (kp + kSkew floats apart); the planes rounded to
// bf16 when kBf16 (the dense block arrives in its compute type).
template <bool kBf16>
__device__ __forceinline__ void load_rows(const void* dense, const float* planes, long long row0,
                                          int cd, int cp, int kp, float* rows) {
  const int ldx = kp + kSkew;
  for (int i = threadIdx.x; i < kSlots * kp; i += kThreads) {
    const int r = i / kp, k = i - r * kp;
    float v = 0.0f;
    if (k < cd) {
      v = dense_at<kBf16>(dense, (row0 + r) * cd + k);
    } else if (k < cd + cp) {
      v = planes[(row0 + r) * cp + (k - cd)];
      if (kBf16) v = round_bf16(v);
    }
    rows[r * ldx + k] = v;
  }
}

}  // namespace fused_sa
