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
// edge (25,088 at P=4, 64, 64, 128), on the bf16 tensor cores at best, plus
// the distance tests of the selection (8 flops each, f32); the output is the
// only sizeable traffic (B*M*C values).
//
// Design: a block of 128 threads takes one centroid at a time and loops over
// centroids (grid: as many blocks as fit on the card), so that the folded
// weights (already rounded to the compute type by the caller) are copied into
// shared memory once per block. Per centroid: the 128 threads find the bucket
// minima (dlbt::bucket_first) and threads 0..63 capture the slots' edge rows
// into shared memory. Then, in bf16, each warp runs the three layers for its
// 16 slots on the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulators;
// the weights are stored transposed in bf16 so that a fragment is one 32-bit
// load, and rows are padded by 8 values so that a warp's fragment loads hit
// 32 banks), keeping each hidden layer's bf16 rows to itself. In f32 the
// layers run as 64-column passes on the CUDA cores (f32 FMAs), every thread
// holding a 4-row x 8-column tile and reading 16-byte vectors. The last
// layer's tiles are reduced to a per-column max over the valid rows with warp
// shuffles and one shared-memory step across the 4 warps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "mma_bf16.cuh"
#include "stratified_select.cuh"

namespace {

using dlbt::kBuckets;
using dlbt::kSlots;

constexpr int kThreads = kBuckets;  // one thread per residue bucket
constexpr int kWarps = kThreads / 32;
constexpr int kInPad = 8;   // f32 layer-1 input: [feat..., dx, dy, dz] padded with zeros to 8
constexpr int kInMma = 16;  // bf16 layer-1 input: padded to one MMA step
constexpr int kSkew = 4;    // f32 rows are (width + 4) floats apart: 16-byte aligned, and the
                            // 4 row groups of a warp fall in other banks
using dlbt::kSkewH;  // bf16 rows are (depth + 8) values apart (mma_bf16.cuh)
using dlbt::warp_mma64;

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__host__ __device__ __forceinline__ size_t take(size_t& at, size_t bytes) {
  const size_t offset = at;
  at += (bytes + 15) / 16 * 16;
  return offset;
}

// Byte offsets of one block's shared memory. f32: the weights as the caller
// packs them (w1 (8, H1), b1, w2 (H1, H2), b2, w3 (H2, C), b3: one contiguous
// copy), activation rows of (width + 4) floats. bf16: each weight matrix
// transposed, (width, depth + 8) bf16, the biases f32, activation rows of
// (depth + 8) bf16. Then the per-warp column maxima, slot flags, bucket minima.
struct Layout {
  size_t w1, b1, w2, b2, w3, b3, edge, a1, a2, red, valid, first, total;
  __host__ __device__ Layout(bool bf16, int h1, int h2, int c) {
    size_t at = 0;
    if (bf16) {
      w1 = take(at, 2ull * h1 * (kInMma + kSkewH));
      b1 = take(at, 4ull * h1);
      w2 = take(at, 2ull * h2 * (h1 + kSkewH));
      b2 = take(at, 4ull * h2);
      w3 = take(at, 2ull * c * (h2 + kSkewH));
      b3 = take(at, 4ull * c);
      edge = take(at, 2ull * kSlots * (kInMma + kSkewH));
      a1 = take(at, 2ull * kSlots * (h1 + kSkewH));
      a2 = take(at, 2ull * kSlots * (h2 + kSkewH));
    } else {
      w1 = take(at, 4ull * kInPad * h1);
      b1 = take(at, 4ull * h1);
      w2 = take(at, 4ull * h1 * h2);
      b2 = take(at, 4ull * h2);
      w3 = take(at, 4ull * h2 * c);
      b3 = take(at, 4ull * c);
      edge = take(at, 4ull * kSlots * (kInPad + kSkew));
      a1 = take(at, 4ull * kSlots * (h1 + kSkew));
      a2 = take(at, 4ull * kSlots * (h2 + kSkew));
    }
    red = take(at, 4ull * kWarps * c);
    valid = take(at, 4ull * kSlots);
    first = take(at, 4ull * kBuckets);
    total = at;
  }
};

// ---- f32: CUDA-core FMAs ----------------------------------------------------

__device__ __forceinline__ float lane_of(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Thread (rg, cg) of the 16 x 8 thread grid: rows rg + 16 i (i < 4) and columns
// col0 + cg*4 + {0..3}, col0 + 32 + cg*4 + {0..3} of in (64 x in_dim, rows
// in_stride apart) @ w (in_dim x w_cols), summed over k in ascending order.
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

__device__ __forceinline__ int tile_col(int col0, int cg, int j) {
  return col0 + (j < 4 ? cg * 4 + j : 32 + cg * 4 + (j - 4));
}

// out = relu(in @ w + bias), 64 x out_dim, rows out_stride apart.
__device__ __forceinline__ void fma_hidden(const float* in, int in_stride, int in_dim,
                                           const float* w, const float* bias, int out_dim,
                                           float* out, int out_stride, int rg, int cg) {
  for (int col0 = 0; col0 < out_dim; col0 += 64) {
    float acc[4][8];
    tile_dot(in, in_stride, in_dim, w, out_dim, col0, rg, cg, acc);
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
}

// The three layers in f32; red[warp * c + col] = the warp's max over its valid rows.
__device__ void fma_mlp(char* smem, const Layout& L, const int* valid, float* red, int h1,
                        int h2, int c) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cg = lane & 7, rg = warp * 4 + (lane >> 3);
  const auto at = [smem](size_t off) { return reinterpret_cast<float*>(smem + off); };
  fma_hidden(at(L.edge), kInPad + kSkew, kInPad, at(L.w1), at(L.b1), h1, at(L.a1), h1 + kSkew,
             rg, cg);
  __syncthreads();
  fma_hidden(at(L.a1), h1 + kSkew, h1, at(L.w2), at(L.b2), h2, at(L.a2), h2 + kSkew, rg, cg);
  __syncthreads();
  const float* b3 = at(L.b3);
  for (int col0 = 0; col0 < c; col0 += 64) {
    float acc[4][8];
    tile_dot(at(L.a2), h2 + kSkew, h2, at(L.w3), c, col0, rg, cg, acc);
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
}

// ---- bf16: tensor-core MMA (mma_bf16.cuh) ------------------------------------

// The warp's 16 rows of out = bf16(relu(in @ w + bias)), rows (width + 8) apart.
__device__ __forceinline__ void mma_hidden(const __nv_bfloat16* in, int depth,
                                           const __nv_bfloat16* wt, const float* bias,
                                           int width, __nv_bfloat16* out, int r0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int lda = depth + kSkewH, ldo = width + kSkewH;
  for (int n0 = 0; n0 < width; n0 += 64) {
    float acc[8][4];
    warp_mma64(in, lda, wt, depth, r0, n0, acc);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = n0 + nt * 8 + 2 * t;
      const float b0 = bias[col], b1 = bias[col + 1];
      *reinterpret_cast<__nv_bfloat162*>(out + (r0 + g) * ldo + col) = __floats2bfloat162_rn(
          fmaxf(acc[nt][0] + b0, 0.0f), fmaxf(acc[nt][1] + b1, 0.0f));
      *reinterpret_cast<__nv_bfloat162*>(out + (r0 + g + 8) * ldo + col) = __floats2bfloat162_rn(
          fmaxf(acc[nt][2] + b0, 0.0f), fmaxf(acc[nt][3] + b1, 0.0f));
    }
  }
}

// The three layers in bf16, each warp on its own 16 rows from the edge rows on
// (a warp reads back only the hidden rows it wrote); red as in fma_mlp.
__device__ void mma_mlp(char* smem, const Layout& L, const int* valid, float* red, int h1,
                        int h2, int c) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;
  const auto h = [smem](size_t off) { return reinterpret_cast<__nv_bfloat16*>(smem + off); };
  const auto f = [smem](size_t off) { return reinterpret_cast<float*>(smem + off); };
  mma_hidden(h(L.edge), kInMma, h(L.w1), f(L.b1), h1, h(L.a1), r0);
  __syncwarp();
  mma_hidden(h(L.a1), h1, h(L.w2), f(L.b2), h2, h(L.a2), r0);
  __syncwarp();
  const float* b3 = f(L.b3);
  const bool v0 = valid[r0 + g], v1 = valid[r0 + g + 8];
  for (int n0 = 0; n0 < c; n0 += 64) {
    float acc[8][4];
    warp_mma64(h(L.a2), h2 + kSkewH, h(L.w3), h2, r0, n0, acc);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = n0 + nt * 8 + 2 * t;
      float m0 = fmaxf(v0 ? acc[nt][0] + b3[col] : neg_inf(),
                       v1 ? acc[nt][2] + b3[col] : neg_inf());
      float m1 = fmaxf(v0 ? acc[nt][1] + b3[col + 1] : neg_inf(),
                       v1 ? acc[nt][3] + b3[col + 1] : neg_inf());
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {  // over the 8 row pairs (lane bits 2..4)
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
      }
      if (g == 0) {
        red[warp * c + col] = m0;
        red[warp * c + col + 1] = m1;
      }
    }
  }
}

// wt (width, ld) bf16 = the transpose of w (rows, width) f32, zero for depths >= rows;
// consecutive threads read consecutive columns of w.
__device__ void store_transposed(__nv_bfloat16* wt, const float* __restrict__ w, int rows,
                                 int width, int ld) {
  for (int i = threadIdx.x; i < width * ld; i += kThreads) {
    const int k = i / width, n = i - k * width;
    wt[n * ld + k] = __float2bfloat16_rn(k < rows ? w[i] : 0.0f);
  }
}

template <bool kBf16>
__device__ void load_weights(char* smem, const Layout& L, const float* __restrict__ w, int h1,
                             int h2, int c) {
  const float* w1 = w;
  const float* b1 = w1 + kInPad * h1;
  const float* w2 = b1 + h1;
  const float* b2 = w2 + h1 * h2;
  const float* w3 = b2 + h2;
  const float* b3 = w3 + h2 * c;
  if constexpr (kBf16) {
    const auto h = [smem](size_t off) { return reinterpret_cast<__nv_bfloat16*>(smem + off); };
    store_transposed(h(L.w1), w1, kInPad, h1, kInMma + kSkewH);
    store_transposed(h(L.w2), w2, h1, h2, h1 + kSkewH);
    store_transposed(h(L.w3), w3, h2, c, h2 + kSkewH);
    const auto f = [smem](size_t off) { return reinterpret_cast<float*>(smem + off); };
    for (int i = threadIdx.x; i < h1; i += kThreads) f(L.b1)[i] = b1[i];
    for (int i = threadIdx.x; i < h2; i += kThreads) f(L.b2)[i] = b2[i];
    for (int i = threadIdx.x; i < c; i += kThreads) f(L.b3)[i] = b3[i];
  } else {  // the packed block is the layout's prefix (every part a multiple of 16 bytes)
    const int n4 = static_cast<int>((b3 + c - w1) / 4);
    const float4* src = reinterpret_cast<const float4*>(w);
    float4* dst = reinterpret_cast<float4*>(smem);
    for (int i = threadIdx.x; i < n4; i += kThreads) dst[i] = src[i];
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
sa1_fused_eval_kernel(const float* __restrict__ centers, const unsigned char* __restrict__ cmask,
                      const float* __restrict__ planes, const unsigned char* __restrict__ mask,
                      const float* __restrict__ weights, void* __restrict__ out, int b, int m,
                      int n, int f, int h1, int h2, int c, int c_out, float r2, int out_bf16) {
  using E = std::conditional_t<kBf16, __nv_bfloat16, float>;  // an edge value
  constexpr int kEdgeDepth = kBf16 ? kInMma : kInPad;
  constexpr int kEdgeLd = kEdgeDepth + (kBf16 ? kSkewH : kSkew);
  extern __shared__ float4 smem4[];
  char* const smem = reinterpret_cast<char*>(smem4);
  const Layout L(kBf16, h1, h2, c);
  E* const edge = reinterpret_cast<E*>(smem + L.edge);
  float* const red = reinterpret_cast<float*>(smem + L.red);
  int* const valid = reinterpret_cast<int*>(smem + L.valid);
  int* const first = reinterpret_cast<int*>(smem + L.first);
  const int tid = threadIdx.x;

  load_weights<kBf16>(smem, L, weights, h1, h2, c);
  __syncthreads();

  const long long total = static_cast<long long>(b) * m;
  for (long long ci = blockIdx.x; ci < total; ci += gridDim.x) {
    const long long bi = ci / m;
    const float* px = planes + bi * (3 + f) * static_cast<long long>(n);
    const float* py = px + n;
    const float* pz = py + n;
    const float cx = centers[3 * ci], cy = centers[3 * ci + 1], cz = centers[3 * ci + 2];

    first[tid] = cmask[ci] ? dlbt::bucket_first(px, py, pz, mask + bi * n, n, cx, cy, cz, r2, tid)
                           : n;
    __syncthreads();
    int ok = 0;
    if (tid < kSlots) {
      const int sel = dlbt::pair_select(first, tid);
      ok = sel < n;
      E* e = edge + tid * kEdgeLd;
      for (int q = 0; q < f; ++q) {
        put(e + q, ok ? px[(3 + q) * static_cast<long long>(n) + sel] : 0.0f);
      }
      put(e + f, ok ? __fsub_rn(px[sel], cx) : 0.0f);
      put(e + f + 1, ok ? __fsub_rn(py[sel], cy) : 0.0f);
      put(e + f + 2, ok ? __fsub_rn(pz[sel], cz) : 0.0f);
      for (int q = f + 3; q < kEdgeDepth; ++q) put(e + q, 0.0f);
      valid[tid] = ok;
    }
    if (!__syncthreads_or(ok)) {  // no valid slot (or a masked centroid): the row is 0
      for (int col = tid; col < c_out; col += kThreads) {
        if (out_bf16) {
          static_cast<__nv_bfloat16*>(out)[ci * c_out + col] = __float2bfloat16_rn(0.0f);
        } else {
          static_cast<float*>(out)[ci * c_out + col] = 0.0f;
        }
      }
      continue;
    }
    if constexpr (kBf16) {
      mma_mlp(smem, L, valid, red, h1, h2, c);
    } else {
      fma_mlp(smem, L, valid, red, h1, h2, c);
    }
    __syncthreads();
    for (int col = tid; col < c_out; col += kThreads) {
      float v = red[col];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) v = fmaxf(v, red[w * c + col]);
      if (out_bf16) {
        static_cast<__nv_bfloat16*>(out)[ci * c_out + col] = __float2bfloat16_rn(v);
      } else {
        static_cast<float*>(out)[ci * c_out + col] = v;
      }
    }
  }
}

}  // namespace

// centers (B, M, 3) f32, cmask (B, M) bool, planes (B, 3+F, N) f32 [x, y, z, features],
// mask (B, N) bool, weights f32 [w1 (8, H1) with rows F+3.. zero, b1 (H1), w2 (H1, H2),
// b2 (H2), w3 (H2, C), b3 (C)], each already rounded to the compute type (bf16 != 0:
// bf16, else f32) -> out (B, M, c_out) bf16 (out_bf16 != 0) or f32. H1, H2 and C are
// multiples of 64 (zero-padded by the caller), F + 3 <= 8, c_out <= C.
extern "C" int dlbt_sa1_fused_eval(const void* centers, const void* cmask, const void* planes,
                                   const void* mask, const void* weights, void* out, int b,
                                   int m, int n, int f, int h1, int h2, int c, int c_out,
                                   float r2, int bf16, int out_bf16, void* stream) {
  if (f < 0 || f + 3 > kInPad || h1 <= 0 || h2 <= 0 || c <= 0 || h1 % 64 || h2 % 64 ||
      c % 64 || c_out > c) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total = static_cast<long long>(b) * m;
  if (total == 0) return 0;
  auto kernel = bf16 ? sa1_fused_eval_kernel<true> : sa1_fused_eval_kernel<false>;
  const size_t smem = Layout(bf16 != 0, h1, h2, c).total;
  int dev = 0, max_smem = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem > static_cast<size_t>(max_smem)) return static_cast<int>(cudaErrorInvalidValue);
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  long long grid = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (grid > total) grid = total;
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(centers), static_cast<const unsigned char*>(cmask),
      static_cast<const float*>(planes), static_cast<const unsigned char*>(mask),
      static_cast<const float*>(weights), out, b, m, n, f, h1, h2, c, c_out, r2, out_bf16);
  return static_cast<int>(cudaGetLastError());
}
