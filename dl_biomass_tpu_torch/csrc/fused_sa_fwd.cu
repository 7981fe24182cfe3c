// Kernel 6's forward: the three recomputing passes of the fused SA-layer MLP
// (Linear -> BatchNorm -> act, twice, then Linear and the masked max over the
// 64 neighbour slots). No (B, M, 64, C) hidden tensor reaches device memory.
//
// Replaces: dl_biomass_tpu/ops/pallas_sa_train.py fused_sa_mlp (_f1_kernel, _f2_kernel,
// _f3_kernel).
// Semantics: an edge row is [dense..., planes...] (W1's row order). h1 = x W1 + b1,
// a1 = act(h1 sc1 + sh1), h2 = a1 W2 + b2, a2 = act(h2 sc2 + sh2), h3 = a2 W3 + b3,
// every product with f32 accumulation and an f32 bias. In bf16 mode the operands of
// each product are bf16 values (the caller rounds the weights and the dense block; the
// kernel rounds the planes, a1 and a2), while h1, h2, h3, a1 and a2 themselves stay
// f32. F1 returns the masked sum and sum of squares of h1 over every valid edge of the
// batch, F2 those of h2 (sc1, sh1 folded from F1's statistics), F3 the masked max of
// h3 over the 64 slots and the first slot that reaches it: 0 and -1 for a centroid
// with no valid slot. Invalid slots enter no sum and never win the max.
//
// Bound on the H100: operations. Per edge row 2 (KP C1) flop for F1,
// 2 (KP C1 + C1 C2) for F2 and 2 (KP C1 + C1 C2 + C2 C3) for F3 (25,088 at SA1's
// 4, 64, 64, 128; 131,840 at SA2's 131, 128, 128, 256), at best on the bf16 tensor
// cores; this file's kernel runs them as f32 FMAs on the CUDA cores (67 TFLOP/s):
// every f32 pass, and the bf16 passes at the widths the tensor-core kernels
// (csrc/fused_sa_f1.cu, _f2.cu, _f3.cu, which the same entries launch) do not take,
// such as SA2 at neuron_multiplier 2 and both layers at 3. The
// inputs are read once per pass (SA2's bf16 dense block: 134 MB at 16 x 10240), the
// outputs are (B, M, C3) values and indices.
//
// Design: a block of 128 threads takes one centroid (its 64 edge rows) at a time
// and walks the centroids with a grid stride. The rows are loaded into shared
// memory as f32, then each layer runs as 64-column passes of f32 FMAs, every thread
// holding a 4-row x 8-column tile (the tile of csrc/sa1_fused_eval.cu). Weights
// do not fit a block's shared memory at SA2 (~260 KB in f32), so they are read
// from device memory through L1 and L2 as 16-byte vectors: the 4 row groups of a
// warp read the same addresses. a1 and a2 are kept in shared memory (a2 in the
// space of the rows); h3 is never stored: each 64-column pass is reduced into the
// per-column max and first argmax at once, with warp shuffles and one
// shared-memory step across the 4 warps. F1 and F2 reduce each centroid's column
// sums the same way, and add them to the block's f64 sums in centroid order; a
// second launch adds the blocks' sums in block order. No float atomics: a forward
// repeats bit for bit on one card. Each pass has a shared-memory layout of its own
// (Layout), which is what lets SA2 at neuron_multiplier 3 run at all.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "fused_sa_tile.cuh"

// csrc/fused_sa_f1.cu, _f2.cu, _f3.cu: F1, F2 and F3 in bf16 on the tensor cores, each
// kernel alone (*grid: the slices of partial F1 or F2 wrote); wb is their bf16 weight
// block.
#define DLBT_MMA_PASS(name)                                                                  \
  extern "C" int name(const void* dense, const void* planes, const void* mask, const void* w, \
                      const void* wb, void* partial, void* out, void* amax, int centroids,   \
                      int cd, int cp, int c1, int c2, int c3, int c_out, int act,            \
                      int max_grid, void* stream, int* grid);
DLBT_MMA_PASS(dlbt_fused_sa_f1_mma)
DLBT_MMA_PASS(dlbt_fused_sa_f2_mma)
DLBT_MMA_PASS(dlbt_fused_sa_f3_mma)
#undef DLBT_MMA_PASS

namespace {

using namespace fused_sa;

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }

// Byte offsets of one block's shared memory, by pass: the edge rows (KP + 4 floats
// apart; in F3 later a2, C2 + 4 apart, in the same buffer); a1 (C1 + 4 apart; F2, F3);
// the per-warp column partials (F1, F2: sums and sums of squares, 2 x 4 warps x the
// summed layer's width; F3: the max and its slot, 2 x 4 warps x C3); the block's f64
// sums (F1, F2); the slot flags. SA2 at neuron_multiplier 3 (KP 388, C1 = C2 = 384,
// C3 768) takes 219 KiB in F3, the widest pass.
struct Layout {
  size_t rows, a1, red, sums, valid, total;
  __host__ __device__ Layout(int stage, int kp, int c1, int c2, int c3) {
    size_t at = 0;
    const int cw = stage == 1 ? c1 : stage == 2 ? c2 : c3;
    rows = take(at, 4ull * kSlots * ((stage == 3 ? imax(kp, c2) : kp) + kSkew));
    a1 = stage >= 2 ? take(at, 4ull * kSlots * (c1 + kSkew)) : 0;
    red = take(at, 4ull * 2 * kWarps * cw);
    sums = stage < 3 ? take(at, 8ull * 2 * cw) : 0;
    valid = take(at, 4ull * kSlots);
    total = at;
  }
};

// The warp's column sums and sums of squares of h over its valid rows:
// red[warp * cw + col] and red[(kWarps + warp) * cw + col].
__device__ __forceinline__ void tile_sums(const float (&h)[4][8], const int* valid, int col0,
                                          int rg, int cg, int lane, int warp, float* red,
                                          int cw) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float s = 0.0f, ss = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (valid[rg + 16 * i]) {
        s += h[i][j];
        ss += h[i][j] * h[i][j];
      }
    }
    // the warp's 4 row groups differ in lane bits 3 and 4
    s += __shfl_xor_sync(0xffffffffu, s, 8);
    ss += __shfl_xor_sync(0xffffffffu, ss, 8);
    s += __shfl_xor_sync(0xffffffffu, s, 16);
    ss += __shfl_xor_sync(0xffffffffu, ss, 16);
    if (lane < 8) {
      red[warp * cw + tile_col(col0, cg, j)] = s;
      red[(kWarps + warp) * cw + tile_col(col0, cg, j)] = ss;
    }
  }
}

// (v, i) replaces (best, at) when it is larger, or equal at an earlier slot.
__device__ __forceinline__ void take_max(float v, int i, float& best, int& at) {
  if (v > best || (v == best && i < at)) {
    best = v;
    at = i;
  }
}

// The warp's max over its valid rows and the first row reaching it, per column:
// red[warp * c + col] and red_at[warp * c + col] (slot kSlots: no valid row).
__device__ __forceinline__ void tile_max(const float (&h)[4][8], const int* valid, int col0,
                                         int rg, int cg, int lane, int warp, float* red,
                                         int* red_at, int c) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float best = neg_inf();
    int at = kSlots;
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // rows ascend, so a strict > keeps the first
      if (valid[rg + 16 * i] && h[i][j] > best) {
        best = h[i][j];
        at = rg + 16 * i;
      }
    }
#pragma unroll
    for (int off = 8; off <= 16; off <<= 1) {
      take_max(__shfl_xor_sync(0xffffffffu, best, off), __shfl_xor_sync(0xffffffffu, at, off),
               best, at);
    }
    if (lane < 8) {
      red[warp * c + tile_col(col0, cg, j)] = best;
      red_at[warp * c + tile_col(col0, cg, j)] = at;
    }
  }
}

// kStage 1: F1, 2: F2, 3: F3. w packs, each part zero-padded: w1 (KP, C1), b1, sc1,
// sh1 (C1), w2 (C1, C2), b2, sc2, sh2 (C2), w3 (C2, C3), b3 (C3).
template <int kStage, bool kBf16>
__global__ void __launch_bounds__(kThreads)
fused_sa_fwd_kernel(const void* __restrict__ dense, const float* __restrict__ planes,
                    const unsigned char* __restrict__ mask, const float* __restrict__ w,
                    double* __restrict__ partial, float* __restrict__ out,
                    int* __restrict__ amax, long long total, int cd, int cp, int kp, int c1,
                    int c2, int c3, int c_out, int act) {
  extern __shared__ float4 smem4[];
  char* const smem = reinterpret_cast<char*>(smem4);
  const Layout L(kStage, kp, c1, c2, c3);
  float* const rows = reinterpret_cast<float*>(smem + L.rows);
  float* const a1 = reinterpret_cast<float*>(smem + L.a1);
  float* const red = reinterpret_cast<float*>(smem + L.red);
  double* const sums = reinterpret_cast<double*>(smem + L.sums);
  int* const valid = reinterpret_cast<int*>(smem + L.valid);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = lane & 7, rg = warp * 4 + (lane >> 3);
  const int cw = kStage == 1 ? c1 : c2;  // the summed layer's width (F1, F2)
  const int ldx = kp + kSkew, ld1 = c1 + kSkew, ld2 = c2 + kSkew;

  const float* const w1 = w;
  const float* const b1 = w1 + static_cast<size_t>(kp) * c1;
  const float* const sc1 = b1 + c1;
  const float* const sh1 = sc1 + c1;
  const float* const w2 = sh1 + c1;
  const float* const b2 = w2 + static_cast<size_t>(c1) * c2;
  const float* const sc2 = b2 + c2;
  const float* const sh2 = sc2 + c2;
  const float* const w3 = sh2 + c2;
  const float* const b3 = w3 + static_cast<size_t>(c2) * c3;

  if (kStage < 3) {
    for (int i = tid; i < 2 * cw; i += kThreads) sums[i] = 0.0;
  }

  for (long long ci = blockIdx.x; ci < total; ci += gridDim.x) {
    const long long row0 = ci * kSlots;
    int ok = 0;
    if (tid < kSlots) {
      ok = mask[row0 + tid] != 0;
      valid[tid] = ok;
    }
    if (!__syncthreads_or(ok)) {  // no valid slot: nothing to sum, and a row of 0 / -1
      if (kStage == 3) {
        for (int col = tid; col < c_out; col += kThreads) {
          out[ci * c_out + col] = 0.0f;
          amax[ci * c_out + col] = -1;
        }
      }
      continue;
    }
    load_rows<kBf16>(dense, planes, row0, cd, cp, kp, rows);
    __syncthreads();

    float h[4][8];
    for (int col0 = 0; col0 < c1; col0 += 64) {
      tile_layer(rows, ldx, kp, w1, b1, c1, col0, rg, cg, h);
      if (kStage == 1) {
        tile_sums(h, valid, col0, rg, cg, lane, warp, red, cw);
      } else {
        store_act<kBf16>(h, sc1, sh1, act, col0, rg, cg, a1, ld1);
      }
    }
    __syncthreads();

    if (kStage >= 2) {
      for (int col0 = 0; col0 < c2; col0 += 64) {
        tile_layer(a1, ld1, c1, w2, b2, c2, col0, rg, cg, h);
        if (kStage == 2) {
          tile_sums(h, valid, col0, rg, cg, lane, warp, red, cw);
        } else {  // a2 takes the rows' place: every read of them is behind the barrier
          store_act<kBf16>(h, sc2, sh2, act, col0, rg, cg, rows, ld2);
        }
      }
      __syncthreads();
    }

    if (kStage < 3) {  // the 4 warps' partials, in warp order, into the block's sums
      for (int col = tid; col < cw; col += kThreads) {
        double s = 0.0, ss = 0.0;
#pragma unroll
        for (int q = 0; q < kWarps; ++q) {
          s += red[q * cw + col];
          ss += red[(kWarps + q) * cw + col];
        }
        sums[col] += s;
        sums[cw + col] += ss;
      }
    } else {
      int* const red_at = reinterpret_cast<int*>(red + kWarps * c3);
      for (int col0 = 0; col0 < c3; col0 += 64) {
        tile_layer(rows, ld2, c2, w3, b3, c3, col0, rg, cg, h);
        tile_max(h, valid, col0, rg, cg, lane, warp, red, red_at, c3);
      }
      __syncthreads();
      for (int col = tid; col < c_out; col += kThreads) {
        float best = red[col];
        int at = red_at[col];
#pragma unroll
        for (int q = 1; q < kWarps; ++q) take_max(red[q * c3 + col], red_at[q * c3 + col], best, at);
        const bool found = at < kSlots;
        out[ci * c_out + col] = found ? best : 0.0f;
        amax[ci * c_out + col] = found ? at : -1;
      }
    }
    __syncthreads();
  }

  if (kStage < 3) {
    __syncthreads();
    for (int i = tid; i < 2 * cw; i += kThreads) {
      partial[static_cast<size_t>(blockIdx.x) * 2 * cw + i] = sums[i];
    }
  }
}

// sums[i] = f32 of the blocks' partial[g][i] added in block order.
__global__ void reduce_partials(const double* __restrict__ partial, int blocks, int n,
                                float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  double s = 0.0;
  for (int g = 0; g < blocks; ++g) s += partial[static_cast<size_t>(g) * n + i];
  out[i] = static_cast<float>(s);
}

// Launches this file's kernel of a pass; *grid_out = its blocks.
template <int kStage>
cudaError_t launch_fma(const void* dense, const void* planes, const void* mask, const void* w,
                       void* partial, void* out, void* amax, int centroids, int cd, int cp,
                       int kp, int c1, int c2, int c3, int c_out, int act, int bf16,
                       int max_grid, cudaStream_t s, int* grid_out) {
  auto kernel = bf16 ? fused_sa_fwd_kernel<kStage, true> : fused_sa_fwd_kernel<kStage, false>;
  const size_t smem = Layout(kStage, kp, c1, c2, c3).total;
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
  if (grid < 1) grid = 1;  // F1 and F2 write one block's (zero) sums even for no centroid
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, s>>>(
      dense, static_cast<const float*>(planes), static_cast<const unsigned char*>(mask),
      static_cast<const float*>(w), static_cast<double*>(partial), static_cast<float*>(out),
      static_cast<int*>(amax), centroids, cd, cp, kp, c1, c2, c3, c_out, act);
  e = cudaGetLastError();
  if (e == cudaSuccess) *grid_out = static_cast<int>(grid);
  return e;
}

template <int kStage>
int launch_stage(const void* dense, const void* planes, const void* mask, const void* w,
                 const void* wb, void* partial, void* sums, void* out, void* amax,
                 int centroids, int cd, int cp, int kp, int c1, int c2, int c3, int c_out,
                 int act, int bf16, int max_grid, void* stream) {
  if (centroids < 0 || cd < 0 || cp < 0 || cd + cp < 1 || kp < cd + cp || kp % 4 || c1 <= 0 ||
      c2 <= 0 || c3 <= 0 || c1 % 64 || c2 % 64 || c3 % 64 || c_out > c3 || act < kNone ||
      act > kElu || max_grid < 1 || (wb != nullptr && !bf16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int grid = 0;
  cudaError_t e;
  if (wb != nullptr) {  // bf16 on the tensor cores
    const auto mma = kStage == 1   ? dlbt_fused_sa_f1_mma
                     : kStage == 2 ? dlbt_fused_sa_f2_mma
                                   : dlbt_fused_sa_f3_mma;
    e = static_cast<cudaError_t>(mma(dense, planes, mask, w, wb, partial, out, amax, centroids,
                                     cd, cp, c1, c2, c3, c_out, act, max_grid, stream, &grid));
  } else {
    e = launch_fma<kStage>(dense, planes, mask, w, partial, out, amax, centroids, cd, cp, kp,
                           c1, c2, c3, c_out, act, bf16, max_grid, s, &grid);
  }
  if (e != cudaSuccess || kStage == 3) return static_cast<int>(e);
  const int n = 2 * (kStage == 1 ? c1 : c2);
  reduce_partials<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const double*>(partial), grid, n, static_cast<float*>(sums));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One pass of kernel 6's forward over B*M = centroids centroids of 64 slots.
// dense (B, M, 64, CD) bf16 (bf16 != 0) or f32, or null when CD = 0; planes
// (B, M, 64, CP) f32, or null when CP = 0; mask (B, M, 64) bool; w the packed f32
// weights (see fused_sa_fwd_kernel), already rounded to the compute type, with
// KP = CD + CP rounded up to 4 and C1, C2, C3 multiples of 64. act: 0 none, 1 ReLU,
// 2 LeakyReLU (0.01), 3 ELU. F1 and F2 write sums (2, C): the column sums of h1 (of
// h2) over the valid slots, then the sums of squares; partial is their scratch,
// (max_grid, 2, C) f64. F3 writes out (B, M, c_out) f32 and amax (B, M, c_out) int32.
// wb: null, or in bf16 the bf16 weight block that sends the pass to its tensor-core
// kernel (csrc/fused_sa_f1.cu, csrc/fused_sa_f2.cu, csrc/fused_sa_f3.cu; the wrapper's
// routing rule, sa_train_kernel.mma_takes, decides from the widths), w then being the
// forward's per-column vectors of that kernel and mask 16-byte aligned.
#define DLBT_FWD_ENTRY(name, stage)                                                         \
  extern "C" int name(const void* dense, const void* planes, const void* mask, const void* w, \
                      const void* wb, void* partial, void* sums, void* out, void* amax,      \
                      int centroids, int cd, int cp, int kp, int c1, int c2, int c3,          \
                      int c_out, int act, int bf16, int max_grid, void* stream) {             \
    return launch_stage<stage>(dense, planes, mask, w, wb, partial, sums, out, amax,        \
                               centroids, cd, cp, kp, c1, c2, c3, c_out, act, bf16,         \
                               max_grid, stream);                                            \
  }
DLBT_FWD_ENTRY(dlbt_fused_sa_f1, 1)
DLBT_FWD_ENTRY(dlbt_fused_sa_f2, 2)
DLBT_FWD_ENTRY(dlbt_fused_sa_f3, 3)
#undef DLBT_FWD_ENTRY
