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
// bf16 values (carried exactly in f32, so -0.0 and +0.0 compare equal); the
// argmax is the smallest slot whose value equals the max, and 64 where the max
// is -inf (no valid slot); the output is 0 where no slot is valid. Backward:
// gs holds gb (the cotangent in bf16) at row amax[c] of column c (nothing for
// 64), then da2 = bf16(gs W3^T) and dW3 = a2^T gs, bf16 products with f32 sums,
// dense over the 64 slots as in the TPU kernel (so, as there, a non-finite a2
// value at a slot that no column routes to reaches dW3 as 0 x junk). db3 is
// summed from the f32 cotangent outside the kernel.
//
// Bound on the H100: bytes. The forward reads a2 once (B*M*64*C2 bf16: 604 MB
// at SA1's 36 x 2048 x 64 x 64) and the mask, and writes (B, M, C3) bf16; its
// 2*B*M*64*C2*C3 flop (77.3 G at SA1) take 0.078 ms on the bf16 tensor cores
// against 0.187 ms of bytes. The backward reads a2 and writes da2 (1.2 GB at
// SA1, 0.37 ms); its two dense products are twice the forward's flop (0.16
// ms), and the routed work they stand for is 4*C2*C3 flop per centroid.
//
// Design: both kernels keep a block on one centroid at a time with a grid
// stride, and copy the next centroid's inputs (a2's 64 rows, and the mask or
// the cotangent and argmax) into a second shared-memory buffer with cp.async
// while they compute on the current one. W3 is rounded to bf16 in shared
// memory once per block. All products run on the tensor cores
// (mma_bf16.cuh). Forward: each warp takes 32 output columns at a time for all
// 64 rows (its accumulators cover the 4 row tiles, so each B fragment read
// from shared memory serves 4 products), rounds z to bf16, selects -inf at
// invalid slots and folds its rows into a (max, first slot) pair per column
// in registers, then merges the 8 row groups of its lanes with shuffles and
// writes the columns. Backward: the
// block scatters gb into a zeroed bf16 gs tile (64 x C3) in shared memory;
// warps take da2's 16 x 32 tiles (gs W3^T, rounded to bf16 and written out),
// and each warp keeps two 16 x 64 tiles of dW3 in registers for all its
// block's centroids (a2^T gs, fragments loaded transposed with ldmatrix); the
// tile's scattered entries are zeroed again after use, by the threads that
// routed them, from the rows they kept in registers. No float atomics: each
// block writes its dW3 slice, summed over its centroids in order, and a second
// launch (dlbt_sum_slices, csrc/sum_slices.cu) adds the slices in block order
// in f64, so a backward repeats bit for bit on one card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_bf16.cuh"

namespace {

using dlbt::kSkewH;

constexpr int kSlots = 64;
constexpr int kRowGroups = kSlots / 16;  // the 16-row tiles of a centroid's slots
constexpr int kFwdCols = 32;             // the forward's columns per warp task
constexpr int kFwdMaxWarps = 8;
constexpr int kTilesPerWarp = 2;         // the backward's 16 x 64 dW3 tiles per warp
constexpr int kBwdMaxThreads = 512;      // 128 registers a thread
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }

__host__ __device__ __forceinline__ size_t take(size_t& at, size_t bytes) {
  const size_t offset = at;
  at += (bytes + 15) / 16 * 16;
  return offset;
}

// (v, i) takes (ov, oi) if ov is larger, or equal at a smaller slot: the max
// with the first-slot tie rule, whatever order the pairs are merged in.
__device__ __forceinline__ void keep_first_max(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
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

// The forward's shared memory: W3^T in bf16 (C3 rows of C2 + 8), b3, and two
// buffers of a centroid's a2 rows (64 rows of C2 + 8 bf16) and slot flags.
struct FwdLayout {
  size_t wt, bias, a[2], mask[2], total;
  __host__ __device__ FwdLayout(int c2, int c3) {
    size_t at = 0;
    wt = take(at, 2ull * c3 * (c2 + kSkewH));
    bias = take(at, 4ull * c3);
    for (int b = 0; b < 2; ++b) {
      a[b] = take(at, 2ull * kSlots * (c2 + kSkewH));
      mask[b] = take(at, kSlots);
    }
    total = at;
  }
};

__global__ void __launch_bounds__(32 * kFwdMaxWarps)
    fused_tail_fwd_kernel(const __nv_bfloat16* __restrict__ a2,
                          const unsigned char* __restrict__ mask, const float* __restrict__ w3,
                          const float* __restrict__ b3, __nv_bfloat16* __restrict__ out,
                          int* __restrict__ amax, int centroids, int c2, int c3) {
  extern __shared__ __align__(16) char smem[];
  const FwdLayout L(c2, c3);
  __nv_bfloat16* wt = reinterpret_cast<__nv_bfloat16*>(smem + L.wt);
  float* bias = reinterpret_cast<float*>(smem + L.bias);
  const int lda = c2 + kSkewH;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int warps = blockDim.x >> 5;

  auto stage = [&](long long cen, int b) {
    stage_rows(reinterpret_cast<__nv_bfloat16*>(smem + L.a[b]), lda, a2, cen, c2);
    if (threadIdx.x < kSlots / 16) {
      dlbt::cp_async16(smem + L.mask[b] + 16 * threadIdx.x, mask + cen * kSlots + 16 * threadIdx.x);
    }
  };
  if (static_cast<int>(blockIdx.x) < centroids) stage(blockIdx.x, 0);
  dlbt::cp_async_commit();
  load_w3(wt, w3, c2, c3, lda, true);
  for (int i = threadIdx.x; i < c3; i += blockDim.x) bias[i] = b3[i];

  int b = 0;
  for (long long cen = blockIdx.x; cen < centroids; cen += gridDim.x, b ^= 1) {
    if (cen + gridDim.x < centroids) stage(cen + gridDim.x, b ^ 1);
    dlbt::cp_async_commit();
    dlbt::cp_async_wait<1>();  // this centroid's copies have landed
    __syncthreads();
    const __nv_bfloat16* a = reinterpret_cast<const __nv_bfloat16*>(smem + L.a[b]);
    const unsigned char* mk = reinterpret_cast<const unsigned char*>(smem + L.mask[b]);
    const bool any = __any_sync(kFull, mk[lane] | mk[lane + 32]);
    for (int n0 = warp * kFwdCols; n0 < c3; n0 += warps * kFwdCols) {
      // z for all 64 rows x the 32 columns: each B fragment serves the 4 row groups
      float acc[kRowGroups][4][4];
#pragma unroll
      for (int rg = 0; rg < kRowGroups; ++rg) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[rg][nt][j] = 0.0f;
        }
      }
      for (int k0 = 0; k0 < c2; k0 += 16) {
        uint32_t bf[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const __nv_bfloat16* br = wt + (n0 + nt * 8 + g) * lda + k0 + 2 * t;
          bf[nt][0] = dlbt::ld32(br);
          bf[nt][1] = dlbt::ld32(br + 8);
        }
#pragma unroll
        for (int rg = 0; rg < kRowGroups; ++rg) {
          const __nv_bfloat16* ar = a + (rg * 16 + g) * lda + k0 + 2 * t;
          const uint32_t af[4] = {dlbt::ld32(ar), dlbt::ld32(ar + 8 * lda), dlbt::ld32(ar + 8),
                                  dlbt::ld32(ar + 8 * lda + 8)};
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) dlbt::mma_bf16(acc[rg][nt], af, bf[nt]);
        }
      }
      // each lane's rows (g and g + 8 of each row group) folded into a running
      // (max, first slot) pair per column, in ascending row order
      float best[4][2];
      int arg[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        best[nt][0] = best[nt][1] = neg_inf();
        arg[nt][0] = arg[nt][1] = kSlots;
      }
#pragma unroll
      for (int rg = 0; rg < kRowGroups; ++rg) {
        const int r0 = rg * 16 + g, r1 = r0 + 8;
        const bool v0 = mk[r0] != 0, v1 = mk[r1] != 0;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // the lane's two columns
            const float bb = bias[n0 + nt * 8 + 2 * t + h];
            const float z0 = v0 ? round_bf16(acc[rg][nt][h] + bb) : neg_inf();
            const float z1 = v1 ? round_bf16(acc[rg][nt][2 + h] + bb) : neg_inf();
            keep_first_max(best[nt][h], arg[nt][h], z0, z0 == neg_inf() ? kSlots : r0);
            keep_first_max(best[nt][h], arg[nt][h], z1, z1 == neg_inf() ? kSlots : r1);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v = best[nt][h];
          int i = arg[nt][h];
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {  // over the 8 row groups (lane bits 2..4)
            keep_first_max(v, i, __shfl_xor_sync(kFull, v, off), __shfl_xor_sync(kFull, i, off));
          }
          if (g == 0) {
            const long long o = cen * c3 + n0 + nt * 8 + 2 * t + h;
            out[o] = __float2bfloat16_rn(any ? v : 0.0f);
            if (amax != nullptr) amax[o] = i;
          }
        }
      }
    }
    __syncthreads();  // the buffer is consumed before the copies of the centroid after next
  }
  dlbt::cp_async_wait<0>();
}

// The backward's shared memory: bf16(W3) as it is (C2 rows of C3 + 8), the gs
// tile (64 rows of C3 + 8 bf16, zero but where routed), and two buffers of a
// centroid's a2 rows (64 rows of C2 + 8 bf16), argmax (C3 int32) and
// cotangent (C3 bf16).
struct BwdLayout {
  size_t w, gs, a[2], am[2], g[2], total;
  __host__ __device__ BwdLayout(int c2, int c3) {
    size_t at = 0;
    w = take(at, 2ull * c2 * (c3 + kSkewH));
    gs = take(at, 2ull * kSlots * (c3 + kSkewH));
    for (int b = 0; b < 2; ++b) {
      a[b] = take(at, 2ull * kSlots * (c2 + kSkewH));
      am[b] = take(at, 4ull * c3);
      g[b] = take(at, 2ull * c3);
    }
    total = at;
  }
};

__host__ __device__ __forceinline__ int bwd_warps(int c2, int c3) {
  return (c2 / 16) * (c3 / 64) / kTilesPerWarp;
}

__global__ void __launch_bounds__(kBwdMaxThreads)
    fused_tail_bwd_kernel(const __nv_bfloat16* __restrict__ a2,
                          const __nv_bfloat16* __restrict__ gb, const int* __restrict__ amax,
                          const float* __restrict__ w3, float* __restrict__ partial,
                          __nv_bfloat16* __restrict__ da2, int centroids, int c2, int c3) {
  extern __shared__ __align__(16) char smem[];
  const BwdLayout L(c2, c3);
  __nv_bfloat16* w = reinterpret_cast<__nv_bfloat16*>(smem + L.w);
  __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(smem + L.gs);
  const int lda = c2 + kSkewH, ldg = c3 + kSkewH;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int warps = blockDim.x >> 5;
  const int col_tiles = c3 / 64;

  auto stage = [&](long long cen, int b) {
    stage_rows(reinterpret_cast<__nv_bfloat16*>(smem + L.a[b]), lda, a2, cen, c2);
    const char* am_src = reinterpret_cast<const char*>(amax + cen * c3);
    const char* g_src = reinterpret_cast<const char*>(gb + cen * c3);
    for (int i = threadIdx.x; i < c3 / 4; i += blockDim.x) {
      dlbt::cp_async16(smem + L.am[b] + 16 * i, am_src + 16 * i);
    }
    for (int i = threadIdx.x; i < c3 / 8; i += blockDim.x) {
      dlbt::cp_async16(smem + L.g[b] + 16 * i, g_src + 16 * i);
    }
  };
  if (static_cast<int>(blockIdx.x) < centroids) stage(blockIdx.x, 0);
  dlbt::cp_async_commit();
  load_w3(w, w3, c2, c3, ldg, false);
  for (int i = threadIdx.x; i < kSlots * ldg / 2; i += blockDim.x) {
    reinterpret_cast<uint32_t*>(gs)[i] = 0u;
  }
  float acc[kTilesPerWarp][8][4];
#pragma unroll
  for (int tt = 0; tt < kTilesPerWarp; ++tt) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[tt][nt][j] = 0.0f;
    }
  }

  int b = 0;
  for (long long cen = blockIdx.x; cen < centroids; cen += gridDim.x, b ^= 1) {
    if (cen + gridDim.x < centroids) stage(cen + gridDim.x, b ^ 1);
    dlbt::cp_async_commit();
    dlbt::cp_async_wait<1>();  // this centroid's copies have landed
    __syncthreads();           // ... for every thread, and gs is clean again
    // thread c routes column c (blockDim.x = C2 C3 / 64 >= C3) and keeps its
    // row, to clear it below without reading the buffer that the next
    // centroid's copies refill
    const int c = threadIdx.x;
    const int r = c < c3 ? reinterpret_cast<const int*>(smem + L.am[b])[c] : kSlots;
    const bool routed = r >= 0 && r < kSlots;
    if (routed) gs[r * ldg + c] = reinterpret_cast<const __nv_bfloat16*>(smem + L.g[b])[c];
    __syncthreads();
    const __nv_bfloat16* a = reinterpret_cast<const __nv_bfloat16*>(smem + L.a[b]);
    // da2 = bf16(gs W3^T), 16 x 32 tiles: rows r, columns j
    for (int task = warp; task < kRowGroups * (c2 / 32); task += warps) {
      const int r0 = (task % kRowGroups) * 16, j0 = (task / kRowGroups) * 32;
      float d[4][4];
      dlbt::warp_mma<4>(gs, ldg, w, c3, r0, j0, d);
      __nv_bfloat16* dst = da2 + cen * kSlots * c2 + j0 + 2 * t;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        *reinterpret_cast<__nv_bfloat162*>(dst + (r0 + g) * c2 + nt * 8) =
            __floats2bfloat162_rn(d[nt][0], d[nt][1]);
        *reinterpret_cast<__nv_bfloat162*>(dst + (r0 + g + 8) * c2 + nt * 8) =
            __floats2bfloat162_rn(d[nt][2], d[nt][3]);
      }
    }
    // dW3 += a2^T gs on the warp's tiles: rows j, columns c
#pragma unroll
    for (int tt = 0; tt < kTilesPerWarp; ++tt) {
      const int tile = warp * kTilesPerWarp + tt;
      dlbt::warp_mma64_tn(a, lda, gs, ldg, kSlots, (tile / col_tiles) * 16,
                          (tile % col_tiles) * 64, acc[tt]);
    }
    __syncthreads();  // gs and the buffer are consumed
    if (routed) gs[r * ldg + c] = __float2bfloat16_rn(0.0f);
  }
  dlbt::cp_async_wait<0>();
  float* slice = partial + static_cast<size_t>(blockIdx.x) * c2 * c3;
#pragma unroll
  for (int tt = 0; tt < kTilesPerWarp; ++tt) {
    const int tile = warp * kTilesPerWarp + tt;
    const int j = (tile / col_tiles) * 16 + g, c0 = (tile % col_tiles) * 64 + 2 * t;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      *reinterpret_cast<float2*>(slice + static_cast<size_t>(j) * c3 + c0 + nt * 8) =
          make_float2(acc[tt][nt][0], acc[tt][nt][1]);
      *reinterpret_cast<float2*>(slice + static_cast<size_t>(j + 8) * c3 + c0 + nt * 8) =
          make_float2(acc[tt][nt][2], acc[tt][nt][3]);
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

}  // namespace

// Forward over B*M = centroids centroids: a2 (centroids, 64, C2) bf16 and mask
// (centroids, 64) bool, both 16-byte aligned; w3 (C2, C3) and b3 (C3) f32.
// Writes out (centroids, C3) bf16 and, unless amax is null, amax (centroids,
// C3) int32. C2 a multiple of 16, C3 of 32.
extern "C" int dlbt_fused_tail_fwd(const void* a2, const void* mask, const void* w3,
                                   const void* b3, void* out, void* amax, int centroids, int c2,
                                   int c3, void* stream) {
  if (centroids < 0 || c2 <= 0 || c3 <= 0 || c2 % 16 || c3 % kFwdCols || !aligned16(a2) ||
      !aligned16(mask)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (centroids == 0) return 0;
  const int warps = c3 / kFwdCols < kFwdMaxWarps ? c3 / kFwdCols : kFwdMaxWarps;
  const size_t smem = FwdLayout(c2, c3).total;
  int grid = 0;
  cudaError_t e = grid_for(fused_tail_fwd_kernel, 32 * warps, smem, centroids, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  fused_tail_fwd_kernel<<<grid, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a2), static_cast<const unsigned char*>(mask),
      static_cast<const float*>(w3), static_cast<const float*>(b3),
      static_cast<__nv_bfloat16*>(out), static_cast<int*>(amax), centroids, c2, c3);
  return static_cast<int>(cudaGetLastError());
}

// Backward over B*M = centroids centroids: a2 (centroids, 64, C2) bf16, gb
// (centroids, C3) bf16 and amax (centroids, C3) int32, the forward's argmax,
// all 16-byte aligned; w3 (C2, C3) f32. Writes da2 (centroids, 64, C2) bf16 and
// each block's dW3 slice, (C2, C3) f32, into partial (max_grid, C2 * C3);
// *grid_out (host memory) is the number of slices written, for dlbt_sum_slices
// (csrc/sum_slices.cu). C2 and C3 multiples of 64, (C2/16)(C3/64) <= 32.
extern "C" int dlbt_fused_tail_bwd(const void* a2, const void* gb, const void* amax,
                                   const void* w3, void* partial, void* da2, int centroids,
                                   int c2, int c3, int max_grid, int* grid_out, void* stream) {
  *grid_out = 0;
  if (centroids < 0 || c2 <= 0 || c3 <= 0 || c2 % 64 || c3 % 64 ||
      32 * bwd_warps(c2, c3) > kBwdMaxThreads || max_grid < 1 || !aligned16(a2) ||
      !aligned16(gb) || !aligned16(amax)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (centroids == 0) return 0;
  const int threads = 32 * bwd_warps(c2, c3);
  const size_t smem = BwdLayout(c2, c3).total;
  int grid = 0;
  const long long cap = centroids < max_grid ? centroids : max_grid;
  cudaError_t e = grid_for(fused_tail_bwd_kernel, threads, smem, cap, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  fused_tail_bwd_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a2), static_cast<const __nv_bfloat16*>(gb),
      static_cast<const int*>(amax), static_cast<const float*>(w3),
      static_cast<float*>(partial), static_cast<__nv_bfloat16*>(da2), centroids, c2, c3);
  e = cudaGetLastError();
  if (e == cudaSuccess) *grid_out = grid;
  return static_cast<int>(e);
}
