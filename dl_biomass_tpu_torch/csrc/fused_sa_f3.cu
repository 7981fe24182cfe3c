// Kernel 6-F3 in bf16, on the tensor cores: the last recomputing pass of the fused
// SA-layer MLP's forward (csrc/fused_sa_fwd.cu holds all three passes and runs this
// one in f32, and in bf16 at the widths this kernel does not take). Per edge row it
// recomputes h1 = [dense, planes] W1 + b1, a1 = act(h1 sc1 + sh1), h2 = a1 W2 + b2,
// a2 = act(h2 sc2 + sh2) and h3 = a2 W3 + b3, and per centroid and column the max of
// h3 over the valid slots among the 64 and the first slot that reaches it: 0 and -1
// for a centroid with no valid slot. Invalid slots never win.
//
// Replaces: dl_biomass_tpu/ops/pallas_sa_train.py fused_sa_mlp, its forward's last pass
// (_f3_kernel), in bf16.
// Semantics: those of fused_sa_stage_plain(3, ..., bf16=True). Every product takes
// bf16 operands (the weights, the edge rows with the planes rounded, a1, a2) with f32
// sums; h1 is the dense rows' product plus the planes', then b1; h1, h2, h3 and the
// BatchNorm terms stay f32.
//
// Bound on the H100: operations. Per valid edge row 2 (KP C1 + C1 C2 + C2 C3) flop
// (25,088 at SA1's 4, 64, 64, 128; 131,840 at SA2's 131, 128, 128, 256) at the bf16
// tensor cores' 989 TFLOP/s: 0.034 ms at SA1 and 0.069 ms at SA2 of a 16 x 10240
// forward. The bytes are fewer: SA2's bf16 dense block read once (134 MB), 0.04 ms;
// the outputs are (B, M, C3) values and indices.
//
// Design: the front half of the bf16 backward passes (csrc/fused_sa_b2.cu; the shared
// pieces in csrc/fused_sa_mma.cuh). A persistent block of 8 warps copies the bf16
// weights (W1^T, W2^T, W3: 138 KiB at SA2) and the forward's per-column vectors into
// shared memory once, and walks centroids with a grid stride while cp.async fills the
// other of two input buffers with the next one's edge rows, mask and planes. Warp w
// takes row tile w % 4 and half w / 4 of the columns of every product, on mma.sync
// m16n8k16 with f32 accumulators: layer1 gives a1 in bf16; layer 2 runs 32 columns at
// a time and writes a2 in bf16 into the edge rows' buffer, dead once h1 is formed (a
// region of its own where a2 is the wider); layer 3 runs 32 columns at a time, its B
// fragments from W3 as packed by ldmatrix.trans, so that the block the backward
// passes read serves here too. h3 is never stored: each accumulator fragment is
// reduced at once to its column's max and first slot (the fragment's rows g and
// g + 8 in the lane, then shuffles over lane bits 2-4, ties to the lower slot), the
// 4 row tiles' partials go to shared memory, and one thread per column takes them in
// row-tile order, so that ties go to the lowest slot. Shared memory at SA2: 211 KiB
// of 227 (the weights 138, two input buffers 40, a1 17, the vectors 8 and the max
// partials 8), one block per SM; SA1: 63 KiB. No atomics and no cross-block sum: a
// forward repeats bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "fused_sa_mma.cuh"

namespace {

using namespace fused_sa_mma;

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }

// (v, i) replaces (best, at) when it is larger, or equal at an earlier slot.
__device__ __forceinline__ void take_max(float v, int i, float& best, int& at) {
  if (v > best || (v == best && i < at)) {
    best = v;
    at = i;
  }
}

// Byte offsets of one block's shared memory: the bf16 weights (W1^T, W2^T, W3), the
// forward's per-column vectors (fwd_vec_bytes), two input buffers (Inputs, without a
// cotangent), the a1 rows, the a2 rows where the edge rows cannot hold them, and the
// row tiles' column maxima (f32) and slots (int32), C3 each.
struct Layout {
  Inputs in;
  size_t w3, vec, buf, a1, a2, red, total;
  bool a2_in_x;
  __host__ __device__ Layout(int kx, int cp, int c1, int c2, int c3) : in(kx, cp, 0) {
    size_t at = w1t_bytes(kx, c1) + w2t_bytes(c1, c2);
    w3 = at;
    at += w3_bytes(c2, c3);
    vec = take(at, fwd_vec_bytes(c1, c2, c3));
    buf = take(at, 2 * in.stride);
    a1 = take(at, 2ull * kSlots * (c1 + kSkewH));
    a2_in_x = c2 <= kx;
    a2 = a2_in_x ? 0 : take(at, 2ull * kSlots * (c2 + kSkewH));
    red = take(at, 8ull * kRowTiles * c3);
    total = at;
  }
};

// kT1: layer 1's n-tiles per warp (C1 / 16). w holds the forward's per-column vectors
// (Vec order, layer 1's then layer 2's, then b3), wb the bf16 weights.
template <int kT1>
__global__ void __launch_bounds__(kThreads, kT1 == 4 ? 2 : 1)
    fused_sa_f3_kernel(const bf16* __restrict__ dense, const float* __restrict__ planes,
                       const unsigned char* __restrict__ mask, const float* __restrict__ w,
                       const bf16* __restrict__ wb, float* __restrict__ out,
                       int* __restrict__ amax, long long total, int cd, int cp, int c1, int c2,
                       int c3, int c_out, int act) {
  extern __shared__ __align__(16) char smem[];
  const int cd16 = round16(cd), kx = cd16 + round16(cp);
  const Layout L(kx, cp, c1, c2, c3);
  const bf16* const w1t = reinterpret_cast<const bf16*>(smem);
  const bf16* const w2t = reinterpret_cast<const bf16*>(smem + w1t_bytes(kx, c1));
  const bf16* const w3 = reinterpret_cast<const bf16*>(smem + L.w3);
  const float* const v1 = reinterpret_cast<const float*>(smem + L.vec);
  const float* const v2 = v1 + kVecs * c1;
  const float* const b3 = v2 + kVecs * c2;
  bf16* const a1 = reinterpret_cast<bf16*>(smem + L.a1);
  float* const red = reinterpret_cast<float*>(smem + L.red);
  int* const red_at = reinterpret_cast<int*>(red + kRowTiles * c3);
  const int ldx = kx + kSkewH, ld1 = c1 + kSkewH, ld2 = c2 + kSkewH, ld3 = c3 + kSkewH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int tile = warp % kRowTiles, r0 = 16 * tile, half = warp / kRowTiles;
  const int n1 = half * 8 * kT1;  // the warp's first column of layer 1
  const bool dense_vec = cd % 8 == 0 && reinterpret_cast<uintptr_t>(dense) % 16 == 0;

  copy_async(smem, wb, L.vec);  // the weights and the vectors, once per block
  copy_async(smem + L.vec, w, fwd_vec_bytes(c1, c2, c3));
  const auto prefetch = [&](long long ci, int b) {
    prefetch_inputs(smem + L.buf + b * L.in.stride, L.in, ci, dense, planes, mask, nullptr,
                    nullptr, cd, cp, ldx, 0, dense_vec);
  };
  if (blockIdx.x < total) prefetch(blockIdx.x, 0);
  dlbt::cp_async_commit();

  int b = 0;
  for (long long ci = blockIdx.x; ci < total; ci += gridDim.x, b ^= 1) {
    if (ci + gridDim.x < total) prefetch(ci + gridDim.x, b ^ 1);
    dlbt::cp_async_commit();
    dlbt::cp_async_wait<1>();  // this centroid's copies (and the weights) have landed
    __syncthreads();           // ... for every thread
    const long long row0 = ci * kSlots;
    char* const in = smem + L.buf + b * L.in.stride;
    const unsigned char* const mk = reinterpret_cast<const unsigned char*>(in + L.in.mask);
    if (!__syncthreads_or(tid < kSlots && mk[tid] != 0)) {  // no valid slot: 0 and -1
      for (int col = tid; col < c_out; col += kThreads) {
        out[ci * c_out + col] = 0.0f;
        amax[ci * c_out + col] = -1;
      }
      continue;
    }
    bf16* const x = reinterpret_cast<bf16*>(in + L.in.x);
    stage_inputs(in, L.in, nullptr, nullptr, 0, 0, 0, dense, row0, cd, cp, kx, ldx, dense_vec);
    __syncthreads();

    {
      float h1[kT1][4];
      layer1<kT1>(x, ldx, w1t, cd16, kx, cp, v1, c1, act, a1, ld1, r0, n1, h1);
    }
    __syncthreads();  // from here the edge rows are dead: their room takes a2
    bf16* const a2 = L.a2_in_x ? x : reinterpret_cast<bf16*>(smem + L.a2);

    // layer 2: a2 in bf16
    layer2_fwd(a1, ld1, w2t, c1, c2, r0, half, [&](int col, const float (&h2)[4]) {
      const float2 bias = at2(v2 + kBias * c2, col), sc = at2(v2 + kScale * c2, col),
                   sh = at2(v2 + kShift * c2, col);
      float a[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a[e] = activate((h2[e] + lane2(bias, e)) * lane2(sc, e) + lane2(sh, e), act);
      }
      put2(a2, ld2, r0 + g, col, a[0], a[1]);
      put2(a2, ld2, r0 + g + 8, col, a[2], a[3]);
    });
    __syncthreads();

    // layer 3, 32 columns at a time: h3 = a2 W3 + b3, reduced at once to each column's
    // max over the tile's valid rows and the first row that reaches it
    const bool ok_lo = mk[r0 + g] != 0, ok_hi = mk[r0 + g + 8] != 0;
    for (int n0 = half * (c3 / 2); n0 < (half + 1) * (c3 / 2); n0 += 8 * kSub) {
      float h3[kSub][4];
      dlbt::zero_acc(h3);
      dlbt::warp_mma_tb<kSub / 2>(a2, ld2, w3, ld3, c2, r0, n0, h3);
#pragma unroll
      for (int nt = 0; nt < kSub; ++nt) {
        const int col = n0 + 8 * nt + 2 * t;
        const float2 bias = at2(b3, col);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          float best = ok_lo ? h3[nt][p] + lane2(bias, p) : neg_inf();
          int at = ok_lo ? r0 + g : kSlots;
          const float hi = h3[nt][p + 2] + lane2(bias, p);
          if (ok_hi && hi > best) {
            best = hi;
            at = r0 + g + 8;
          }
#pragma unroll
          for (int off = 4; off <= 16; off <<= 1) {  // the lanes of the other rows g
            take_max(__shfl_xor_sync(0xffffffffu, best, off),
                     __shfl_xor_sync(0xffffffffu, at, off), best, at);
          }
          if (g == 0) {
            red[tile * c3 + col + p] = best;
            red_at[tile * c3 + col + p] = at;
          }
        }
      }
    }
    __syncthreads();

    // the 4 row tiles in order: ties to the lowest slot
    for (int col = tid; col < c_out; col += kThreads) {
      float best = red[col];
      int at = red_at[col];
#pragma unroll
      for (int q = 1; q < kRowTiles; ++q) take_max(red[q * c3 + col], red_at[q * c3 + col], best, at);
      const bool found = at < kSlots;
      out[ci * c_out + col] = found ? best : 0.0f;
      amax[ci * c_out + col] = found ? at : -1;
    }
    __syncthreads();  // the buffer, the rows and the partials are consumed
  }
  dlbt::cp_async_wait<0>();
}

template <int kT1>
cudaError_t launch(const void* dense, const void* planes, const void* mask, const void* w,
                   const void* wb, void* out, void* amax, int centroids, int cd, int cp, int c1,
                   int c2, int c3, int c_out, int act, int max_grid, cudaStream_t stream) {
  const auto kernel = fused_sa_f3_kernel<kT1>;
  const size_t smem = Layout(round16(cd) + round16(cp), cp, c1, c2, c3).total;
  int blocks = 0;
  cudaError_t e = persistent_grid(kernel, smem, centroids, max_grid, 1, &blocks);
  if (e != cudaSuccess) return e;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const bf16*>(dense), static_cast<const float*>(planes),
      static_cast<const unsigned char*>(mask), static_cast<const float*>(w),
      static_cast<const bf16*>(wb), static_cast<float*>(out), static_cast<int*>(amax),
      centroids, cd, cp, c1, c2, c3, c_out, act);
  return cudaGetLastError();
}

}  // namespace

// F3 in bf16 over B*M = centroids centroids, the arguments of dlbt_fused_sa_f3
// (csrc/fused_sa_fwd.cu, which checks the shared ones) but w, here the forward's
// per-column vectors (7 (C1 + C2) + C3 f32: b, sc, sh, mean, inv, ta, tb of layer 1,
// then of layer 2, only b, sc and sh read; then b3), and wb, the bf16 weight block
// (W1^T, W2^T, W3 as fused_sa_mma.cuh lays them out); mask, w and wb 16-byte aligned;
// partial unread. Writes out (B, M, c_out) f32 and amax (B, M, c_out) int32; *grid = 0
// (no slices). C1 64 or 128, C2 and C3 multiples of 64, and the layout within the
// block's shared memory.
extern "C" int dlbt_fused_sa_f3_mma(const void* dense, const void* planes, const void* mask,
                                    const void* w, const void* wb, void* partial, void* out,
                                    void* amax, int centroids, int cd, int cp, int c1, int c2,
                                    int c3, int c_out, int act, int max_grid, void* stream,
                                    int* grid) {
  (void)partial;
  *grid = 0;
  if ((c1 != 64 && c1 != 128) || c2 % 64 || c3 % 64 || wb == nullptr ||
      reinterpret_cast<uintptr_t>(wb) % 16 || reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(mask) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      c1 == 64 ? launch<4>(dense, planes, mask, w, wb, out, amax, centroids, cd, cp, c1, c2, c3,
                           c_out, act, max_grid, s)
               : launch<8>(dense, planes, mask, w, wb, out, amax, centroids, cd, cp, c1, c2, c3,
                           c_out, act, max_grid, s);
  return static_cast<int>(e);
}
