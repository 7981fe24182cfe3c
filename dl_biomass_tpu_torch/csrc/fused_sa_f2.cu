// Kernel 6-F2 in bf16, on the tensor cores: the second recomputing pass of the fused
// SA-layer MLP's forward (csrc/fused_sa_fwd.cu holds all three passes and runs this
// one in f32, and in bf16 at the widths this kernel does not take). Per edge row it
// recomputes h1 = [dense, planes] W1 + b1 and a1 = act(h1 sc1 + sh1), and forms
// h2 = a1 W2 + b2; it returns the column sums of h2 and of h2^2 over the valid edge
// rows of the whole batch (F3's statistics for layer 2's BatchNorm).
//
// Replaces: dl_biomass_tpu/ops/pallas_sa_train.py fused_sa_mlp, its forward's second
// pass (_f2_kernel), in bf16.
// Semantics: those of fused_sa_stage_plain(2, ..., bf16=True). Every product takes
// bf16 operands (the weights, the edge rows with the planes rounded, a1) with f32
// sums; h1, h2 and the sums stay f32 (f64 across centroids and blocks).
//
// Bound on the H100: bytes. SA2's bf16 dense block read once (134 MB at a 16 x 10240
// forward), 0.042 ms; the products, 2 (KP C1 + C1 C2) flop per valid edge row, take
// less at the bf16 tensor cores' 989 TFLOP/s (0.023 ms at SA2).
//
// Design: the front half of csrc/fused_sa_f3.cu, with B2's column sums (csrc/fused_sa_b2.cu;
// the shared pieces in csrc/fused_sa_mma.cuh). A persistent block of 8 warps copies the
// bf16 W1^T and W2^T (not W3) and the per-column vectors into shared memory once, and
// walks centroids with a grid stride while cp.async fills the other of two input
// buffers. Warp w takes row tile w % 4 and half w / 4 of the columns: layer1 gives a1
// in bf16, layer 2 runs 32 columns at a time on mma.sync, and each accumulator tile is
// reduced at once to its columns' sums of the masked h2 and h2^2 over the tile's 16
// rows in f32 (tile_colsum). These land in the edge rows' buffer, dead once h1 is
// formed (a region of their own where they do not fit there), and one thread per
// element adds the 4 row tiles in their order in f64 into a register it keeps across
// centroids. No float atomics: each block writes its f64 slice, and the entry's second
// launch (csrc/fused_sa_fwd.cu, reduce_partials) adds the slices in block order, so
// two launches agree bit for bit. Shared memory at SA2: 136 KiB (the weights 72, two
// input buffers 40, a1 17, the vectors 7); SA1: 33 KiB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "fused_sa_mma.cuh"

namespace {

using namespace fused_sa_mma;

constexpr int kOwned = 2;  // elements of the block's slice (s, then ss: 2 C2) a thread adds up

// Byte offsets of one block's shared memory: the bf16 W1^T and W2^T, the per-column
// vectors of both layers (Vec order), two input buffers (Inputs, without a
// cotangent), the a1 rows, and the row tiles' column sums of h2 and h2^2 (2 C2 each)
// where the edge rows cannot hold them.
struct Layout {
  Inputs in;
  size_t vec, buf, a1, red, total;
  bool red_in_x;
  __host__ __device__ Layout(int kx, int cp, int c1, int c2) : in(kx, cp, 0) {
    size_t at = w1t_bytes(kx, c1) + w2t_bytes(c1, c2);
    vec = take(at, vec_bytes(c1, c2));
    buf = take(at, 2 * in.stride);
    a1 = take(at, 2ull * kSlots * (c1 + kSkewH));
    const size_t red_bytes = 4ull * kRowTiles * 2 * c2;
    red_in_x = red_bytes <= 2ull * kSlots * (kx + kSkewH);
    red = red_in_x ? 0 : take(at, red_bytes);
    total = at;
  }
};

// kT1: layer 1's n-tiles per warp (C1 / 16). w holds the per-column vectors (Vec
// order, layer 1's then layer 2's), wb the bf16 weights (W3 unread).
template <int kT1>
__global__ void __launch_bounds__(kThreads, kT1 == 4 ? 2 : 1)
    fused_sa_f2_kernel(const bf16* __restrict__ dense, const float* __restrict__ planes,
                       const unsigned char* __restrict__ mask, const float* __restrict__ w,
                       const bf16* __restrict__ wb, double* __restrict__ partial,
                       long long total, int cd, int cp, int c1, int c2, int act) {
  extern __shared__ __align__(16) char smem[];
  const int cd16 = round16(cd), kx = cd16 + round16(cp);
  const Layout L(kx, cp, c1, c2);
  const bf16* const w1t = reinterpret_cast<const bf16*>(smem);
  const bf16* const w2t = reinterpret_cast<const bf16*>(smem + w1t_bytes(kx, c1));
  const float* const v1 = reinterpret_cast<const float*>(smem + L.vec);
  const float* const v2 = v1 + kVecs * c1;
  bf16* const a1 = reinterpret_cast<bf16*>(smem + L.a1);
  const int ldx = kx + kSkewH, ld1 = c1 + kSkewH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2;
  const int tile = warp % kRowTiles, r0 = 16 * tile, half = warp / kRowTiles;
  const int n1 = half * 8 * kT1;  // the warp's first column of layer 1
  const int nv = 2 * c2;          // the block's slice: s, then ss
  const bool dense_vec = cd % 8 == 0 && reinterpret_cast<uintptr_t>(dense) % 16 == 0;

  copy_async(smem, wb, w1t_bytes(kx, c1) + w2t_bytes(c1, c2));  // once per block
  copy_async(smem + L.vec, w, vec_bytes(c1, c2));
  const auto prefetch = [&](long long ci, int b) {
    prefetch_inputs(smem + L.buf + b * L.in.stride, L.in, ci, dense, planes, mask, nullptr,
                    nullptr, cd, cp, ldx, 0, dense_vec);
  };
  if (blockIdx.x < total) prefetch(blockIdx.x, 0);
  dlbt::cp_async_commit();

  double sums[kOwned] = {};  // elements tid + kThreads k of the slice

  int b = 0;
  for (long long ci = blockIdx.x; ci < total; ci += gridDim.x, b ^= 1) {
    if (ci + gridDim.x < total) prefetch(ci + gridDim.x, b ^ 1);
    dlbt::cp_async_commit();
    dlbt::cp_async_wait<1>();  // this centroid's copies (and the weights) have landed
    __syncthreads();           // ... for every thread
    const long long row0 = ci * kSlots;
    char* const in = smem + L.buf + b * L.in.stride;
    const unsigned char* const mk = reinterpret_cast<const unsigned char*>(in + L.in.mask);
    if (!__syncthreads_or(tid < kSlots && mk[tid] != 0)) continue;  // no valid slot
    bf16* const x = reinterpret_cast<bf16*>(in + L.in.x);
    stage_inputs(in, L.in, nullptr, nullptr, 0, 0, 0, dense, row0, cd, cp, kx, ldx, dense_vec);
    __syncthreads();

    {
      float h1[kT1][4];
      layer1<kT1>(x, ldx, w1t, cd16, kx, cp, v1, c1, act, a1, ld1, r0, n1, h1);
    }
    __syncthreads();  // from here the edge rows are dead: their room takes the sums
    float* const red = reinterpret_cast<float*>(L.red_in_x ? in + L.in.x : smem + L.red);

    // layer 2: the tile's column sums of the masked h2 and h2^2
    const bool ok_lo = mk[r0 + g] != 0, ok_hi = mk[r0 + g + 8] != 0;
    layer2_fwd(a1, ld1, w2t, c1, c2, r0, half, [&](int col, const float (&h2)[4]) {
      const float2 bias = at2(v2 + kBias * c2, col);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const float lo = ok_lo ? h2[p] + lane2(bias, p) : 0.0f;
        const float hi = ok_hi ? h2[p + 2] + lane2(bias, p) : 0.0f;
        const float s = tile_colsum(lo, hi), ss = tile_colsum(lo * lo, hi * hi);
        if (g == 0) {
          red[tile * nv + col + p] = s;
          red[tile * nv + c2 + col + p] = ss;
        }
      }
    });
    __syncthreads();

    // each element's 4 row tiles, in their order, in f64
#pragma unroll
    for (int k = 0; k < kOwned; ++k) {
      const int j = tid + k * kThreads;
      if (j < nv) {
        double s = 0.0;
#pragma unroll
        for (int q = 0; q < kRowTiles; ++q) s += red[q * nv + j];
        sums[k] += s;
      }
    }
    __syncthreads();  // the buffer, the rows and the column sums are consumed
  }
  dlbt::cp_async_wait<0>();
#pragma unroll
  for (int k = 0; k < kOwned; ++k) {
    const int j = tid + k * kThreads;
    if (j < nv) partial[static_cast<size_t>(blockIdx.x) * nv + j] = sums[k];
  }
}

template <int kT1>
cudaError_t launch(const void* dense, const void* planes, const void* mask, const void* w,
                   const void* wb, void* partial, int centroids, int cd, int cp, int c1, int c2,
                   int act, int max_grid, cudaStream_t stream, int* grid) {
  const auto kernel = fused_sa_f2_kernel<kT1>;
  const size_t smem = Layout(round16(cd) + round16(cp), cp, c1, c2).total;
  int blocks = 0;
  cudaError_t e = persistent_grid(kernel, smem, centroids, max_grid, 1, &blocks);
  if (e != cudaSuccess) return e;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const bf16*>(dense), static_cast<const float*>(planes),
      static_cast<const unsigned char*>(mask), static_cast<const float*>(w),
      static_cast<const bf16*>(wb), static_cast<double*>(partial), centroids, cd, cp, c1, c2,
      act);
  e = cudaGetLastError();
  if (e == cudaSuccess) *grid = blocks;
  return e;
}

}  // namespace

// F2 in bf16 over B*M = centroids centroids, the arguments of dlbt_fused_sa_f2
// (csrc/fused_sa_fwd.cu, which checks the shared ones and adds the slices) but w, here
// the forward's per-column vectors (7 (C1 + C2) + C3 f32: b, sc, sh, mean, inv, ta, tb
// of layer 1, then of layer 2, then b3; layer 1's b, sc, sh and b2 read), and wb, the
// bf16 weight block (W1^T, W2^T, W3 as fused_sa_mma.cuh lays them out; W3 unread);
// mask, w and wb 16-byte aligned; out, amax and c3 unread. Writes each block's slice of
// partial, (2, C2) f64: the sums of h2, then of h2^2; *grid gets the number of slices.
// C1 64 or 128, C2 a multiple of 64 and at most kOwned x 128, and the layout within
// the block's shared memory.
extern "C" int dlbt_fused_sa_f2_mma(const void* dense, const void* planes, const void* mask,
                                    const void* w, const void* wb, void* partial, void* out,
                                    void* amax, int centroids, int cd, int cp, int c1, int c2,
                                    int c3, int c_out, int act, int max_grid, void* stream,
                                    int* grid) {
  (void)out;
  (void)amax;
  (void)c3;
  (void)c_out;
  *grid = 0;
  if ((c1 != 64 && c1 != 128) || c2 % 64 || 2 * c2 > kOwned * kThreads || wb == nullptr ||
      reinterpret_cast<uintptr_t>(wb) % 16 || reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(mask) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      c1 == 64 ? launch<4>(dense, planes, mask, w, wb, partial, centroids, cd, cp, c1, c2, act,
                           max_grid, s, grid)
               : launch<8>(dense, planes, mask, w, wb, partial, centroids, cd, cp, c1, c2, act,
                           max_grid, s, grid);
  return static_cast<int>(e);
}
