// Kernel 6-F1 in bf16, on the tensor cores: the first pass of the fused SA-layer MLP's
// forward (csrc/fused_sa_fwd.cu holds all three passes and runs this one in f32, and
// in bf16 at the widths this kernel does not take). Per edge row it forms
// h1 = [dense, planes] W1 + b1; it returns the column sums of h1 and of h1^2 over the
// valid edge rows of the whole batch (F2's statistics for layer 1's BatchNorm).
//
// Replaces: dl_biomass_tpu/ops/pallas_sa_train.py fused_sa_mlp, its forward's first
// pass (_f1_kernel), in bf16.
// Semantics: those of fused_sa_stage_plain(1, ..., bf16=True). The product takes bf16
// operands (W1, the dense rows, the planes rounded once) with f32 sums, the dense rows'
// product and the planes' added, then the f32 bias; h1 and each 16-row column sum stay
// f32, the sums across row tiles, centroids and blocks f64.
//
// Bound on the H100: bytes. SA2's bf16 dense block read once (134 MB at a 16 x 10240
// forward), 0.042 ms; the product, 2 KP C1 flop per valid edge row, takes less at the
// bf16 tensor cores' 989 TFLOP/s. At SA1 (4 plane channels, nothing dense) the planes
// and the mask are the traffic, 0.011 ms.
//
// Design: the front half of csrc/fused_sa_f2.cu, one layer shorter (the shared pieces
// in csrc/fused_sa_mma.cuh). A persistent block of 8 warps copies the bf16 W1^T part of
// the layer's weight block and b1 into shared memory once, and walks centroids with a
// grid stride while cp.async fills the other of two input buffers. Warp w takes row
// tile w % 4 and half w / 4 of C1: layer1_h1 forms h1 on mma.sync, and each
// accumulator tile is reduced at once to its columns' sums of the masked h1 and h1^2
// over the tile's 16 rows in f32 (tile_colsum). These land in a buffer of their own,
// and one thread per element adds the 4 row tiles in their order in f64 into a
// register it keeps across centroids. Three barriers per centroid: the mask's
// check (which also shows every thread the copies), the staged rows, the sums. No
// float atomics: each block writes its f64 slice, and the entry's second launch
// (csrc/fused_sa_fwd.cu, reduce_partials) adds the slices in block order, so two
// launches agree bit for bit. Shared memory at SA2: 82 KiB (W1^T 38, two input
// buffers 40, the sums 4), two blocks per SM; SA1: 13 KiB, four blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "fused_sa_mma.cuh"

namespace {

using namespace fused_sa_mma;

// Byte offsets of one block's shared memory: the bf16 W1^T, b1 (C1 f32), two input
// buffers (Inputs, without a cotangent), and the row tiles' column sums of h1 and
// h1^2 (2 C1 each).
struct Layout {
  Inputs in;
  size_t b1, buf, red, total;
  __host__ __device__ Layout(int kx, int cp, int c1) : in(kx, cp, 0) {
    size_t at = w1t_bytes(kx, c1);
    b1 = take(at, 4ull * c1);
    buf = take(at, 2 * in.stride);
    red = take(at, 4ull * kRowTiles * 2 * c1);
    total = at;
  }
};

// kT1: the warp's n-tiles of layer 1 (C1 / 16). w holds the per-column vectors (Vec
// order; only b1, its first C1 values, read), wb the bf16 weights (only W1^T read).
// Four blocks per SM at C1 64 (each thread's h1 is 16 values), two at 128.
template <int kT1>
__global__ void __launch_bounds__(kThreads, kT1 == 4 ? 4 : 2)
    fused_sa_f1_kernel(const bf16* __restrict__ dense, const float* __restrict__ planes,
                       const unsigned char* __restrict__ mask, const float* __restrict__ w,
                       const bf16* __restrict__ wb, double* __restrict__ partial,
                       long long total, int cd, int cp, int c1) {
  extern __shared__ __align__(16) char smem[];
  const int cd16 = round16(cd), kx = cd16 + round16(cp);
  const Layout L(kx, cp, c1);
  const bf16* const w1t = reinterpret_cast<const bf16*>(smem);
  const float* const b1 = reinterpret_cast<const float*>(smem + L.b1);
  const int ldx = kx + kSkewH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int tile = warp % kRowTiles, r0 = 16 * tile, half = warp / kRowTiles;
  const int n1 = half * 8 * kT1;  // the warp's first column
  const int nv = 2 * c1;          // the block's slice: s, then ss; at most kThreads
  const bool dense_vec = cd % 8 == 0 && reinterpret_cast<uintptr_t>(dense) % 16 == 0;

  copy_async(smem, wb, w1t_bytes(kx, c1));  // once per block
  copy_async(smem + L.b1, w, 4ull * c1);
  const auto prefetch = [&](long long ci, int b) {
    prefetch_inputs(smem + L.buf + b * L.in.stride, L.in, ci, dense, planes, mask, nullptr,
                    nullptr, cd, cp, ldx, 0, dense_vec);
  };
  if (blockIdx.x < total) prefetch(blockIdx.x, 0);
  dlbt::cp_async_commit();

  double sum = 0.0;  // element tid of the slice, across this block's centroids

  int b = 0;
  for (long long ci = blockIdx.x; ci < total; ci += gridDim.x, b ^= 1) {
    if (ci + gridDim.x < total) prefetch(ci + gridDim.x, b ^ 1);
    dlbt::cp_async_commit();
    dlbt::cp_async_wait<1>();  // this centroid's copies (and the weights) have landed
    const long long row0 = ci * kSlots;
    char* const in = smem + L.buf + b * L.in.stride;
    const unsigned char* const mk = reinterpret_cast<const unsigned char*>(in + L.in.mask);
    // threads 0..3 copied the mask's 4 pieces and see them; the barrier shows every
    // thread all the copies
    uint4 own = make_uint4(0, 0, 0, 0);
    if (tid < kSlots / 16) own = reinterpret_cast<const uint4*>(mk)[tid];
    if (!__syncthreads_or((own.x | own.y | own.z | own.w) != 0)) continue;  // no valid slot
    bf16* const x = reinterpret_cast<bf16*>(in + L.in.x);
    stage_inputs(in, L.in, nullptr, nullptr, 0, 0, 0, dense, row0, cd, cp, kx, ldx, dense_vec);
    __syncthreads();

    float h1[kT1][4];
    layer1_h1<kT1>(x, ldx, w1t, cd16, kx, cp, b1, n1, r0, h1);
    float* const red = reinterpret_cast<float*>(smem + L.red);

    // the tile's column sums of the masked h1 and h1^2
    const bool ok_lo = mk[r0 + g] != 0, ok_hi = mk[r0 + g + 8] != 0;
#pragma unroll
    for (int nt = 0; nt < kT1; ++nt) {
      const int col = n1 + 8 * nt + 2 * t;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const float lo = ok_lo ? h1[nt][p] : 0.0f, hi = ok_hi ? h1[nt][p + 2] : 0.0f;
        const float s = tile_colsum(lo, hi), ss = tile_colsum(lo * lo, hi * hi);
        if (g == 0) {
          red[tile * nv + col + p] = s;
          red[tile * nv + c1 + col + p] = ss;
        }
      }
    }
    __syncthreads();  // the input buffer is consumed, the column sums are in

    // each element's 4 row tiles, in their order, in f64 (the next centroid writes the
    // sums only past its first barrier, which waits for this)
    if (tid < nv) {
      double s = 0.0;
#pragma unroll
      for (int q = 0; q < kRowTiles; ++q) s += red[q * nv + tid];
      sum += s;
    }
  }
  dlbt::cp_async_wait<0>();
  if (tid < nv) partial[static_cast<size_t>(blockIdx.x) * nv + tid] = sum;
}

template <int kT1>
cudaError_t launch(const void* dense, const void* planes, const void* mask, const void* w,
                   const void* wb, void* partial, int centroids, int cd, int cp, int c1,
                   int max_grid, cudaStream_t stream, int* grid) {
  const auto kernel = fused_sa_f1_kernel<kT1>;
  const size_t smem = Layout(round16(cd) + round16(cp), cp, c1).total;
  int blocks = 0;
  cudaError_t e = persistent_grid(kernel, smem, centroids, max_grid, 1, &blocks);
  if (e != cudaSuccess) return e;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const bf16*>(dense), static_cast<const float*>(planes),
      static_cast<const unsigned char*>(mask), static_cast<const float*>(w),
      static_cast<const bf16*>(wb), static_cast<double*>(partial), centroids, cd, cp, c1);
  e = cudaGetLastError();
  if (e == cudaSuccess) *grid = blocks;
  return e;
}

}  // namespace

// F1 in bf16 over B*M = centroids centroids, the arguments of dlbt_fused_sa_f1
// (csrc/fused_sa_fwd.cu, which checks the shared ones and adds the slices) but w, here
// the forward's per-column vectors (7 (C1 + C2) + C3 f32, as F2 and F3 take them; b1,
// the first C1, read), and wb, the bf16 weight block (W1^T, W2^T, W3 as
// fused_sa_mma.cuh lays them out; W1^T read); mask, w and wb 16-byte aligned; out,
// amax, c2, c3 and c_out unread. Writes each block's slice of partial, (2, C1) f64: the
// sums of h1, then of h1^2; *grid gets the number of slices. C1 64 or 128, and the
// layout within the block's shared memory.
extern "C" int dlbt_fused_sa_f1_mma(const void* dense, const void* planes, const void* mask,
                                    const void* w, const void* wb, void* partial, void* out,
                                    void* amax, int centroids, int cd, int cp, int c1, int c2,
                                    int c3, int c_out, int act, int max_grid, void* stream,
                                    int* grid) {
  (void)out;
  (void)amax;
  (void)c2;
  (void)c3;
  (void)c_out;
  (void)act;
  *grid = 0;
  if ((c1 != 64 && c1 != 128) || wb == nullptr || reinterpret_cast<uintptr_t>(wb) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 || reinterpret_cast<uintptr_t>(mask) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      c1 == 64 ? launch<4>(dense, planes, mask, w, wb, partial, centroids, cd, cp, c1, max_grid,
                           s, grid)
               : launch<8>(dense, planes, mask, w, wb, partial, centroids, cd, cp, c1, max_grid,
                           s, grid);
  return static_cast<int>(e);
}
