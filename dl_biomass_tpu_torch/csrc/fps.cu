// Batched, masked farthest-point sampling from given starts.
//
// Replaces: dl_biomass_tpu/ops/pallas_fps.py fps_pallas (kernel _fps_kernel).
// Semantics: row r picks k points; step s takes the point with the largest
// running-min squared distance to the picks so far, ties to the first index;
// masked points start at -inf and picked points are set to -inf, so picks are
// unique while the row has valid points left (after that, index 0, as argmax
// over an all -inf row gives). The distance is the Pallas kernel's form,
// d = |p|^2 - 2 p.l + |l|^2, in the same operation order, with every multiply
// and add rounded on its own (__fmul_rn / __fadd_rn: nvcc may not contract
// them into FMAs), so the kernel matches its plain PyTorch version
// (ops/fps_kernel.py) index for index.
//
// Bound on the H100: neither bytes (a row of 1280 points is 20 KB) nor
// operations (~9 flops per point per step). The k steps depend on each other,
// so the time is k times the latency of one step: a pass over the row and a
// block-wide argmax.
//
// Design: one block per row. The row's coordinates, |p|^2 and the running
// minimum live in shared memory (in a global scratch buffer when 5 floats per
// point exceed what a block may hold). Each step every thread updates its
// strided points and keeps its best (value, index); a warp-shuffle argmax and
// one more over the warps' winners give the pick, two barriers per step.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void take_better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_down_sync(kFull, v, off);
    int oi = __shfl_down_sync(kFull, i, off);
    take_better(v, i, ov, oi);
  }
}

template <int THREADS>
__global__ void __launch_bounds__(THREADS)
fps_kernel(const float* __restrict__ pos, const unsigned char* __restrict__ mask,
           const int* __restrict__ starts, int* __restrict__ out,
           float* __restrict__ scratch, int n, int k) {
  extern __shared__ float smem[];
  constexpr int kWarps = THREADS / 32;
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int pick;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  float* px = scratch == nullptr ? smem : scratch + static_cast<size_t>(row) * 5 * n;
  float* py = px + n;
  float* pz = py + n;
  float* sq = pz + n;
  float* dist = sq + n;
  const float* p = pos + static_cast<size_t>(row) * n * 3;
  const unsigned char* m = mask + static_cast<size_t>(row) * n;
  for (int i = tid; i < n; i += THREADS) {
    const float x = p[3 * i], y = p[3 * i + 1], z = p[3 * i + 2];
    px[i] = x;
    py[i] = y;
    pz[i] = z;
    sq[i] = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
    dist[i] = m[i] ? CUDART_INF_F : -CUDART_INF_F;
  }
  int prev = starts[row];
  int* o = out + static_cast<size_t>(row) * k;
  if (tid == 0) o[0] = prev;
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  for (int s = 1; s < k; ++s) {
    const float lx = px[prev], ly = py[prev], lz = pz[prev];
    const float ll = __fadd_rn(__fadd_rn(__fmul_rn(lx, lx), __fmul_rn(ly, ly)), __fmul_rn(lz, lz));
    float bv = -CUDART_INF_F;
    int bi = 0x7fffffff;
    for (int i = tid; i < n; i += THREADS) {
      const float t = __fadd_rn(__fadd_rn(__fmul_rn(px[i], lx), __fmul_rn(py[i], ly)),
                                __fmul_rn(pz[i], lz));
      const float d = __fadd_rn(__fsub_rn(sq[i], __fmul_rn(2.0f, t)), ll);
      const float cur = (i == prev) ? -CUDART_INF_F : fminf(dist[i], d);
      dist[i] = cur;
      take_better(bv, bi, cur, i);
    }
    warp_argmax(bv, bi);
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < kWarps ? red_v[lane] : -CUDART_INF_F;
      bi = lane < kWarps ? red_i[lane] : 0x7fffffff;
      warp_argmax(bv, bi);
      if (lane == 0) {
        pick = bi;
        o[s] = bi;
      }
    }
    __syncthreads();
    prev = pick;
  }
}

template <int THREADS>
cudaError_t launch(const float* pos, const unsigned char* mask, const int* starts, int* out,
                   float* scratch, int rows, int n, int k, cudaStream_t stream) {
  const size_t smem = scratch == nullptr ? static_cast<size_t>(5) * n * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(fps_kernel<THREADS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  fps_kernel<THREADS><<<rows, THREADS, smem, stream>>>(pos, mask, starts, out, scratch, n, k);
  return cudaGetLastError();
}

}  // namespace

// pos (rows, n, 3) f32, mask (rows, n) bool, starts (rows,) int32 -> out (rows, k) int32.
// scratch: null to keep the row in shared memory, else (rows, 5, n) f32.
extern "C" int dlbt_fps(const void* pos, const void* mask, const void* starts, void* out,
                        void* scratch, int rows, int n, int k, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto p = static_cast<const float*>(pos);
  auto m = static_cast<const unsigned char*>(mask);
  auto st = static_cast<const int*>(starts);
  auto o = static_cast<int*>(out);
  auto sc = static_cast<float*>(scratch);
  cudaError_t e = n > 4096 ? launch<1024>(p, m, st, o, sc, rows, n, k, s)
                           : launch<256>(p, m, st, o, sc, rows, n, k, s);
  return static_cast<int>(e);
}
