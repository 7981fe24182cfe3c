// Batched, masked farthest-point sampling from given starts.
//
// Replaces: dl_biomass_tpu/ops/pallas_fps.py fps_pallas (kernel _fps_kernel).
// Semantics: row r picks k points; step s takes the point with the largest
// running-min squared distance to the picks so far, ties to the first index;
// masked points start at -inf and picked points are set to -inf, so picks are
// unique while the row has valid points left (after that, index 0, as argmax
// over an all -inf row gives). The distance is the Pallas kernel's form,
// d = |p|^2 - 2 p.l + |l|^2, in the same operation order, with every multiply
// and add rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn: nvcc may not
// contract them into FMAs), so the kernel matches its plain PyTorch version
// (ops/fps_kernel.py) index for index. |l|^2 is the pick's own |p|^2.
//
// Bound on the H100: neither bytes (a row of 1280 points is 20 KB) nor
// operations (~9 flops per point per step: 0.0059 ms for the two launches of
// a 16 x 10240 forward, if every point of every step ran at once). The k
// steps depend on each other, so the time is k times the latency of one
// step. The parent kernel (five planes in shared memory, a 10-shuffle argmax
// per warp, two barriers a step) took 0.914 us a step at SA1 of 16 x 10240
// (128 rows of 1280), and its loop with the per-point work taken out (a
// chain-only instantiation: argmax, barriers, winner read) still took 0.498
// us a step there and 0.49-0.63 at every other shape: that chain, not the
// arithmetic, set the floor (PERF.md, kernel 1; H100 80GB HBM3, 700 W).
//
// Design: what it does about that latency.
// - The row's points live in registers: each thread owns P points (i = t,
//   t + T, ...; T the row's threads) and keeps x, y, z, |p|^2 and the running
//   minimum of each across all k steps, so no plane is re-read or written
//   back. (x, y, z, |p|^2) is also written once to shared memory, read-only,
//   where every thread reads the step's winner after the reduction. Slots
//   beyond n hold -inf and an index >= n.
// - Per step a thread updates its P minima (the kill of the last pick is a
//   select on the old minimum: a select on the new one let nvcc branch
//   around each point's distance, which serialised the points), then takes
//   their max and the first index holding it by two trees, no branch.
// - A warp's argmax is two redux.sync: the max of an order-preserving key of
//   the running minimum, then the min index over the lanes holding it.
// - A row of W > 1 warps takes one barrier a step: lane 0 of each warp
//   writes (key, index) to a slot array double-buffered by step parity, and
//   after the barrier every warp reduces the W slots itself. Parity makes one
//   barrier enough: a warp writes buffer b again only at step s + 2, after
//   the barrier of step s + 1, which every warp reaches only after reading
//   buffer b at step s.
// - Threads per row follow the row (fps_kernel.plan mirrors the dispatch):
//   a row of at most 32 * 12 points is one warp, with no block barrier
//   (__syncwarp only) and four rows a block; a longer one the fewest warps
//   that hold it at 12 points a thread in a block of up to 256 threads;
//   beyond 8 warps, at 10 points a thread in a block of up to 512 or 1024
//   threads (so up to 10240 points). Each is compiled for its most threads
//   and one block an SM (__launch_bounds__(MAXT, 1)): 255, 128 or 64
//   registers a thread. With the bound alone ptxas kept P = 8 in 64
//   registers and ran the points one after another; given the registers it
//   overlaps them. The 1024-thread one spills 36 bytes.
// - Rows beyond the registers (n > 10240) keep the loop over the points in a
//   global scratch buffer, with (x, y, z, |p|^2) as one float4 and the same
//   one-barrier argmax.
//
// The key: -0.0 becomes +0.0 first (a float compare holds them equal, so the
// key must too; the test is on the bits, which no compiler drops); then the
// sign bit is flipped for v >= 0 and all bits for v < 0, which orders -inf
// below every finite value. No NaN reaches it: the running min is fminf,
// which returns the other operand when d is NaN (garbage coordinates in a pad
// row), as torch.fmin does in the plain version. Within a thread the max is
// fmaxf and the index the least whose value == it (== holds -0.0 and +0.0
// equal, as the key does).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoIndex = 0xffffffffu;
constexpr int kMaxWarps = 32;
constexpr int kPlanesThreads = 1024;

__device__ __forceinline__ unsigned order_key(float v) {
  unsigned u = __float_as_uint(v);
  if ((u << 1) == 0u) u = 0u;  // -0.0 -> +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// d = |p|^2 - 2 p.l + |l|^2 in the Pallas kernel's order
__device__ __forceinline__ float distance(float x, float y, float z, float sq, float4 l) {
  const float t = __fadd_rn(__fadd_rn(__fmul_rn(x, l.x), __fmul_rn(y, l.y)), __fmul_rn(z, l.z));
  return __fadd_rn(__fsub_rn(sq, __fmul_rn(2.0f, t)), l.w);
}

// The largest of a thread's P values, as a tree (depth log2 P, no branch).
template <int P>
__device__ __forceinline__ float max_of(const float (&v)[P]) {
  float w[P];
#pragma unroll
  for (int j = 0; j < P; ++j) w[j] = v[j];
#pragma unroll
  for (int h = 1; h < P; h *= 2) {
#pragma unroll
    for (int j = 0; j + h < P; j += 2 * h) w[j] = fmaxf(w[j], w[j + h]);
  }
  return w[0];
}

// The first index i = t + j T whose value equals m, as a tree of mins.
template <int P>
__device__ __forceinline__ unsigned first_at(const float (&v)[P], float m, int t, int T) {
  unsigned w[P];
#pragma unroll
  for (int j = 0; j < P; ++j) w[j] = v[j] == m ? static_cast<unsigned>(t + j * T) : kNoIndex;
#pragma unroll
  for (int h = 1; h < P; h *= 2) {
#pragma unroll
    for (int j = 0; j + h < P; j += 2 * h) w[j] = min(w[j], w[j + h]);
  }
  return w[0];
}

// The row's winner from each thread's best (key, index): all threads of the
// row get it. W warps per row; with W > 1 the slots and one barrier of the
// block (one row per block then), buffer b = step parity.
__device__ __forceinline__ int row_argmax(unsigned key, unsigned idx, int W, int wr, int lane,
                                          unsigned (*slot_key)[kMaxWarps],
                                          unsigned (*slot_idx)[kMaxWarps], int b) {
  unsigned top = __reduce_max_sync(kFull, key);
  unsigned win = __reduce_min_sync(kFull, key == top ? idx : kNoIndex);
  if (W > 1) {
    if (lane == 0) {
      slot_key[b][wr] = top;
      slot_idx[b][wr] = win;
    }
    __syncthreads();
    key = lane < W ? slot_key[b][lane] : 0u;
    idx = lane < W ? slot_idx[b][lane] : kNoIndex;
    top = __reduce_max_sync(kFull, key);
    win = __reduce_min_sync(kFull, key == top ? idx : kNoIndex);
  }
  return static_cast<int>(win);
}

// Rows of at most 32 * W * P points held in registers. blockDim.x = 32 * W *
// R: W warps per row, R rows per block (R > 1 only with W == 1).
// CHAIN (a measurement, no path runs it): the per-point work removed, the
// reduction, barrier and winner read kept on the same k-step loop.
template <int P, int MAXT, bool CHAIN>
__global__ void __launch_bounds__(MAXT, 1)
fps_regs(const float* __restrict__ pos, const unsigned char* __restrict__ mask,
         const int* __restrict__ starts, int* __restrict__ out, int rows, int n, int k, int W) {
  extern __shared__ float4 pts[];  // R rows of n (x, y, z, |p|^2)
  __shared__ unsigned slot_key[2][kMaxWarps], slot_idx[2][kMaxWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp % W, rb = warp / W;
  const int row = blockIdx.x * (blockDim.x / (32 * W)) + rb;
  if (row >= rows) return;  // whole rows of one warp (W == 1): no barrier follows
  const int T = 32 * W, t = wr * 32 + lane;
  float4* rp = pts + static_cast<size_t>(rb) * n;
  const float* p = pos + static_cast<size_t>(row) * n * 3;
  const unsigned char* m = mask + static_cast<size_t>(row) * n;

  float px[P], py[P], pz[P], sq[P], dist[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int i = t + j * T;
    px[j] = py[j] = pz[j] = sq[j] = 0.0f;
    dist[j] = -CUDART_INF_F;
    if (i < n) {
      px[j] = p[3 * i];
      py[j] = p[3 * i + 1];
      pz[j] = p[3 * i + 2];
      sq[j] = sq_norm(px[j], py[j], pz[j]);
      dist[j] = m[i] ? CUDART_INF_F : -CUDART_INF_F;
      rp[i] = make_float4(px[j], py[j], pz[j], sq[j]);
    }
  }
  int prev = starts[row];
  int* o = out + static_cast<size_t>(row) * k;
  if (t == 0) o[0] = prev;
  if (W == 1) {
    __syncwarp();
  } else {
    __syncthreads();
  }

  for (int s = 1; s < k; ++s) {
    const float4 l = rp[prev];
    unsigned bk = 0u, bi = kNoIndex;
    if (CHAIN) {
      bk = order_key(__fadd_rn(l.x, static_cast<float>(t)));
      bi = t < n ? t : 0;
    } else {
      const int rel = prev - t;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        // the kill selects the old value, not the new one: a select around
        // fminf lets the compiler branch around the distance, point by point
        const float d = distance(px[j], py[j], pz[j], sq[j], l);
        dist[j] = fminf(rel == j * T ? -CUDART_INF_F : dist[j], d);
      }
      const float top = max_of<P>(dist);
      bk = order_key(top);
      bi = first_at<P>(dist, top, t, T);
    }
    prev = row_argmax(bk, bi, W, wr, lane, slot_key, slot_idx, s & 1);
    if (t == 0) o[s] = prev;
  }
}

// Rows beyond the registers: (x, y, z, |p|^2) and the running min in a
// global scratch buffer (rows x n float4, then rows x n float), one block of
// 1024 threads per row, each thread walking the points t, t + 1024, ...
template <bool CHAIN>
__global__ void __launch_bounds__(kPlanesThreads)
fps_planes(const float* __restrict__ pos, const unsigned char* __restrict__ mask,
           const int* __restrict__ starts, int* __restrict__ out, float* __restrict__ scratch,
           int rows, int n, int k) {
  __shared__ unsigned slot_key[2][kMaxWarps], slot_idx[2][kMaxWarps];
  const int row = blockIdx.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  float4* pts = reinterpret_cast<float4*>(scratch) + static_cast<size_t>(row) * n;
  float* dist = scratch + static_cast<size_t>(rows) * n * 4 + static_cast<size_t>(row) * n;
  const float* p = pos + static_cast<size_t>(row) * n * 3;
  const unsigned char* m = mask + static_cast<size_t>(row) * n;
  for (int i = t; i < n; i += kPlanesThreads) {
    const float x = p[3 * i], y = p[3 * i + 1], z = p[3 * i + 2];
    pts[i] = make_float4(x, y, z, sq_norm(x, y, z));
    dist[i] = m[i] ? CUDART_INF_F : -CUDART_INF_F;
  }
  int prev = starts[row];
  int* o = out + static_cast<size_t>(row) * k;
  if (t == 0) o[0] = prev;
  __syncthreads();

  for (int s = 1; s < k; ++s) {
    const float4 l = pts[prev];
    unsigned bk = 0u, bi = kNoIndex;  // key 0: below every point's (a thread beyond n)
    if (CHAIN) {
      bk = order_key(__fadd_rn(l.x, static_cast<float>(t)));
      bi = t < n ? t : 0;
    } else {
      float bv = 0.0f;
      for (int i = t; i < n; i += kPlanesThreads) {
        const float4 q = pts[i];
        const float cur = fminf(i == prev ? -CUDART_INF_F : dist[i], distance(q.x, q.y, q.z, q.w, l));
        dist[i] = cur;
        if (bi == kNoIndex || cur > bv) {
          bv = cur;
          bi = i;
        }
      }
      if (bi != kNoIndex) bk = order_key(bv);
    }
    prev = row_argmax(bk, bi, kPlanesThreads / 32, warp, lane, slot_key, slot_idx, s & 1);
    if (t == 0) o[s] = prev;
  }
}

// The instantiations fps_kernel.plan names: P points a thread in blocks of
// at most 256 threads (up to 255 registers a thread), and P = 10 in blocks of
// up to 1024 (64), which plan takes only beyond 8 warps a row.
template <bool CHAIN>
const void* regs_kernel(int p, int threads) {
  if (threads > 512) {
    return p == 10 ? reinterpret_cast<const void*>(fps_regs<10, 1024, CHAIN>) : nullptr;
  }
  if (threads > 256) {
    return p == 10 ? reinterpret_cast<const void*>(fps_regs<10, 512, CHAIN>) : nullptr;
  }
  switch (p) {
    case 2: return reinterpret_cast<const void*>(fps_regs<2, 256, CHAIN>);
    case 4: return reinterpret_cast<const void*>(fps_regs<4, 256, CHAIN>);
    case 6: return reinterpret_cast<const void*>(fps_regs<6, 256, CHAIN>);
    case 8: return reinterpret_cast<const void*>(fps_regs<8, 256, CHAIN>);
    case 10: return reinterpret_cast<const void*>(fps_regs<10, 256, CHAIN>);
    case 12: return reinterpret_cast<const void*>(fps_regs<12, 256, CHAIN>);
    default: return nullptr;
  }
}

// The launch a plan names, checked against what the kernels take:
// path 0 (registers) W warps per row, P points a thread, R rows a block;
// path 1 (planes in scratch). Sets grid, block, shared bytes and the kernel.
cudaError_t resolve(int path, int warps, int p, int rows_per_block, int rows, int n, bool chain,
                    const void** fn, dim3* grid, dim3* block, size_t* smem) {
  if (rows < 1 || n < 1) return cudaErrorInvalidValue;
  if (path == 1) {
    if (warps != kPlanesThreads / 32 || rows_per_block != 1) return cudaErrorInvalidValue;
    *fn = chain ? reinterpret_cast<const void*>(fps_planes<true>)
                : reinterpret_cast<const void*>(fps_planes<false>);
    *grid = dim3(rows);
    *block = dim3(kPlanesThreads);
    *smem = 0;
    return cudaSuccess;
  }
  if (path != 0 || warps < 1 || warps > kMaxWarps || rows_per_block < 1 ||
      (warps > 1 && rows_per_block != 1) || warps * rows_per_block > kMaxWarps ||
      n > 32 * warps * p)
    return cudaErrorInvalidValue;
  const int threads = 32 * warps * rows_per_block;
  *fn = chain ? regs_kernel<true>(p, threads) : regs_kernel<false>(p, threads);
  if (*fn == nullptr) return cudaErrorInvalidValue;
  *grid = dim3((rows + rows_per_block - 1) / rows_per_block);
  *block = dim3(threads);
  *smem = static_cast<size_t>(rows_per_block) * n * sizeof(float4);
  if (*smem > 48 * 1024)
    return cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(*smem));
  return cudaSuccess;
}

int launch(const void* pos, const void* mask, const void* starts, void* out, void* scratch,
           int rows, int n, int k, int path, int warps, int p, int rows_per_block, bool chain,
           void* stream) {
  const void* fn = nullptr;
  dim3 grid, block;
  size_t smem = 0;
  cudaError_t e = resolve(path, warps, p, rows_per_block, rows, n, chain, &fn, &grid, &block,
                          &smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (path == 1 && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (path == 1) {
    void* args[] = {&pos, &mask, &starts, &out, &scratch, &rows, &n, &k};
    e = cudaLaunchKernel(fn, grid, block, args, smem, static_cast<cudaStream_t>(stream));
  } else {
    void* args[] = {&pos, &mask, &starts, &out, &rows, &n, &k, &warps};
    e = cudaLaunchKernel(fn, grid, block, args, smem, static_cast<cudaStream_t>(stream));
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pos (rows, n, 3) f32, mask (rows, n) bool, starts (rows,) int32 -> out (rows, k) int32,
// on the launch fps_kernel.plan(n) names (path 0: registers, 1: planes in scratch, which
// is then 5 rows n f32, 16-byte aligned). A plan the kernels do not take returns cudaErrorInvalidValue.
extern "C" int dlbt_fps(const void* pos, const void* mask, const void* starts, void* out,
                        void* scratch, int rows, int n, int k, int path, int warps, int p,
                        int rows_per_block, void* stream) {
  return launch(pos, mask, starts, out, scratch, rows, n, k, path, warps, p, rows_per_block,
                false, stream);
}

// The same launch with the per-point work removed (a measurement; no path runs it).
extern "C" int dlbt_fps_chain(const void* pos, const void* mask, const void* starts, void* out,
                              void* scratch, int rows, int n, int k, int path, int warps, int p,
                              int rows_per_block, void* stream) {
  return launch(pos, mask, starts, out, scratch, rows, n, k, path, warps, p, rows_per_block,
                true, stream);
}

// Blocks per SM, threads per block and shared memory per block of a plan's launch.
extern "C" int dlbt_fps_occupancy(int n, int path, int warps, int p, int rows_per_block,
                                  int* per_sm, int* threads, int* smem) {
  const void* fn = nullptr;
  dim3 grid, block;
  size_t bytes = 0;
  cudaError_t e = resolve(path, warps, p, rows_per_block, 1, n, false, &fn, &grid, &block,
                          &bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  *threads = static_cast<int>(block.x);
  *smem = static_cast<int>(bytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, fn, static_cast<int>(block.x), bytes));
}
