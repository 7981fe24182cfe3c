// Kernel 9: the rank-scatter ball query of the TPU tool's phase bisection,
// with its phase stubs.
//
// Replaces: tools/bq_phase_bench.py bq (kernels _bq_kernel and _bq_kernel_when).
// Semantics: for a valid centroid, the in-radius points are the valid points
// with (dx*dx + dy*dy) + dz*dz <= r2 (every operation rounded on its own; r2 is
// the tool's float(radius)**2 rounded once to f32) in index order; rank is a
// point's place in that list, its bucket is index % 128. Mode kWrite (full,
// mstatic, munroll, when: cap 8; whenN: cap N; dyn: no cap, passed as k): slot
// rank < k holds the index of an in-radius point that is among the first `cap`
// of its bucket, every other slot n; dropped points leave holes. The stubs
// repeat one value over the k slots: kDist the in-radius count, kRank and
// kExtract the least packed key (min(rank, k) << 24) | index, or 2^31 - 1. An
// invalid centroid writes n (kDist 0, kRank and kExtract 2^31 - 1).
//
// Bound on the H100: bytes at the tool's shape (36 x 512 centroids, 2048
// points, K=64): the (B, M, K) int32 output, 4.7 MB, over the 1.3 MB of input;
// the distance tests the data needs (8 flops each: up to the K-th hit for the
// writing modes, the first hit for kRank and kExtract, all N for kDist) come
// to less, except kDist's all-N scan, which is bound by operations (on the
// CUDA cores, with no FMA, 9 instructions a test).
//
// Design: kernel 3's (csrc/ball_query.cu), with a copy of its staging and
// scan. A block takes one cloud and a tile of its centroids and stages the
// cloud's points in shared memory once, as float4 (x, y, z, 0) read straight
// from pos (B, N, 3) and mask (B, N); a masked point, or a pad slot past N,
// holds NaN in x, so it fails every test and the scan needs no bounds or mask
// test. A warp scans one centroid in index order, kAhead = 8 chunks of 32
// points at a time: every test of the group, then eight ballots, then each
// chunk that hit ranked by __popc prefixes; the hit count is read once per 256
// points. A chunk starts at a multiple of 32 and a group at a multiple of 128,
// so lane l of chunk t sees bucket 32 (t % 4) + l: each lane keeps four counts
// of kept hits in the bytes of one register (a count stays <= cap <= 127),
// carried across chunks of the cloud. The modes:
// - kWrite puts each kept hit of rank < k in the warp's k slots in shared
//   memory (n before the scan, so holes and the tail stay n), stops after the
//   group that holds the K-th hit and writes the row out once, coalesced,
//   setting the slots back to n as it reads them.
// - kDist tests all N points: a count a lane, one warp sum. In a whole cloud
//   a warp scans two centroids at once, each point read once for both tests
//   (one centroid a warp reads shared memory at its rate: 16 bytes a test).
// - kRank and kExtract (one instantiation) stop at the first group with a
//   hit: the least packed key is the first hit's, rank 0, its index (kept
//   under any cap >= 1; kExtract with cap 0 keeps nothing).
// Whole (the padded cloud, the tile's centroids and the warps' slots fit a
// block's shared memory): the tile's centroids are staged beside the cloud,
// in the same round of loads, and a warp that is done takes the tile's next
// centroid from a counter in shared memory, so no warp waits on device memory
// between centroids and one long scan does not hold the others idle. Chunked
// (larger N): the block stages the cloud 8192 points at a time, one centroid a
// warp, and moves to the next chunk while any of its warps still needs points
// (__syncthreads_or). bq_phase_bench.plan mirrors the launch: centroids a
// block, warps, points staged at once, whole or chunked; cm is not read.
// Measurement modes (bq_phase_bench.probe): no early exit; the staging and the
// writing of the outputs alone (as for no hit); the scan without the writing.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kKeyBits = 24;
constexpr int kIntBig = 0x7fffffff;
constexpr int kMaxThreads = 1024;
constexpr int kAhead = 8;  // chunks of 32 points tested before the hit count is read
static_assert(kAhead % 4 == 0, "a group must start at a multiple of 128");
// the API's modes, and the kernel's instantiations (kRank and kExtract share kFirst)
enum Mode { kDist = 0, kRank = 1, kExtract = 2, kWrite = 3 };
constexpr int kFirst = kRank;
// the measurement modes (bq_phase_bench.probe); kKernel on every path
constexpr int kKernel = 0, kFullScan = 1, kLoadsOnly = 2, kNoStore = 3;

__device__ __forceinline__ float nan_x() { return __int_as_float(0x7fc00000); }

// Points first .. first + count - 1 of one cloud into pts[0 .. count): (x, y, z,
// 0), x NaN where the point is masked or past n. A thread loads kStage points
// before it stores any, from clamped indices, so that the loads do not wait on
// one another or on the mask.
constexpr int kStage = 4;

__device__ __forceinline__ void stage(float4* pts, const float* __restrict__ pos,
                                      const unsigned char* __restrict__ mask, int first,
                                      int count, int n) {
  for (int i0 = threadIdx.x; i0 < count; i0 += kStage * blockDim.x) {
    float4 p[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int j = first + i0 + u * blockDim.x;
      const int jc = min(j, n - 1);  // n >= 1 wherever count >= 1
      const float* q = pos + 3 * static_cast<size_t>(jc);
      p[u] = make_float4(__ldg(q), __ldg(q + 1), __ldg(q + 2), 0.f);
      if (j >= n || !__ldg(mask + jc)) p[u].x = nan_x();
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < count) pts[i] = p[u];
    }
  }
}

struct Args {
  const float* centers;
  const unsigned char* cmask;
  const float* pos;
  const unsigned char* mask;
  int* out;
  int m, n, k, cap;
  float r2;
  int tile;   // centroids a block (whole)
  int count;  // points staged at once: the padded cloud (whole) or a chunk
  int probe;  // kKernel on every path; the others measure
};

// One centroid of a warp: its coordinates; whether it is in the warp's tile
// (in) and still needs points (need); hits so far (cnt); each lane's counts of
// kept hits in buckets 32 q + lane, byte q of counts (kWrite: a count stays <=
// cap <= 127); the lane's in-radius count (kDist) or the least key found
// (kFirst).
struct Centroid {
  float x, y, z;
  int cnt, acc;
  unsigned counts;
  bool in, need;
};

// A centroid at (x, y, z), valid or not, in its warp's tile or not.
template <int kMode>
__device__ __forceinline__ Centroid make(const Args& a, float4 p, bool valid, bool in) {
  Centroid w;
  w.in = in;
  w.need = in && valid && a.probe != kLoadsOnly;
  w.x = p.x;
  w.y = p.y;
  w.z = p.z;
  w.cnt = 0;
  w.acc = kMode == kDist ? 0 : kIntBig;
  w.counts = 0;
  return w;
}

// Centroid c of cloud b from device memory, if it is below c1.
template <int kMode>
__device__ __forceinline__ Centroid load(const Args& a, int b, int c, int c1) {
  const size_t ci = static_cast<size_t>(b) * a.m + min(c, a.m - 1);
  const float4 p = make_float4(a.centers[3 * ci], a.centers[3 * ci + 1], a.centers[3 * ci + 2],
                               0.f);
  return make<kMode>(a, p, a.cmask[ci], c < c1);
}

// Centroid c0 + i of the block's tile from shared memory (w 1 where valid),
// if c0 + i is below c1.
template <int kMode>
__device__ __forceinline__ Centroid staged(const Args& a, const float4* cen, int i, int c0,
                                           int c1) {
  const float4 p = cen[min(i, c1 - c0 - 1)];
  return make<kMode>(a, p, p.w != 0.f, c0 + i < c1);
}

// One warp scans pts[0 .. count) (count a multiple of 32 * kAhead; pts[0] is
// point `first` of the cloud, a multiple of 128) for its centroid, as its mode
// says, until its value is settled or the points end.
template <int kMode>
__device__ __forceinline__ void scan(const float4* pts, int count, int first, Centroid& w,
                                     const Args& a, int* slots, int lane) {
  const unsigned below = (1u << lane) - 1u;
  const float r2 = a.r2;
  const int k = a.k;
  // the slots' shared-memory address, held in one register
  const unsigned row = static_cast<unsigned>(__cvta_generic_to_shared(slots));
  for (int s = 0; s < count && w.need; s += 32 * kAhead) {
    // every test of the group before any ballot: the ballot's convergence
    // check would otherwise hold the later chunks' loads behind the first
    bool ok[kAhead];
#pragma unroll
    for (int t = 0; t < kAhead; ++t) {
      const float4 p = pts[s + 32 * t + lane];
      const float dx = __fsub_rn(p.x, w.x);
      const float dy = __fsub_rn(p.y, w.y);
      const float dz = __fsub_rn(p.z, w.z);
      const float d2 =
          __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      ok[t] = d2 <= r2;
    }
    if constexpr (kMode == kDist) {
#pragma unroll
      for (int t = 0; t < kAhead; ++t) w.acc += ok[t];
      continue;
    }
    unsigned hits[kAhead], any = 0;
#pragma unroll
    for (int t = 0; t < kAhead; ++t) {
      hits[t] = __ballot_sync(kFull, ok[t]);
      any |= hits[t];
    }
    if (any == 0) continue;
    if constexpr (kMode == kFirst) {
      // the first hit: rank 0, so its key is its index
      int key = kIntBig;
#pragma unroll
      for (int t = kAhead - 1; t >= 0; --t) {
        if (hits[t] != 0) key = first + s + 32 * t + __ffs(hits[t]) - 1;
      }
      if (a.cap > 0) w.acc = min(w.acc, key);
      w.need = a.probe == kFullScan;
    } else {
#pragma unroll
      for (int t = 0; t < kAhead; ++t) {
        const int rank = w.cnt + __popc(hits[t] & below);
        const int shift = 8 * (t % 4);
        const bool kept = ok[t] && static_cast<int>((w.counts >> shift) & 0xffu) < a.cap;
        w.counts += static_cast<unsigned>(kept) << shift;
        if (kept && rank < k) {
          asm volatile("st.shared.u32 [%0], %1;" ::"r"(row + 4 * rank),
                       "r"(first + s + 32 * t + lane)
                       : "memory");
        }
        w.cnt += __popc(hits[t]);
      }
      w.need = a.probe == kFullScan || w.cnt < k;
    }
  }
}

// kDist in a whole cloud: one warp scans pts[0 .. count) for two centroids at
// once, each point read once for both tests (the scan reads shared memory at
// its rate otherwise).
__device__ __forceinline__ void scan_dist2(const float4* pts, int count, Centroid& w0,
                                           Centroid& w1, float r2, int lane) {
  if (!w0.need && !w1.need) return;
  for (int s = 0; s < count; s += 32 * kAhead) {
#pragma unroll
    for (int t = 0; t < kAhead; ++t) {
      const float4 p = pts[s + 32 * t + lane];
      const float dx0 = __fsub_rn(p.x, w0.x), dx1 = __fsub_rn(p.x, w1.x);
      const float dy0 = __fsub_rn(p.y, w0.y), dy1 = __fsub_rn(p.y, w1.y);
      const float dz0 = __fsub_rn(p.z, w0.z), dz1 = __fsub_rn(p.z, w1.z);
      const float d0 =
          __fadd_rn(__fadd_rn(__fmul_rn(dx0, dx0), __fmul_rn(dy0, dy0)), __fmul_rn(dz0, dz0));
      const float d1 =
          __fadd_rn(__fadd_rn(__fmul_rn(dx1, dx1), __fmul_rn(dy1, dy1)), __fmul_rn(dz1, dz1));
      w0.acc += d0 <= r2;
      w1.acc += d1 <= r2;
    }
  }
  if (!w0.need) w0.acc = 0;
  if (!w1.need) w1.acc = 0;
}

// The warp's centroid c, if in its tile: its k slots written out (kWrite: the
// slots, each set back to n as it is read; the stubs: the warp's value).
template <int kMode>
__device__ __forceinline__ void write_out(const Centroid& w, const Args& a, int b, int c,
                                          int* slots, int lane) {
  int v = w.acc;
  if constexpr (kMode == kDist) {
    v = static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(v)));
  } else if constexpr (kMode == kFirst) {
    v = static_cast<int>(__reduce_min_sync(kFull, static_cast<unsigned>(v)));
  }
  __syncwarp();  // the slots other lanes placed
  const bool store = w.in && a.probe != kNoStore;
  int* o = a.out + (static_cast<size_t>(b) * a.m + c) * a.k;
  for (int j = lane; j < a.k; j += 32) {
    if constexpr (kMode == kWrite) {
      v = slots[j];
      slots[j] = a.n;
    }
    if (store) o[j] = v;
  }
  if (!store) asm volatile("" ::"r"(v));
  __syncwarp();  // before the slots are placed again
}

// The cloud and the tile's centroids staged whole; the block's warps take the
// tile's centroids from a shared counter (kDist two at a time).
template <int kMode>
__global__ void __launch_bounds__(kMaxThreads) bq_whole(Args a) {
  extern __shared__ float4 pts[];
  __shared__ int next;
  constexpr int kTake = kMode == kDist ? 2 : 1;  // centroids a warp scans at once
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int c0 = blockIdx.x * a.tile, c1 = min(a.m, c0 + a.tile);
  float4* cen = pts + a.count;  // the tile's centroids, w 1 where valid
  int* slots = reinterpret_cast<int*>(cen + a.tile) + a.k * warp;
  for (int j = lane; j < a.k; j += 32) slots[j] = a.n;
  for (int i = threadIdx.x; i < c1 - c0; i += blockDim.x) {
    const size_t ci = static_cast<size_t>(b) * a.m + c0 + i;
    cen[i] = make_float4(a.centers[3 * ci], a.centers[3 * ci + 1], a.centers[3 * ci + 2],
                         a.cmask[ci] ? 1.f : 0.f);
  }
  stage(pts, a.pos + static_cast<size_t>(b) * 3 * a.n, a.mask + static_cast<size_t>(b) * a.n,
        0, a.count, a.n);
  if (threadIdx.x == 0) next = c0 + kTake * warps;
  __syncthreads();
  for (int c = c0 + kTake * warp; c < c1;) {
    int taken = 0;
    if (lane == 0) taken = atomicAdd(&next, kTake);
    const int nc = __shfl_sync(kFull, taken, 0);
    Centroid w = staged<kMode>(a, cen, c - c0, c0, c1);
    if constexpr (kMode == kDist) {
      Centroid w1 = staged<kMode>(a, cen, c + 1 - c0, c0, c1);
      scan_dist2(pts, a.count, w, w1, a.r2, lane);
      write_out<kMode>(w1, a, b, c + 1, slots, lane);
    } else {
      scan<kMode>(pts, a.count, 0, w, a, slots, lane);
    }
    write_out<kMode>(w, a, b, c, slots, lane);
    c = nc;
  }
}

// The cloud staged a chunk at a time, one centroid a warp.
template <int kMode>
__global__ void __launch_bounds__(kMaxThreads) bq_chunked(Args a) {
  extern __shared__ float4 pts[];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int c = blockIdx.x * warps + warp;
  int* slots = reinterpret_cast<int*>(pts + a.count) + a.k * warp;
  for (int j = lane; j < a.k; j += 32) slots[j] = a.n;
  Centroid w = load<kMode>(a, b, c, a.m);
  const int n_pad = (a.n + 32 * kAhead - 1) / (32 * kAhead) * (32 * kAhead);
  const float* pos = a.pos + static_cast<size_t>(b) * 3 * a.n;
  const unsigned char* mask = a.mask + static_cast<size_t>(b) * a.n;
  for (int first = 0; first < n_pad; first += a.count) {
    const int count = min(a.count, n_pad - first);
    stage(pts, pos, mask, first, count, a.n);
    __syncthreads();
    scan<kMode>(pts, count, first, w, a, slots, lane);
    if (!__syncthreads_or(w.need)) break;  // and off this chunk
  }
  write_out<kMode>(w, a, b, c, slots, lane);
}

// A block's dynamic shared memory: the staged points, the tile's centroids
// (whole), then each warp's slots.
size_t smem_bytes(int count, int tile, int warps, int k) {
  return static_cast<size_t>(count + tile) * sizeof(float4) +
         static_cast<size_t>(warps) * k * sizeof(int);
}

using Kernel = void (*)(Args);

template <int kMode>
Kernel pick_mode(int whole) {
  return whole ? bq_whole<kMode> : bq_chunked<kMode>;
}

Kernel pick(int mode, int whole) {
  switch (mode) {
    case kDist: return pick_mode<kDist>(whole);
    case kRank:
    case kExtract: return pick_mode<kFirst>(whole);
    case kWrite: return pick_mode<kWrite>(whole);
    default: return nullptr;
  }
}

// The launch of a plan: the kernel, its shared memory (set as the kernel's
// limit) and its grid.
cudaError_t prepare(int mode, int b, int m, int n, int k, int tile, int warps, int count,
                    int whole, Kernel* kernel, size_t* smem, dim3* grid) {
  *kernel = pick(mode, whole);
  if (*kernel == nullptr || b < 1 || m < 1 || n < 0 || k < 1 || k > 127 ||
      n >= (1 << kKeyBits) || warps < 1 || 32 * warps > kMaxThreads || tile < 1 || count < 0 ||
      count % (32 * kAhead) != 0 || (whole && count < n) || (!whole && count < 1)) {
    return cudaErrorInvalidValue;
  }
  *smem = smem_bytes(count, whole ? tile : 0, warps, k);
  *grid = dim3(whole ? (m + tile - 1) / tile : (m + warps - 1) / warps, b);
  return cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

}  // namespace

// centers (B, M, 3) f32, cmask (B, M) bool, pos (B, N, 3) f32, mask (B, N) bool
// -> out (B, M, K) int32. k 1-127; n < 2^24; mode kDist/kRank/kExtract/kWrite;
// cap 0-127 (a cap of k or more caps nothing). The plan (bq_phase_bench.plan):
// tile centroids a block (whole; one a warp where chunked), warps a block,
// count points staged at once (the cloud padded to 256 where whole, a
// multiple of 256 where chunked). probe kKernel, or a measurement mode.
extern "C" int dlbt_bq_phase(const void* centers, const void* cmask, const void* pos,
                             const void* mask, void* out, int b, int m, int n, int k, int mode,
                             int cap, float r2, int tile, int warps, int count, int whole,
                             int probe, void* stream) {
  if (cap < 0 || cap > 127 || probe < kKernel || probe > kNoStore) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Kernel kernel;
  size_t smem;
  dim3 grid;
  cudaError_t e = prepare(mode, b, m, n, k, tile, warps, count, whole, &kernel, &smem,
                          &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Args a{static_cast<const float*>(centers), static_cast<const unsigned char*>(cmask),
               static_cast<const float*>(pos), static_cast<const unsigned char*>(mask),
               static_cast<int*>(out), m, n, k, cap, r2, tile, count, probe};
  kernel<<<grid, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// A plan's launch on the current card, as dlbt_bq_phase makes it: out[0]
// blocks per SM, out[1] threads a block, out[2] shared memory a block (bytes,
// dynamic), out[3] and out[4] the grid, out[5] registers a thread, out[6]
// local memory a thread (bytes: spills).
extern "C" int dlbt_bq_phase_launch(int mode, int b, int m, int n, int k, int tile, int warps,
                                    int count, int whole, int* out) {
  Kernel kernel;
  size_t smem;
  dim3 grid;
  cudaError_t e = prepare(mode, b, m, n, k, tile, warps, count, whole, &kernel, &smem,
                          &grid);
  cudaFuncAttributes attr;
  int per_sm = 0;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(kernel));
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * warps, smem);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = per_sm;
  out[1] = 32 * warps;
  out[2] = static_cast<int>(smem);
  out[3] = static_cast<int>(grid.x);
  out[4] = static_cast<int>(grid.y);
  out[5] = attr.numRegs;
  out[6] = static_cast<int>(attr.localSizeBytes);
  return 0;
}
