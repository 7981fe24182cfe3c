// Exact ball query: the first K in-radius neighbours of each centroid by index.
//
// Replaces: dl_biomass_tpu/ops/pallas_ballquery.py ball_query_pallas (kernel
// _bq_kernel).
// Semantics: those of the exact jnp path, dl_biomass_tpu/ops/ballquery.py
// ball_query(method="exact"): for a valid centroid, the K smallest indices of
// valid points with dx*dx + dy*dy + dz*dz <= r2 (inclusive, every operation
// rounded on its own), ascending; the remaining slots hold index 0 and are
// masked off. The Pallas kernel matches this except when one residue bucket
// holds more than R=8 of the first 64; this kernel has no such cap.
//
// Bound on the H100: the bytes (each point and centroid read once, the (B, M,
// K) int32 and bool outputs written once) where the balls fill early (SA2);
// where they do not (the parity preset's SA1 at r=2 scans most clouds whole),
// the operations of the distance tests the data needs (a scan stops at the
// K-th hit, so a centroid tests the index of its K-th neighbour plus one
// points, or all N), 8 flops each, which on the CUDA cores, with no FMA, are
// 9 instructions a test.
//
// Design: a block takes one cloud and a tile of its centroids and stages the
// cloud's points in shared memory once, as float4 (x, y, z, 0) read straight
// from pos (B, N, 3) and mask (B, N); a masked point, or a pad slot past N,
// holds NaN in x, so it fails every test and the scan needs no bounds or mask
// test. A warp scans one centroid in index order, AHEAD chunks of 32 points at
// a time: every test of the group, then AHEAD ballots, then each chunk's hits
// placed at their slots in ascending order by __popc prefixes; the hit count
// is read once per 32 * AHEAD points. A group that hits nothing places
// nothing; one whose every chunk hits (SA2's balls) places them all without a
// branch; otherwise (SA1's sparse balls at r=2) only the chunks that hit are
// placed. Points tested past the K-th hit change nothing (their slots are
// >= K and not kept). The hits go to the warp's K slots in shared memory, and
// the row is written out once, coalesced, with 0 and the mask after the hits.
// - Whole (the padded cloud and the warps' slots fit a block's shared memory:
//   N <= 13,824 at K=64): a warp that has filled its K slots takes the tile's
//   next centroid from a counter in shared memory (its coordinates loaded
//   before it scans the one it holds), so one long scan does not hold the
//   others idle.
// - Chunked (larger N): the block stages the cloud 8192 points at a time, one
//   centroid a warp, and moves to the next chunk while any of its warps still
//   needs points (__syncthreads_or); a warp that is done waits at the
//   barrier, since a centroid taken mid-cloud would have to scan from point 0.
// ball_query_kernel.plan mirrors the launch: centroids a block, warps, points
// staged at once, whole or chunked, and AHEAD.
// Measurement modes (ball_query_kernel.probe): no early exit; the staging and
// the writing of the outputs alone; the scan without the writing.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 1024;

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
      const int jc = min(j, n - 1);
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

// One centroid of a warp: its coordinates, hits so far, whether it is in the
// warp's tile (in) and still needs points (need).
struct Centroid {
  float x, y, z;
  int cnt;
  bool in, need;
};

struct Args {
  const float* centers;
  const unsigned char* cmask;
  const float* pos;
  const unsigned char* mask;
  int* idx;
  unsigned char* nbr_mask;
  int m, n, k;
  float r2;
  int tile;   // centroids a block (whole)
  int count;  // points staged at once: the padded cloud (whole) or a chunk
  int mode;   // kKernel on every path; the others measure
};

// the measurement modes (ball_query_kernel.probe): no early exit; the staging
// and the writing of the outputs alone; the scan without the writing
constexpr int kKernel = 0, kFullScan = 1, kStageOnly = 2, kNoStore = 3;

// Centroid c of cloud b, if it is below c1; the loads are issued here and
// waited for at the first use.
__device__ __forceinline__ Centroid load(const Args& a, int b, int c, int c1) {
  const size_t ci = static_cast<size_t>(b) * a.m + min(c, a.m - 1);
  Centroid w;
  w.in = c < c1;
  w.need = w.in && a.cmask[ci];
  w.x = a.centers[3 * ci];
  w.y = a.centers[3 * ci + 1];
  w.z = a.centers[3 * ci + 2];
  w.cnt = 0;
  return w;
}

// One chunk's hits (its ballot), placed in the slots at shared-memory address
// row from slot cnt on, in index order: a lane's slot is cnt plus the hits
// of the lanes below it.
__device__ __forceinline__ void place(unsigned hits, bool ok, int base, unsigned below, int k,
                                      unsigned row, int& cnt, int lane) {
  const int slot = cnt + __popc(hits & below);
  if (ok && slot < k) {
    asm volatile("st.shared.u32 [%0], %1;" ::"r"(row + 4 * slot), "r"(base + lane) : "memory");
  }
  cnt += __popc(hits);
}

// One warp scans pts[0 .. count) (count a multiple of 32 * AHEAD; pts[0] is
// point `first` of the cloud) for its centroid, putting each hit whose slot
// is below k in the centroid's k slots of `slots` (shared memory), until it
// has k hits.
template <int AHEAD>
__device__ __forceinline__ void scan(const float4* pts, int count, int first, Centroid& w,
                                     const Args& a, int* slots, int lane) {
  const unsigned below = (1u << lane) - 1u;
  const float r2 = a.r2;
  const int k = a.k;
  // the slots' shared-memory address, held in one register
  const unsigned row = static_cast<unsigned>(__cvta_generic_to_shared(slots));
  for (int s = 0; s < count && w.need; s += 32 * AHEAD) {
    // every test of the group before any ballot: the ballot's convergence
    // check would otherwise hold the later chunks' loads behind the first
    bool ok[AHEAD];
#pragma unroll
    for (int t = 0; t < AHEAD; ++t) {
      const float4 p = pts[s + 32 * t + lane];
      const float dx = __fsub_rn(p.x, w.x);
      const float dy = __fsub_rn(p.y, w.y);
      const float dz = __fsub_rn(p.z, w.z);
      const float d2 =
          __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      ok[t] = d2 <= r2;
    }
    unsigned hits[AHEAD], any = 0;
#pragma unroll
    for (int t = 0; t < AHEAD; ++t) {
      hits[t] = __ballot_sync(kFull, ok[t]);
      any |= hits[t];
    }
    if (any == 0) continue;  // most groups of a long scan hit nothing
    bool dense = true;
#pragma unroll
    for (int t = 0; t < AHEAD; ++t) dense &= hits[t] != 0;
    if (dense) {  // every chunk hit (SA2's balls): placed together, no branch
#pragma unroll
      for (int t = 0; t < AHEAD; ++t) {
        place(hits[t], ok[t], first + s + 32 * t, below, k, row, w.cnt, lane);
      }
    } else {  // sparse hits (SA1's balls at r=2): the chunks that hit, alone
#pragma unroll
      for (int t = 0; t < AHEAD; ++t) {
        if (hits[t] != 0) place(hits[t], ok[t], first + s + 32 * t, below, k, row, w.cnt,
                                lane);
      }
    }
    w.need = a.mode == kFullScan || w.cnt < k;
  }
}

// The warp's centroid c, if in its tile: its k slots written out, the hits
// from `slots` and 0 after them, with the mask, in coalesced rows.
__device__ __forceinline__ void write_out(const Centroid& w, const Args& a, int b, int c,
                                          const int* slots, int lane) {
  __syncwarp();  // the slots other lanes placed
  if (w.in && a.mode != kNoStore) {
    const size_t row = (static_cast<size_t>(b) * a.m + c) * a.k;
    const int filled = min(w.cnt, a.k);
    for (int s = lane; s < a.k; s += 32) {
      a.idx[row + s] = s < filled ? slots[s] : 0;
      a.nbr_mask[row + s] = s < filled;
    }
  }
  __syncwarp();  // before the slots are placed again
}

// The cloud staged whole; the block's warps take the tile's centroids from a
// shared counter, and load the next one before they scan.
template <int AHEAD>
__global__ void __launch_bounds__(kMaxThreads) ball_query_whole(Args a) {
  extern __shared__ float4 pts[];
  __shared__ int next;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int c0 = blockIdx.x * a.tile, c1 = min(a.m, c0 + a.tile);
  int* slots = reinterpret_cast<int*>(pts + a.count) + a.k * warp;
  int c = c0 + warp;
  Centroid cur = load(a, b, c, c1);
  stage(pts, a.pos + static_cast<size_t>(b) * 3 * a.n, a.mask + static_cast<size_t>(b) * a.n,
        0, a.count, a.n);
  if (threadIdx.x == 0) next = c0 + warps;
  __syncthreads();
  while (c < c1) {
    int taken = 0;
    if (lane == 0) taken = atomicAdd(&next, 1);
    const int nc = __shfl_sync(kFull, taken, 0);
    const Centroid nx = load(a, b, nc, c1);
    if (a.mode != kStageOnly) scan<AHEAD>(pts, a.count, 0, cur, a, slots, lane);
    write_out(cur, a, b, c, slots, lane);
    c = nc;
    cur = nx;
  }
}

// The cloud staged a chunk at a time, one centroid a warp.
template <int AHEAD>
__global__ void __launch_bounds__(kMaxThreads) ball_query_chunked(Args a) {
  extern __shared__ float4 pts[];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int c = blockIdx.x * warps + warp;
  int* slots = reinterpret_cast<int*>(pts + a.count) + a.k * warp;
  Centroid w = load(a, b, c, a.m);
  const int n_pad = (a.n + 32 * AHEAD - 1) / (32 * AHEAD) * (32 * AHEAD);
  const float* pos = a.pos + static_cast<size_t>(b) * 3 * a.n;
  const unsigned char* mask = a.mask + static_cast<size_t>(b) * a.n;
  for (int first = 0; first < n_pad; first += a.count) {
    const int count = min(a.count, n_pad - first);
    stage(pts, pos, mask, first, count, a.n);
    __syncthreads();
    if (a.mode != kStageOnly) scan<AHEAD>(pts, count, first, w, a, slots, lane);
    if (!__syncthreads_or(w.need && a.mode != kStageOnly)) break;  // and off this chunk
  }
  write_out(w, a, b, c, slots, lane);
}

// A block's dynamic shared memory: the staged points, then each warp's slots.
size_t smem_bytes(int count, int warps, int k) {
  return static_cast<size_t>(count) * sizeof(float4) +
         static_cast<size_t>(warps) * k * sizeof(int);
}

template <int AHEAD>
cudaError_t set_smem(int whole, size_t smem) {
  return whole ? cudaFuncSetAttribute(ball_query_whole<AHEAD>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      static_cast<int>(smem))
               : cudaFuncSetAttribute(ball_query_chunked<AHEAD>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      static_cast<int>(smem));
}

template <int AHEAD>
cudaError_t launch(const Args& a, int b, int warps, int whole, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.count, warps, a.k);
  const cudaError_t err = set_smem<AHEAD>(whole, smem);
  if (err != cudaSuccess) return err;
  if (whole) {
    ball_query_whole<AHEAD><<<dim3((a.m + a.tile - 1) / a.tile, b), 32 * warps, smem,
                              stream>>>(a);
  } else {
    ball_query_chunked<AHEAD><<<dim3((a.m + warps - 1) / warps, b), 32 * warps, smem,
                                stream>>>(a);
  }
  return cudaGetLastError();
}

template <int AHEAD>
cudaError_t occupancy(int warps, int count, int whole, int k, int* per_sm) {
  const size_t smem = smem_bytes(count, warps, k);
  const cudaError_t err = set_smem<AHEAD>(whole, smem);
  if (err != cudaSuccess) return err;
  return whole ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     per_sm, ball_query_whole<AHEAD>, 32 * warps, smem)
               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     per_sm, ball_query_chunked<AHEAD>, 32 * warps, smem);
}

}  // namespace

// centers (B, M, 3) f32, cmask (B, M) bool, pos (B, N, 3) f32, mask (B, N) bool
// -> idx (B, M, K) int32, nbr_mask (B, M, K) bool. The plan
// (ball_query_kernel.plan): tile centroids a block (whole; one a warp where
// chunked), warps a block, count points staged at once (the cloud padded to
// 32 * ahead where whole, a multiple of it where chunked), ahead 4 or 8
// chunks tested before the hit count is read. mode: 0 on every path; 1, 2, 3
// for the measurements (full scan, staging alone, no writing).
extern "C" int dlbt_ball_query(const void* centers, const void* cmask, const void* pos,
                               const void* mask, void* idx, void* nbr_mask, int b, int m,
                               int n, int k, float r2, int tile, int warps, int count,
                               int whole, int ahead, int mode, void* stream) {
  if (warps < 1 || 32 * warps > kMaxThreads || ahead < 1 || count % (32 * ahead) != 0 ||
      tile < 1 || mode < kKernel || mode > kNoStore)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(centers), static_cast<const unsigned char*>(cmask),
               static_cast<const float*>(pos), static_cast<const unsigned char*>(mask),
               static_cast<int*>(idx), static_cast<unsigned char*>(nbr_mask), m, n, k, r2, tile,
               count, mode};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ahead) {
    case 4: return static_cast<int>(launch<4>(a, b, warps, whole, s));
    case 8: return static_cast<int>(launch<8>(a, b, warps, whole, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Blocks per SM of a plan's launch on the current card.
extern "C" int dlbt_ball_query_occupancy(int warps, int count, int whole, int ahead, int k,
                                         int* per_sm) {
  switch (ahead) {
    case 4: return static_cast<int>(occupancy<4>(warps, count, whole, k, per_sm));
    case 8: return static_cast<int>(occupancy<8>(warps, count, whole, k, per_sm));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
