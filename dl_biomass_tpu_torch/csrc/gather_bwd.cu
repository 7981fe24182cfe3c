// Scatter-add backward of the batched row gather: ct (B, M, K, C), idx (B, M, K)
// -> out (B, N, C), each out row the float32 sum of the ct rows whose index
// points at it, rounded once to ct's dtype (float32 or bfloat16).
//
// Replaces: dl_biomass_tpu/ops/pallas_mxu_gather.py mxu_gather, its backward
// (_gather_bwd / _bwd_kernel). The Pallas kernel builds a one-hot (N, CM*K)
// block per centroid tile and accumulates its product with the ct tile in a
// float32 VMEM accumulator across tiles. Here the float sum is taken row by
// row instead, in ascending flat-row order (k fastest, then m), with no float
// atomics: the result is deterministic and bit-identical to
// ops/gather_kernel.py scatter_rows_plain, which sums in the same order. An
// index outside [0, N) contributes nothing; a pad slot (index 0) contributes
// its ct, which is zero on the model's path.
//
// Bound on the H100: bytes. ct is read once (B*M*K*C values: 134 MB in bf16
// at B=16, M=512, K=64, C=128), idx once and the output written once; the
// float32 adds (one per ct value) are far below the card's rate.
//
// Design: four launches, each spread over the card but the scan.
// 1. Count: block (s, b) counts the keys of rows [s*kCsrRows, (s+1)*kCsrRows)
//    of cloud b into a shared-memory histogram (integer atomics: the counts do
//    not depend on their order) and writes it out, cnt (B, S, N).
// 2. Scan: one block a cloud adds up each key's counts, scans them into the
//    segment offsets and writes each chunk's first slot per key (the offset
//    plus the counts of the chunks before it), first (B, S, N). It writes one
//    record per output row (the row, its segment's start and end, the cloud)
//    into a list of all clouds' rows: the long segments (> kBatch rows) of
//    every cloud at the front, each cloud's short ones together from the back,
//    a cloud's places taken by an integer atomic (which cloud comes first
//    changes which warp sums a row, not the sum).
// 3. Place: block (s, b) again, its chunk's keys staged in shared memory. Each
//    warp owns a contiguous range of the chunk and walks it in order, 32 keys a
//    step, each lane finding the lanes of its key by 32 shuffles (faster here
//    than __match_any_sync): each row learns its rank among the warp's rows of
//    its key and the warp counts its keys. A pass over the warps
//    turns the counts into each warp's first slot per key (from the chunk's),
//    and then every row is written at its slot at once. Rows land in ascending
//    order inside every segment because chunks, and warps inside a chunk, own
//    ascending ranges.
// 4. Sum: one warp per record of the list, so the long segments of every cloud
//    (row 0, which also takes a cloud's pad slots: 441 rows at 16 x 10240) run
//    beside the bulk instead of after it, and each cloud's rows run together. A
//    warp loads 32 row ids at once, then 16 rows at a time before it adds them
//    (4 channels a lane, one 8-byte bf16 or 16-byte f32 vector load a row; past
//    the segment's end its first row again, so that no load waits behind a
//    branch), adds them in order into float32 registers and stores the row once.
//    Sixteen rows in flight at three blocks an SM measured fastest
//    (chip_compare.py scatter: 32 at one or two blocks, 8 at five, 16 at four).
// At 16 x 10240 (H100, CUDA graph) the count takes 0.003 ms, the scan 0.010 (16
// blocks), the place pass 0.017 and the sum 0.061 with row 0's pad slots out,
// 0.065-0.075 with them: the one warp on row 0 still waits out 28 dependent
// loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kCsrRows = 2048;    // rows of a cloud a block of the count and place passes takes
constexpr int kCountThreads = 256;
constexpr int kCountPer = kCsrRows / kCountThreads;  // keys a counting thread loads at once
constexpr int kBatch = 32;        // row ids a summing warp loads at once; longer segments go first
constexpr int kSumThreads = 256;
constexpr int kScanThreads = 1024;
// a scan thread holds its keys' counts in registers where n <= kScanKeys * 1024 and
// S <= kScanChunks (16 x 10240 and 36 x 10240: N = 2048, S = 16): one round of loads
constexpr int kScanKeys = 2, kScanChunks = 16;
constexpr int kUnroll = 8;        // loads a scan or place thread starts before it uses them
constexpr int kDepth = 16;        // rows whose loads a summing lane starts before it adds them

// ---- 1. count -------------------------------------------------------------------

__global__ void __launch_bounds__(kCountThreads)
    count_kernel(const int* __restrict__ idx, int* __restrict__ cnt, int* __restrict__ heads,
                 int r, int n, int chunks) {
  extern __shared__ int hist[];  // [n]
  const int s = blockIdx.x, b = blockIdx.y;
  if (s == 0 && b == 0 && threadIdx.x < 2) heads[threadIdx.x] = 0;  // the place pass's
  for (int i = threadIdx.x; i < n; i += kCountThreads) hist[i] = 0;
  __syncthreads();
  const int* ix = idx + static_cast<long long>(b) * r;
  const int r0 = s * kCsrRows, r1 = min(r, r0 + kCsrRows);
  int key[kCountPer];
#pragma unroll
  for (int q = 0; q < kCountPer; ++q) {  // every load started before the first add
    const int t = r0 + q * kCountThreads + threadIdx.x;
    key[q] = t < r1 ? ix[t] : -1;
  }
#pragma unroll
  for (int q = 0; q < kCountPer; ++q) {
    if (key[q] >= 0 && key[q] < n) atomicAdd(&hist[key[q]], 1);
  }
  __syncthreads();
  int* out = cnt + (static_cast<long long>(b) * chunks + s) * n;
  for (int i = threadIdx.x; i < n; i += kCountThreads) out[i] = hist[i];
}

// ---- 2. scan --------------------------------------------------------------------

// Exclusive scan over the block of x[0..n) and of the flags x[i] > kBatch: x[i]
// becomes its prefix sum, longs[i] the long rows before i. Returns the totals
// (sum, long rows) to every thread.
__device__ int2 scan_pairs(int* x, int* longs, int n) {
  __shared__ int2 wsum[32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
  const int ch = (n + blockDim.x - 1) / blockDim.x;
  const int s0 = min(n, static_cast<int>(threadIdx.x) * ch), s1 = min(n, s0 + ch);
  int a = 0, l = 0;
  for (int i = s0; i < s1; ++i) {
    a += x[i];
    l += x[i] > kBatch;
  }
  int ia = a, il = l;  // inclusive over the warp
  for (int o = 1; o < 32; o <<= 1) {
    const int ya = __shfl_up_sync(kFull, ia, o), yl = __shfl_up_sync(kFull, il, o);
    if (lane >= o) {
      ia += ya;
      il += yl;
    }
  }
  if (lane == 31) wsum[warp] = make_int2(ia, il);
  __syncthreads();
  if (warp == 0) {
    int2 w = lane < nwarps ? wsum[lane] : make_int2(0, 0);
    for (int o = 1; o < 32; o <<= 1) {
      const int ya = __shfl_up_sync(kFull, w.x, o), yl = __shfl_up_sync(kFull, w.y, o);
      if (lane >= o) {
        w.x += ya;
        w.y += yl;
      }
    }
    wsum[lane] = w;  // inclusive over the warps
  }
  __syncthreads();
  int ra = ia - a + (warp > 0 ? wsum[warp - 1].x : 0);
  int rl = il - l + (warp > 0 ? wsum[warp - 1].y : 0);
  for (int i = s0; i < s1; ++i) {
    const int c = x[i];
    x[i] = ra;
    longs[i] = rl;
    ra += c;
    rl += c > kBatch;
  }
  const int2 total = wsum[nwarps - 1];
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(kScanThreads)
    scan_kernel(const int* __restrict__ cnt, int* __restrict__ first, int* __restrict__ heads,
                int4* __restrict__ recs, int b_total, int n, int chunks) {
  extern __shared__ int smem[];
  int* start = smem;      // [n]: the key's total, then its segment's start
  int* longs = smem + n;  // [n]: the long segments before the key
  const int b = blockIdx.x;
  const int* cb = cnt + static_cast<long long>(b) * chunks * n;  // (S, N) of the cloud
  int* fb = first + static_cast<long long>(b) * chunks * n;
  const bool held = n <= kScanKeys * kScanThreads && chunks <= kScanChunks;
  int c[kScanKeys][kScanChunks];
  if (held) {
#pragma unroll
    for (int u = 0; u < kScanKeys; ++u) {
      const int i = u * kScanThreads + threadIdx.x;
#pragma unroll
      for (int q = 0; q < kScanChunks; ++q) {
        c[u][q] = i < n && q < chunks ? cb[static_cast<long long>(q) * n + i] : 0;
      }
    }
#pragma unroll
    for (int u = 0; u < kScanKeys; ++u) {
      const int i = u * kScanThreads + threadIdx.x;
      int tot = 0;
#pragma unroll
      for (int q = 0; q < kScanChunks; ++q) tot += c[u][q];
      if (i < n) start[i] = tot;
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kScanThreads) {
      int tot = 0;
      for (int q0 = 0; q0 < chunks; q0 += kUnroll) {  // kUnroll loads before their adds
        int d[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          d[u] = q0 + u < chunks ? cb[static_cast<long long>(q0 + u) * n + i] : 0;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) tot += d[u];
      }
      start[i] = tot;
    }
  }
  __syncthreads();
  const int2 total = scan_pairs(start, longs, n);

  __shared__ int at[2];
  if (threadIdx.x == 0) {
    at[0] = atomicAdd(&heads[0], total.y);
    at[1] = atomicAdd(&heads[1], n - total.y);
  }
  __syncthreads();
  const long long last = static_cast<long long>(b_total) * n - 1;
  for (int i = threadIdx.x; i < n; i += kScanThreads) {
    const int e = i + 1 < n ? start[i + 1] : total.x;
    const long long pos = e - start[i] > kBatch ? at[0] + longs[i]
                                                 : last - (at[1] + i - longs[i]);
    recs[pos] = make_int4(i, start[i], e, b);
  }
  // each chunk's first slot for the key: its start and the counts of the chunks before
  if (held) {
#pragma unroll
    for (int u = 0; u < kScanKeys; ++u) {
      const int i = u * kScanThreads + threadIdx.x;
      if (i < n) {
        int run = start[i];
#pragma unroll
        for (int q = 0; q < kScanChunks; ++q) {
          if (q < chunks) fb[static_cast<long long>(q) * n + i] = run;
          run += c[u][q];
        }
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < n; i += kScanThreads) {
    int run = start[i];
    for (int q0 = 0; q0 < chunks; q0 += kUnroll) {
      int d[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        d[u] = q0 + u < chunks ? cb[static_cast<long long>(q0 + u) * n + i] : 0;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (q0 + u < chunks) {
          fb[static_cast<long long>(q0 + u) * n + i] = run;
          run += d[u];
        }
      }
    }
  }
}

// ---- 3. place -------------------------------------------------------------------

__global__ void place_kernel(const int* __restrict__ idx, const int* __restrict__ first,
                             int* __restrict__ rows, int r, int n, int chunks) {
  extern __shared__ int smem[];
  const int nwarps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int* keys = smem;               // [kCsrRows]: the chunk's keys, -1 where out of range
  int* rank = keys + kCsrRows;    // [kCsrRows]: a row's rank among its warp's of its key
  int* hist = rank + kCsrRows;    // [nwarps][n]: each warp's count, then first slot, per key
  const int s = blockIdx.x, b = blockIdx.y;
  const int* ix = idx + static_cast<long long>(b) * r;
  const int r0 = s * kCsrRows, len = min(r, r0 + kCsrRows) - r0;
  {  // kUnroll loads started before any is used: a rolled loop waits out each in turn
    int k[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = u * blockDim.x + threadIdx.x;
      k[u] = i < len ? ix[r0 + i] : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = u * blockDim.x + threadIdx.x;
      if (i < len) keys[i] = k[u] >= 0 && k[u] < n ? k[u] : -1;
    }
    for (int i = kUnroll * blockDim.x + threadIdx.x; i < len; i += blockDim.x) {
      const int key = ix[r0 + i];
      keys[i] = key >= 0 && key < n ? key : -1;
    }
  }
  for (int i = threadIdx.x; i < nwarps * n; i += blockDim.x) hist[i] = 0;
  __syncthreads();

  const int per = (len + nwarps - 1) / nwarps;
  const int k0 = min(len, warp * per), k1 = min(len, k0 + per);
  int* h = hist + warp * n;
  const unsigned below = (1u << lane) - 1u;
  for (int base = k0; base < k1; base += 32) {
    const int i = base + lane;
    const int k = i < k1 ? keys[i] : -1;
    unsigned peers = 0;  // the lanes with this lane's key: 32 shuffles (MATCH.ANY is slower)
#pragma unroll
    for (int o = 0; o < 32; ++o) peers |= static_cast<unsigned>(__shfl_sync(kFull, k, o) == k) << o;
    if (k >= 0) rank[i] = h[k] + __popc(peers & below);
    __syncwarp();
    if (k >= 0 && lane == __ffs(peers) - 1) h[k] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  const int* fs = first + (static_cast<long long>(b) * chunks + s) * n;
  for (int i0 = 0; i0 < n; i0 += kUnroll * blockDim.x) {
    int run[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * blockDim.x + threadIdx.x;
      run[u] = i < n ? fs[i] : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * blockDim.x + threadIdx.x;
      if (i < n) {
        for (int w = 0; w < nwarps; ++w) {
          const int c = hist[w * n + i];
          hist[w * n + i] = run[u];
          run[u] += c;
        }
      }
    }
  }
  __syncthreads();
  int* rw = rows + static_cast<long long>(b) * r;
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    const int k = keys[i];
    if (k >= 0) rw[hist[(i / per) * n + k] + rank[i]] = r0 + i;
  }
}

// ---- 4. sum ---------------------------------------------------------------------

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// kMinBlocks: blocks an SM holds at once (the register budget)
template <typename T, int V, int kMinBlocks>
__global__ void __launch_bounds__(kSumThreads, kMinBlocks)
    segment_sum_kernel(const T* __restrict__ ct, const int4* __restrict__ recs,
                       const int* __restrict__ rows, T* __restrict__ out, int b, int r, int n,
                       int c) {
  const long long gw = (static_cast<long long>(blockIdx.x) * kSumThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (gw >= static_cast<long long>(b) * n) return;  // the whole warp leaves together
  const int4 rec = recs[gw];  // row, start, end, cloud
  const int bi = rec.w;
  const int* rw = rows + static_cast<long long>(bi) * r;
  const T* src = ct + static_cast<long long>(bi) * r * c;
  T* dst = out + (static_cast<long long>(bi) * n + rec.x) * c;
  using VT = Vec<T, V>;
  for (int cb = 0; cb < c; cb += 32 * V) {  // warp-uniform: every lane takes the shuffles
    const int c0 = cb + lane * V;
    const bool on = c0 < c;
    float acc[V];
#pragma unroll
    for (int q = 0; q < V; ++q) acc[q] = 0.0f;
    // the batch's row ids, the next batch's loaded before this one's rows (clamped to
    // the segment's last id: no load waits behind a branch)
    int next = rec.y < rec.z ? rw[min(rec.y + lane, rec.z - 1)] : 0;
    for (int j = rec.y; j < rec.z; j += kBatch) {
      const int cnt = min(kBatch, rec.z - j);
      const int mine = next;
      next = rw[min(j + kBatch + lane, rec.z - 1)];
#pragma unroll
      for (int a0 = 0; a0 < kBatch; a0 += kDepth) {
        if (a0 >= cnt) break;
        VT vals[kDepth];
        // every load unconditional (past the segment's end, its first row again, an
        // L1 hit): a load under a branch makes the compiler wait for each in turn
#pragma unroll
        for (int a = 0; a < kDepth; ++a) {
          const long long row = __shfl_sync(kFull, mine, a0 + a < cnt ? a0 + a : 0);
          vals[a] = *reinterpret_cast<const VT*>(src + row * c + (on ? c0 : 0));
        }
#pragma unroll
        for (int a = 0; a < kDepth; ++a) {
          if (a0 + a < cnt) {
#pragma unroll
            for (int q = 0; q < V; ++q) acc[q] += to_f32(vals[a].v[q]);
          }
        }
      }
    }
    if (on) {
      VT o;
#pragma unroll
      for (int q = 0; q < V; ++q) o.v[q] = from_f32<T>(acc[q]);
      *reinterpret_cast<VT*>(dst + c0) = o;
    }
  }
}

template <typename T, int V, int kMinBlocks>
void sum(const void* ct, const int4* recs, const int* rows, void* out, int b, int r, int n, int c,
         cudaStream_t stream) {
  const long long warps = static_cast<long long>(b) * n;
  const unsigned blocks = static_cast<unsigned>((warps * 32 + kSumThreads - 1) / kSumThreads);
  segment_sum_kernel<T, V, kMinBlocks><<<blocks, kSumThreads, 0, stream>>>(
      static_cast<const T*>(ct), recs, rows, static_cast<T*>(out), b, r, n, c);
}

// three blocks an SM (85 registers) where a row is 8 bytes a lane or less, two at 16
template <typename T>
cudaError_t launch_sum(const void* ct, const int4* recs, const int* rows, void* out, int b, int r,
                       int n, int c, cudaStream_t stream) {
  const auto aligned = [](const void* p, int bytes) {
    return reinterpret_cast<std::uintptr_t>(p) % bytes == 0;
  };
  const int b4 = static_cast<int>(sizeof(T)) * 4, b2 = static_cast<int>(sizeof(T)) * 2;
  if (c % 4 == 0 && aligned(ct, b4) && aligned(out, b4)) {
    sum<T, 4, sizeof(T) == 2 ? 3 : 2>(ct, recs, rows, out, b, r, n, c, stream);
  } else if (c % 2 == 0 && aligned(ct, b2) && aligned(out, b2)) {
    sum<T, 2, 3>(ct, recs, rows, out, b, r, n, c, stream);
  } else {
    sum<T, 1, 3>(ct, recs, rows, out, b, r, n, c, stream);
  }
  return cudaGetLastError();
}

int chunks_of(int r) { return r > 0 ? (r + kCsrRows - 1) / kCsrRows : 1; }

size_t place_smem(int n, int warps) {
  return sizeof(int) * (2 * kCsrRows + static_cast<size_t>(warps) * n);
}

// Opts kernel in to smem bytes of dynamic shared memory.
template <typename K>
cudaError_t opt_in(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The four launches, or one of them (mode 1 count, 2 scan, 3 place, 4 sum, each on
// the scratch the launches before it left).
int run(const void* ct, const void* idx, void* cnt, void* recs, void* rows, void* out, int b,
        int r, int n, int c, int dtype, int warps, int mode, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (b < 1 || n < 1 || c < 1 || r < 0 || warps < 1 || warps > 32 ||
      (dtype != 0 && dtype != 1) || mode < 0 || mode > 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool all = mode == 0;
  const int chunks = chunks_of(r);
  const dim3 grid(chunks, b);
  // cnt holds the counts (B, S, N), the first slots (B, S, N) and the list's two counters
  int* counts = static_cast<int*>(cnt);
  int* first = counts + static_cast<long long>(b) * chunks * n;
  int* heads = first + static_cast<long long>(b) * chunks * n;
  auto* rc = static_cast<int4*>(recs);
  auto* rw = static_cast<int*>(rows);
  cudaError_t e = cudaSuccess;
  if (all || mode == 1) {
    const size_t smem = sizeof(int) * static_cast<size_t>(n);
    e = opt_in(count_kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    count_kernel<<<grid, kCountThreads, smem, s>>>(static_cast<const int*>(idx), counts, heads,
                                                   r, n, chunks);
    e = cudaGetLastError();
  }
  if (e == cudaSuccess && mode == 2) e = cudaMemsetAsync(heads, 0, 2 * sizeof(int), s);
  if (e == cudaSuccess && (all || mode == 2)) {
    const size_t smem = 2 * sizeof(int) * static_cast<size_t>(n);
    e = opt_in(scan_kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    scan_kernel<<<b, kScanThreads, smem, s>>>(counts, first, heads, rc, b, n, chunks);
    e = cudaGetLastError();
  }
  if (e == cudaSuccess && (all || mode == 3)) {
    const size_t smem = place_smem(n, warps);
    e = opt_in(place_kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    place_kernel<<<grid, warps * 32, smem, s>>>(static_cast<const int*>(idx), first, rw, r, n,
                                                chunks);
    e = cudaGetLastError();
  }
  if (e == cudaSuccess && (all || mode == 4)) {
    e = dtype == 0 ? launch_sum<float>(ct, rc, rw, out, b, r, n, c, s)
                   : launch_sum<__nv_bfloat16>(ct, rc, rw, out, b, r, n, c, s);
  }
  return static_cast<int>(e);
}

}  // namespace

// ct (B, R=M*K, C) of dtype 0 = float32 or 1 = bfloat16, idx (B, R) int32 ->
// out (B, N, C) of ct's dtype. Scratch: cnt 2 (B, S, N) + 2 int32 with S =
// ceil(R / 2048) (1 where R is 0), recs (B*N) int4 (16-byte
// aligned), rows (B, R) int32. warps: warps per block of the place pass, which
// takes (2 * 2048 + warps * N) * 4 bytes of shared memory; the scan takes 8 N.
extern "C" int dlbt_scatter_rows(const void* ct, const void* idx, void* cnt, void* recs,
                                 void* rows, void* out, int b, int r, int n, int c, int dtype,
                                 int warps, void* stream) {
  return run(ct, idx, cnt, recs, rows, out, b, r, n, c, dtype, warps, 0, stream);
}

// dlbt_scatter_rows's arguments and a mode: 1 the count alone, 2 the scan, 3 the
// place pass, 4 the sum, each on the scratch an earlier launch filled. A
// measurement; no path launches it.
extern "C" int dlbt_scatter_rows_probe(const void* ct, const void* idx, void* cnt, void* recs,
                                       void* rows, void* out, int b, int r, int n, int c,
                                       int dtype, int warps, int mode, void* stream) {
  return run(ct, idx, cnt, recs, rows, out, b, r, n, c, dtype, warps, mode, stream);
}
