// Kernel 9: the rank-scatter ball query of the TPU tool's phase bisection,
// with its phase stubs, one warp per centroid.
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
// to less, except kDist's all-N scan, which is bound by operations.
//
// Design: the TPU kernel ranks hits with prefix products on the MXU and pulls
// each bucket's first 8 in 8 extraction rounds; here one warp scans its
// centroid's points in index order from the (B, 3, N) planes (coalesced loads),
// 128 points an iteration: the loads of four 32-point steps are issued first,
// then each step's hits are ranked in order by __ballot_sync and __popc. An
// iteration starts at a multiple of 128, so in step q lane l always sees bucket
// l + 32 q: each lane keeps its four bucket counts in registers, counting only
// kept hits (a count stays <= cap). kWrite scatters kept hits into the warp's
// k slots in shared memory (set to n first, so holes and the tail stay n),
// stops after the iteration that holds the K-th hit and writes the slots out
// coalesced. Each stub computes the TPU stub's value from its own phase's work,
// so none of it can be dropped: kDist the distance tests over all N (a
// per-lane count, one warp sum); kRank those plus the ballot ranking (the least
// packed key); kExtract those plus the bucket counts (the least key among the
// hits within the first 8 of their bucket).

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kKeyBits = 24;
constexpr int kIntBig = 0x7fffffff;
constexpr int kSteps = 4;  // 32-point steps per iteration: 128 points, one per bucket
enum Mode { kDist = 0, kRank = 1, kExtract = 2, kWrite = 3 };

template <int kMode>
__global__ void __launch_bounds__(1024)
bq_phase_kernel(const float* __restrict__ centers, const unsigned char* __restrict__ cmask,
                const float* __restrict__ planes, const unsigned char* __restrict__ mask,
                int* __restrict__ out, int m, int n, int k, int cap, float r2) {
  extern __shared__ int slots[];  // kWrite: (warps, k)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * (blockDim.x >> 5) + warp;
  const int b = blockIdx.y;
  if (c >= m) return;  // whole warps leave together; no block barrier follows
  const size_t ci = static_cast<size_t>(b) * m + c;
  int* o = out + ci * k;
  int* s = slots + warp * k;
  if constexpr (kMode == kWrite) {
    for (int j = lane; j < k; j += 32) s[j] = n;
    __syncwarp();
  }
  const float* px = planes + static_cast<size_t>(b) * 3 * n;
  const float* py = px + n;
  const float* pz = py + n;
  const unsigned char* mk = mask + static_cast<size_t>(b) * n;
  const float cx = centers[3 * ci], cy = centers[3 * ci + 1], cz = centers[3 * ci + 2];
  const int end = cmask[ci] ? n : 0;
  const unsigned below = (1u << lane) - 1u;
  int cnt = 0;               // hits before this step, the same in every lane
  int counts[kSteps] = {};  // kept hits so far in buckets lane + 32 q
  int acc = kMode == kDist ? 0 : kIntBig;
  for (int base = 0; base < end; base += 32 * kSteps) {
    if (kMode == kWrite && cnt >= k) break;
    bool ok[kSteps];
#pragma unroll
    for (int q = 0; q < kSteps; ++q) {  // all loads of the 128 points first
      const int i = base + 32 * q + lane;
      ok[q] = false;
      if (i < n) {
        const float dx = __fsub_rn(px[i], cx);
        const float dy = __fsub_rn(py[i], cy);
        const float dz = __fsub_rn(pz[i], cz);
        const float d2 =
            __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        ok[q] = mk[i] && d2 <= r2;
      }
    }
#pragma unroll
    for (int q = 0; q < kSteps; ++q) {
      if constexpr (kMode == kDist) {
        acc += ok[q];
      } else {
        const int i = base + 32 * q + lane;
        const unsigned hits = __ballot_sync(kFull, ok[q]);
        const int rank = cnt + __popc(hits & below);
        cnt += __popc(hits);
        const int key = (min(rank, k) << kKeyBits) | i;
        if constexpr (kMode == kRank) {
          if (ok[q]) acc = min(acc, key);
        } else {
          const bool kept = ok[q] && counts[q] < cap;
          counts[q] += kept;
          if constexpr (kMode == kExtract) {
            if (kept) acc = min(acc, key);
          } else {
            if (kept && rank < k) s[rank] = i;
          }
        }
      }
    }
  }
  if constexpr (kMode == kWrite) {
    __syncwarp();
    for (int j = lane; j < k; j += 32) o[j] = s[j];
  } else {
    const int v = kMode == kDist
                      ? static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(acc)))
                      : static_cast<int>(__reduce_min_sync(kFull, static_cast<unsigned>(acc)));
    for (int j = lane; j < k; j += 32) o[j] = v;
  }
}

template <int kMode>
cudaError_t launch(const dim3& grid, int threads, size_t smem, cudaStream_t stream,
                   const void* centers, const void* cmask, const void* planes, const void* mask,
                   void* out, int m, int n, int k, int cap, float r2) {
  bq_phase_kernel<kMode><<<grid, threads, smem, stream>>>(
      static_cast<const float*>(centers), static_cast<const unsigned char*>(cmask),
      static_cast<const float*>(planes), static_cast<const unsigned char*>(mask),
      static_cast<int*>(out), m, n, k, cap, r2);
  return cudaGetLastError();
}

}  // namespace

// centers (B, M, 3) f32, cmask (B, M) bool, planes (B, 3, N) f32 [x, y, z], mask (B, N)
// bool -> out (B, M, K) int32. cm centroids (warps) per block, 1-32; k 1-127; n < 2^24;
// mode kDist/kRank/kExtract/kWrite; cap 0-k (kExtract 8).
extern "C" int dlbt_bq_phase(const void* centers, const void* cmask, const void* planes,
                             const void* mask, void* out, int b, int m, int n, int k, int cm,
                             int mode, int cap, float r2, void* stream) {
  if (b < 1 || m < 1 || n < 0 || k < 1 || k > 127 || n >= (1 << kKeyBits) || cm < 1 ||
      cm > 32 || cap < 0 || cap > 127) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((m + cm - 1) / cm, b);
  const int threads = 32 * cm;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kDist:
      return static_cast<int>(launch<kDist>(grid, threads, 0, st, centers, cmask, planes, mask,
                                            out, m, n, k, cap, r2));
    case kRank:
      return static_cast<int>(launch<kRank>(grid, threads, 0, st, centers, cmask, planes, mask,
                                            out, m, n, k, cap, r2));
    case kExtract:
      return static_cast<int>(launch<kExtract>(grid, threads, 0, st, centers, cmask, planes,
                                               mask, out, m, n, k, cap, r2));
    case kWrite:
      return static_cast<int>(launch<kWrite>(grid, threads, sizeof(int) * cm * k, st, centers,
                                             cmask, planes, mask, out, m, n, k, cap, r2));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
