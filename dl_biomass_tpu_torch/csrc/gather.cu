// Batched row gather: values (B, N, C), idx (B, M, K) -> out (B, M, K, C).
//
// Replaces: dl_biomass_tpu/ops/pallas_mxu_gather.py mxu_gather, forward only
// (_gather_fwd / _fwd_kernel). The Pallas kernel gathers with a one-hot matrix
// product on the MXU; here a row is copied as it is, which gives the same bits
// (a one-hot product of bf16 values with f32 accumulation is exact). An index
// outside [0, N) yields a row of zeros, as a one-hot row with no match does.
// The scatter-add backward and the gradient-free aux table are not ported yet.
//
// Bound on the H100: bytes. Each output row is written once (B*M*K*C values);
// the table is small enough to stay in the 50 MB L2 and is read from device
// memory about once.
//
// Design: a flat grid-stride loop over 16-byte (or narrower, when the row
// width asks for it) chunks of the output: consecutive threads copy
// consecutive chunks, so a warp moves two 256-byte bf16 rows of C=128 per
// step with vector loads and stores; each thread reads its row's index itself.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

template <typename V>
__global__ void gather_kernel(const V* __restrict__ values, const int* __restrict__ idx,
                              V* __restrict__ out, long long rows, int mk, int n,
                              int vecs_per_row) {
  const long long total = rows * vecs_per_row;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const long long r = t / vecs_per_row;
    const int v = static_cast<int>(t - r * vecs_per_row);
    const long long b = r / mk;
    const int src = idx[r];
    V val;
    if (src >= 0 && src < n) {
      val = values[(b * n + src) * vecs_per_row + v];
    } else {
      val = V{};
    }
    out[t] = val;
  }
}

template <typename V>
cudaError_t launch(const void* values, const int* idx, void* out, long long rows, int mk, int n,
                   int row_bytes, cudaStream_t stream) {
  const int vecs = row_bytes / static_cast<int>(sizeof(V));
  const long long total = rows * vecs;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 32) blocks = 132LL * 32;  // grid-stride beyond 32 blocks per SM
  if (blocks < 1) blocks = 1;
  gather_kernel<V><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const V*>(values), idx, static_cast<V*>(out), rows, mk, n, vecs);
  return cudaGetLastError();
}

}  // namespace

// values (B, N, row_bytes) as bytes, idx (B, M*K) int32 -> out (B, M*K, row_bytes).
// vec_bytes (16, 8, 4, 2 or 1) divides row_bytes and the alignment of both pointers.
extern "C" int dlbt_gather(const void* values, const void* idx, void* out, int b, int mk, int n,
                           int row_bytes, int vec_bytes, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto ix = static_cast<const int*>(idx);
  const long long rows = static_cast<long long>(b) * mk;
  cudaError_t e;
  switch (vec_bytes) {
    case 16: e = launch<uint4>(values, ix, out, rows, mk, n, row_bytes, s); break;
    case 8: e = launch<uint2>(values, ix, out, rows, mk, n, row_bytes, s); break;
    case 4: e = launch<uint32_t>(values, ix, out, rows, mk, n, row_bytes, s); break;
    case 2: e = launch<uint16_t>(values, ix, out, rows, mk, n, row_bytes, s); break;
    case 1: e = launch<uint8_t>(values, ix, out, rows, mk, n, row_bytes, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}
