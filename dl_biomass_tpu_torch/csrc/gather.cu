// Batched row gather: values (B, N, C), idx (B, M, K) -> out (B, M, K, C), and
// the same gather of two tables by one index (dlbt_gather_aux).
//
// Replaces: dl_biomass_tpu/ops/pallas_mxu_gather.py mxu_gather, forward
// (_gather_fwd / _fwd_kernel), with one table or with the gradient-free aux
// table beside the values (_core2). The Pallas kernel gathers with a one-hot
// matrix product on the MXU; here a row is copied as it is, which gives the
// same bits (a one-hot product of bf16 values with f32 accumulation is exact;
// the TPU's compiled path carries an f32 aux table as three bf16 chunks, to
// 2^-21 relative, where a copy is exact). An index outside [0, N) yields rows
// of zeros, as a one-hot row with no match does. The scatter-add backward is
// csrc/gather_bwd.cu; the aux table has no gradient.
//
// Bound on the H100: bytes. Each output row is written once (B*M*K*C values,
// and B*M*K*C2 f32 of aux); the tables are small enough to stay in the 50 MB
// L2 and are read from device memory about once.
//
// Design: a flat grid-stride loop over 16-byte (or narrower, when the row
// width asks for it) chunks of the output: consecutive threads copy
// consecutive chunks, so a warp moves two 256-byte bf16 rows of C=128 per
// step with vector loads and stores; each thread reads its row's index itself.
// With an aux table, a row is its value chunks followed by its C2 aux floats,
// so one flat loop (one index read per element) fills both outputs.

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
__global__ void gather_aux_kernel(const V* __restrict__ values, const float* __restrict__ aux,
                                  const int* __restrict__ idx, V* __restrict__ out,
                                  float* __restrict__ out_aux, long long rows, int mk, int n,
                                  int vecs_per_row, int c2) {
  const int per_row = vecs_per_row + c2;
  const long long total = rows * per_row;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const long long r = t / per_row;
    const int j = static_cast<int>(t - r * per_row);
    const long long b = r / mk;
    const int src = idx[r];
    const bool ok = src >= 0 && src < n;
    if (j < vecs_per_row) {
      out[r * vecs_per_row + j] = ok ? values[(b * n + src) * vecs_per_row + j] : V{};
    } else {
      const int q = j - vecs_per_row;
      out_aux[r * c2 + q] = ok ? aux[(b * n + src) * c2 + q] : 0.0f;
    }
  }
}

long long grid_blocks(long long total, int threads) {
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 32) blocks = 132LL * 32;  // grid-stride beyond 32 blocks per SM
  return blocks < 1 ? 1 : blocks;
}

template <typename V>
cudaError_t launch_aux(const void* values, const float* aux, const int* idx, void* out,
                       float* out_aux, long long rows, int mk, int n, int row_bytes, int c2,
                       cudaStream_t stream) {
  const int vecs = row_bytes / static_cast<int>(sizeof(V));
  const int threads = 256;
  const long long blocks = grid_blocks(rows * (vecs + c2), threads);
  gather_aux_kernel<V><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const V*>(values), aux, idx, static_cast<V*>(out), out_aux, rows, mk, n, vecs,
      c2);
  return cudaGetLastError();
}

template <typename V>
cudaError_t launch(const void* values, const int* idx, void* out, long long rows, int mk, int n,
                   int row_bytes, cudaStream_t stream) {
  const int vecs = row_bytes / static_cast<int>(sizeof(V));
  const int threads = 256;
  const long long blocks = grid_blocks(rows * vecs, threads);
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

// values (B, N, row_bytes) as bytes, aux (B, N, C2) f32, idx (B, M*K) int32 ->
// out (B, M*K, row_bytes), out_aux (B, M*K, C2) f32; vec_bytes as for dlbt_gather.
extern "C" int dlbt_gather_aux(const void* values, const void* aux, const void* idx, void* out,
                               void* out_aux, int b, int mk, int n, int row_bytes, int vec_bytes,
                               int c2, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto ix = static_cast<const int*>(idx);
  auto ax = static_cast<const float*>(aux);
  auto oa = static_cast<float*>(out_aux);
  const long long rows = static_cast<long long>(b) * mk;
  cudaError_t e;
  switch (vec_bytes) {
    case 16: e = launch_aux<uint4>(values, ax, ix, out, oa, rows, mk, n, row_bytes, c2, s); break;
    case 8: e = launch_aux<uint2>(values, ax, ix, out, oa, rows, mk, n, row_bytes, c2, s); break;
    case 4: e = launch_aux<uint32_t>(values, ax, ix, out, oa, rows, mk, n, row_bytes, c2, s); break;
    case 2: e = launch_aux<uint16_t>(values, ax, ix, out, oa, rows, mk, n, row_bytes, c2, s); break;
    case 1: e = launch_aux<uint8_t>(values, ax, ix, out, oa, rows, mk, n, row_bytes, c2, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}
