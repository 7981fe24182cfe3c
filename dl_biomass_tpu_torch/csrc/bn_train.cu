// Kernel 11: the train-mode masked BatchNorm of a hidden layer of an SA MLP,
// with the bias add and the rounding of the Dense before it and the activation
// after it, forward and backward, in four passes over the (rows, C) edge
// tensor, rows = chunks x 64 (a chunk: one centroid's 64 neighbour slots):
//
//   F1 (dlbt_bn_stats): y = round(z + b) from the GEMM's f32 product z, or y
//       as given; per chunk the f32 sums of y m and (y m) y, m the row mask
//       as 0.0 or 1.0 (kernel 8's multiply-by-mask form: a NaN or Inf at a
//       masked row reaches the sums)
//   F2 (dlbt_bn_apply): out = act(round(y scale + shift))
//   B1 (dlbt_bn_grad_sums): g = act'(o) dout, o = round(y scale + shift)
//       recomputed; per chunk the f32 sums of g and g (y - mean)
//   B2 (dlbt_bn_grad): dy = round(g scale + m (d1 + d2 y) + d2 (y m)), the
//       rounding at the cast to f32 of the plain chain's backward; per chunk
//       the f32 sums of dy (the bias's gradient) where asked
//
// round() is to the value type T (bf16 or f32); every product and sum of a
// value is rounded on its own (__fmul_rn, __fadd_rn: no contraction into an
// FMA), in the order of the PyTorch operations of models/layers.py, so F1's y
// and F2's out are theirs bit for bit on the same statistics. The activations
// are torch's on T: ReLU (clamp_min, NaN kept; its gradient passes where the
// result is not <= 0), LeakyReLU 0.01 and ELU 1 in f32, rounded to T.
//
// Replaces: no TPU kernel. The JAX package leaves this elementwise chain to
// XLA, which fuses it (dl_biomass_tpu/models/layers.py MaskedBatchNorm,
// MLP); the port ran it as some thirty PyTorch passes forward and backward.
//
// Bound on the H100: bytes. At the SSG cell's SA1 (36 x 1588 x 64 rows of 64
// channels, bf16): F1 reads z (f32) and writes y, 1.41 GB, 0.42 ms; F2 reads y
// and writes out, 0.94 GB, 0.28 ms; B1 reads dout and y, 0.94 GB, 0.28 ms; B2
// reads dout and y and writes dy, 1.41 GB, 0.42 ms (the chunk partials add
// 3-6%). Some ten f32 operations a value are far below the f32 peak.
//
// Design: a warp takes one chunk, 64 rows x C, so a chunk's partial never
// leaves the warp (no shared memory, no float atomics: a run repeats bit for
// bit on one card). A lane owns V channels of a 16-byte vector (8 bf16 or 4
// f32; F1 reads f32 z 4 at a time and writes 8 bytes of bf16), at KG column
// groups 32 vectors apart where a row holds more than 32 vectors; lanes that
// share channels (32 / (C / V) rows at a time) add their sums by shuffles at
// the chunk's end. Each lane loads four steps' vectors before it computes on
// them. Eight warps a block. The partials, (chunks, 2C) or (chunks, C) f32,
// are added in f64 by dlbt_sum_slices_f64 (csrc/sum_slices.cu): chunk_sums'
// order, f32 over a chunk's rows, then f64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kChunk = 64;  // rows a chunk
constexpr int kWarps = 8;   // warps (chunks) a block
constexpr int kThreads = kWarps * 32;
constexpr int kAhead = 4;   // steps a lane loads before it computes on them
constexpr int kMaxC = 512;

enum Act { kNone = 0, kRelu = 1, kLeaky = 2, kElu = 3 };

template <int Bytes>
struct Raw;
template <>
struct Raw<16> {
  using type = uint4;
};
template <>
struct Raw<8> {
  using type = uint2;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and back
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

// V values of T as one 8- or 16-byte word: loaded whole, read one by one
template <typename T, int V>
struct Vec {
  using R = typename Raw<V * sizeof(T)>::type;
  R r;
  __device__ __forceinline__ void load(const T* __restrict__ p) {
    r = *reinterpret_cast<const R*>(p);
  }
  __device__ __forceinline__ float get(int e) const {
    return to_f(reinterpret_cast<const T*>(&r)[e]);
  }
};

// f holds values of T already
template <typename T, int V>
__device__ __forceinline__ void store(T* __restrict__ p, const float (&f)[V]) {
  using R = typename Raw<V * sizeof(T)>::type;
  R r;
  T* t = reinterpret_cast<T*>(&r);
#pragma unroll
  for (int e = 0; e < V; ++e) t[e] = from_f<T>(f[e]);
  *reinterpret_cast<R*>(p) = r;
}

template <int V>
__device__ __forceinline__ void store_f32(float* __restrict__ p, const float (&f)[V]) {
#pragma unroll
  for (int e = 0; e < V; e += 4) {
    *reinterpret_cast<float4*>(p + e) = make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
  }
}

// act(o) for o a value of T, rounded to T
template <typename T>
__device__ __forceinline__ float act_fwd(float o, int act) {
  switch (act) {
    case kRelu:
      return isnan(o) ? o : fmaxf(o, 0.0f);
    case kLeaky:
      return rnd<T>(o > 0.0f ? o : __fmul_rn(o, 0.01f));
    case kElu:
      return rnd<T>(o > 0.0f ? o : expm1f(o));
    default:
      return o;
  }
}

// the gradient of o from the gradient g of act(o), rounded to T
template <typename T>
__device__ __forceinline__ float act_bwd(float o, float g, int act) {
  switch (act) {
    case kRelu:
      return (o > 0.0f || isnan(o)) ? g : 0.0f;
    case kLeaky:
      return rnd<T>(o > 0.0f ? g : __fmul_rn(g, 0.01f));
    case kElu:
      return rnd<T>(o <= 0.0f ? __fmul_rn(g, expf(o)) : g);
    default:
      return g;
  }
}

// A lane's place in its warp's chunk: its vector column cv (and cv + 32, ...
// for KG > 1), its first row ro, and the rows a warp step advances, rps.
struct Lanes {
  int lpr, rps, cv, ro;
  __device__ Lanes(int c, int v) {
    const int nv = c / v;
    lpr = nv < 32 ? nv : 32;
    rps = 32 / lpr;
    const int lane = threadIdx.x & 31;
    cv = lane % lpr;
    ro = lane / lpr;
  }
  __device__ int channel(int k, int v) const { return (cv + k * lpr) * v; }
};

// Add each lane's sums over the lanes that share its channels (a warp's
// rows at one step) and store them, from the lanes of the first row, at
// out + channel.
template <int KG, int V>
__device__ __forceinline__ void write_sums(const Lanes& ln, float (&s)[KG][V], float* out) {
  for (int off = ln.lpr; off < 32; off <<= 1) {
#pragma unroll
    for (int k = 0; k < KG; ++k) {
#pragma unroll
      for (int e = 0; e < V; ++e) s[k][e] += __shfl_xor_sync(0xffffffffu, s[k][e], off);
    }
  }
  if (ln.ro == 0) {
#pragma unroll
    for (int k = 0; k < KG; ++k) store_f32<V>(out + ln.channel(k, V), s[k]);
  }
}

template <int KG, int V>
__device__ __forceinline__ void load_vec(const float* __restrict__ p, const Lanes& ln,
                                         float (&f)[KG][V]) {
#pragma unroll
  for (int k = 0; k < KG; ++k) {
#pragma unroll
    for (int e = 0; e < V; ++e) f[k][e] = p[ln.channel(k, V) + e];
  }
}

template <int KG, int V>
__device__ __forceinline__ void zero(float (&s)[KG][V]) {
#pragma unroll
  for (int k = 0; k < KG; ++k) {
#pragma unroll
    for (int e = 0; e < V; ++e) s[k][e] = 0.0f;
  }
}

// F1. Dense: in is z (rows, C) f32, y is written. Otherwise in is y (T).
template <typename T, int KG, bool Dense>
__global__ void __launch_bounds__(kThreads)
    bn_stats_kernel(const void* __restrict__ in_, const float* __restrict__ bias,
                    T* __restrict__ y, const unsigned char* __restrict__ mask,
                    float* __restrict__ partial, int chunks, int c) {
  using In = typename std::conditional<Dense, float, T>::type;
  constexpr int V = 16 / sizeof(In);
  const int chunk = blockIdx.x * kWarps + threadIdx.x / 32;
  if (chunk >= chunks) return;
  const Lanes ln(c, V);
  const size_t row0 = static_cast<size_t>(chunk) * kChunk;
  const In* in = static_cast<const In*>(in_);
  float b[KG][V];
  if constexpr (Dense) load_vec<KG, V>(bias, ln, b);
  float s1[KG][V], s2[KG][V];
  zero<KG, V>(s1);
  zero<KG, V>(s2);
  const int steps = kChunk / ln.rps;
  for (int s0 = 0; s0 < steps; s0 += kAhead) {
    Vec<In, V> v[kAhead][KG];
    unsigned char mk[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (s0 + u < steps) {
        const size_t r = row0 + ln.ro + (s0 + u) * ln.rps;
        mk[u] = mask[r];
#pragma unroll
        for (int k = 0; k < KG; ++k) v[u][k].load(in + r * c + ln.channel(k, V));
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (s0 + u < steps) {
        const size_t r = row0 + ln.ro + (s0 + u) * ln.rps;
        const float mf = mk[u] ? 1.0f : 0.0f;
#pragma unroll
        for (int k = 0; k < KG; ++k) {
          float x[V];
#pragma unroll
          for (int e = 0; e < V; ++e) {
            if constexpr (Dense) {
              x[e] = rnd<T>(__fadd_rn(v[u][k].get(e), b[k][e]));
            } else {
              x[e] = v[u][k].get(e);
            }
            const float xm = __fmul_rn(x[e], mf);
            s1[k][e] = __fadd_rn(s1[k][e], xm);
            s2[k][e] = __fadd_rn(s2[k][e], __fmul_rn(xm, x[e]));
          }
          if constexpr (Dense) store<T, V>(y + r * c + ln.channel(k, V), x);
        }
      }
    }
  }
  float* out = partial + static_cast<size_t>(chunk) * 2 * c;
  write_sums<KG, V>(ln, s1, out);
  write_sums<KG, V>(ln, s2, out + c);
}

// F2
template <typename T, int KG>
__global__ void __launch_bounds__(kThreads)
    bn_apply_kernel(const T* __restrict__ y, const float* __restrict__ scale,
                    const float* __restrict__ shift, T* __restrict__ out, int chunks, int c,
                    int act) {
  constexpr int V = 16 / sizeof(T);
  const int chunk = blockIdx.x * kWarps + threadIdx.x / 32;
  if (chunk >= chunks) return;
  const Lanes ln(c, V);
  const size_t row0 = static_cast<size_t>(chunk) * kChunk;
  float sc[KG][V], sh[KG][V];
  load_vec<KG, V>(scale, ln, sc);
  load_vec<KG, V>(shift, ln, sh);
  const int steps = kChunk / ln.rps;
  for (int s0 = 0; s0 < steps; s0 += kAhead) {
    Vec<T, V> v[kAhead][KG];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (s0 + u < steps) {
        const size_t r = row0 + ln.ro + (s0 + u) * ln.rps;
#pragma unroll
        for (int k = 0; k < KG; ++k) v[u][k].load(y + r * c + ln.channel(k, V));
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (s0 + u < steps) {
        const size_t r = row0 + ln.ro + (s0 + u) * ln.rps;
#pragma unroll
        for (int k = 0; k < KG; ++k) {
          float a[V];
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float o = rnd<T>(__fadd_rn(__fmul_rn(v[u][k].get(e), sc[k][e]), sh[k][e]));
            a[e] = act_fwd<T>(o, act);
          }
          store<T, V>(out + r * c + ln.channel(k, V), a);
        }
      }
    }
  }
}

// B1 (Grad false): the sums of g and g (y - mean). B2 (Grad true): dy and,
// where partial is given, the sums of dy.
template <typename T, int KG, bool Grad>
__global__ void __launch_bounds__(kThreads)
    bn_backward_kernel(const T* __restrict__ dout, const T* __restrict__ y,
                       const unsigned char* __restrict__ mask, const float* __restrict__ scale,
                       const float* __restrict__ shift, const float* __restrict__ mean,
                       const float* __restrict__ d1, const float* __restrict__ d2,
                       T* __restrict__ dy, float* __restrict__ partial, int chunks, int c,
                       int act) {
  constexpr int V = 16 / sizeof(T);
  const int chunk = blockIdx.x * kWarps + threadIdx.x / 32;
  if (chunk >= chunks) return;
  const Lanes ln(c, V);
  const size_t row0 = static_cast<size_t>(chunk) * kChunk;
  float sc[KG][V], sh[KG][V], p[KG][V], q[KG][V];  // p: mean (B1) or d1 (B2); q: d2
  load_vec<KG, V>(scale, ln, sc);
  load_vec<KG, V>(shift, ln, sh);
  if constexpr (Grad) {
    load_vec<KG, V>(d1, ln, p);
    load_vec<KG, V>(d2, ln, q);
  } else {
    load_vec<KG, V>(mean, ln, p);
  }
  float s1[KG][V], s2[KG][V];
  zero<KG, V>(s1);
  zero<KG, V>(s2);
  const int steps = kChunk / ln.rps;
  for (int s0 = 0; s0 < steps; s0 += kAhead) {
    Vec<T, V> gv[kAhead][KG], yv[kAhead][KG];
    unsigned char mk[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (s0 + u < steps) {
        const size_t r = row0 + ln.ro + (s0 + u) * ln.rps;
        if constexpr (Grad) mk[u] = mask[r];
#pragma unroll
        for (int k = 0; k < KG; ++k) {
          gv[u][k].load(dout + r * c + ln.channel(k, V));
          yv[u][k].load(y + r * c + ln.channel(k, V));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (s0 + u < steps) {
        const size_t r = row0 + ln.ro + (s0 + u) * ln.rps;
        float mf = 0.0f;
        if constexpr (Grad) mf = mk[u] ? 1.0f : 0.0f;
#pragma unroll
        for (int k = 0; k < KG; ++k) {
          float d[V];
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float x = yv[u][k].get(e);
            const float o = rnd<T>(__fadd_rn(__fmul_rn(x, sc[k][e]), sh[k][e]));
            const float g = act_bwd<T>(o, gv[u][k].get(e), act);
            if constexpr (Grad) {
              const float t = __fmul_rn(__fadd_rn(p[k][e], __fmul_rn(q[k][e], x)), mf);
              d[e] = rnd<T>(__fadd_rn(__fadd_rn(__fmul_rn(g, sc[k][e]), t),
                                      __fmul_rn(q[k][e], __fmul_rn(x, mf))));
              s1[k][e] = __fadd_rn(s1[k][e], d[e]);
            } else {
              s1[k][e] = __fadd_rn(s1[k][e], g);
              s2[k][e] = __fadd_rn(s2[k][e], __fmul_rn(g, __fsub_rn(x, p[k][e])));
            }
          }
          if constexpr (Grad) store<T, V>(dy + r * c + ln.channel(k, V), d);
        }
      }
    }
  }
  if constexpr (Grad) {
    if (partial != nullptr) write_sums<KG, V>(ln, s1, partial + static_cast<size_t>(chunk) * c);
  } else {
    float* out = partial + static_cast<size_t>(chunk) * 2 * c;
    write_sums<KG, V>(ln, s1, out);
    write_sums<KG, V>(ln, s2, out + c);
  }
}

// C a power of two in [8, 512]: then C / V divides 32 or is 32 KG
bool width_ok(int c) { return c >= 8 && c <= kMaxC && (c & (c - 1)) == 0; }

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// the column groups a lane takes for C channels of V a vector
int groups(int c, int v) { return c / v > 32 ? c / v / 32 : 1; }

unsigned grid_of(int chunks) { return static_cast<unsigned>((chunks + kWarps - 1) / kWarps); }

template <typename T>
cudaError_t stats(const void* in, const float* bias, void* y, const unsigned char* m, float* part,
                  int chunks, int c, cudaStream_t st) {
  const dim3 grid(grid_of(chunks)), block(kThreads);
  T* yt = static_cast<T*>(y);
  if (bias != nullptr) {
    switch (groups(c, 4)) {
      case 1:
        bn_stats_kernel<T, 1, true><<<grid, block, 0, st>>>(in, bias, yt, m, part, chunks, c);
        break;
      case 2:
        bn_stats_kernel<T, 2, true><<<grid, block, 0, st>>>(in, bias, yt, m, part, chunks, c);
        break;
      default:
        bn_stats_kernel<T, 4, true><<<grid, block, 0, st>>>(in, bias, yt, m, part, chunks, c);
    }
  } else {
    switch (groups(c, 16 / sizeof(T))) {
      case 1:
        bn_stats_kernel<T, 1, false><<<grid, block, 0, st>>>(in, bias, yt, m, part, chunks, c);
        break;
      case 2:
        bn_stats_kernel<T, 2, false><<<grid, block, 0, st>>>(in, bias, yt, m, part, chunks, c);
        break;
      default:
        bn_stats_kernel<T, 4, false><<<grid, block, 0, st>>>(in, bias, yt, m, part, chunks, c);
    }
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t apply(const void* y, const float* scale, const float* shift, void* out, int chunks,
                  int c, int act, cudaStream_t st) {
  const dim3 grid(grid_of(chunks)), block(kThreads);
  const T* yt = static_cast<const T*>(y);
  T* ot = static_cast<T*>(out);
  switch (groups(c, 16 / sizeof(T))) {
    case 1:
      bn_apply_kernel<T, 1><<<grid, block, 0, st>>>(yt, scale, shift, ot, chunks, c, act);
      break;
    case 2:
      bn_apply_kernel<T, 2><<<grid, block, 0, st>>>(yt, scale, shift, ot, chunks, c, act);
      break;
    default:
      bn_apply_kernel<T, 4><<<grid, block, 0, st>>>(yt, scale, shift, ot, chunks, c, act);
  }
  return cudaGetLastError();
}

template <typename T, bool Grad>
cudaError_t backward(const void* dout, const void* y, const unsigned char* m, const float* scale,
                     const float* shift, const float* mean, const float* d1, const float* d2,
                     void* dy, float* part, int chunks, int c, int act, cudaStream_t st) {
  const dim3 grid(grid_of(chunks)), block(kThreads);
  const T* gt = static_cast<const T*>(dout);
  const T* yt = static_cast<const T*>(y);
  T* dt = static_cast<T*>(dy);
  switch (groups(c, 16 / sizeof(T))) {
    case 1:
      bn_backward_kernel<T, 1, Grad><<<grid, block, 0, st>>>(gt, yt, m, scale, shift, mean, d1, d2,
                                                              dt, part, chunks, c, act);
      break;
    case 2:
      bn_backward_kernel<T, 2, Grad><<<grid, block, 0, st>>>(gt, yt, m, scale, shift, mean, d1, d2,
                                                              dt, part, chunks, c, act);
      break;
    default:
      bn_backward_kernel<T, 4, Grad><<<grid, block, 0, st>>>(gt, yt, m, scale, shift, mean, d1, d2,
                                                              dt, part, chunks, c, act);
  }
  return cudaGetLastError();
}

bool args_ok(int chunks, int c, int bf16, int act) {
  return chunks >= 0 && width_ok(c) && (bf16 == 0 || bf16 == 1) && act >= kNone && act <= kElu;
}

}  // namespace

// F1. in: z (chunks x 64, C) f32 with bias (C) f32, y written in T; or, bias
// null, y (chunks x 64, C) in T, read only (y null). mask (chunks x 64) bool;
// partial (chunks, 2C) f32. T is bf16 where bf16 is 1, else f32. C a power
// of two in [8, 512]; every tensor on 16 bytes.
extern "C" int dlbt_bn_stats(const void* in, const void* bias, void* y, const void* mask,
                             void* partial, int chunks, int c, int bf16, void* stream) {
  if (!args_ok(chunks, c, bf16, kNone) || !aligned(in) || !aligned(partial) ||
      (bias != nullptr && (y == nullptr || !aligned(y)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (chunks == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const unsigned char* m = static_cast<const unsigned char*>(mask);
  float* p = static_cast<float*>(partial);
  const cudaError_t e = bf16 ? stats<__nv_bfloat16>(in, b, y, m, p, chunks, c, st)
                             : stats<float>(in, b, y, m, p, chunks, c, st);
  return static_cast<int>(e);
}

// F2. y and out (chunks x 64, C) in T; scale, shift (C) f32; act 0 none, 1
// ReLU, 2 LeakyReLU, 3 ELU.
extern "C" int dlbt_bn_apply(const void* y, const void* scale, const void* shift, void* out,
                             int chunks, int c, int bf16, int act, void* stream) {
  if (!args_ok(chunks, c, bf16, act) || !aligned(y) || !aligned(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (chunks == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  const cudaError_t e = bf16 ? apply<__nv_bfloat16>(y, sc, sh, out, chunks, c, act, st)
                             : apply<float>(y, sc, sh, out, chunks, c, act, st);
  return static_cast<int>(e);
}

// B1. dout, y (chunks x 64, C) in T; scale, shift, mean (C) f32; partial
// (chunks, 2C) f32: the sums of g, then of g (y - mean).
extern "C" int dlbt_bn_grad_sums(const void* dout, const void* y, const void* scale,
                                 const void* shift, const void* mean, void* partial, int chunks,
                                 int c, int bf16, int act, void* stream) {
  if (!args_ok(chunks, c, bf16, act) || !aligned(dout) || !aligned(y) || !aligned(partial)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (chunks == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  const float* mu = static_cast<const float*>(mean);
  float* p = static_cast<float*>(partial);
  const cudaError_t e =
      bf16 ? backward<__nv_bfloat16, false>(dout, y, nullptr, sc, sh, mu, nullptr, nullptr,
                                            nullptr, p, chunks, c, act, st)
           : backward<float, false>(dout, y, nullptr, sc, sh, mu, nullptr, nullptr, nullptr, p,
                                    chunks, c, act, st);
  return static_cast<int>(e);
}

// B2. dout, y, dy (chunks x 64, C) in T; mask (chunks x 64) bool; scale,
// shift, d1, d2 (C) f32; partial (chunks, C) f32, the sums of dy, or null.
extern "C" int dlbt_bn_grad(const void* dout, const void* y, const void* mask, const void* scale,
                            const void* shift, const void* d1, const void* d2, void* dy,
                            void* partial, int chunks, int c, int bf16, int act, void* stream) {
  if (!args_ok(chunks, c, bf16, act) || !aligned(dout) || !aligned(y) || !aligned(dy) ||
      (partial != nullptr && !aligned(partial))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (chunks == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned char* m = static_cast<const unsigned char*>(mask);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  const float* a = static_cast<const float*>(d1);
  const float* b = static_cast<const float*>(d2);
  float* p = static_cast<float*>(partial);
  const cudaError_t e =
      bf16 ? backward<__nv_bfloat16, true>(dout, y, m, sc, sh, nullptr, a, b, dy, p, chunks, c,
                                           act, st)
           : backward<float, true>(dout, y, m, sc, sh, nullptr, a, b, dy, p, chunks, c, act, st);
  return static_cast<int>(e);
}
