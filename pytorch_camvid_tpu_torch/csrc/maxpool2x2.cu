// 2x2 / stride-2 max pool with indices, its index unpool, and the phase
// gather: SegNet's pooling, NHWC, for Hopper (sm_90a).
//
// Replaces the TPU kernels of pytorch_camvid_tpu/ops/pallas_pool.py:
//   K3 (eval)   pool with flat int32 indices   max_pool_2x2_argmax_pallas
//               unpool from flat indices       max_unpool_2x2_pallas
//   K2 (train)  pool with int8 phases          max_pool_2x2_phase_mxu,
//                                              max_pool_2x2_phase_packed
//               unpool from phases, which is   max_unpool_2x2_phase_nat,
//               also the pool's backward       max_unpool_2x2_phase_packed
//               phase gather, the unpool's     _unpool_phase_grad_mxu,
//               backward                       _unpool_phase_packed_grad
// The TPU needed the quadrant views, packed (W2, 2C) lane views and 0/1
// selection matmuls on the MXU only to reach the 2x2 window without a
// relayout; here a thread simply addresses the window's four pixels, so one
// kernel covers each pair of TPU variants.
//
// Three templates, on the element type T (bf16 for the model, f32 as a
// second instance, int8 for K3 on the int8-quantized SegNet's fused pool
// edges, where each pool sees the next block's int8 operand), on the index
// type I (int32 flat y*W+x for K3, int8 phase
// k = 2*dy+dx for K2) and on V, the channels a thread owns:
//   pool          (N,H,W,C) -> pooled (N,H/2,W/2,C) + index; odd H, W floor
//   unpool        pooled + index -> (N,Ho,Wo,C): a gather, each thread owns V
//                 channels of one output pixel and writes the pooled value
//                 where the saved index selects that pixel and 0 elsewhere,
//                 including the rows and columns past 2*(H/2) (45 -> 44 + 1)
//                 in the same pass: no memset, no scatter, no atomics
//   phase_gather  out[n,i,j,c] = g[n, 2i+dy, 2j+dx, c]
//
// Selection rule, equal to torch's max_pool2d (the port's plain version): the
// window is scanned (0,0),(0,1),(1,0),(1,1) and a pixel takes over when it is
// strictly greater than the running maximum (compared in f32, exact for
// bf16 and int8) or is NaN. The pooled value is the selected element itself.
// On int8 values ties are common: the first maximal pixel wins, which is the
// index the JAX package's argmax pair gives (ops/pooling.py::
// max_pool_2x2_with_argmax). The unpool's fill 0 is quantize(0).
//
// What bounds it on the H100: bytes. Each kernel reads its inputs once and
// writes its output once, with no arithmetic to speak of (at 3.35 TB/s the
// stage-1 pool of a batch-32 SegNet step, 0.97 GB, takes >= 0.29 ms). The
// design keeps each access 16 bytes wide where it can: V = 16 / sizeof(T)
// channels per thread (8 for bf16, 16 for int8) when C % V == 0 and every pointer is
// 16-byte aligned (all SegNet shapes, C = 64..512), so the four window loads
// and the pooled store are one 16-byte access each, the int32 index store two,
// the int8 phase one 8-byte access. Neighbouring threads own neighbouring
// channel groups, so a warp's accesses are contiguous runs. Otherwise V = 1
// with scalar accesses. Thread indices are 32-bit (a call that needs more
// than 2^31 - 1 threads is refused); element offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <typename T, int V>
struct alignas(sizeof(T) * V > 16 ? 16 : sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load(const T* p) {
  return *reinterpret_cast<const Vec<T, V>*>(p);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const Vec<T, V>& v) {
  *reinterpret_cast<Vec<T, V>*>(p) = v;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}
template <>
__device__ __forceinline__ int8_t zero<int8_t>() { return 0; }

// The 2x2 window whose top-left pixel is (2i, 2j) of image n, V channels
// from c0: w[q] is window pixel q = 2*dy + dx.
template <typename T, int V>
__device__ __forceinline__ void load_window(const T* __restrict__ x, int n,
                                            int i, int j, int64_t c0, int H,
                                            int W, int C, Vec<T, V> (&w)[4]) {
  const T* p = x + ((static_cast<int64_t>(n) * H + 2 * i) * W + 2 * j) * C +
               c0;
  const int64_t row = static_cast<int64_t>(W) * C;
  w[0] = load<T, V>(p);
  w[1] = load<T, V>(p + C);
  w[2] = load<T, V>(p + row);
  w[3] = load<T, V>(p + row + C);
}

template <typename T, typename I, int V>
__global__ void __launch_bounds__(THREADS)
    pool_kernel(const T* __restrict__ x, T* __restrict__ out,
                I* __restrict__ idx, int H, int W, int C, int H2, int W2,
                int total) {
  const int groups = C / V;
  // one thread per group; unsigned, so the last block cannot overflow
  const unsigned t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= static_cast<unsigned>(total)) return;
  const int pix = static_cast<int>(t / groups);  // pooled (n, i, j)
  const int64_t c0 = static_cast<int64_t>(t % groups) * V;
  const int j = pix % W2;
  const int i = (pix / W2) % H2;
  const int n = pix / W2 / H2;
  Vec<T, V> w[4];
  load_window<T, V>(x, n, i, j, c0, H, W, C, w);
  Vec<T, V> o;
  Vec<I, V> k;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    T best = w[0].v[e];
    float m = to_f32(best);
    int sel = 0;
#pragma unroll
    for (int q = 1; q < 4; ++q) {
      const float v = to_f32(w[q].v[e]);
      if (v > m || isnan(v)) {
        m = v;
        best = w[q].v[e];
        sel = q;
      }
    }
    o.v[e] = best;
    if constexpr (sizeof(I) == 4)
      k.v[e] = (2 * i + (sel >> 1)) * W + 2 * j + (sel & 1);
    else
      k.v[e] = static_cast<I>(sel);
  }
  const int64_t dst = static_cast<int64_t>(pix) * C + c0;
  store<T, V>(out + dst, o);
  store<I, V>(idx + dst, k);
}

template <typename T, typename I, int V>
__global__ void __launch_bounds__(THREADS)
    unpool_kernel(const T* __restrict__ x, const I* __restrict__ idx,
                  T* __restrict__ out, int H2, int W2, int C, int Ho, int Wo,
                  int total) {
  const int groups = C / V;
  // one thread per group; unsigned, so the last block cannot overflow
  const unsigned t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= static_cast<unsigned>(total)) return;
  const int pix = static_cast<int>(t / groups);  // output (n, y, x)
  const int64_t c0 = static_cast<int64_t>(t % groups) * V;
  const int xo = pix % Wo;
  const int yo = (pix / Wo) % Ho;
  const int n = pix / Wo / Ho;
  Vec<T, V> o;
  if (yo < 2 * H2 && xo < 2 * W2) {
    const int64_t src =
        ((static_cast<int64_t>(n) * H2 + (yo >> 1)) * W2 + (xo >> 1)) * C +
        c0;
    const Vec<T, V> v = load<T, V>(x + src);
    const Vec<I, V> k = load<I, V>(idx + src);
    const int mine = sizeof(I) == 4 ? yo * Wo + xo
                                     : 2 * (yo & 1) + (xo & 1);
#pragma unroll
    for (int e = 0; e < V; ++e)
      o.v[e] = static_cast<int>(k.v[e]) == mine ? v.v[e] : zero<T>();
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) o.v[e] = zero<T>();
  }
  store<T, V>(out + static_cast<int64_t>(pix) * C + c0, o);
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
    phase_gather_kernel(const T* __restrict__ g,
                        const int8_t* __restrict__ k, T* __restrict__ out,
                        int H, int W, int C, int H2, int W2, int total) {
  const int groups = C / V;
  // one thread per group; unsigned, so the last block cannot overflow
  const unsigned t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= static_cast<unsigned>(total)) return;
  const int pix = static_cast<int>(t / groups);  // pooled (n, i, j)
  const int64_t c0 = static_cast<int64_t>(t % groups) * V;
  const int j = pix % W2;
  const int i = (pix / W2) % H2;
  const int n = pix / W2 / H2;
  Vec<T, V> w[4];
  load_window<T, V>(g, n, i, j, c0, H, W, C, w);
  const int64_t dst = static_cast<int64_t>(pix) * C + c0;
  const Vec<int8_t, V> ph = load<int8_t, V>(k + dst);
  Vec<T, V> o;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const int q = ph.v[e];
    o.v[e] = q == 0 ? w[0].v[e]
           : q == 1 ? w[1].v[e]
           : q == 2 ? w[2].v[e]
                    : w[3].v[e];
  }
  store<T, V>(out + dst, o);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

inline unsigned blocks_for(int total) {
  return static_cast<unsigned>((static_cast<int64_t>(total) + THREADS - 1) /
                               THREADS);
}

// Thread groups of V channels over `pixels` pixels of C channels, or -1 when
// the count does not fit a 32-bit thread index.
inline int groups_total(int64_t pixels, int C, int V) {
  const int64_t total = pixels * (C / V);
  return total > 2147483647LL ? -1 : static_cast<int>(total);
}

template <typename T, typename I>
cudaError_t pool(const void* x, void* out, void* idx, int N, int H, int W,
                 int C, cudaStream_t st) {
  constexpr int VV = 16 / sizeof(T);
  const int H2 = H / 2, W2 = W / 2;
  const bool vec = C % VV == 0 && aligned16(x) && aligned16(out) &&
                   aligned16(idx);
  const int64_t pixels = static_cast<int64_t>(N) * H2 * W2;
  const int total = groups_total(pixels, C, vec ? VV : 1);
  if (total < 0) return cudaErrorInvalidValue;
  if (total == 0) return cudaSuccess;
  auto xs = static_cast<const T*>(x);
  auto os = static_cast<T*>(out);
  auto is = static_cast<I*>(idx);
  if (vec)
    pool_kernel<T, I, VV><<<blocks_for(total), THREADS, 0, st>>>(
        xs, os, is, H, W, C, H2, W2, total);
  else
    pool_kernel<T, I, 1><<<blocks_for(total), THREADS, 0, st>>>(
        xs, os, is, H, W, C, H2, W2, total);
  return cudaGetLastError();
}

template <typename T, typename I>
cudaError_t unpool(const void* x, const void* idx, void* out, int N, int H2,
                   int W2, int C, int Ho, int Wo, cudaStream_t st) {
  constexpr int VV = 16 / sizeof(T);
  const bool vec = C % VV == 0 && aligned16(x) && aligned16(idx) &&
                   aligned16(out);
  const int64_t pixels = static_cast<int64_t>(N) * Ho * Wo;
  const int total = groups_total(pixels, C, vec ? VV : 1);
  if (total < 0) return cudaErrorInvalidValue;
  if (total == 0) return cudaSuccess;
  auto xs = static_cast<const T*>(x);
  auto is = static_cast<const I*>(idx);
  auto os = static_cast<T*>(out);
  if (vec)
    unpool_kernel<T, I, VV><<<blocks_for(total), THREADS, 0, st>>>(
        xs, is, os, H2, W2, C, Ho, Wo, total);
  else
    unpool_kernel<T, I, 1><<<blocks_for(total), THREADS, 0, st>>>(
        xs, is, os, H2, W2, C, Ho, Wo, total);
  return cudaGetLastError();
}

template <typename T>
cudaError_t phase_gather(const void* g, const void* k, void* out, int N,
                         int H, int W, int C, int H2, int W2,
                         cudaStream_t st) {
  constexpr int VV = 16 / sizeof(T);
  const bool vec = C % VV == 0 && aligned16(g) && aligned16(k) &&
                   aligned16(out);
  const int64_t pixels = static_cast<int64_t>(N) * H2 * W2;
  const int total = groups_total(pixels, C, vec ? VV : 1);
  if (total < 0) return cudaErrorInvalidValue;
  if (total == 0) return cudaSuccess;
  auto gs = static_cast<const T*>(g);
  auto ks = static_cast<const int8_t*>(k);
  auto os = static_cast<T*>(out);
  if (vec)
    phase_gather_kernel<T, VV><<<blocks_for(total), THREADS, 0, st>>>(
        gs, ks, os, H, W, C, H2, W2, total);
  else
    phase_gather_kernel<T, 1><<<blocks_for(total), THREADS, 0, st>>>(
        gs, ks, os, H, W, C, H2, W2, total);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = bf16, 1 = f32, 2 = int8 (pool and unpool only). phase: 0 =
// flat int32 index (K3), 1 = int8 phase (K2). Each returns a cudaError_t as int (0 on success) and does not
// synchronize.

extern "C" int maxpool2x2_pool(const void* x, void* out, void* idx,
                               int dtype, int phase, int N, int H, int W,
                               int C, void* stream) {
  if (N <= 0 || H < 2 || W < 2 || C <= 0 ||
      static_cast<int64_t>(H) * W > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = phase ? pool<__nv_bfloat16, int8_t>(x, out, idx, N, H, W, C, st)
                : pool<__nv_bfloat16, int32_t>(x, out, idx, N, H, W, C, st);
  else if (dtype == 1)
    err = phase ? pool<float, int8_t>(x, out, idx, N, H, W, C, st)
                : pool<float, int32_t>(x, out, idx, N, H, W, C, st);
  else if (dtype == 2)
    err = phase ? pool<int8_t, int8_t>(x, out, idx, N, H, W, C, st)
                : pool<int8_t, int32_t>(x, out, idx, N, H, W, C, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" int maxpool2x2_unpool(const void* x, const void* idx, void* out,
                                 int dtype, int phase, int N, int H2, int W2,
                                 int C, int Ho, int Wo, void* stream) {
  if (N <= 0 || H2 <= 0 || W2 <= 0 || C <= 0 || Ho < 2 * H2 ||
      Wo < 2 * W2 || static_cast<int64_t>(Ho) * Wo > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = phase ? unpool<__nv_bfloat16, int8_t>(x, idx, out, N, H2, W2, C,
                                                Ho, Wo, st)
                : unpool<__nv_bfloat16, int32_t>(x, idx, out, N, H2, W2, C,
                                                 Ho, Wo, st);
  else if (dtype == 1)
    err = phase ? unpool<float, int8_t>(x, idx, out, N, H2, W2, C, Ho, Wo,
                                        st)
                : unpool<float, int32_t>(x, idx, out, N, H2, W2, C, Ho, Wo,
                                         st);
  else if (dtype == 2)
    err = phase ? unpool<int8_t, int8_t>(x, idx, out, N, H2, W2, C, Ho, Wo,
                                         st)
                : unpool<int8_t, int32_t>(x, idx, out, N, H2, W2, C, Ho, Wo,
                                          st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" int maxpool2x2_phase_gather(const void* g, const void* k,
                                       void* out, int dtype, int N, int H,
                                       int W, int C, int H2, int W2,
                                       void* stream) {
  if (N <= 0 || H2 <= 0 || W2 <= 0 || C <= 0 || H < 2 * H2 || W < 2 * W2)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0   ? phase_gather<__nv_bfloat16>(g, k, out, N, H, W, C, H2,
                                                 W2, st)
      : dtype == 1 ? phase_gather<float>(g, k, out, N, H, W, C, H2, W2, st)
                   : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
