// Layout probes for Hopper (sm_90a): the six kernels of
// tools/mosaic_probes.py, each asking on the H100 the question its TPU
// kernel asked of the Mosaic compiler: can a kernel read a staged tile at a
// row or width offset that is not aligned, and what does it cost?
//
// Replaces the TPU kernels of tools/mosaic_probes.py (each a pallas_call):
//   M1 :59   probe_a     x[1:33, :] of a VMEM ref, f32    rows_kernel<float>
//   M2 :70   probe_a16   the same in bf16                 rows_kernel<bf16>
//   M3 :82   probe_b     x[s:s+32, :], s an int32 in SMEM rows_kernel DYNAMIC
//   M4 :98   probe_b_mm  x[1:33] @ w on the MXU, f32      slice_matmul_kernel
//   M5 :113  probe_c     pltpu.roll(x, 1, axis 0)         rows_kernel ROLL
//   M6 :137  probe_d     3 DMAs of xp at width offsets    width_shifts_kernel
//                        0/1/2 into VMEM, summed
//
// rows_kernel (M1, M2, M3, M5). A block owns RB = 8 output rows of one
// CT = 256-byte column tile (at the tool's 64 x 256 f32 input, M1 runs 16
// blocks, M5 32): the probes move 32-64 KB, so a launch and one load's
// round trip bound them, and the work is spread over the card so that no
// block waits on more than one round trip. A block stages its source rows,
// starting at the row s0 & ~7 below its first source row s0 (an 8-row
// boundary, the TPU's sublane tile), into shared memory with 16-byte
// cp.async, each thread's one or two copies in a single group issued
// before any wait, and then writes its output rows from the staged tile at
// the unaligned row offset s0 - (s0 & ~7): global memory is never read at
// the offset. The three modes differ only in s0: a static start (M1, M2),
// an int32 start read from device memory by the kernel and clamped to
// [0, rows - n] as lax.dynamic_slice clamps (M3: the host never reads it),
// and the rotation (M5: s0 = (r0 - shift) mod rows, the staged rows
// wrapping at the end). One template serves f32 and bf16: the kernel moves
// bytes. ops/layout_probes.py::rows_grid holds the same grid rule.
//
// slice_matmul_kernel (M4). out = x[start:start+n] @ w in f32 on the tensor
// cores, fed from a shared tile at an odd row offset. The product is small
// (32 x 256 @ 256 x 128 in the probe: a launch and a load's latency bound
// it), so the work is spread over the card and every load goes out at once:
// a block computes 32 rows x 8 columns (the probe: 16 blocks), stages x's
// 39-row slab from the 8-row boundary below its first row and its 8
// columns of w, up to K = 256 deep, in one cp.async group before its first
// MMA; its 8 warps take the k8 steps in turn and add their partial sums in
// warp order through shared memory (no atomics: two calls give the same
// bits). The A fragments of mma.sync.m16n8k8 are loaded from shared memory
// at the unaligned row (row + off, off in 0..7). TF32 keeps 10 mantissa
// bits: one TF32 product per term has ~1e-3
// relative error, and over K = 256 terms of N(0,1) x N(0,1) the worst of
// 4,096 outputs can pass the tool's atol of 5e-2. So each operand is split
// into a TF32 high part and a TF32 residual, and three products are summed
// (lo*hi + hi*lo + hi*hi; the lo*lo term is below f32's rounding): f32
// accuracy, ~1e-6 relative, at three tensor-core products per term.
//
// width_shifts_kernel (M6). out[h, j, :] = (xp[h, j] + xp[h, j+1]) +
// xp[h, j+2] for j < w. The TPU kernel copied xp three times, at width
// offsets 0, 1 and 2, from HBM into VMEM with async copies signalled on DMA
// semaphores. The Hopper counterpart is the bulk async-copy engine: one
// thread issues three cp.async.bulk copies per tile, one per width offset,
// from the one global array into shared memory, each completing on one
// mbarrier (arrive.expect_tx with the three copies' bytes, then
// try_wait.parity). A tile is one row h and up to TILE_BYTES of columns
// (all C channels): the TPU kernel's 983 KB of VMEM does not fit a block's
// 227 KB. A row's width slab is contiguous, so a 1-D bulk copy takes it with
// no tensor map; bulk copies need 16-byte aligned addresses and sizes, so C
// must be a multiple of 4 (checked here and by the wrapper). The sum is
// taken in the plain version's order, so the result is bit-equal to it.
// The three offsets are arguments; the probe's are 0, 1 and 2.
//
// What bounds them on the H100: bytes (3.35 TB/s). At the tool's shapes
// each moves 64 KB to 720 KB, a bound of 2e-5 to 2e-4 ms, so every probe
// there is bound by its launch; at a conv stage's shape (M6 at
// 360 x 488 x 64) the bound is ~0.026 ms and the time says something about
// the copy engine.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

// ------------------------------------------------------------- helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes == 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// ------------------------------------------------ rows (M1, M2, M3, M5)

constexpr int RB = 8;               // output rows per block
constexpr int CT = 256;             // bytes of a row per column tile
constexpr int CHUNKS = CT / 16;     // 16-byte chunks of a tile row
constexpr int ROW_THREADS = RB * CHUNKS;  // one output chunk a thread

enum RowMode { STATIC = 0, DYNAMIC = 1, ROLL = 2 };

template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
    rows_kernel(const T* __restrict__ x, T* __restrict__ out,
                const int* __restrict__ s_dev, int mode, int rows,
                int row_bytes, int n, int start_or_shift) {
  // RB rows and up to 7 rows above them, from the 8-row boundary
  __shared__ __align__(16) unsigned char tile[(RB + 7) * CT];
  const int r0 = blockIdx.x * RB;              // first output row
  const int nr = min(RB, n - r0);              // output rows of the block
  const int c0 = blockIdx.y * CT;              // first byte of the tile
  const int chunks = min(CT, row_bytes - c0) / 16;
  int s0;                                      // source row of output r0
  if (mode == ROLL) {
    s0 = static_cast<int>(
        (static_cast<int64_t>(r0) + rows - start_or_shift) % rows);
  } else {
    int s = mode == DYNAMIC ? *s_dev : start_or_shift;
    s = min(max(s, 0), rows - n);              // lax.dynamic_slice's clamp
    s0 = s + r0;
  }
  const int a0 = s0 & ~7;                      // the 8-row boundary below
  const int off = s0 - a0;                     // unaligned offset, 0..7
  const int staged = off + nr;                 // at most 15 rows
  const auto* xb = reinterpret_cast<const unsigned char*>(x);
  // every copy of the block in one group: at most two a thread
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = threadIdx.x + j * ROW_THREADS;
    const int r = i / CHUNKS, c = i % CHUNKS;
    if (r < staged && c < chunks) {
      const int src = (a0 + r) % rows;         // wraps only for ROLL
      cp_async16(tile + r * CT + c * 16,
                 xb + static_cast<int64_t>(src) * row_bytes + c0 + c * 16,
                 16);
    }
  }
  cp_async_wait_all();
  __syncthreads();
  const int r = threadIdx.x / CHUNKS, c = threadIdx.x % CHUNKS;
  if (r < nr && c < chunks) {
    const uint4 v =
        *reinterpret_cast<const uint4*>(tile + (off + r) * CT + c * 16);
    auto* ob = reinterpret_cast<unsigned char*>(out);
    *reinterpret_cast<uint4*>(ob + static_cast<int64_t>(r0 + r) * row_bytes +
                              c0 + c * 16) = v;
  }
}

// --------------------------------------------------- slice matmul (M4)

constexpr int MM_THREADS = 256;     // 8 warps, each a share of K
constexpr int MM_WARPS = MM_THREADS / 32;
constexpr int BM = 32;              // output rows per block (two m16)
constexpr int BN = 8;               // output columns per block (one n8)
constexpr int KT = 256;             // K staged at once
constexpr int AP = KT + 4;          // A row pitch (floats): conflict-free
constexpr int MM_SMEM = ((BM + 7) * AP + KT * BN + MM_WARPS * BM * BN) * 4;

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo, both TF32: hi keeps v's top 11 significant bits, lo the next.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32_1688(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(MM_THREADS)
    slice_matmul_kernel(const float* __restrict__ x,
                        const float* __restrict__ w, float* __restrict__ out,
                        int rows, int K, int N, int start, int n) {
  extern __shared__ __align__(16) float mm_smem[];
  float* As = mm_smem;                      // (BM + 7) x AP
  float* Bs = As + (BM + 7) * AP;           // KT x BN
  float* red = Bs + KT * BN;                // MM_WARPS x BM x BN
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int s0 = start + m0;                   // source row of output m0
  const int a0 = s0 & ~7;
  const int off = s0 - a0;                     // 1 for the tool's probe
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float acc[2][4] = {};
  for (int k0 = 0; k0 < K; k0 += KT) {
    const int steps = (min(KT, K - k0) + 7) / 8;  // k8 steps, zero past K
    // Every load of the round at once, one cp.async group: x rows a0 ..
    // a0 + BM + 6 (zero past the source rows and the slice's end), then w
    // rows k0 .., columns n0 .. n0 + BN - 1 (zero past K and N).
    for (int i = threadIdx.x; i < (BM + 7) * steps * 2; i += MM_THREADS) {
      const int r = i / (steps * 2), c = (i % (steps * 2)) * 4;
      const int src = a0 + r, k = k0 + c;
      const bool ok = src < rows && src < start + n && k < K;
      cp_async16(&As[r * AP + c],
                 ok ? x + static_cast<int64_t>(src) * K + k : x, ok ? 16 : 0);
    }
    for (int i = threadIdx.x; i < steps * 8 * (BN / 4); i += MM_THREADS) {
      const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
      const int k = k0 + r, col = n0 + c;
      const bool ok = k < K && col < N;
      cp_async16(&Bs[r * BN + c],
                 ok ? w + static_cast<int64_t>(k) * N + col : w, ok ? 16 : 0);
    }
    cp_async_wait_all();
    __syncthreads();
    // warp w takes the k8 steps w, w + MM_WARPS, ...: a fixed order
    for (int st = warp; st < steps; st += MM_WARPS) {
      const int kk = st * 8;
      const float* bp = &Bs[(kk + t) * BN + g];
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(bp[0], bh0, bl0);
      split_tf32(bp[4 * BN], bh1, bl1);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        // A fragment of rows 16 mt .. 16 mt + 15 of the slice: shared rows
        // off + 16 mt + g (+ 8), at the unaligned offset
        const float* ap = &As[(off + 16 * mt + g) * AP + kk + t];
        uint32_t ah[4], al[4];
        split_tf32(ap[0], ah[0], al[0]);
        split_tf32(ap[8 * AP], ah[1], al[1]);
        split_tf32(ap[4], ah[2], al[2]);
        split_tf32(ap[8 * AP + 4], ah[3], al[3]);
        mma_tf32_1688(acc[mt], al, bh0, bh1);
        mma_tf32_1688(acc[mt], ah, bl0, bl1);
        mma_tf32_1688(acc[mt], ah, bh0, bh1);
      }
    }
    __syncthreads();
  }
  // The warps' partial sums, added in warp order: no atomics, the same
  // bits on every call.
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* r = &red[(warp * BM + 16 * mt + g + 8 * h) * BN + 2 * t];
      r[0] = acc[mt][2 * h];
      r[1] = acc[mt][2 * h + 1];
    }
  __syncthreads();
  const int row = threadIdx.x / BN, col = threadIdx.x % BN;  // BM x BN
  float sum = red[row * BN + col];
#pragma unroll
  for (int wi = 1; wi < MM_WARPS; ++wi) sum += red[(wi * BM + row) * BN + col];
  if (m0 + row < n && n0 + col < N)
    out[static_cast<int64_t>(m0 + row) * N + n0 + col] = sum;
}

// ------------------------------------------------- width shifts (M6)

constexpr int WS_THREADS = 256;
constexpr int TILE_BYTES = 16384;   // one copy's bytes at most: 3 per tile

__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src,
                                         uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__global__ void __launch_bounds__(WS_THREADS)
    width_shifts_kernel(const float* __restrict__ xp, float* __restrict__ out,
                        int Wp, int C, int w, int tile_w, int tiles_w, int d0,
                        int d1, int d2) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  const int h = blockIdx.x / tiles_w;
  const int j0 = (blockIdx.x % tiles_w) * tile_w;
  const int cols = min(tile_w, w - j0);
  const uint32_t bytes = static_cast<uint32_t>(cols) * C * 4;
  const uint32_t stride = static_cast<uint32_t>(tile_w) * C * 4;
  const uint32_t bar_a = smem_u32(&bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar_a),
                 "r"(1));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            bar_a),
        "r"(3 * bytes)
        : "memory");
    const int d[3] = {d0, d1, d2};
    const float* row = xp + static_cast<int64_t>(h) * Wp * C;
#pragma unroll
    for (int q = 0; q < 3; ++q)
      bulk_g2s(smem_u32(smem + q * stride),
               row + static_cast<int64_t>(j0 + d[q]) * C, bytes, bar_a);
  }
  mbar_wait(bar_a, 0);
  const float4* s0 = reinterpret_cast<const float4*>(smem);
  const float4* s1 = reinterpret_cast<const float4*>(smem + stride);
  const float4* s2 = reinterpret_cast<const float4*>(smem + 2 * stride);
  float4* o = reinterpret_cast<float4*>(
      out + (static_cast<int64_t>(h) * w + j0) * C);
  for (int i = threadIdx.x; i < static_cast<int>(bytes / 16);
       i += WS_THREADS) {
    const float4 a = s0[i], b = s1[i], c = s2[i];
    o[i] = make_float4(__fadd_rn(__fadd_rn(a.x, b.x), c.x),
                       __fadd_rn(__fadd_rn(a.y, b.y), c.y),
                       __fadd_rn(__fadd_rn(a.z, b.z), c.z),
                       __fadd_rn(__fadd_rn(a.w, b.w), c.w));
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Each returns a cudaError_t as int (0 on success) and does not
// synchronize.

// M1, M2, M3, M5: out (n, cols) from x (rows, cols); dtype 0 = bf16,
// 1 = f32; mode 0 static start, 1 start read from s_dev[0], 2 roll by
// `start_or_shift` in [0, rows) (then n == rows).
extern "C" int layout_rows(const void* x, void* out, const int* s_dev,
                           int mode, int dtype, int rows, int cols, int n,
                           int start_or_shift, void* stream) {
  const int item = dtype == 0 ? 2 : 4;
  const int64_t row_bytes = static_cast<int64_t>(cols) * item;
  if (rows <= 0 || cols <= 0 || n <= 0 || n > rows || row_bytes % 16 ||
      row_bytes > 2147483647LL || !aligned16(x) || !aligned16(out) ||
      mode < 0 || mode > 2 || (mode == DYNAMIC && s_dev == nullptr) ||
      (mode == STATIC && (start_or_shift < 0 || start_or_shift + n > rows)) ||
      (mode == ROLL && (n != rows || start_or_shift < 0 ||
                        start_or_shift >= rows)))
    return static_cast<int>(cudaErrorInvalidValue);
  // row blocks along x, column tiles along y (ops/layout_probes.py::
  // rows_grid)
  const int64_t ty = (row_bytes + CT - 1) / CT;
  if (ty > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((n + RB - 1) / RB),
                  static_cast<unsigned>(ty));
  auto st = static_cast<cudaStream_t>(stream);
  const int rb = static_cast<int>(row_bytes);
  if (dtype == 0)
    rows_kernel<__nv_bfloat16><<<grid, ROW_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
        s_dev, mode, rows, rb, n, start_or_shift);
  else
    rows_kernel<float><<<grid, ROW_THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(out), s_dev, mode,
        rows, rb, n, start_or_shift);
  return static_cast<int>(cudaGetLastError());
}

// M4: out (n, N) = x[start:start+n] (x is (rows, K)) @ w (K, N), all f32.
extern "C" int layout_slice_matmul(const float* x, const float* w,
                                   float* out, int rows, int K, int N,
                                   int start, int n, void* stream) {
  if (rows <= 0 || K <= 0 || N <= 0 || n <= 0 || start < 0 ||
      start + n > rows || K % 4 || N % 4 || !aligned16(x) || !aligned16(w) ||
      (n + BM - 1) / BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      slice_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MM_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + BN - 1) / BN, (n + BM - 1) / BM);
  slice_matmul_kernel<<<grid, MM_THREADS, MM_SMEM,
                        static_cast<cudaStream_t>(stream)>>>(x, w, out, rows,
                                                             K, N, start, n);
  return static_cast<int>(cudaGetLastError());
}

// M6: out (H, w, C) = xp[:, d0:d0+w] + xp[:, d1:d1+w] + xp[:, d2:d2+w],
// xp (H, Wp, C), all f32, summed in that order.
extern "C" int layout_sum_width_shifts(const float* xp, float* out, int H,
                                       int Wp, int C, int w, int d0, int d1,
                                       int d2, void* stream) {
  const int d_max = d0 > d1 ? (d0 > d2 ? d0 : d2) : (d1 > d2 ? d1 : d2);
  if (H <= 0 || Wp <= 0 || C <= 0 || w <= 0 || C % 4 || d0 < 0 || d1 < 0 ||
      d2 < 0 || d_max + w > Wp || !aligned16(xp) || !aligned16(out) ||
      static_cast<int64_t>(C) * 4 > TILE_BYTES)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tile_w = std::min(w, TILE_BYTES / (C * 4));
  const int tiles_w = (w + tile_w - 1) / tile_w;
  const int64_t blocks = static_cast<int64_t>(H) * tiles_w;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 3 * tile_w * C * 4;
  cudaError_t err = cudaFuncSetAttribute(
      width_shifts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  width_shifts_kernel<<<static_cast<unsigned>(blocks), WS_THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      xp, out, Wp, C, w, tile_w, tiles_w, d0, d1, d2);
  return static_cast<int>(cudaGetLastError());
}
