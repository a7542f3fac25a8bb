// Weight gradient of a conv3x3 (pad 1, stride 1), NHWC bf16 in, f32 out,
// for Hopper (sm_90a):
//
//     dW[ky,kx,ci,co] = sum_{n,h,w} x[n,h+ky-1,w+kx-1,ci] * g[n,h,w,co]
//
// with out-of-image taps reading zero. Replaces the TPU kernel
// pytorch_camvid_tpu/ops/pallas_conv_train.py::_conv3x3_dw (body _dw_kernel),
// the weight-gradient leg of the training conv's custom VJP. That kernel
// carried the f32 sum across a sequential grid in VMEM and padded the input
// into a flat 8-aligned slab; GPU blocks run in no order, so here the sum is
// split over blocks (split-K over the pixels) and each block writes its
// partial tile to an f32 workspace [split][9][Cin][Cout]; a second kernel
// sums the splits in a fixed order, so the result is deterministic (no
// float atomics). With one split the first kernel writes dW directly. The
// pixels are walked in tiles of TH x TW = 8 x 16; offsets are 64-bit.
//
// Two paths, chosen by conv3x3_wgrad_path(Cin, Cout) (the wrapper holds the
// same rule, ops/conv_train.py::wgrad_path):
//
// * wgmma (Cin % 8 == 0 and Cout % 8 == 0). Per tap a GEMM with M = Cin,
//   N = Cout and K = pixels. A block owns 64 input x 64 output channels and
//   all 9 taps; its three consumer warpgroups own one kernel row dy each
//   (three taps x 32 f32 accumulators per thread: all nine would be 288),
//   and a producer warpgroup (setmaxnreg gives its registers to them) keeps
//   a 5-stage ring full with TMA: per pixel tile the (TH+2) x (TW+2) x 64
//   input patch through a 4-D tensor map over x (C, W, H, N), whose halo
//   lies outside the image and is filled with zero, and the TH x TW x 64
//   cotangent tile through one over g, unshifted (its ragged edge is zero
//   too, so it adds nothing). Both land with the 128-byte swizzle, pixel
//   rows of 128 bytes. Per tile row r (one k16 step of 16 pixels) g's rows
//   are B as an N-major operand (descriptor, transpose bit set) and tap
//   (dy, dx) reads A = x^T with ldmatrix.trans at the patch's shifted row
//   (swizzle XOR in the address) into registers: wgmma.m64n64k16, three
//   taps per B. Each tile's patch serves all 9 taps, so x and g are each
//   read once per (Cin, Cout) tile of 64 x 64: per call Cout/64 * |x| * 1.4
//   (the halo) + Cin/64 * |g| bytes from L2, where a tap-per-block tiling
//   would read x 9 times as often. The split-K takes whole waves of two
//   blocks per SM (ops/conv_train.py::wgrad_splits).
// * narrow (the Cin = 3 stem, the Cout = 12 head): the first design,
//   mma.sync m16n8k16 on 9 taps x 32 input x 64 output channels per block,
//   cp.async double buffering, scalar loads for a channel count that is not
//   a multiple of 8.
//
// What bounds it on the H100: 2*9*M*Cin*Cout FLOP against reading x and g
// once per (Cin, Cout) tile from L2: for Cin, Cout >= 64 it is
// compute-bound, and the wgmma path's ~241 FLOP per L2 byte (9.4 MFLOP per
// 39 KB stage) is above the ridge. Shared memory bounds it next: each
// m64n64k16 reads 2 KB of B and its warps 2 KB of A, the SM's whole 128
// bytes per cycle at the tensor cores' rate; and a 64 x 64 x 9-tap output
// tile is the most a block's registers hold (a 64 x 128 one would need
// 192 accumulators per thread), so N stays 64. ptxas serializes each
// warpgroup's wgmmas for want of registers; the three warpgroups overlap
// one another's. It runs at about half the tensor rate.

#include "sm90_common.cuh"

namespace {

using sm90::smem_u32;

// out[i] = sum_{s < splits} ws[s][i], in split order.
__global__ void sum_splits_kernel(const float* __restrict__ ws,
                                  float* __restrict__ out, int64_t size,
                                  int splits) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < size; i += stride) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += ws[k * size + i];
    out[i] = s;
  }
}

// ================================================================ narrow

namespace narrow {

constexpr int TH = 8;            // pixel rows per tile
constexpr int TW = 16;           // pixel cols per tile (= one k16 step)
constexpr int PH = TH + 2;       // patch rows (with halo)
constexpr int PW = TW + 2;       // patch cols (with halo)
constexpr int KC = 32;           // input channels per block
constexpr int KCP = KC + 8;      // padded patch pixel stride (80 B: ldmatrix
                                 // rows hit distinct banks)
constexpr int BN = 64;           // output channels per block
constexpr int BNP = BN + 8;      // padded cotangent pixel stride (144 B)
constexpr int THREADS = 256;     // 8 warps: 2 along Cin x 4 along Cout

constexpr int PATCH_ELEMS = PH * PW * KCP;
constexpr int GTILE_ELEMS = TH * TW * BNP;
constexpr int STAGE_ELEMS = PATCH_ELEMS + GTILE_ELEMS;
constexpr int SMEM_BYTES = 2 * STAGE_ELEMS * 2;  // two stages of bf16

// 16-byte async copy; src_bytes == 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage pixel tile (n, h0, w0): the input patch for channels [c0, c0+KC)
// and the cotangent tile for channels [n0, n0+BN). VEC_X: Cin % 8 == 0 and
// x 16-byte aligned -> 16-byte cp.async per 8 channels; otherwise scalar
// loads of the valid channels only (the Cin=3 stem). VEC_G likewise for
// Cout (the Cout=12 head takes the scalar path). Channels past Cin / Cout
// are left unwritten in the scalar paths: they only feed output rows and
// columns that are never stored. Pixels outside the image are zero, which
// is the conv's padding for x and keeps g's ragged tiles out of the sum.
template <bool VEC_X, bool VEC_G>
__device__ __forceinline__ void stage_tile(
    __nv_bfloat16* patch, __nv_bfloat16* gt,
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
    int n, int h0, int w0, int c0, int n0, int H, int W, int Cin, int Cout) {
  const int tid = threadIdx.x;
  const int64_t img_base = static_cast<int64_t>(n) * H * W;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  if (VEC_X) {
    constexpr int VPP = KC / 8;  // 16-byte vectors per patch pixel
    for (int i = tid; i < PH * PW * VPP; i += THREADS) {
      const int pix = i / VPP, v = i % VPP;
      const int h = h0 + pix / PW - 1, ww = w0 + pix % PW - 1;
      const int c = c0 + v * 8;
      const bool ok = h >= 0 && h < H && ww >= 0 && ww < W && c < Cin;
      const __nv_bfloat16* src =
          ok ? x + ((img_base + static_cast<int64_t>(h) * W + ww) * Cin + c)
             : x;
      cp_async16(patch + pix * KCP + v * 8, src, ok ? 16 : 0);
    }
  } else {
    // the valid channels, walked in a power-of-two stride (shifts, not
    // divisions, keep the loop within the registers of two blocks per SM)
    const int kc = min(KC, Cin - c0);
    const int lg = 32 - __clz(kc - 1);
    for (int i = tid; i < (PH * PW) << lg; i += THREADS) {
      const int pix = i >> lg, k = i & ((1 << lg) - 1);
      const int h = h0 + pix / PW - 1, ww = w0 + pix % PW - 1;
      const bool ok = h >= 0 && h < H && ww >= 0 && ww < W;
      if (k < kc)
        patch[pix * KCP + k] =
            ok ? x[(img_base + static_cast<int64_t>(h) * W + ww) * Cin + c0 +
                   k]
               : zero;
    }
  }
  if (VEC_G) {
    constexpr int VPP = BN / 8;
    for (int i = tid; i < TH * TW * VPP; i += THREADS) {
      const int pix = i / VPP, v = i % VPP;
      const int h = h0 + pix / TW, ww = w0 + pix % TW;
      const int co = n0 + v * 8;
      const bool ok = h < H && ww < W && co < Cout;
      const __nv_bfloat16* src =
          ok ? g + ((img_base + static_cast<int64_t>(h) * W + ww) * Cout +
                    co)
             : g;
      cp_async16(gt + pix * BNP + v * 8, src, ok ? 16 : 0);
    }
  } else {
    const int bn = min(BN, Cout - n0);
    const int lg = 32 - __clz(bn - 1);
    for (int i = tid; i < (TH * TW) << lg; i += THREADS) {
      const int pix = i >> lg, j = i & ((1 << lg) - 1);
      const int h = h0 + pix / TW, ww = w0 + pix % TW;
      const bool ok = h < H && ww < W;
      if (j < bn)
        gt[pix * BNP + j] =
            ok ? g[(img_base + static_cast<int64_t>(h) * W + ww) * Cout + n0 +
                   j]
               : zero;
    }
  }
}

template <bool VEC_X, bool VEC_G>
__global__ void __launch_bounds__(THREADS, 2)
    conv3x3_wgrad_narrow_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ g,
                         float* __restrict__ out, int N, int H, int W,
                         int Cin, int Cout, int splits) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  // blockIdx.x -> (Cin chunk, Cout tile), Cout tile fastest; blockIdx.y is
  // the split. Blocks of one split read the same pixels, so they run
  // close together and share x and g in L2.
  const int tiles_co = (Cout + BN - 1) / BN;
  const int tco = blockIdx.x % tiles_co;
  const int c0 = (blockIdx.x / tiles_co) * KC;
  const int n0 = tco * BN;
  const int split = blockIdx.y;

  const int tiles_h = (H + TH - 1) / TH;
  const int tiles_w = (W + TW - 1) / TW;
  const int64_t total = static_cast<int64_t>(N) * tiles_h * tiles_w;
  const int64_t t_begin = total * split / splits;
  const int64_t t_end = total * (split + 1) / splits;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp & 1;   // input channels wm*16 .. +15 of the chunk
  const int wn = warp >> 1;  // output channels wn*16 .. +15 of the tile

  float acc[9][2][4];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[t][j][q] = 0.f;

  // Per-lane ldmatrix row offsets (elements, within one stage). Lane l
  // addresses row (l & 7) of 8x8 matrix l >> 3.
  // A (rows ci, cols pixel k): matrices a0..a3 = (ci +0, k +0), (ci +8,
  //   k +0), (ci +0, k +8), (ci +8, k +8); memory rows are pixels, so
  //   .trans hands each lane its A[ci][k] pair.
  // B (rows pixel k, cols co): lanes 0-15 give pixels 0-15 at co +0, lanes
  //   16-31 the same pixels at co +8 -> (b0, b1) of two adjacent n8 tiles.
  const int a_off = ((lane & 7) + ((lane >> 4) << 3)) * KCP + wm * 16 +
                    ((lane >> 3) & 1) * 8;
  const int b_off = (lane & 15) * BNP + wn * 16 + (lane >> 4) * 8;

  auto tile_origin = [&](int64_t t, int& n, int& h0, int& w0) {
    w0 = static_cast<int>(t % tiles_w) * TW;
    t /= tiles_w;
    h0 = static_cast<int>(t % tiles_h) * TH;
    n = static_cast<int>(t / tiles_h);
  };

  {
    int n, h0, w0;
    tile_origin(t_begin, n, h0, w0);
    stage_tile<VEC_X, VEC_G>(smem, smem + PATCH_ELEMS, x, g, n, h0, w0, c0,
                             n0, H, W, Cin, Cout);
    cp_async_commit();
  }

  for (int64_t t = t_begin; t < t_end; ++t) {
    const int buf = static_cast<int>((t - t_begin) & 1);
    if (t + 1 < t_end) {
      int n, h0, w0;
      tile_origin(t + 1, n, h0, w0);
      __nv_bfloat16* nxt = smem + (buf ^ 1) * STAGE_ELEMS;
      stage_tile<VEC_X, VEC_G>(nxt, nxt + PATCH_ELEMS, x, g, n, h0, w0, c0,
                               n0, H, W, Cin, Cout);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const __nv_bfloat16* cur = smem + buf * STAGE_ELEMS;
    const uint32_t patch_s = smem_u32(cur);
    const uint32_t gt_s = smem_u32(cur + PATCH_ELEMS);

#pragma unroll
    for (int r = 0; r < TH; ++r) {  // one k16 step: tile row r, 16 pixels
      uint32_t b[4];
      sm90::ldmatrix_x4_trans(b, gt_s + 2 * (b_off + r * TW * BNP));
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        uint32_t a[4];
        sm90::ldmatrix_x4_trans(a,
                          patch_s + 2 * (a_off + ((r + dy) * PW + dx) * KCP));
        mma_bf16_16816(acc[tap][0], a, b[0], b[1]);
        mma_bf16_16816(acc[tap][1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration
  }

  // C fragment rows g8 / g8+8 are input channels, cols 2*t4, 2*t4+1 output
  // channels.
  const int g8 = lane >> 2, t4 = lane & 3;
  float* dst = out + static_cast<int64_t>(split) * 9 * Cin * Cout;
  const bool pair_store = (Cout % 2) == 0;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ci = c0 + wm * 16 + g8 + half * 8;
      if (ci >= Cin) continue;
      float* row = dst + (static_cast<int64_t>(tap) * Cin + ci) * Cout;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int co = n0 + wn * 16 + j * 8 + t4 * 2;
        if (co >= Cout) continue;
        const float v0 = acc[tap][j][half * 2];
        const float v1 = acc[tap][j][half * 2 + 1];
        if (pair_store) {  // co even and Cout even -> 8-byte aligned pair
          *reinterpret_cast<float2*>(row + co) = make_float2(v0, v1);
        } else {
          row[co] = v0;
          if (co + 1 < Cout) row[co + 1] = v1;
        }
      }
    }
  }
}

template <bool VEC_X, bool VEC_G>
cudaError_t launch(const __nv_bfloat16* x, const __nv_bfloat16* g,
                   float* dst, int N, int H, int W, int Cin, int Cout,
                   int splits, cudaStream_t stream) {
  auto kern = conv3x3_wgrad_narrow_kernel<VEC_X, VEC_G>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(((Cin + KC - 1) / KC) * ((Cout + BN - 1) / BN), splits);
  kern<<<grid, THREADS, SMEM_BYTES, stream>>>(x, g, dst, N, H, W, Cin, Cout,
                                             splits);
  return cudaGetLastError();
}

cudaError_t run(const __nv_bfloat16* x, const __nv_bfloat16* g, float* dst,
                int N, int H, int W, int Cin, int Cout, int splits,
                cudaStream_t st) {
  const bool vec_x =
      Cin % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool vec_g =
      Cout % 8 == 0 && (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  if (vec_x && vec_g)
    return launch<true, true>(x, g, dst, N, H, W, Cin, Cout, splits, st);
  if (vec_x)
    return launch<true, false>(x, g, dst, N, H, W, Cin, Cout, splits, st);
  if (vec_g)
    return launch<false, true>(x, g, dst, N, H, W, Cin, Cout, splits, st);
  return launch<false, false>(x, g, dst, N, H, W, Cin, Cout, splits, st);
}

}  // namespace narrow

// ================================================================= wgmma

namespace wg {

constexpr int TH = 8;            // pixel rows per tile
constexpr int TW = 16;           // pixel cols per tile (= one k16 step)
constexpr int PH = TH + 2, PW = TW + 2;
constexpr int BM = 64;           // input channels per block (M)
constexpr int BN = 64;           // output channels per block (N)
constexpr int THREADS = 512;     // warpgroups 0-2 consume (dy), 3 produces
constexpr int CONSUMER_WARPS = 12;
constexpr int X_TX = PH * PW * 128;           // 23040: one patch box
constexpr int X_BYTES = (X_TX + 1023) / 1024 * 1024;
constexpr int G_TX = TH * TW * 128;           // 16384: one cotangent box
constexpr int STAGE_BYTES = X_BYTES + G_TX;
constexpr int STAGES = 5;
constexpr int BAR_OFF = STAGES * STAGE_BYTES;
constexpr int SMEM = BAR_OFF + 2 * STAGES * 8 + 1024;

__global__ void __launch_bounds__(THREADS, 1)
    conv3x3_wgrad_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                               const __grid_constant__ CUtensorMap gmap,
                               float* __restrict__ out, int N, int H, int W,
                               int Cin, int Cout, int splits) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* empty = full + STAGES;

  // blockIdx.x -> (Cin tile, Cout tile), Cout tile fastest; blockIdx.y is
  // the split. Blocks of one split read the same pixels, so they run
  // close together and share x and g in L2.
  const int tiles_co = (Cout + BN - 1) / BN;
  const int n0 = (blockIdx.x % tiles_co) * BN;
  const int c0 = (blockIdx.x / tiles_co) * BM;
  const int split = blockIdx.y;
  const int tiles_h = (H + TH - 1) / TH;
  const int tiles_w = (W + TW - 1) / TW;
  // this split's pixel tiles [t_begin, t_end) (fewer than 2^31: host) and
  // the first one's origin, decoded before the roles part
  const int total = N * tiles_h * tiles_w;
  const int t_begin =
      static_cast<int>(static_cast<int64_t>(total) * split / splits);
  const int t_end =
      static_cast<int>(static_cast<int64_t>(total) * (split + 1) / splits);
  const int w_begin = t_begin % tiles_w * TW;
  const int h_begin = t_begin / tiles_w % tiles_h * TH;
  const int img_begin = t_begin / (tiles_w * tiles_h);

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      sm90::mbar_init(&full[i], 1);
      sm90::mbar_init(&empty[i], CONSUMER_WARPS);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 3) {
    // ------------------------------------------------------ producer
    sm90::setmaxnreg_dec<40>();  // 128 x 40 + 384 x 152 <= 65536
    if (threadIdx.x == 384) {
      sm90::prefetch_tensormap(&xmap);
      sm90::prefetch_tensormap(&gmap);
      // the tile origin steps along the row, then down, then to the next
      // image: no division in the loop
      int w0 = w_begin, h0 = h_begin, img = img_begin;
      uint32_t it = 0;
      for (int t = t_begin; t < t_end; ++t, ++it) {
        const int s = it % STAGES;
        sm90::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full[s], X_TX + G_TX);
        unsigned char* st = smem + s * STAGE_BYTES;
        sm90::tma_load_4d(st, &xmap, &full[s], c0, w0 - 1, h0 - 1, img);
        sm90::tma_load_4d(st + X_BYTES, &gmap, &full[s], n0, w0, h0, img);
        if ((w0 += TW) >= W) {
          w0 = 0;
          if ((h0 += TH) >= H) {
            h0 = 0;
            ++img;
          }
        }
      }
    }
  } else {
    // --------------------------------------------- consumers: dy = wgi
    sm90::setmaxnreg_inc<152>();
    const int dy = wgi;
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const uint32_t smem0 = smem_u32(smem);
    // ldmatrix.trans row of this lane: pixel (lane & 7) + 8 * (lane >> 4)
    // of the k16 step, input channels 16 * warp + 8 * ((lane >> 3) & 1):
    // the four 8x8 matrices of the warp's 16 (ci) x 16 (pixel) A slice
    const int prow = (lane & 7) + 8 * (lane >> 4);
    const int chunk = 2 * warp + ((lane >> 3) & 1);
    float acc[3][BN / 2];
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[dx][i] = 0.f;
    uint32_t it = 0;
    for (int t = t_begin; t < t_end; ++t, ++it) {
      const int s = it % STAGES;
      sm90::mbar_wait(&full[s], (it / STAGES) & 1);
      const uint32_t xs = smem0 + s * STAGE_BYTES;
      const uint32_t gs = xs + X_BYTES;
      uint32_t afrag[2][3][4];
#pragma unroll
      for (int r = 0; r < TH; ++r) {
        // B: g's pixel rows 16r .. 16r+15 (K) x 64 channels (N), N-major:
        // 8 rows are 1024 bytes
        const uint64_t desc = sm90::wgmma_desc(gs + r * 2048, 8192, 1024, 1);
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          sm90::ldmatrix_x4_trans(
              afrag[r & 1][dx],
              sm90::swz128(xs, (r + dy) * PW + dx + prow, chunk));
        sm90::wgmma_fence();
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          sm90::wgmma_rs<BN, 1>(acc[dx], afrag[r & 1][dx], desc);
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();
      }
      sm90::wgmma_wait<0>();
      if (lane == 0) sm90::mbar_arrive(&empty[s]);
    }
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) sm90::fence_regs(acc[dx]);

    // Accumulator i of tap (dy, dx): input channel c0 + 16*warp + lane/4
    // (+8 for i%4 >= 2), output channel n0 + 8*(i/4) + 2*(lane%4) + i%2.
    float* dst = out + static_cast<int64_t>(split) * 9 * Cin * Cout;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int tap = dy * 3 + dx;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ci = c0 + 16 * warp + (lane >> 2) + 8 * half;
        if (ci >= Cin) continue;
        float* row = dst + (static_cast<int64_t>(tap) * Cin + ci) * Cout;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int co = n0 + 8 * j + 2 * (lane & 3);
          if (co < Cout)  // Cout % 8 == 0: the pair is in range, aligned
            *reinterpret_cast<float2*>(row + co) =
                make_float2(acc[dx][4 * j + 2 * half],
                            acc[dx][4 * j + 2 * half + 1]);
        }
      }
    }
  }
}

cudaError_t run(const __nv_bfloat16* x, const __nv_bfloat16* g, float* dst,
                int N, int H, int W, int Cin, int Cout, int splits,
                cudaStream_t stream) {
  CUtensorMap xmap, gmap;
  const uint64_t xd[4] = {static_cast<uint64_t>(Cin),
                          static_cast<uint64_t>(W), static_cast<uint64_t>(H),
                          static_cast<uint64_t>(N)};
  const uint64_t xs[3] = {2ull * Cin, 2ull * Cin * W, 2ull * Cin * W * H};
  const uint32_t xb[4] = {64, PW, PH, 1};
  const uint64_t gd[4] = {static_cast<uint64_t>(Cout),
                          static_cast<uint64_t>(W), static_cast<uint64_t>(H),
                          static_cast<uint64_t>(N)};
  const uint64_t gstr[3] = {2ull * Cout, 2ull * Cout * W,
                            2ull * Cout * W * H};
  const uint32_t gb[4] = {64, TW, TH, 1};
  if (static_cast<int64_t>(N) * ((H + TH - 1) / TH) * ((W + TW - 1) / TW) >
      2147483647LL)
    return cudaErrorInvalidConfiguration;
  if (!sm90::encode_bf16_map(&xmap, x, 4, xd, xs, xb) ||
      !sm90::encode_bf16_map(&gmap, g, 4, gd, gstr, gb))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_wgrad_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(((Cin + BM - 1) / BM) * ((Cout + BN - 1) / BN), splits);
  conv3x3_wgrad_wgmma_kernel<<<grid, THREADS, SMEM, stream>>>(
      xmap, gmap, dst, N, H, W, Cin, Cout, splits);
  return cudaGetLastError();
}

}  // namespace wg


}  // namespace

// 1: the wgmma path takes (Cin, Cout); 0: the narrow path does.
extern "C" int conv3x3_wgrad_path(int Cin, int Cout) {
  return Cin % 8 == 0 && Cout % 8 == 0;
}

// Pixel tiles of the split-K range (both paths walk 8 x 16 tiles): the
// wrapper picks splits <= this.
extern "C" long long conv3x3_wgrad_pixel_tiles(int N, int H, int W) {
  return static_cast<long long>(N) * ((H + wg::TH - 1) / wg::TH) *
         ((W + wg::TW - 1) / wg::TW);
}

// Output tiles (blocks per split) of the path that takes (Cin, Cout): the
// wrapper sizes the split-K from this.
extern "C" long long conv3x3_wgrad_out_tiles(int Cin, int Cout) {
  if (conv3x3_wgrad_path(Cin, Cout))
    return static_cast<long long>((Cin + wg::BM - 1) / wg::BM) *
           ((Cout + wg::BN - 1) / wg::BN);
  return static_cast<long long>((Cin + narrow::KC - 1) / narrow::KC) *
         ((Cout + narrow::BN - 1) / narrow::BN);
}

// dW (3,3,Cin,Cout) f32 <- x (N,H,W,Cin) bf16, g (N,H,W,Cout) bf16.
// ws: f32 workspace of splits*9*Cin*Cout elements when splits > 1 (unused
// and may be null when splits == 1).
extern "C" int conv3x3_wgrad_bf16(const void* x, const void* g, void* out,
                                  void* ws, int N, int H, int W, int Cin,
                                  int Cout, int splits, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || splits <= 0 ||
      splits > 65535 || splits > conv3x3_wgrad_pixel_tiles(N, H, W) ||
      (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto xb = static_cast<const __nv_bfloat16*>(x);
  auto gb = static_cast<const __nv_bfloat16*>(g);
  auto of = static_cast<float*>(out);
  float* dst = splits > 1 ? static_cast<float*>(ws) : of;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      conv3x3_wgrad_path(Cin, Cout)
          ? wg::run(xb, gb, dst, N, H, W, Cin, Cout, splits, st)
          : narrow::run(xb, gb, dst, N, H, W, Cin, Cout, splits, st);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int64_t size = static_cast<int64_t>(9) * Cin * Cout;
  const int64_t blocks = (size + 255) / 256;
  sum_splits_kernel<<<static_cast<unsigned>(blocks < 1056 ? blocks : 1056),
                      256, 0, st>>>(dst, of, size, splits);
  return static_cast<int>(cudaGetLastError());
}
