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
// Three paths, chosen by conv3x3_wgrad_path(Cin, Cout) (the wrapper holds the
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
// * packed (one side narrow, the other wide: Cin % 8 != 0 with 9 x Cin <=
//   M_MAX = 192 and Cout % 8 == 0, the Cin = 3 stem; or Cout % 8 != 0 with
//   9 x Cout <= 192 and Cin % 8 == 0, the heads, Cout 12 (CamVid) and 21
//   (VOC)). Bound by bytes: at 360x480, batch 24, the stem reads x 25 MB
//   and g 531 MB (0.166 ms at 3.35 TB/s), the 12-class head x 531 MB and g
//   100 MB (0.188 ms), the 21-class head x 531 MB and g 174 MB (0.210 ms),
//   while their useful work is 14, 57 and 100 GFLOP. The wide tensor (the
//   stem's g, the heads' x; Cw channels) is read once, unshifted, by TMA:
//   per pixel tile an 8 x 16 x 64 box with the 128-byte swizzle, B of
//   wgmma.m64n64k16 as the wgmma path reads g (N-major descriptor, one k16
//   step a tile row). The narrow tensor (Cn channels) is the shifted
//   operand. Per tile a producer warpgroup copies its (8 + 2) x (16 + 2) x
//   Cn patch, each patch row 18 x Cn contiguous elements, as it lies into
//   shared memory (16-byte cp.async, three tiles ahead: one 2-byte load a
//   pixel and channel had cost the head a fifth of its time,
//   dw_variants.py), then each thread takes one (patch row, channel) line
//   of 18 values from there (two lines past 128: 210 at Cn 21) and writes
//   it transposed, channel-major, three times, shifted by dx = 0, 1, 2
//   columns, so that each (tap, channel) row of A = 16 pixels of one tile
//   row is 32 aligned bytes: M packs the 9 taps x Cn tap-major, m = (3 dy
//   + dx) Cn + c, padded to 64 per m64 tile (27 -> 64 for the stem, 108 ->
//   128 for the 12-class head, 189 -> 192 for the 21-class one), the pad
//   rows reading a zero plane, and ldmatrix (no transpose) loads each
//   warp's 16 rows straight from the shifted copies into wgmma's A
//   registers. So
//       D[(t, c)][w] = sum_p narrow[p + off(t)][c] * wide[p][w],
//   the stem's dW[t][c][w] and, since g[p + off(t)] = g[q - off(8 - t)],
//   the heads' dW[8 - t][w][c]. MMA work per pixel: 4,096 (stem), 8,192
//   (Cn 12) and 12,288 (Cn 21) MACs, from the narrow path's 18,432,
//   36,864 and 36,864: the tensor cores stay off the critical path
//   (dw_variants.py's no_mma, without the wgmmas, reads within 3% of it).
//   Each block is one consumer warpgroup and one producer warpgroup
//   (thread 0 issues the TMA), a 3- or 4-stage ring under full / empty
//   mbarriers, two blocks per SM, one at three m64 tiles (Cn 15-21: 96
//   accumulators a consumer thread; smem_bytes(21) = 184,000 B at 4
//   stages); split-K over pixel tiles as the wgmma path
//   (ops/conv_train.py::wgrad_splits, whole waves of two blocks per SM);
//   offsets 64-bit. The shared-memory plan is smem_bytes() below, held by
//   static_asserts and by ops/conv_train.py::wgrad_packed_plan.
// * narrow (every other shape with a channel count that is not a multiple
//   of 8, e.g. 64->28 or 3->12): the first design,
//   mma.sync m16n8k16 on 9 taps x 32 input x 64 output channels per block,
//   cp.async double buffering, scalar loads for a channel count that is not
//   a multiple of 8. Models run it: UNet at width 9/16's training step
//   sends it the dW of seven blocks (3->36, 36->36 x2, 72->36 x2, 36->72,
//   36->12), a 150-class head its dW (64->150).
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

// ================================================================ packed

namespace pk {

constexpr int TH = 8, TW = 16;           // pixel tile (the wgmma path's)
constexpr int PH = TH + 2;               // narrow patch rows (with halo)
constexpr int PWN = TW + 2;              // narrow patch columns
// bytes of one (dx, channel) plane: PH rows of 16 pixels (32 B), then 16 B
// of pad, so a plane is an odd number of 16-byte chunks and the 8 rows one
// ldmatrix reads from consecutive planes fall in distinct banks
constexpr int PLANE = PH * TW * 2 + 16;
constexpr int WIDE_TX = TH * TW * 128;   // 16384: one wide box
constexpr int THREADS = 256;             // warpgroup 0 consumes, 1 produces
constexpr int PRODUCERS = 128;
constexpr int CONSUMER_WARPS = 4;
constexpr int RAW = 4;                   // raw patch buffers: 3 tiles ahead
constexpr int SM_SMEM = 233472;          // shared memory of an SM
constexpr int BLOCK_RESERVED = 1024;     // the runtime's share per block
constexpr int M_MAX = 192;               // 9 taps x Cn: three m64 tiles

__host__ __device__ constexpr int m_tiles(int cn) {
  return (9 * cn + 63) / 64;
}
constexpr int blocks_per_sm(int cn) { return m_tiles(cn) == 3 ? 1 : 2; }
// a ring stage of the narrow patch: 3 shifted copies x cn planes and one
// zero plane (the pad rows of M), 128-byte aligned
__host__ __device__ constexpr int narrow_stage(int cn) {
  return ((3 * cn + 1) * PLANE + 127) / 128 * 128;
}
// 16-byte chunks a patch row of 18 x cn elements spans at any alignment
__host__ __device__ constexpr int raw_chunks(int cn) {
  return (18 * cn + 6) / 8 + 1;
}
// alignment slack, the wide and narrow rings, the raw patch buffers, 2
// mbarriers a stage
constexpr int smem_at(int cn, int stages) {
  return 1024 + stages * (WIDE_TX + narrow_stage(cn)) +
         RAW * PH * raw_chunks(cn) * 16 + 16 * stages;
}
// four stages where blocks_per_sm blocks still fit an SM, else three
constexpr int stages(int cn) {
  return blocks_per_sm(cn) * (smem_at(cn, 4) + BLOCK_RESERVED) <= SM_SMEM
             ? 4
             : 3;
}
constexpr int smem_bytes(int cn) { return smem_at(cn, stages(cn)); }
// ops/conv_train.py::wgrad_packed_plan holds the same figures
static_assert(smem_bytes(3) == 85568, "the stem's plan (Cn 3, 4 stages)");
static_assert(smem_bytes(12) == 105776, "the head's plan (Cn 12, 3 stages)");
static_assert(smem_bytes(15) == 150976, "Cn 15: 3 m64 tiles, 1 block/SM");
static_assert(smem_bytes(21) == 184000, "VOC's head (Cn 21, 4 stages)");

__device__ __forceinline__ uint32_t lds_u16(uint32_t addr) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr));
  return v;
}

template <int MT, bool HEAD>
__global__ void __launch_bounds__(THREADS, MT == 3 ? 1 : 2)
    conv3x3_wgrad_packed_kernel(const __grid_constant__ CUtensorMap wmap,
                                const __nv_bfloat16* __restrict__ nar,
                                float* __restrict__ out, int N, int H, int W,
                                int Cw, int Cn, int S, int splits) {
  constexpr int LPT = MT == 1 ? 1 : 2;   // patch lines a producer thread
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const int nb = narrow_stage(Cn);
  unsigned char* nar0 = smem + S * WIDE_TX;
  unsigned char* raw0 = nar0 + S * nb;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(raw0 + RAW * raw_chunks(Cn) * PH * 16);
  uint64_t* empty = full + S;

  const int n0 = blockIdx.x * 64;        // the block's wide channels
  const int split = blockIdx.y;
  const int tiles_h = (H + TH - 1) / TH;
  const int tiles_w = (W + TW - 1) / TW;
  const int total = N * tiles_h * tiles_w;   // < 2^31 (host)
  const int t_begin =
      static_cast<int>(static_cast<int64_t>(total) * split / splits);
  const int t_end =
      static_cast<int>(static_cast<int64_t>(total) * (split + 1) / splits);

  // the zero plane of every stage, written once
  for (int i = threadIdx.x; i < S * (PLANE / 16); i += THREADS)
    reinterpret_cast<uint4*>(nar0 + (i / (PLANE / 16)) * nb +
                             3 * Cn * PLANE)[i % (PLANE / 16)] =
        make_uint4(0, 0, 0, 0);
  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      sm90::mbar_init(&full[i], 1 + PRODUCERS);
      sm90::mbar_init(&empty[i], CONSUMER_WARPS);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ------------------------------------------------------ producers
    const int p = threadIdx.x - 128;
    if (p == 0) sm90::prefetch_tensormap(&wmap);
    const unsigned short* xs = reinterpret_cast<const unsigned short*>(nar);
    // Patch row pr (input row h0 + pr - 1) is L = 18 x Cn elements,
    // contiguous in NHWC (pixels w0 - 1 .. w0 + TW); it spans CPR 16-byte
    // chunks, aligned in the narrow tensor. Each tile's rows are copied as
    // they lie (cp.async, 16 bytes a copy; item i = pr x CPR + q is chunk q
    // of row pr) into one of RAW buffers, three tiles ahead, skipping rows
    // outside the image and chunks outside the tensor: the reader below
    // zeroes what lies outside the image, whatever the buffer holds there.
    const int CPR = raw_chunks(Cn);
    const int64_t numel = static_cast<int64_t>(N) * H * W * Cn;
    auto row_start = [&](int img, int h, int w0) {
      return ((static_cast<int64_t>(img) * H + h) * W + w0 - 1) * Cn;
    };
    auto load_raw = [&](int t) {
      if (t < t_end) {
        const int w0 = t % tiles_w * TW;
        const int h0 = t / tiles_w % tiles_h * TH;
        const int img = t / (tiles_w * tiles_h);
        unsigned char* rb = raw0 + (t - t_begin) % RAW * (PH * CPR * 16);
        for (int i = p; i < PH * CPR; i += PRODUCERS) {
          const int pr = i / CPR, q = i % CPR;
          const int h = h0 + pr - 1;
          if (h < 0 || h >= H) continue;
          const int64_t g0 =
              (row_start(img, h, w0) & ~static_cast<int64_t>(7)) + 8 * q;
          if (g0 < 0 || g0 >= numel) continue;
          const int n8 = numel - g0 < 8 ? static_cast<int>(numel - g0) : 8;
          narrow::cp_async16(rb + i * 16, xs + g0, 2 * n8);
        }
      }
      narrow::cp_async_commit();   // one group a tile, empty past the end
    };
    // Line (pr, c) of the tile, one a thread (two past 128 lines): its 18
    // pixels' channel c from the raw rows, zero outside the image, written
    // transposed into the three shifted copies, 32 bytes each (pixels dx ..
    // dx + 15 of copy dx, plane (dx, c), row pr).
    auto put = [&](int t, unsigned char* st) {
      const int w0 = t % tiles_w * TW;
      const int h0 = t / tiles_w % tiles_h * TH;
      const int img = t / (tiles_w * tiles_h);
      const uint32_t rb =
          smem_u32(raw0 + (t - t_begin) % RAW * (PH * CPR * 16));
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const int l = p + j * PRODUCERS;
        if (l >= PH * Cn) continue;
        const int pr = l / Cn, c = l % Cn;
        const int h = h0 + pr - 1;
        const bool row = h >= 0 && h < H;
        const uint32_t src =
            rb + pr * CPR * 16 +
            2 * (static_cast<int>(row_start(img, h, w0) & 7) + c);
        uint32_t v[PWN];
#pragma unroll
        for (int q = 0; q < PWN; ++q) {
          const int w = w0 + q - 1;
          v[q] = row && w >= 0 && w < W ? lds_u16(src + 2 * q * Cn) : 0u;
        }
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const uint32_t a =
              smem_u32(st + (dx * Cn + c) * PLANE + pr * (TW * 2));
          uint32_t u[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            u[e] = v[dx + 2 * e] | (v[dx + 2 * e + 1] << 16);
          asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
                       "r"(u[0]), "r"(u[1]), "r"(u[2]), "r"(u[3])
                       : "memory");
          asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                           a + 16),
                       "r"(u[4]), "r"(u[5]), "r"(u[6]), "r"(u[7])
                       : "memory");
        }
      }
    };
    int s = 0;
    uint32_t phase = 0;
    for (int k = 0; k < RAW - 1; ++k) load_raw(t_begin + k);
    for (int t = t_begin; t < t_end; ++t) {
      narrow::cp_async_wait<RAW - 2>();   // this tile's copies, then all
      asm volatile("bar.sync 1, %0;\n" ::"n"(PRODUCERS) : "memory");
      sm90::mbar_wait(&empty[s], phase ^ 1);
      if (p == 0) {
        const int w0 = t % tiles_w * TW;
        const int h0 = t / tiles_w % tiles_h * TH;
        const int img = t / (tiles_w * tiles_h);
        sm90::mbar_arrive_expect_tx(&full[s], WIDE_TX);
        sm90::tma_load_4d(smem + s * WIDE_TX, &wmap, &full[s], n0, w0, h0,
                          img);
      }
      put(t, nar0 + s * nb);
      sm90::mbar_arrive(&full[s]);
      // into the buffer read one tile ago, before this tile's barrier
      load_raw(t + RAW - 1);
      if (++s == S) {
        s = 0;
        phase ^= 1;
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    // this lane's ldmatrix row: M row m (matrix lane / 8: rows +8 for odd,
    // k +8 for lane >= 16), at its tap's shifted copy, channel plane and
    // patch row dy; a pad row reads the zero plane
    int aoff[MT];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const int m = 64 * mi + 16 * warp + 8 * ((lane >> 3) & 1) + (lane & 7);
      const int tap = m / Cn, c = m % Cn;
      aoff[mi] = (m < 9 * Cn ? ((tap % 3) * Cn + c) * PLANE +
                                   (tap / 3) * (TW * 2)
                             : 3 * Cn * PLANE) +
                 16 * (lane >> 4);
    }
    float acc[MT][32];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[mi][i] = 0.f;
    const uint32_t wide0 = smem_u32(smem), nar0s = smem_u32(nar0);
    int s = 0;
    uint32_t phase = 0;
    for (int t = t_begin; t < t_end; ++t) {
      sm90::mbar_wait(&full[s], phase);
      const uint32_t ws = wide0 + s * WIDE_TX;
      const uint32_t ns = nar0s + s * nb;
      uint32_t afrag[2][MT][4];
#pragma unroll
      for (int r = 0; r < TH; ++r) {
        // B: the wide tile's pixel rows 16r .. 16r+15 (K) x 64 channels
        // (N), N-major, 8 rows are 1024 bytes
        const uint64_t desc = sm90::wgmma_desc(ws + r * 2048, 8192, 1024, 1);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
          sm90::ldmatrix_x4(afrag[r & 1][mi], ns + aoff[mi] + r * (TW * 2));
        sm90::wgmma_fence();
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
          sm90::wgmma_rs<64, 1>(acc[mi], afrag[r & 1][mi], desc);
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();
      }
      sm90::wgmma_wait<0>();
      if (lane == 0) sm90::mbar_arrive(&empty[s]);
      if (++s == S) {
        s = 0;
        phase ^= 1;
      }
    }
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) sm90::fence_regs(acc[mi]);

    // Accumulator i of M tile mi: row m = 64 mi + 16 warp + lane / 4 (+8
    // for i % 4 >= 2) = (tap, c), wide channel n0 + 8 (i / 4) + 2 (lane %
    // 4) + i % 2. The stem's dW[tap][c][w] (pairs adjacent), the head's
    // dW[8 - tap][w][c].
    float* dst = out + static_cast<int64_t>(split) * 9 * Cw * Cn;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = 64 * mi + 16 * warp + (lane >> 2) + 8 * half;
        if (m >= 9 * Cn) continue;
        const int tap = m / Cn, c = m % Cn;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int w = n0 + 8 * j + 2 * (lane & 3);
          if (w >= Cw) continue;   // Cw % 8 == 0: w + 1 is in range too
          const float v0 = acc[mi][4 * j + 2 * half];
          const float v1 = acc[mi][4 * j + 2 * half + 1];
          if constexpr (HEAD) {
            float* q =
                dst + (static_cast<int64_t>(8 - tap) * Cw + w) * Cn + c;
            q[0] = v0;
            q[Cn] = v1;
          } else {
            *reinterpret_cast<float2*>(
                dst + (static_cast<int64_t>(tap) * Cn + c) * Cw + w) =
                make_float2(v0, v1);
          }
        }
      }
  }
}

template <int MT, bool HEAD>
cudaError_t launch(const CUtensorMap& wmap, const __nv_bfloat16* nar,
                   float* dst, int N, int H, int W, int Cw, int Cn,
                   int splits, cudaStream_t stream) {
  auto kern = conv3x3_wgrad_packed_kernel<MT, HEAD>;
  const int smem = smem_bytes(Cn);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Cw + 63) / 64, splits);
  kern<<<grid, THREADS, smem, stream>>>(wmap, nar, dst, N, H, W, Cw, Cn,
                                         stages(Cn), splits);
  return cudaGetLastError();
}

// x-side (the stem): x narrow, g wide; g-side (the head): g narrow, x wide
cudaError_t run(const __nv_bfloat16* x, const __nv_bfloat16* g, float* dst,
                int N, int H, int W, int Cin, int Cout, int splits,
                cudaStream_t stream) {
  const bool head = Cout % 8 != 0;
  const __nv_bfloat16* wide = head ? x : g;
  const __nv_bfloat16* nar = head ? g : x;
  const int Cw = head ? Cin : Cout, Cn = head ? Cout : Cin;
  if (reinterpret_cast<uintptr_t>(nar) & 15)   // its 16-byte vector loads
    return cudaErrorInvalidValue;
  if (static_cast<int64_t>(N) * ((H + TH - 1) / TH) * ((W + TW - 1) / TW) >
      2147483647LL)
    return cudaErrorInvalidConfiguration;
  CUtensorMap wmap;
  const uint64_t d[4] = {static_cast<uint64_t>(Cw), static_cast<uint64_t>(W),
                         static_cast<uint64_t>(H), static_cast<uint64_t>(N)};
  const uint64_t st[3] = {2ull * Cw, 2ull * Cw * W, 2ull * Cw * W * H};
  const uint32_t box[4] = {64, TW, TH, 1};
  if (!sm90::encode_bf16_map(&wmap, wide, 4, d, st, box))
    return cudaErrorInvalidValue;
  const int mt = m_tiles(Cn);
  if (mt == 1)
    return head ? launch<1, true>(wmap, nar, dst, N, H, W, Cw, Cn, splits,
                                  stream)
                : launch<1, false>(wmap, nar, dst, N, H, W, Cw, Cn, splits,
                                   stream);
  if (mt == 2)
    return head ? launch<2, true>(wmap, nar, dst, N, H, W, Cw, Cn, splits,
                                  stream)
                : launch<2, false>(wmap, nar, dst, N, H, W, Cw, Cn, splits,
                                   stream);
  if (mt == 3)
    return head ? launch<3, true>(wmap, nar, dst, N, H, W, Cw, Cn, splits,
                                  stream)
                : launch<3, false>(wmap, nar, dst, N, H, W, Cw, Cn, splits,
                                   stream);
  return cudaErrorInvalidValue;
}

}  // namespace pk



}  // namespace

// 1: the wgmma path takes (Cin, Cout); 2: the packed path (one side
// narrow enough to pack 9 taps x its channels into M <= pk::M_MAX = 192,
// the other side a multiple of 8); 0: the narrow path.
extern "C" int conv3x3_wgrad_path(int Cin, int Cout) {
  if (Cin % 8 == 0 && Cout % 8 == 0) return 1;
  if ((Cin % 8 != 0 && 9 * Cin <= pk::M_MAX && Cout % 8 == 0) ||
      (Cout % 8 != 0 && 9 * Cout <= pk::M_MAX && Cin % 8 == 0))
    return 2;
  return 0;
}

// Pixel tiles of the split-K range (every path walks 8 x 16 tiles): the
// wrapper picks splits <= this.
extern "C" long long conv3x3_wgrad_pixel_tiles(int N, int H, int W) {
  return static_cast<long long>(N) * ((H + wg::TH - 1) / wg::TH) *
         ((W + wg::TW - 1) / wg::TW);
}

// Output tiles (blocks per split) of the path that takes (Cin, Cout): the
// wrapper sizes the split-K from this.
extern "C" long long conv3x3_wgrad_out_tiles(int Cin, int Cout) {
  const int path = conv3x3_wgrad_path(Cin, Cout);
  if (path == 2)   // the wide side's 64-channel tiles
    return ((Cout % 8 != 0 ? Cin : Cout) + 63) / 64;
  if (path == 1)
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
  const int path = conv3x3_wgrad_path(Cin, Cout);
  cudaError_t err =
      path == 1   ? wg::run(xb, gb, dst, N, H, W, Cin, Cout, splits, st)
      : path == 2 ? pk::run(xb, gb, dst, N, H, W, Cin, Cout, splits, st)
                  : narrow::run(xb, gb, dst, N, H, W, Cin, Cout, splits, st);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int64_t size = static_cast<int64_t>(9) * Cin * Cout;
  const int64_t blocks = (size + 255) / 256;
  sum_splits_kernel<<<static_cast<unsigned>(blocks < 1056 ? blocks : 1056),
                      256, 0, st>>>(dst, of, size, splits);
  return static_cast<int>(cudaGetLastError());
}
