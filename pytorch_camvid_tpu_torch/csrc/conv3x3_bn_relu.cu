// Fused conv3x3 (pad 1, stride 1) + per-channel affine + optional ReLU, NHWC
// bf16 in / bf16 out, f32 accumulation, for Hopper (sm_90a).
//
//     out[n,h,w,co] = relu( sum_{dy,dx,ci} x[n,h+dy-1,w+dx-1,ci] * W[dy,dx,ci,co]
//                           * A[co] + B[co] )
//
// Replaces the TPU kernel pytorch_camvid_tpu/ops/pallas_conv.py::_conv3x3_impl
// (body _conv_kernel): the eval-mode conv+BN+ReLU block with BN folded into
// (A, B), and through ops/conv_train.py the training conv's forward
// (pallas_conv_train.py::_conv3x3_fwd) and input gradient (_vjp_bwd). The
// TPU-only workarounds of that kernel (the Cin<128 zero pad, the flat
// 8-aligned padded layout with its garbage columns, the cross-grid-step DMA
// prefetch, the VMEM tile picker) have no counterpart here.
//
// ``flip`` = 1 computes the input gradient of a conv with forward weights
// w (3,3,Cout,Cin) (this call's Cin is that conv's Cout): the taps are read
// reversed and the two channel axes swapped, W'[t][ci][co] = w[8-t][co][ci],
// in place, with no weight copy.
//
// Three paths, chosen by conv3x3_bn_relu_path(Cin, Cout) (the wrapper holds
// the same rule, ops/fused_conv.py::conv_path):
//
// * wgmma (Cin % 8 == 0, and Cout % 8 == 0 above 16 or, the head tile,
//   Cout <= 24 with Cin <= 128). An implicit GEMM, M = output pixels, N =
//   output channels, K = 9 taps x Cin in 64-channel chunks, on a
//   warp-specialised persistent block of three warpgroups: two producer
//   threads of the third issue TMA loads into rings guarded by full/empty
//   mbarriers, one for the patches and one for the weights, so neither
//   ring waits for the other; two consumer warpgroups run wgmma.m64nNk16
//   (bf16, f32 accumulators in registers), and setmaxnreg moves registers
//   from the producers to them. Per chunk one TMA box loads the (TH+2) x
//   18 x 64 input patch with the 128-byte swizzle through a 4-D tensor map
//   over x (C, W, H, N): the halo's coordinates lie outside the image and
//   TMA fills them with zero, so there are no bounds checks. The weights
//   come one tap at a time (64 x N bf16), N-major W[tap][ci][co] for the
//   forward (the descriptor's transpose bit set) or K-major W[8-tap][co][ci]
//   for flip. A is read from registers: each warp loads its 16 pixels x 16
//   channels of tap (dy, dx) with ldmatrix straight out of the patch at the
//   tap's shifted row, the swizzle XOR in the address, so one staged patch
//   serves all 9 taps (option (a); three shifted copies for A in shared
//   memory would take 3x the patch's shared memory and halve the tile).
//   The wgmmas of two (RES: four) k16 steps go out as one commit group,
//   their A fragments double-buffered across groups (wgmma.wait_group 1).
//   Tiles: TW = 16 columns, each warp one output row per m64 tile, 128
//   accumulators per consumer thread: N = 256 (TH = 8) or 128 (TH = 16) by
//   Cout, streaming the weights through a 3- or 4-stage ring; N = 64 with
//   Cin > 64 (TH = 32, 4 stages); N = 64 with Cin <= 64 (RES, TH = 16),
//   whose 9 taps stay resident (a block keeps one channel tile: the grid is
//   a multiple of the channel tiles). The epilogue is acc * A[co] + B[co],
//   the optional ReLU and bf16; each warp writes its output row into shared
//   memory (128-byte swizzle, conflict-free) and hands it to a TMA store
//   that runs while the next tile's wgmmas do and drops what lies past H,
//   W or Cout.
//   The head tile (Cout <= 24: the 64->12 CamVid head at N = 16, VOC's
//   64->21 head at N = 24, wgmma.m64n24k16; TMA cannot describe their 24-
//   and 42-byte weight and output rows) loads the block's 9 x Cin x N
//   weights once, zero-padded to N and to whole 64-channel chunks, into a
//   no-swizzle K-major tile (Tile<N>::SMEM: 195,616 B at N 16, 214,048 at
//   N 24, both below a block's 232,448), and takes TH = 32 rows a tile (MT
//   = 4, 32 or 48 accumulators a consumer thread). It is bound by bytes:
//   VOC's head at 360x480, batch 24, reads 531 MB of x and writes 174 MB,
//   0.210 ms at 3.35 TB/s, while its 100 GFLOP (115 at N = 24) take 0.10
//   ms at the tensor rate. So the design keeps x's stream whole (one TMA
//   box a tile, every tap from it) and the MMA padding small (24 of 21
//   channels, where the narrow path's mma.sync tile was 64 wide); the
//   epilogue stores each pixel's channels directly, masked, pairs as one
//   4-byte store where the address allows (every other pixel at odd Cout).
// * packed (Cin % 8 != 0 with 9 x Cin <= K_MAX = 192, and Cout % 8 == 0:
//   the Cin = 3 stem's forward and the input gradients of the 64->12 and
//   64->21 heads, Cin 12 and 21). Bound by the bytes it writes: at
//   360x480, batch 24, it reads 25 MB (stem), 100 MB (Cin 12) or 174 MB
//   (Cin 21) and writes 531 MB of 64-channel output, so its bound is
//   0.17-0.21 ms, while its FLOPs (14-100 G) take 0.01-0.10 ms at the
//   tensor rate. The design keeps the tensor cores off the critical path
//   and the output stream moving: K packs the 9 taps x Cin tap-major, k =
//   (3 dy + dx) Cin + ci, padded to a multiple of 16 (K = 32 at Cin 3, 112
//   at Cin 12, 192 at Cin 21: 2, 7 and 12 k16 steps, where a 32-channel
//   chunk per tap took 18). Each persistent block (two per SM, a fixed
//   tile of 64 output channels) loads its K x 64 weights once, applying
//   flip and the zero padding in that load, and walks tiles of 8 rows x 32
//   columns. A tile's input rows, (TW + 2) x Cin contiguous elements each,
//   are read as 16-byte vectors into registers while the previous tile
//   computes and written after it into a double-buffered patch at any
//   element alignment (the halo outside the image zero); A fragments are
//   gathered straight from the patch at each packed k (32-bit pairs when
//   Cin is even, 16-bit values when it is odd), at per-lane offsets held
//   in registers up to Cin 12 and past it in a shared table, one 8-byte
//   read a k16 step (at Cin 21 the 12 steps' offsets in registers made
//   ptxas spill 116 B, and the dx ran 12% slower); B comes by ldmatrix
//   from the resident weights, mma.sync m16n8k16 accumulates in f32. Each
//   warp stages its output row (32 pixels x 128 bytes, swizzled) and
//   hands it to a TMA store that runs while the next tile computes and
//   clips H, W and Cout. Shared memory (Geo<CIN>::SMEM): 46,400 B at Cin
//   3, 79,808 at 12, 114,176 at 21, so two blocks fit an SM at every Cin.
//   Instances: Cin 1-7, 9-15 and 17-21, every Cin the rule admits.
// * narrow (every other shape: Cin % 8 != 0 above K_MAX / 9 or into
//   Cout % 8 != 0, Cout % 8 != 0 above 24, a head-like Cin > 128 into
//   Cout <= 24). Models run it: UNet at width 9/16 (channels 36 and 72)
//   sends seven of its 23 blocks here (the stem 3->36, 36->36 x2, 72->36
//   x2, 36->72, the head 36->12) and six dx (36->36 x2, 36->72 x2, 72->36,
//   12->36); a head past 24 classes and off a multiple of 8 (ADE20K's 150)
//   its forward 64->150 and dx 150->64. Bound by bytes: at 360x480, batch
//   8, 36->36 moves 199 MB (0.059 ms at 3.35 TB/s) for 32 GFLOP (0.033 ms
//   at the tensor rate); every UNet 9/16 shape sits at 160-220 FLOP a
//   byte, under the ridge. So the design reads x once, in 16-byte chunks,
//   whatever Cin's alignment, writes the output once in 16-byte chunks,
//   and keeps the tensor work's padding small (K = 9 x Cin packed, N =
//   Cout rounded up to 8): a persistent block (one channel tile, its
//   weights resident: 9 x Cin x N bf16 in wgmma's K-major layout, zero
//   past K and Cout, read once under flip tap-reversed and transposed)
//   walks tiles of 8 x MT rows x 16 columns. A tile's 8 MT + 2 input rows,
//   (16 + 2) x Cin contiguous elements each, come as the 16-byte chunks of
//   x that hold them (cp.async, the next tile's while this one computes) to a
//   row stride = W x Cin mod 8, so that any element offset lands on a
//   16-byte boundary; the columns outside the image are zeroed after.
//   Each warpgroup runs wgmma.m64nNk16 with A from registers, gathered per
//   lane at a shared table's offsets of packed k (the register form: the
//   patch is not in wgmma's canonical layout) for MT m64s on the same
//   weights, and N as a sum of wgmma sizes (40 = 32 + 8). The epilogue
//   stages each output row of 16 pixels x Cout, contiguous in NHWC, at
//   the offset that aligns it with out, and writes it in 16-byte chunks.
//   Instances: N 16-128 (Cout past 128 or weights past shared memory split
//   into channel tiles, 64->150 into two of 80), MT 2 up to N 40 where two
//   stages fit. The rest of its cost is shared memory: the A gather reads
//   2 bytes a (pixel, k), the pixel order per lane chosen to spread them
//   over the banks. Past Cin ~330 no tile fits and the first design,
//   namespace mma_sync, takes the call (no model reaches it; chip_smoke's
//   350->12 does), and the C entry reports it as route 3.
//
// What bounds it on the H100 (989 TFLOP/s bf16, 3.35 TB/s: ridge ~295
// FLOP/byte): every block shape with Cin, Cout >= 64 has 290 to several
// thousand FLOP per byte of input+output, so it is compute-bound if the
// tensor cores are fed. They are fed from shared memory: a wgmma
// m64nNk16 reads its 32N-byte B there whatever N is (64 B per cycle at the
// tensor cores' rate) and the A fragments cost 4096/N more (ldmatrix), so
// N = 64 needs the SM's whole 128 B per cycle, N = 128 96 and N = 256 80.
// Shared memory, more than L2, bounds it: at N = 256 the weights are
// re-read from L2 for every 128-pixel tile (2.9 GB per call at 22x30
// 1024->1024, batch 24), yet those shapes run at 0.5-0.7 of the tensor
// rate, and the N = 64 shapes at about half of it. ptxas serializes each
// warpgroup's wgmmas in the instances that hold 128 accumulators and
// stream their weights, for want of registers; the two consumer
// warpgroups overlap one another's. The epilogue's TMA store took 40% off
// the shallow shapes, whose direct 4-byte stores had bound them. The heads
// (~90 FLOP/byte), the stem (~26) and the heads' dx (~90) are bound by
// bytes.

#include "sm90_common.cuh"

#include <array>
#include <mutex>
#include <type_traits>

namespace {

using sm90::smem_u32;

// ============================================================== mma_sync

// The first design, kept for the shapes the narrow path's plan holds no tile
// of (Cin past ~330, where a tile's patch rows and resident weights pass a
// block's shared memory; no model runs one): mma.sync m16n8k16 from a
// cp.async double-buffered patch and weight slice, 32 channels a chunk,
// scalar loads where a channel count is not a multiple of 8 or the weights
// are read under flip.
namespace mma_sync {

constexpr int TH = 8;            // output rows per block tile
constexpr int TW = 16;           // output cols per block tile (= one m16 tile)
constexpr int PH = TH + 2;       // patch rows (with halo)
constexpr int PW = TW + 2;       // patch cols (with halo)
constexpr int KC = 32;           // input channels per staged chunk
constexpr int KCP = KC + 8;      // padded patch pixel stride (80 B: ldmatrix
                                 // rows hit distinct banks)
constexpr int BN = 64;           // output channels per block tile
constexpr int BNP = BN + 8;      // padded weight row stride (144 B)
constexpr int THREADS = 256;     // 8 warps: 4 along M x 2 along N

constexpr int PATCH_ELEMS = PH * PW * KCP;
constexpr int WTILE_ELEMS = 9 * KC * BNP;
constexpr int STAGE_ELEMS = PATCH_ELEMS + WTILE_ELEMS;
constexpr int SMEM_BYTES = 2 * STAGE_ELEMS * 2;  // two stages of bf16

// Stage input channels [c0, c0+KC) of the patch around output tile
// (n, h0, w0) and the matching weight slice for output channels [n0, n0+BN).
// VEC_X: Cin % 8 == 0 and x 16-byte aligned -> 16-byte cp.async per 8
// channels; otherwise scalar loads. VEC_W likewise for Cout % 8 == 0
// (every FLIP call takes scalar loads).
// FLIP reads W'[tap][ci][co] = w[8-tap][co][ci].
template <bool VEC_X, bool VEC_W, bool FLIP>
__device__ __forceinline__ void stage_chunk(
    __nv_bfloat16* patch, __nv_bfloat16* wt, const __nv_bfloat16* __restrict__ x,
    const __nv_bfloat16* __restrict__ w, int n, int h0, int w0, int n0, int c0,
    int H, int W, int Cin, int Cout) {
  const int tid = threadIdx.x;
  const int64_t img_base = static_cast<int64_t>(n) * H * W;
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
      sm90::cp_async16(smem_u32(patch + pix * KCP + v * 8), src,
                       ok ? 16 : 0);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int i = tid; i < PH * PW * KC; i += THREADS) {
      const int pix = i / KC, k = i % KC;
      const int h = h0 + pix / PW - 1, ww = w0 + pix % PW - 1;
      const int c = c0 + k;
      const bool ok = h >= 0 && h < H && ww >= 0 && ww < W && c < Cin;
      patch[pix * KCP + k] =
          ok ? x[(img_base + static_cast<int64_t>(h) * W + ww) * Cin + c]
             : zero;
    }
  }
  if (VEC_W) {
    constexpr int VPR = BN / 8;  // 16-byte vectors per weight row
    for (int i = tid; i < 9 * KC * VPR; i += THREADS) {
      const int row = i / VPR, v = i % VPR;  // row = tap * KC + k
      const int tap = row / KC, k = row % KC;
      const int ci = c0 + k, co = n0 + v * 8;
      const bool ok = ci < Cin && co < Cout;
      const __nv_bfloat16* src =
          ok ? w + ((static_cast<int64_t>(tap) * Cin + ci) * Cout + co) : w;
      sm90::cp_async16(smem_u32(wt + row * BNP + v * 8), src,
                       ok ? 16 : 0);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int i = tid; i < 9 * KC * BN; i += THREADS) {
      const int row = i / BN, j = i % BN;
      const int tap = row / KC, k = row % KC;
      const int ci = c0 + k, co = n0 + j;
      const bool ok = ci < Cin && co < Cout;
      // the weights hold < 2^31 elements (checked by the wrapper)
      const int idx = FLIP ? ((8 - tap) * Cout + co) * Cin + ci
                           : (tap * Cin + ci) * Cout + co;
      wt[row * BNP + j] = ok ? w[idx] : zero;
    }
  }
}

template <bool VEC_X, bool VEC_W, bool FLIP>
__global__ void __launch_bounds__(THREADS, 2)
    conv3x3_bn_relu_narrow_kernel(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ w,
                          const float* __restrict__ scale,
                          const float* __restrict__ shift,
                          __nv_bfloat16* __restrict__ out, int N, int H,
                          int W, int Cin, int Cout, int relu) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  // Block -> (image, tile row, tile col, cout tile); the cout tile varies
  // fastest so blocks that share an input patch run close together.
  const int tiles_h = (H + TH - 1) / TH;
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_co = (Cout + BN - 1) / BN;
  int64_t bid = blockIdx.x;
  const int tco = static_cast<int>(bid % tiles_co);
  bid /= tiles_co;
  const int tw = static_cast<int>(bid % tiles_w);
  bid /= tiles_w;
  const int th = static_cast<int>(bid % tiles_h);
  const int n = static_cast<int>(bid / tiles_h);
  const int h0 = th * TH, w0 = tw * TW, n0 = tco * BN;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp & 3;   // warp rows: tile rows 2*wm, 2*wm+1
  const int wn = warp >> 2;  // warp cols: channels wn*32 .. wn*32+31

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;

  // Per-lane ldmatrix row offsets (elements, within one stage).
  // A: lane l reads pixel column (l & 15) of its m16 tile, channels
  //    +(l >> 4) * 8 -> the four 8x8 matrices a0..a3 of m16n8k16.
  // B: lane l reads weight row k = (l & 15), columns +(l >> 4) * 8 ->
  //    (b0,b1) of two adjacent n8 tiles under .trans.
  int a_off[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
    a_off[mt] = ((2 * wm + mt) * PW + (lane & 15)) * KCP + (lane >> 4) * 8;
  const int b_off = (lane & 15) * BNP + wn * 32 + (lane >> 4) * 8;

  const int nchunks = (Cin + KC - 1) / KC;
  stage_chunk<VEC_X, VEC_W, FLIP>(smem, smem + PATCH_ELEMS, x, w, n, h0, w0,
                                  n0, 0, H, W, Cin, Cout);
  sm90::cp_async_commit();

  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) {
      __nv_bfloat16* nxt = smem + ((c + 1) & 1) * STAGE_ELEMS;
      stage_chunk<VEC_X, VEC_W, FLIP>(nxt, nxt + PATCH_ELEMS, x, w, n, h0,
                                      w0, n0, (c + 1) * KC, H, W, Cin, Cout);
      sm90::cp_async_commit();
      sm90::cp_async_wait<1>();
    } else {
      sm90::cp_async_wait<0>();
    }
    __syncthreads();

    const __nv_bfloat16* cur = smem + (c & 1) * STAGE_ELEMS;
    const uint32_t patch_s = smem_u32(cur);
    const uint32_t wt_s = smem_u32(cur + PATCH_ELEMS);

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          sm90::ldmatrix_x4(a[mt], patch_s + 2 * (a_off[mt] +
                                                  (dy * PW + dx) * KCP + kk));
        uint32_t b[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          sm90::ldmatrix_x4_trans(
              b[j], wt_s + 2 * (b_off + (tap * KC + kk) * BNP + j * 16));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            sm90::mma_bf16_16816(acc[mt][nt], a[mt], b[nt >> 1][(nt & 1) * 2],
                           b[nt >> 1][(nt & 1) * 2 + 1]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration
  }

  // Epilogue: C fragment rows g / g+8 are tile columns, cols 2t, 2t+1 are
  // channels.
  const int g = lane >> 2, t4 = lane & 3;
  const bool pair_store = (Cout % 2) == 0;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int h = h0 + 2 * wm + mt;
    if (h >= H) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ww = w0 + g + half * 8;
      if (ww >= W) continue;
      __nv_bfloat16* orow =
          out + ((static_cast<int64_t>(n) * H + h) * W + ww) * Cout;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int co = n0 + wn * 32 + nt * 8 + t4 * 2;
        if (co >= Cout) continue;
        float v0 = acc[mt][nt][half * 2] * scale[co] + shift[co];
        if (relu) v0 = fmaxf(v0, 0.f);
        if (pair_store) {  // co even and Cout even -> co+1 < Cout, 4B aligned
          float v1 = acc[mt][nt][half * 2 + 1] * scale[co + 1] + shift[co + 1];
          if (relu) v1 = fmaxf(v1, 0.f);
          *reinterpret_cast<__nv_bfloat162*>(orow + co) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          orow[co] = __float2bfloat16(v0);
          if (co + 1 < Cout) {
            float v1 =
                acc[mt][nt][half * 2 + 1] * scale[co + 1] + shift[co + 1];
            if (relu) v1 = fmaxf(v1, 0.f);
            orow[co + 1] = __float2bfloat16(v1);
          }
        }
      }
    }
  }
}

template <bool VEC_X, bool VEC_W, bool FLIP>
cudaError_t launch(const __nv_bfloat16* x, const __nv_bfloat16* w,
                   const float* a, const float* b, __nv_bfloat16* out, int N,
                   int H, int W, int Cin, int Cout, int relu,
                   cudaStream_t stream) {
  auto kern = conv3x3_bn_relu_narrow_kernel<VEC_X, VEC_W, FLIP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const int64_t blocks = static_cast<int64_t>(N) * ((H + TH - 1) / TH) *
                         ((W + TW - 1) / TW) * ((Cout + BN - 1) / BN);
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  kern<<<static_cast<unsigned>(blocks), THREADS, SMEM_BYTES, stream>>>(
      x, w, a, b, out, N, H, W, Cin, Cout, relu);
  return cudaGetLastError();
}

cudaError_t run(const __nv_bfloat16* x, const __nv_bfloat16* w,
                const float* a, const float* b, __nv_bfloat16* out, int N,
                int H, int W, int Cin, int Cout, int relu, int flip,
                cudaStream_t st) {
  const bool vec_x =
      Cin % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool vec_w = !flip && Cout % 8 == 0 &&
                     (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  if (flip)
    return vec_x ? launch<true, false, true>(x, w, a, b, out, N, H, W, Cin,
                                             Cout, relu, st)
                 : launch<false, false, true>(x, w, a, b, out, N, H, W, Cin,
                                              Cout, relu, st);
  if (vec_x && vec_w)
    return launch<true, true, false>(x, w, a, b, out, N, H, W, Cin, Cout,
                                     relu, st);
  if (vec_x)
    return launch<true, false, false>(x, w, a, b, out, N, H, W, Cin, Cout,
                                      relu, st);
  if (vec_w)
    return launch<false, true, false>(x, w, a, b, out, N, H, W, Cin, Cout,
                                      relu, st);
  return launch<false, false, false>(x, w, a, b, out, N, H, W, Cin, Cout,
                                     relu, st);
}

}  // namespace mma_sync

// ================================================================ narrow

namespace narrow {

constexpr int TW = 16;            // output columns per tile: a warp's 16 A rows
constexpr int PW = TW + 2;        // patch columns (with halo)
constexpr int THREADS = 256;      // two warpgroups, MT m64s of 4 rows each
constexpr int WARPS = THREADS / 32;
constexpr int MAX_N = 128;        // the widest N tile
constexpr int SMEM_MAX = 232448;  // a block's shared memory
constexpr int SMEM_SM = 233472;   // an SM's, 1,024 of it reserved a block
constexpr int MAX_STAGES = 2;     // patch stages: a tile in flight
constexpr int G = 2;              // k16 steps a wgmma commit group
constexpr int KGROUP = 2 * G;     // K padded to whole pairs of groups
constexpr int MAX_N_MT2 = 40;     // the widest N at two m64s a warpgroup
constexpr uint32_t NO_K = 0xFFFFFFFFu;  // a table entry past K: reads zero

// The N tiles the kernel is built for: sums of the sizes one wgmma takes
// (mma_n). Cout splits into tiles_n tiles, each the least of these that
// holds ceil(Cout / tiles_n) channels.
constexpr int BNS[] = {16, 24, 32, 40, 48, 64, 80, 96, 128};
constexpr int NBNS = sizeof(BNS) / sizeof(BNS[0]);

constexpr int up(int v, int m) { return (v + m - 1) / m * m; }

// A call's tiling and shared memory (bytes from the 16-byte aligned base):
// tiles of 8 x ``mt`` rows (each warp's row and, at mt 2, the one 8 below:
// a warpgroup's second m64 on the same weights); ``stages`` patch stages,
// each 8 mt + 2 rows of ``row`` = PW x Cin elements at
// a stride RS in [row + 14, row + 21] (RS = W x Cin mod 8, so that every
// 16-byte chunk of x lands on a 16-byte chunk of the stage), from an
// element offset below 8; the resident weights, kp x bn bf16 in wgmma's
// K-major layout without swizzle; the A offsets' table (8 B a k16 step and
// lane column, 16 at odd Cin); the affine's 2 x bn floats and a zero word;
// each warp's output row, 16 pixels at a pixel stride ``ops`` (= Cout when
// one tile holds every channel: the row is one contiguous run).
struct Plan {
  int bn, mt, tiles_n, kp, ksteps, row, ops, stages, blocks, stage_bytes;
  int w_off, tab_off, ab_off, out_off, out_warp_bytes, smem;
};

constexpr Plan geometry(int cin, int cout, int bn, int mt) {
  Plan p{};
  p.bn = bn;
  p.mt = mt;
  p.tiles_n = (cout + bn - 1) / bn;
  p.kp = up(9 * cin, 16 * KGROUP);
  p.ksteps = p.kp / 16;
  p.row = PW * cin;
  p.stage_bytes = up(2 * ((8 * mt + 2) * (p.row + 21) + 16), 128);
  p.ops = p.tiles_n == 1 ? cout : bn + ((cout - bn) % 8 + 8) % 8;
  p.out_warp_bytes = up(2 * (16 * p.ops + 8), 128);  // one row at a time
  const int w = up(p.kp * bn * 2, 128);
  const int tab = up(p.ksteps * 4 * (cin % 2 ? 16 : 8), 128);
  const int ab = up(8 * bn + 16, 128);
  const int fixed = w + tab + ab + WARPS * p.out_warp_bytes;
  // the patch stages, two where they fit (more timed the same): at two
  // blocks an SM where each holds two (BN <= 80: 128 registers a thread),
  // so that one block's loads and epilogue run beside the other's wgmmas;
  // else at one block
  p.stages = 0;
  for (int blocks = bn <= 80 ? 2 : 1; blocks >= 1 && p.stages < 2;
       --blocks) {
    int st = (SMEM_SM / blocks - 1024 - fixed) / p.stage_bytes;
    p.stages = st < MAX_STAGES ? st : MAX_STAGES;
    p.blocks = blocks;
  }
  if (p.stages < 1) p.stages = 1;  // too big: smem > SMEM_MAX below
  p.w_off = p.stages * p.stage_bytes;
  p.tab_off = p.w_off + w;
  p.ab_off = p.tab_off + tab;
  p.out_off = p.ab_off + ab;
  p.smem = p.out_off + WARPS * p.out_warp_bytes;
  return p;
}

// The plan of (Cin, Cout): the widest N tile (at most MAX_N, Cout split
// evenly) whose patch stages, weights and staging fit a block, at two m64s
// a warpgroup where N <= MAX_N_MT2 and two stages fit, else one; smem 0
// where none fits (Cin past ~330).
// ops/fused_conv.py::narrow_fwd_plan holds the same rule.
constexpr Plan plan(int cin, int cout) {
  for (int tn = (cout + MAX_N - 1) / MAX_N;; ++tn) {
    const int want = (cout + tn - 1) / tn;
    int bn = BNS[NBNS - 1];
    for (int i = NBNS - 1; i >= 0; --i)
      if (BNS[i] >= want) bn = BNS[i];
    if (bn <= MAX_N_MT2) {
      const Plan p = geometry(cin, cout, bn, 2);
      if (p.smem <= SMEM_MAX && p.stages >= 2) return p;
    }
    const Plan p = geometry(cin, cout, bn, 1);
    if (p.smem <= SMEM_MAX) return p;
    if (bn == BNS[0]) return Plan{};
  }
}
static_assert(plan(3, 36).smem == 21632, "UNet 9/16's stem");
static_assert(plan(36, 36).smem == 90496, "UNet 9/16's 36->36");
static_assert(plan(72, 36).smem == 163328, "UNet 9/16's 72->36");
static_assert(plan(36, 72).smem == 109312, "UNet 9/16's 36->72");
static_assert(plan(36, 12).smem == 65792, "UNet 9/16's head");
static_assert(plan(12, 36).smem == 38272, "the head's dx");
static_assert(plan(64, 150).smem == 163712, "a 150-class head");
static_assert(plan(150, 64).smem == 211584, "its dx");

// The call's figures, by value in the kernel's parameters.
struct Geo {
  int tiles_n, ksteps, row, rs, stages, stage_bytes;
  int w_off, tab_off, ab_off, out_off, out_warp_bytes, ops, il;
};

// The A rows of lane group g8 (0..7) of a warp: the tile's pixels g8 and
// g8 + 8, or with ``il`` 2 g8 and 2 g8 + 1. The gather's 32 lanes read
// 8 pixels x 4 words at a pixel stride of Cin / 2 words; il is the order
// whose words fall on fewer banks at once (at Cin 36, 18 words: 2 g8 puts
// the 8 pixels 4 banks apart, one wavefront a load where g8 takes two).
// conflicts: the most distinct words one bank serves in a load.
int conflicts(int cin, bool il) {
  int worst = 0;
  for (int set = 0; set < 2; ++set) {
    int words[32], per_bank[32] = {};
    for (int l = 0; l < 32; ++l) {
      const int g8 = l >> 2, px = il ? 2 * g8 + set : g8 + 8 * set;
      words[l] = (px * cin + 2 * (l & 3)) >> 1;
      bool first = true;
      for (int m = 0; m < l && first; ++m) first = words[m] != words[l];
      if (first) {
        const int n = ++per_bank[words[l] % 32];
        worst = n > worst ? n : worst;
      }
    }
  }
  return worst;
}

// il by Cin, worked out once: every Cin with a tile (up to ~345) is in it.
constexpr int IL_CINS = 512;
bool interleaved(int cin) {
  static const auto table = [] {
    std::array<bool, IL_CINS> t{};
    for (int c = 1; c < IL_CINS; ++c)
      t[c] = conflicts(c, true) < conflicts(c, false);
    return t;
  }();
  if (cin > 0 && cin < IL_CINS) return table[cin];
  return conflicts(cin, true) < conflicts(cin, false);
}

// Waits until at most n (0 or 1) of this thread's copy groups are pending.
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n)
    sm90::cp_async_wait<1>();
  else
    sm90::cp_async_wait<0>();
}
static_assert(MAX_STAGES == 2, "cp_async_wait's cases");

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ uint32_t lds16(uint32_t addr) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr));
  return v;
}

// D (64 x N) += A (registers) x B over N as a sum of the sizes wgmma_rs
// issues (40 = 32 + 8, 80 = 64 + 16, ...), each on the same A; B K-major
// without swizzle at ``wb``: 8-row groups of N 256 bytes apart, the two K
// halves 128 bytes apart.
template <int N, int OFF, int TOTAL>
__device__ __forceinline__ void mma_n(float (&acc)[TOTAL / 2],
                                      const uint32_t (&a)[4], uint32_t wb) {
  if constexpr (N > 0) {
    constexpr int P = N >= 128 ? 128 : N >= 64 ? 64 : N >= 32 ? 32
                    : N >= 24 ? 24 : N >= 16 ? 16 : 8;
    sm90::wgmma_rs<P, 0>(*reinterpret_cast<float(*)[P / 2]>(&acc[OFF / 2]),
                         a, sm90::wgmma_desc(wb + OFF * 32, 128, 256, 0));
    mma_n<N - P, OFF + P, TOTAL>(acc, a, wb);
  }
}

// PAIRED: Cin even, so packed k and k + 1 (k even) are adjacent in the
// patch and read as one 32-bit word.
template <int BN, int MT, bool PAIRED>
__global__ void __launch_bounds__(THREADS, BN <= 80 ? 2 : 1)
    conv3x3_bn_relu_narrow_kernel(const __nv_bfloat16* __restrict__ x,
                                  const __nv_bfloat16* __restrict__ w,
                                  const float* __restrict__ scale,
                                  const float* __restrict__ shift,
                                  __nv_bfloat16* __restrict__ out, int N,
                                  int H, int W, int Cin, int Cout, int relu,
                                  int flip, const Geo g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int TH = 8 * MT, PH = TH + 2;  // tile rows, patch rows
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  const int tiles_n = g.tiles_n;
  const int total = N * tiles_h * tiles_w * tiles_n;  // < 2^31 (host)
  // the grid is a multiple of tiles_n: a block keeps one channel tile
  const int n0 = blockIdx.x % tiles_n * BN;
  const int bnc = min(BN, Cout - n0);
  const int K = 9 * Cin, L = g.row, RS = g.rs, S = g.stages;
  const int64_t pitch = static_cast<int64_t>(W) * Cin;
  const int64_t xtotal = static_cast<int64_t>(N) * H * pitch;
  auto origin = [&](int t, int& img, int& h0, int& w0) {
    t /= tiles_n;
    w0 = t % tiles_w * TW;
    t /= tiles_w;
    h0 = t % tiles_h * TH;
    img = t / tiles_h;
  };
  // the element of x at patch row 0, column 0 (it may lie before x)
  auto corner = [&](int img, int h0, int w0) {
    return (static_cast<int64_t>(img) * H + h0 - 1) * pitch +
           static_cast<int64_t>(w0 - 1) * Cin;
  };

  // Resident weights, once a block: W'[k][n] for packed k = tap x Cin +
  // ci and the block's channels n0 + n, zero past K and past Cout; under
  // flip W'[tap][ci][co] = w[8 - tap][co][ci], read in place (k fastest,
  // contiguous in w). Byte (k, n) of the K-major layout: k16 step k / 16
  // at BN x 32 bytes a step, then (n / 8, (k % 16) / 8, n % 8, k % 8).
  unsigned char* wt = smem + g.w_off;
  const int kp = 16 * g.ksteps;
  for (int i = tid; i < kp * BN; i += THREADS) {
    int k, n;
    if (flip) {
      n = i / kp;
      k = i - n * kp;
    } else {
      k = i / BN;
      n = i - k * BN;
    }
    __nv_bfloat16 v = __float2bfloat16(0.f);
    if (k < K && n < bnc) {
      const int co = n0 + n;
      if (flip) {
        const int tap = k / Cin, ci = k - tap * Cin;
        v = w[(static_cast<int64_t>(8 - tap) * Cout + co) * Cin + ci];
      } else {
        v = w[static_cast<int64_t>(k) * Cout + co];
      }
    }
    const int kl = k & 15;
    *reinterpret_cast<__nv_bfloat16*>(wt + (k >> 4) * (BN * 32) +
                                      (n >> 3) * 256 + (kl >> 3) * 128 +
                                      (n & 7) * 16 + (kl & 7) * 2) = v;
  }
  sm90::fence_proxy_async();  // the wgmmas read them through the async proxy
  // the affine of the block's channels (zero past Cout) and a zero word
  float* sa = reinterpret_cast<float*>(smem + g.ab_off);
  const float* sb = sa + BN;
  for (int j = tid; j < 2 * BN + 4; j += THREADS) {
    float v = 0.f;
    if (j < bnc) v = scale[n0 + j];
    else if (j >= BN && j < BN + bnc) v = shift[n0 + j - BN];
    sa[j] = v;
  }
  const uint32_t zero_s = smem_u32(sa + 2 * BN);
  // A's offsets (bytes from the lane's pixel) of packed k for each k16
  // step s and lane column t4: k = 16 s + 2 t4 and k + 8 (PAIRED), or k,
  // k + 1, k + 8, k + 9; tap (dy, dx) = k / Cin at dy rows and dx pixels
  // on; NO_K past K.
  constexpr int TE = PAIRED ? 2 : 4;
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem + g.tab_off);
  for (int i = tid; i < g.ksteps * 4; i += THREADS) {
    const int k0 = 16 * (i >> 2) + 2 * (i & 3);
    auto off = [&](int k) -> uint32_t {
      if (k >= K) return NO_K;
      const int tap = k / Cin, ci = k - tap * Cin;
      return 2u * static_cast<uint32_t>((tap / 3) * RS + (tap % 3) * Cin +
                                        ci);
    };
    if (PAIRED) {
      tab[2 * i] = off(k0);
      tab[2 * i + 1] = off(k0 + 8);
    } else {
      tab[4 * i] = off(k0);
      tab[4 * i + 1] = off(k0 + 1);
      tab[4 * i + 2] = off(k0 + 8);
      tab[4 * i + 3] = off(k0 + 9);
    }
  }

  // A tile's patch: PH rows of x, each PW x Cin contiguous elements from
  // corner + r x pitch, copied as the 16-byte chunks of x that hold them
  // (cp.async, the rows outside the image and chunks outside x zero-
  // filled) to B + r x RS - (its offset in its first chunk), B = corner
  // mod 8: a 16-byte boundary, as RS = pitch mod 8.
  const uint32_t stage0 = smem_u32(smem);
  const int cpr = (L + 14) / 8;  // chunks a row spans, at most
  auto issue = [&](int t, int st) {
    if (t < total) {
      int img, h0, w0;
      origin(t, img, h0, w0);
      const int64_t g0 = corner(img, h0, w0);
      const int b = static_cast<int>(g0 & 7);
      const uint32_t base = stage0 + st * g.stage_bytes;
      for (int i = tid; i < PH * cpr; i += THREADS) {
        const int r = i / cpr, q = i - r * cpr;
        const int64_t gr = g0 + r * pitch;
        const int sr = static_cast<int>(gr & 7);
        const int64_t a = gr - sr + 8 * q;
        if (a >= gr + L) continue;
        const int h = h0 + r - 1;
        const bool ok = h >= 0 && h < H && a >= 0 && a < xtotal;
        // x's last chunk may end past x; the launcher gives x a storage
        // that holds it (fused_conv.whole_chunks): a clamp here cost 3.5%
        // of UNet 9/16's narrow forwards on an H100
        sm90::cp_async16(base + 2 * (b + r * RS - sr + 8 * q),
                         ok ? x + a : x, ok ? 16 : 0);
      }
    }
    sm90::cp_async_commit();  // one group a tile, empty past the end
  };

  const int g8 = lane >> 2, t4 = lane & 3;
  const int pa = g.il ? 2 * g8 : g8, pb = g.il ? 2 * g8 + 1 : g8 + 8;
  const uint32_t tab_s = smem_u32(tab) + t4 * 4 * TE;
  const uint32_t w_s = smem_u32(wt);
  unsigned short* os =
      reinterpret_cast<unsigned short*>(smem + g.out_off +
                                        warp * g.out_warp_bytes);
  unsigned short* out16 = reinterpret_cast<unsigned short*>(out);

  for (int j = 0; j < S; ++j) issue(blockIdx.x + j * gridDim.x, j);
  for (int t = blockIdx.x, it = 0; t < total; t += gridDim.x, ++it) {
    const int st = it % S;
    cp_async_wait(S - 1);  // this tile's group; S - 1 tiles stay in flight
    __syncthreads();  // this tile's patch (and the first time the weights)
    int img, h0, w0;
    origin(t, img, h0, w0);
    const int b = static_cast<int>(corner(img, h0, w0) & 7);
    // at the image's left or right edge the row's elements of columns
    // outside it came from the neighbouring row: zero them
    if (w0 == 0 || w0 + TW + 1 > W) {
      unsigned short* pz =
          reinterpret_cast<unsigned short*>(smem + st * g.stage_bytes);
      const int lo = w0 == 0 ? Cin : 0;
      const int hi = min(W - w0 + 1, PW) * Cin;
      const int span = lo + L - hi;
      for (int i = tid; i < PH * span; i += THREADS) {
        const int r = i / span, e = i - r * span;
        const int h = h0 + r - 1;
        if (h >= 0 && h < H) pz[b + r * RS + (e < lo ? e : hi + e - lo)] = 0;
      }
      __syncthreads();
    }

    // Implicit GEMM: warpgroup wg's m64 mt is tile rows 8 mt + 4 wg .. 8
    // mt + 4 wg + 3, warp `warp` row 8 mt + `warp`, its lanes' A rows
    // pixels pa and pb, gathered from the patch at the table's offsets
    // (one table read for the MT m64s); B the resident
    // weights. The wgmmas of G k16 steps go out as one commit group, their
    // A fragments in two buffers: a group's loads run while the last
    // group's wgmmas do.
    const uint32_t row0 = stage0 + st * g.stage_bytes + 2 * (b + warp * RS);
    const uint32_t pix0 = row0 + 2 * pa * Cin, pix8 = row0 + 2 * pb * Cin;
    const uint32_t mstep = 2 * 8 * RS;  // the second m64: 8 rows below
    // a step's A fragments; MASKED (the last pair of groups, where the
    // padded k lie) reads the zero word at NO_K
    auto load_a = [&](auto masked, uint32_t (&a)[MT][4], int s) {
      constexpr bool M = decltype(masked)::value;
      if constexpr (PAIRED) {
        uint32_t o0, o8;
        asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                     : "=r"(o0), "=r"(o8)
                     : "r"(tab_s + 32 * s));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint32_t p0 = pix0 + mt * mstep, p8 = pix8 + mt * mstep;
          a[mt][0] = lds32(M && o0 == NO_K ? zero_s : p0 + o0);
          a[mt][1] = lds32(M && o0 == NO_K ? zero_s : p8 + o0);
          a[mt][2] = lds32(M && o8 == NO_K ? zero_s : p0 + o8);
          a[mt][3] = lds32(M && o8 == NO_K ? zero_s : p8 + o8);
        }
      } else {
        uint32_t o[4];
        asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(o[0]), "=r"(o[1]), "=r"(o[2]), "=r"(o[3])
                     : "r"(tab_s + 64 * s));
        auto e = [&](uint32_t p, uint32_t off) {
          return lds16(M && off == NO_K ? zero_s : p + off);
        };
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint32_t p0 = pix0 + mt * mstep, p8 = pix8 + mt * mstep;
          a[mt][0] = e(p0, o[0]) | e(p0, o[1]) << 16;
          a[mt][1] = e(p8, o[0]) | e(p8, o[1]) << 16;
          a[mt][2] = e(p0, o[2]) | e(p0, o[3]) << 16;
          a[mt][3] = e(p8, o[2]) | e(p8, o[3]) << 16;
        }
      }
    };
    float acc[MT][BN / 2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[mt][i] = 0.f;
    // K is padded to whole pairs of groups (zero weights, A from the zero
    // word), so no wgmma sits under a branch
    const int ks = g.ksteps;
    uint32_t fa[G][MT][4], fb[G][MT][4];
    const int tail = ks - KGROUP;  // kp - K < 16 x KGROUP
    auto load_g = [&](uint32_t (&f)[G][MT][4], int s) {
      if (s >= tail) {
#pragma unroll
        for (int j = 0; j < G; ++j) load_a(std::true_type{}, f[j], s + j);
      } else {
#pragma unroll
        for (int j = 0; j < G; ++j) load_a(std::false_type{}, f[j], s + j);
      }
    };
    auto mma_g = [&](const uint32_t (&f)[G][MT][4], int s) {
      sm90::wgmma_fence();
#pragma unroll
      for (int j = 0; j < G; ++j)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma_n<BN, 0, BN>(acc[mt], f[j][mt], w_s + (s + j) * (BN * 32));
      sm90::wgmma_commit();
    };
    load_g(fa, 0);
    for (int s = 0; s < ks; s += 2 * G) {
      mma_g(fa, s);
      sm90::wgmma_wait<1>();  // the group before is done: fb is free
      load_g(fb, s + G);
      mma_g(fb, s + G);
      sm90::wgmma_wait<1>();  // group s is done: fa is free
      if (s + 2 * G < ks) load_g(fa, s + 2 * G);
    }
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) sm90::fence_regs(acc[mt]);
    __syncthreads();  // every warp has read the stage
    issue(t + S * gridDim.x, st);

    // Epilogue: acc * A + B, ReLU, bf16 into the warp's staging row at
    // element sb0 + p x ops + c, sb0 = the row's first element of out mod
    // 8, so that out's 16-byte chunks are the staging's; then the warp
    // copies the row (or, with the channels split, each pixel's run)
    // chunk by chunk, 16-byte stores inside the run and element stores
    // at its two ends. Accumulator i: A row g8 (+8 for i % 4 >= 2), that
    // is pixel pa (pb), channel 8 (i / 4) + 2 t4 + i % 2.
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int h = h0 + warp + 8 * mt;
      if (h < H) {
        const int npx = min(TW, W - w0);
        const int64_t go =
            ((static_cast<int64_t>(img) * H + h) * W + w0) * Cout + n0;
        const int sb0 = static_cast<int>(go & 7), ops = g.ops;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int c = 8 * j + 2 * t4;
          if (c >= bnc) continue;
          const float a0 = sa[c], a1 = sa[c + 1];
          const float b0 = sb[c], b1 = sb[c + 1];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float v0 = acc[mt][4 * j + 2 * half] * a0 + b0;
            float v1 = acc[mt][4 * j + 2 * half + 1] * a1 + b1;
            if (relu) {
              v0 = fmaxf(v0, 0.f);
              v1 = fmaxf(v1, 0.f);
            }
            const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
            const uint32_t u = *reinterpret_cast<const uint32_t*>(&v);
            const int e = sb0 + (half ? pb : pa) * ops + c;
            if (c + 1 < bnc && (e & 1) == 0) {
              *reinterpret_cast<uint32_t*>(os + e) = u;
            } else {
              os[e] = static_cast<unsigned short>(u);
              if (c + 1 < bnc)
                os[e + 1] = static_cast<unsigned short>(u >> 16);
            }
          }
        }
        __syncwarp();
        auto copy = [&](int s0, int64_t gs, int len) {
          const int64_t c0 = gs & ~static_cast<int64_t>(7);
          const int nch = static_cast<int>((gs + len - c0 + 7) >> 3);
          for (int q = lane; q < nch; q += 32) {
            const int64_t ca = c0 + 8 * q;
            const int sq = s0 + static_cast<int>(ca - gs);
            if (ca >= gs && ca + 8 <= gs + len) {
              *reinterpret_cast<uint4*>(out16 + ca) =
                  *reinterpret_cast<const uint4*>(os + sq);
            } else {
#pragma unroll
              for (int u = 0; u < 8; ++u)
                if (ca + u >= gs && ca + u < gs + len)
                  out16[ca + u] = os[sq + u];
            }
          }
        };
        if (tiles_n == 1) {
          copy(sb0, go, npx * Cout);
        } else {
          for (int p = 0; p < npx; ++p)
            copy(sb0 + p * ops, go + static_cast<int64_t>(p) * Cout, bnc);
        }
        __syncwarp();
      }
    }
  }
  sm90::cp_async_wait<0>();
}

template <int BN, int MT, bool PAIRED>
cudaError_t launch(const __nv_bfloat16* x, const __nv_bfloat16* w,
                   const float* a, const float* b, __nv_bfloat16* out, int N,
                   int H, int W, int Cin, int Cout, int relu, int flip,
                   const Plan& p, cudaStream_t stream) {
  const int mod = static_cast<int>(
      ((static_cast<int64_t>(W) * Cin - p.row - 14) % 8 + 8) % 8);
  const Geo g{p.tiles_n,  p.ksteps, p.row,          p.row + 14 + mod,
              p.stages,   p.stage_bytes, p.w_off,   p.tab_off,
              p.ab_off,   p.out_off,     p.out_warp_bytes, p.ops,
              interleaved(Cin)};
  auto kern = conv3x3_bn_relu_narrow_kernel<BN, MT, PAIRED>;
  // the instance's shared-memory ceiling and blocks an SM, set and asked
  // once a (device, bytes)
  static std::mutex mu;
  static int set_dev = -1, set_smem = -1, set_sms = 0, set_per_sm = 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (dev != set_dev || p.smem != set_smem) {
      set_dev = -1;
      if ((err = cudaFuncSetAttribute(
               kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
               p.smem)) != cudaSuccess ||
          (err = cudaDeviceGetAttribute(&set_sms,
                                        cudaDevAttrMultiProcessorCount,
                                        dev)) != cudaSuccess ||
          (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &set_per_sm, kern, THREADS, p.smem)) != cudaSuccess)
        return err;
      set_dev = dev;
      set_smem = p.smem;
    }
    sms = set_sms;
    per_sm = set_per_sm;
  }
  const int64_t tiles = static_cast<int64_t>(N) * ((H + 8 * MT - 1) /
                                                   (8 * MT)) *
                        ((W + TW - 1) / TW) * p.tiles_n;
  if (tiles > 2147483647LL) return cudaErrorInvalidConfiguration;
  // persistent: the blocks that fit at once, a multiple of the channel
  // tiles so that each block's weights stay resident
  const int64_t fit = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  int64_t grid = (tiles < fit ? tiles : fit) / p.tiles_n * p.tiles_n;
  if (grid < p.tiles_n) grid = p.tiles_n;
  kern<<<static_cast<unsigned>(grid), THREADS, p.smem, stream>>>(
      x, w, a, b, out, N, H, W, Cin, Cout, relu, flip, g);
  return cudaGetLastError();
}

// *route: 0 (this design) or 3 (mma_sync, where no tile fits).
cudaError_t run(const __nv_bfloat16* x, const __nv_bfloat16* w,
                const float* a, const float* b, __nv_bfloat16* out, int N,
                int H, int W, int Cin, int Cout, int relu, int flip,
                cudaStream_t st, int* route) {
  const Plan p = plan(Cin, Cout);
  *route = p.smem == 0 ? 3 : 0;
  if (p.smem == 0)  // no tile fits: the first design
    return mma_sync::run(x, w, a, b, out, N, H, W, Cin, Cout, relu, flip, st);
#define NARROW_CASE(BN, MT)                                                \
  case BN * 2 + MT - 1:                                                    \
    return Cin % 2 ? launch<BN, MT, false>(x, w, a, b, out, N, H, W, Cin,  \
                                           Cout, relu, flip, p, st)        \
                   : launch<BN, MT, true>(x, w, a, b, out, N, H, W, Cin,   \
                                          Cout, relu, flip, p, st);
  switch (p.bn * 2 + p.mt - 1) {
    NARROW_CASE(16, 1) NARROW_CASE(24, 1) NARROW_CASE(32, 1)
    NARROW_CASE(40, 1) NARROW_CASE(16, 2) NARROW_CASE(24, 2)
    NARROW_CASE(32, 2) NARROW_CASE(40, 2) NARROW_CASE(48, 1)
    NARROW_CASE(64, 1) NARROW_CASE(80, 1) NARROW_CASE(96, 1)
    NARROW_CASE(128, 1)
    default:
      return cudaErrorInvalidValue;
  }
#undef NARROW_CASE
}

}  // namespace narrow

// ================================================================ packed

namespace packed {

constexpr int K_MAX = 192;       // 9 x Cin packed into K: Cin <= 21
constexpr int TH = 8;            // output rows per tile: one per warp
constexpr int TW = 32;           // output columns per tile: two m16 per warp
constexpr int MT = TW / 16;      // m16 tiles per warp
constexpr int MIN_BLOCKS = 2;    // resident blocks per SM (registers <= 128)
constexpr int PH = TH + 2;       // patch rows (with halo)
constexpr int BN = 64;           // output channels per tile
constexpr int BNP = BN + 8;      // weight row stride (144 B: the 8 rows an
                                 // ldmatrix reads hit distinct banks)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int OUT_WARP_BYTES = TW * BN * 2;  // one output row, 32 x 128 B

template <int CIN>
struct Geo {
  static constexpr int K = 9 * CIN;                 // k = tap * CIN + ci
  static constexpr int KP = (K + 15) / 16 * 16;
  static constexpr int KSTEPS = KP / 16;
  static constexpr int L = (TW + 2) * CIN;          // patch row, elements
  static constexpr int RS = (L + 7) / 8 * 8;        // patch row stride
  static constexpr int CPR = (L + 6) / 8 + 1;       // 16-B chunks it spans
  static constexpr int ITEMS = PH * CPR;            // chunks per patch
  static constexpr int LPT = (ITEMS + THREADS - 1) / THREADS;
  // one patch buffer: PH rows, then TH rows of zeros that the padded k
  // (k >= K) read, whatever the pixel
  static constexpr int BUF = (PH + TH) * RS;
  static constexpr int PAD_OFF = PH * RS;
  // past Cin 12 the A offsets of the k16 steps (2 x KSTEPS registers)
  // live in a shared table, one 8-byte entry a (step, t4)
  static constexpr bool TABLE = CIN > 12;
  // shared memory (bytes): per-warp output staging (1024-aligned for the
  // 128-byte swizzle), resident weights, two patch buffers, A and B, the
  // offset table
  static constexpr int W_OFF = WARPS * OUT_WARP_BYTES;
  static constexpr int P_OFF = W_OFF + KP * BNP * 2;
  static constexpr int AB_OFF = P_OFF + 2 * BUF * 2;
  static constexpr int TAB_OFF = AB_OFF + 2 * BN * 4;
  static constexpr int SMEM = TAB_OFF + (TABLE ? KSTEPS * 4 * 8 : 0) + 1024;
};
// ops/fused_conv.py::packed_fwd_plan holds the same figures; two blocks an
// SM need 2 x (SMEM + 1,024) <= 233,472 B
static_assert(Geo<3>::SMEM == 46400, "the stem (Cin 3)");
static_assert(Geo<12>::SMEM == 79808, "the 12-class head's dx (Cin 12)");
static_assert(Geo<21>::SMEM == 114176, "VOC's 21-class head's dx (Cin 21)");

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ uint32_t lds16(uint32_t addr) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr));
  return v;
}

// The patch offset (elements) of packed k for the pixel at patch (0, 0):
// tap (dy, dx) = k / CIN, channel k % CIN; a padded k reads the zero rows.
template <int CIN>
__device__ __forceinline__ int koff(int k) {
  using G = Geo<CIN>;
  if (k >= G::K) return G::PAD_OFF;
  const int tap = k / CIN, ci = k % CIN;
  return (tap / 3) * G::RS + (tap % 3) * CIN + ci;
}
// The byte offsets of k and k + 1 as the two 16-bit halves of one word.
template <int CIN>
__device__ __forceinline__ uint32_t koff2(int k) {
  return 2 * koff<CIN>(k) | 2 * koff<CIN>(k + 1) << 16;
}

template <int CIN>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    conv3x3_bn_relu_packed_kernel(const __grid_constant__ CUtensorMap omap,
                                  const __nv_bfloat16* __restrict__ x,
                                  const __nv_bfloat16* __restrict__ w,
                                  const float* __restrict__ scale,
                                  const float* __restrict__ shift, int N,
                                  int H, int W, int Cout, int relu,
                                  int flip) {
  using G = Geo<CIN>;
  constexpr bool PAIRED = CIN % 2 == 0;  // k, k+1 (k even) adjacent
  static_assert(2 * G::PAD_OFF < 32768, "16-bit patch offsets");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  __nv_bfloat16* wt = reinterpret_cast<__nv_bfloat16*>(smem + G::W_OFF);
  __nv_bfloat16* patch = reinterpret_cast<__nv_bfloat16*>(smem + G::P_OFF);
  float* sa = reinterpret_cast<float*>(smem + G::AB_OFF);
  float* sb = sa + BN;
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);

  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  const int tiles_n = (Cout + BN - 1) / BN;
  const int total = N * tiles_h * tiles_w * tiles_n;  // < 2^31 (host)
  // the grid is a multiple of tiles_n: a block keeps one channel tile
  const int n0 = blockIdx.x % tiles_n * BN;
  auto origin = [&](int t, int& img, int& h0, int& w0) {
    t /= tiles_n;
    w0 = t % tiles_w * TW;
    t /= tiles_w;
    h0 = t % tiles_h * TH;
    img = t / tiles_h;
  };

  // Resident weights, once per block: W'[k][co] for k = tap * CIN + ci,
  // zero for k >= K and co >= Cout; under flip W'[tap][ci][co] =
  // w[8-tap][co][ci], read in place.
  for (int i = threadIdx.x; i < G::KP * BN; i += THREADS) {
    const int k = i / BN, j = i % BN, co = n0 + j;
    __nv_bfloat16 v = __float2bfloat16(0.f);
    if (k < G::K && co < Cout) {
      const int tap = k / CIN, ci = k % CIN;
      v = flip ? w[(static_cast<int64_t>(8 - tap) * Cout + co) * CIN + ci]
               : w[(static_cast<int64_t>(tap) * CIN + ci) * Cout + co];
    }
    wt[k * BNP + j] = v;
  }
  for (int j = threadIdx.x; j < BN; j += THREADS) {
    const bool in = n0 + j < Cout;
    sa[j] = in ? scale[n0 + j] : 0.f;
    sb[j] = in ? shift[n0 + j] : 0.f;
  }
  for (int i = threadIdx.x; i < 2 * TH * G::RS; i += THREADS)
    patch[(i / (TH * G::RS)) * G::BUF + G::PAD_OFF + i % (TH * G::RS)] =
        __float2bfloat16(0.f);

  // Patch row pr of tile (img, h0, w0) is input row h0 + pr - 1, columns
  // w0 - 1 .. w0 + TW: (TW + 2) x CIN elements, contiguous in NHWC from
  // element grs. Its 16-byte chunks (aligned in x) are loaded as vectors
  // into registers; the chunks that straddle the image's edge (a halo
  // column outside the image, or the row before or after) load only
  // their elements inside it, element by element, and rows outside the
  // image load nothing: what is not loaded is zero.
  uint4 pre[G::LPT];
  auto fetch = [&](int t) {
    int img, h0, w0;
    origin(t, img, h0, w0);
#pragma unroll
    for (int j = 0; j < G::LPT; ++j) {
      const int i = threadIdx.x + j * THREADS;
      pre[j] = make_uint4(0, 0, 0, 0);
      const int pr = i / G::CPR, q = i % G::CPR;
      const int h = h0 + pr - 1;
      if (i >= G::ITEMS || h < 0 || h >= H) continue;
      const int64_t rowpix = (static_cast<int64_t>(img) * H + h) * W;
      const int64_t grs = (rowpix + w0 - 1) * CIN;
      const int64_t g0 = (grs & ~static_cast<int64_t>(7)) + 8 * q;
      const int64_t e0 = (rowpix + max(w0 - 1, 0)) * CIN;
      const int64_t e1 = (rowpix + min(w0 + TW + 1, W)) * CIN;
      if (g0 >= e0 && g0 + 8 <= e1) {
        pre[j] = __ldg(reinterpret_cast<const uint4*>(xs + g0));
      } else if (g0 + 8 > e0 && g0 < e1) {
        uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (g0 + u >= e0 && g0 + u < e1)
            v[u / 2] |= static_cast<uint32_t>(__ldg(xs + g0 + u))
                        << (16 * (u % 2));
        pre[j] = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
  };
  // ... and written to the patch at its place in the row: element d of
  // the chunk's row lands at d if 0 <= d < L (pairs where d is even)
  auto put = [&](int t, __nv_bfloat16* buf) {
    int img, h0, w0;
    origin(t, img, h0, w0);
    unsigned short* bs = reinterpret_cast<unsigned short*>(buf);
#pragma unroll
    for (int j = 0; j < G::LPT; ++j) {
      const int i = threadIdx.x + j * THREADS;
      if (i >= G::ITEMS) continue;
      const int pr = i / G::CPR, q = i % G::CPR;
      const int64_t grs =
          ((static_cast<int64_t>(img) * H + h0 + pr - 1) * W + w0 - 1) * CIN;
      const int d0 = 8 * q - static_cast<int>(grs & 7);
      unsigned short* row = bs + pr * G::RS;
      const uint32_t v[4] = {pre[j].x, pre[j].y, pre[j].z, pre[j].w};
      if ((d0 & 1) == 0) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int d = d0 + 2 * u;
          if (d >= 0 && d < G::L)
            *reinterpret_cast<uint32_t*>(row + d) = v[u];
        }
      } else {
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int d = d0 + u;
          if (d >= 0 && d < G::L)
            row[d] = static_cast<unsigned short>(v[u / 2] >> (16 * (u % 2)));
        }
      }
    }
  };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  // byte offsets in the patch of this lane's A elements per k16 step:
  // k = 16 s + 2 t4 (+1) and + 8 (+1) (m16n8k16's A fragment columns).
  // Up to Cin 12 they stay in registers (odd CIN: k's and k + 1's as the
  // two 16-bit halves of one); past it, in the table (koff2 of k and of
  // k + 8 per (step, t4)): at Cin 21 its 12 k16 steps would hold 24
  // registers through the tile loop, and ptxas spilled.
  uint32_t off[G::TABLE ? 1 : G::KSTEPS][2];
  const uint32_t tab_s = smem_u32(smem + G::TAB_OFF) + 8 * t4;
  if constexpr (G::TABLE) {
    for (int i = threadIdx.x; i < G::KSTEPS * 4; i += THREADS) {
      const int k = 16 * (i / 4) + 2 * (i % 4);
      reinterpret_cast<uint2*>(smem + G::TAB_OFF)[i] =
          make_uint2(koff2<CIN>(k), koff2<CIN>(k + 8));
    }
  } else {
#pragma unroll
    for (int s = 0; s < G::KSTEPS; ++s) {
      const int k = 16 * s + 2 * t4;
      off[s][0] = PAIRED ? 2 * koff<CIN>(k) : koff2<CIN>(k);
      off[s][1] = PAIRED ? 2 * koff<CIN>(k + 8) : koff2<CIN>(k + 8);
    }
  }
  const uint32_t wt_s = smem_u32(wt);
  const int b_off = (lane & 15) * BNP + (lane >> 4) * 8;
  unsigned char* st = smem + warp * OUT_WARP_BYTES;
  const uint32_t st0 = smem_u32(st);

  int t = blockIdx.x;
  if (t < total) {
    fetch(t);
    put(t, patch);
  }
  __syncthreads();  // weights, affine, zero rows and the first patch
  for (int it = 0; t < total; t += gridDim.x, ++it) {
    const int tn = t + gridDim.x;
    if (tn < total) fetch(tn);  // in flight while this tile computes

    // Implicit GEMM: warp `warp` computes output row h0 + warp, TW pixels
    // (MT m16 tiles) x 64 channels; A gathered from the patch at each
    // packed k, B by ldmatrix from the resident weights.
    float acc[MT][8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    const uint32_t pix =
        smem_u32(patch + (it & 1) * G::BUF) + 2 * (warp * G::RS + g * CIN);
#pragma unroll
    for (int s = 0; s < G::KSTEPS; ++s) {
      uint32_t a[MT][4];
      uint32_t e0, e1;
      if constexpr (G::TABLE)
        asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                     : "=r"(e0), "=r"(e1)
                     : "r"(tab_s + 32 * s));
      else
        e0 = off[s][0], e1 = off[s][1];
      // PAIRED reads k, k + 1 as one word at o0 and k + 8, k + 9 at o8
      // (in registers, whole offsets)
      const uint32_t o0 = PAIRED && !G::TABLE ? e0 : e0 & 0xFFFF;
      const uint32_t o8 = PAIRED && !G::TABLE ? e1 : e1 & 0xFFFF;
      const uint32_t o1 = e0 >> 16, o9 = e1 >> 16;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint32_t p0 = pix + 2 * 16 * mt * CIN, p1 = p0 + 2 * 8 * CIN;
        if constexpr (PAIRED) {
          a[mt][0] = lds32(p0 + o0);
          a[mt][1] = lds32(p1 + o0);
          a[mt][2] = lds32(p0 + o8);
          a[mt][3] = lds32(p1 + o8);
        } else {
          a[mt][0] = lds16(p0 + o0) | lds16(p0 + o1) << 16;
          a[mt][1] = lds16(p1 + o0) | lds16(p1 + o1) << 16;
          a[mt][2] = lds16(p0 + o8) | lds16(p0 + o9) << 16;
          a[mt][3] = lds16(p1 + o8) | lds16(p1 + o9) << 16;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t b[4];
        sm90::ldmatrix_x4_trans(b, wt_s + 2 * (b_off + 16 * s * BNP + 16 * j));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          sm90::mma_bf16_16816(acc[mt][2 * j], a[mt], b[0], b[1]);
          sm90::mma_bf16_16816(acc[mt][2 * j + 1], a[mt], b[2], b[3]);
        }
      }
    }

    // Epilogue: acc * A + B, ReLU, bf16 into the warp's staging row (TW
    // pixels x 128 B, 128-byte swizzle: the 8 pixels of a fragment land
    // in 8 different 16-byte chunks), then one TMA store of the row that
    // runs while the next tile computes; TMA drops what lies past H, W or
    // Cout. Accumulator e of (mt, nt): pixel 16 mt + g (+8 for e >= 2),
    // channel 8 nt + 2 t4 + e % 2.
    int img, h0, w0;
    origin(t, img, h0, w0);
    if (lane == 0) sm90::bulk_wait<0, true>();  // the last store has read it
    __syncwarp();
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = 8 * nt + 2 * t4;
      const float a0 = sa[c], a1 = sa[c + 1], b0 = sb[c], b1 = sb[c + 1];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float v0 = acc[mt][nt][2 * half] * a0 + b0;
          float v1 = acc[mt][nt][2 * half + 1] * a1 + b1;
          if (relu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
          const uint32_t addr =
              sm90::swz128(st0, 16 * mt + g + 8 * half, nt) + 4 * t4;
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr),
                       "r"(*reinterpret_cast<const uint32_t*>(&v))
                       : "memory");
        }
    }
    sm90::fence_proxy_async();
    __syncwarp();
    if (lane == 0) {
      if (h0 + warp < H)
        sm90::tma_store_4d(&omap, st, n0, w0, h0 + warp, img);
      sm90::bulk_commit();
    }

    if (tn < total) put(tn, patch + ((it + 1) & 1) * G::BUF);
    __syncthreads();  // the next patch is in place; this one may go
  }
  if (lane == 0) sm90::bulk_wait<0, false>();  // the stores are done
}

template <int CIN>
cudaError_t launch(const __nv_bfloat16* x, const __nv_bfloat16* w,
                   const float* a, const float* b, __nv_bfloat16* out, int N,
                   int H, int W, int Cout, int relu, int flip,
                   cudaStream_t stream) {
  using G = Geo<CIN>;
  CUtensorMap omap;
  const uint64_t od[4] = {static_cast<uint64_t>(Cout),
                          static_cast<uint64_t>(W), static_cast<uint64_t>(H),
                          static_cast<uint64_t>(N)};
  const uint64_t os[3] = {2ull * Cout, 2ull * Cout * W, 2ull * Cout * W * H};
  const uint32_t ob[4] = {BN, TW, 1, 1};
  if (!sm90::encode_bf16_map(&omap, out, 4, od, os, ob))
    return cudaErrorInvalidValue;
  auto kern = conv3x3_bn_relu_packed_kernel<CIN>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, THREADS, G::SMEM)) != cudaSuccess)
    return err;
  const int64_t tiles_n = (Cout + BN - 1) / BN;
  const int64_t tiles = static_cast<int64_t>(N) * ((H + TH - 1) / TH) *
                        ((W + TW - 1) / TW) * tiles_n;
  if (tiles > 2147483647LL) return cudaErrorInvalidConfiguration;
  // persistent: the blocks that fit at once, a multiple of the channel
  // tiles so that each block's weights stay resident
  const int64_t fit = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  int64_t grid = (tiles < fit ? tiles : fit) / tiles_n * tiles_n;
  if (grid < tiles_n) grid = tiles_n;
  kern<<<static_cast<unsigned>(grid), THREADS, G::SMEM, stream>>>(
      omap, x, w, a, b, N, H, W, Cout, relu, flip);
  return cudaGetLastError();
}

cudaError_t run(const __nv_bfloat16* x, const __nv_bfloat16* w,
                const float* a, const float* b, __nv_bfloat16* out, int N,
                int H, int W, int Cin, int Cout, int relu, int flip,
                cudaStream_t st) {
#define PACKED_CASE(C) \
  case C:              \
    return launch<C>(x, w, a, b, out, N, H, W, Cout, relu, flip, st);
  switch (Cin) {
    PACKED_CASE(1) PACKED_CASE(2) PACKED_CASE(3) PACKED_CASE(4)
    PACKED_CASE(5) PACKED_CASE(6) PACKED_CASE(7) PACKED_CASE(9)
    PACKED_CASE(10) PACKED_CASE(11) PACKED_CASE(12) PACKED_CASE(13)
    PACKED_CASE(14) PACKED_CASE(15) PACKED_CASE(17) PACKED_CASE(18)
    PACKED_CASE(19) PACKED_CASE(20) PACKED_CASE(21)
    default:
      return cudaErrorInvalidValue;
  }
#undef PACKED_CASE
}

}  // namespace packed

// ================================================================= wgmma

namespace wg {

constexpr int TW = 16;           // output columns per tile: one warp's m16
constexpr int PW = TW + 2;       // patch columns (with halo)
constexpr int THREADS = 384;     // warpgroups 0, 1 consume; 2 produces
constexpr int CONSUMER_WARPS = 8;
constexpr int RES_MAX_CIN = 128;  // the head tile keeps 9 x Cin x N
constexpr int HEAD_MAX_COUT = 24;  // the head tile's widest N

// RES: Cin <= 64, one chunk, so a block's weights change only with its
// output-channel tile; the 9 taps (BN = 64) stay resident in a 9-stage ring
// and are loaded again only when the next tile's channels differ.
// HEAD (BN 16 or 24): the head tile, all 9 x RES_MAX_CIN x BN weights
// resident from the block's start, no weight ring, no output staging.
template <int BN, bool RES>
struct Tile {
  static constexpr bool HEAD = BN <= HEAD_MAX_COUT;
  static constexpr int MT = HEAD ? 4 : RES ? 2 : 256 / BN;  // m64 / WG
  static constexpr int TH = 8 * MT;  // 2 WGs x MT x 4 output rows
  static constexpr int PH = TH + 2;
  static constexpr int PATCH_TX = PH * PW * 128;  // one 64-channel box
  static constexpr int PATCH_BYTES = (PATCH_TX + 1023) / 1024 * 1024;
  static constexpr int P_STAGES = 2;
  static constexpr int W_STAGES = HEAD ? 0 : RES ? 9 : BN == 256 ? 3 : 4;
  static constexpr int W_BYTES = BN * 128;  // one tap: 64 (K) x BN bf16
  static constexpr int RES_BYTES = HEAD ? 9 * RES_MAX_CIN * BN * 2 : 0;
  // output staging for the TMA store: per consumer warp, one output row
  // of 16 pixels x BN channels as BN/64 boxes of 16 x 128 bytes
  static constexpr int OUT_WARP_BYTES = HEAD ? 0 : 16 * BN * 2;
  static constexpr int BAR_OFF = P_STAGES * PATCH_BYTES + W_STAGES * W_BYTES +
                                 RES_BYTES + CONSUMER_WARPS * OUT_WARP_BYTES;
  static constexpr int SMEM = BAR_OFF + 2 * (P_STAGES + W_STAGES) * 8 + 1024;
};
// ops/fused_conv.py::head_tile_plan holds the same figures
static_assert(Tile<16, false>::SMEM == 195616, "the head tile at N 16");
static_assert(Tile<24, false>::SMEM == 214048, "the head tile at N 24");

// Shared-memory descriptor of B for one k16 step ``kk`` of a weight stage.
// N-major (TNSPB 1): TMA wrote BN/64 boxes of 64 K-rows x 128 bytes, one
// per 64 output channels, 8192 bytes apart (leading byte offset); 8 K-rows
// are 1024 bytes (stride byte offset); a k16 step is 16 rows. K-major
// (TNSPB 0): BN rows of 128 bytes (64 K), 8 rows 1024 bytes apart; a k16
// step is 32 bytes along the swizzled row.
template <int TNSPB>
__device__ __forceinline__ uint64_t b_desc(uint32_t stage, int kk) {
  if constexpr (TNSPB == 1)
    return sm90::wgmma_desc(stage + kk * 2048, 8192, 1024, 1);
  else
    return sm90::wgmma_desc(stage + kk * 32, 16, 1024, 1);
}

template <int BN, int TNSPB, bool RES>
__global__ void __launch_bounds__(THREADS, 1)
    conv3x3_bn_relu_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap wmap,
                         const __grid_constant__ CUtensorMap omap,
                         const __nv_bfloat16* __restrict__ w,
                         const float* __restrict__ scale,
                         const float* __restrict__ shift,
                         __nv_bfloat16* __restrict__ out, int N, int H, int W,
                         int Cin, int Cout, int relu, int flip) {
  using T = Tile<BN, RES>;
  constexpr bool HEAD = T::HEAD;
  constexpr int MT = T::MT, TH = T::TH, P = T::P_STAGES, S = T::W_STAGES;
  // k16 steps per wgmma commit group: 4 where the registers allow (RES,
  // 64 accumulators), else 2 (at 4, ptxas serializes the wgmmas)
  constexpr int G = RES ? 4 : 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  unsigned char* patch = smem;
  unsigned char* wring = smem + P * T::PATCH_BYTES;
  unsigned char* res = wring + S * T::W_BYTES;
  unsigned char* ostage = res + T::RES_BYTES;
  uint64_t* pfull = reinterpret_cast<uint64_t*>(smem + T::BAR_OFF);
  uint64_t* pempty = pfull + P;
  uint64_t* wfull = pempty + P;
  uint64_t* wempty = wfull + S;

  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  const int tiles_n = (Cout + BN - 1) / BN;
  const int total = N * tiles_h * tiles_w * tiles_n;  // < 2^31 (host)
  const int nch = (Cin + 63) / 64;
  // tile -> (image, row, column, cout tile), the cout tile fastest so
  // blocks that share an input patch run together
  auto origin = [&](int t, int& img, int& h0, int& w0, int& n0) {
    n0 = t % tiles_n * BN;
    t /= tiles_n;
    w0 = t % tiles_w * TW;
    t /= tiles_w;
    h0 = t % tiles_h * TH;
    img = t / tiles_h;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < P; ++i) {
      sm90::mbar_init(&pfull[i], 1);
      sm90::mbar_init(&pempty[i], CONSUMER_WARPS);
    }
    for (int i = 0; i < S; ++i) {
      sm90::mbar_init(&wfull[i], 1);
      sm90::mbar_init(&wempty[i], CONSUMER_WARPS);
    }
    sm90::fence_barrier_init();
  }
  if constexpr (HEAD) {
    // Resident weights, zero-padded to BN output channels and to whole
    // 64-channel chunks: block (chunk, tap, k16 step) of BN x 32 bytes
    // holds BN (N) x 16 (K) as BN / 4 8x8 core matrices, K-major, no
    // swizzle (8-row groups 256 bytes apart, the two K halves 128 bytes
    // apart).
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int i = threadIdx.x; i < nch * 9 * 64 * BN; i += THREADS) {
      const int n = i % BN, k = (i / BN) & 63, t = i / (BN * 64) % 9,
                c = i / (BN * 64 * 9);
      const int ci = c * 64 + k;
      __nv_bfloat16 v = zero;
      if (ci < Cin && n < Cout)
        v = flip ? w[(static_cast<int64_t>(8 - t) * Cout + n) * Cin + ci]
                 : w[(static_cast<int64_t>(t) * Cin + ci) * Cout + n];
      const int kl = k & 15;
      const int off = ((c * 9 + t) * 4 + (k >> 4)) * (BN * 32) +
                      (n >> 3) * 256 + (kl >> 3) * 128 + (n & 7) * 16 +
                      (kl & 7) * 2;
      *reinterpret_cast<__nv_bfloat16*>(res + off) = v;
    }
    sm90::fence_proxy_async();
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 2) {
    // ----------------------------------------------------- producers
    // One thread streams the patches, another (in another warp) the
    // weights, so a patch is fetched as soon as its slot is free, a whole
    // tile ahead, whatever the weight ring is waiting for.
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      sm90::prefetch_tensormap(&xmap);
      uint32_t pit = 0;
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        int img, h0, w0, n0;
        origin(t, img, h0, w0, n0);
        for (int c = 0; c < nch; ++c, ++pit) {
          const int ps = pit % P;
          sm90::mbar_wait(&pempty[ps], ((pit / P) & 1) ^ 1);
          sm90::mbar_arrive_expect_tx(&pfull[ps], T::PATCH_TX);
          sm90::tma_load_4d(patch + ps * T::PATCH_BYTES, &xmap, &pfull[ps],
                            c * 64, w0 - 1, h0 - 1, img);
        }
      }
    } else if (threadIdx.x == 288) {
      if constexpr (!HEAD) {
      sm90::prefetch_tensormap(&wmap);
      uint32_t wit = 0;
      int res_n0 = -1;
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        const int n0 = t % tiles_n * BN;
        if (RES && n0 == res_n0) continue;  // the resident taps serve
        res_n0 = n0;
        for (int c = 0; c < nch; ++c) {
          for (int tap = 0; tap < 9; ++tap, ++wit) {
            const int ws = wit % S;
            sm90::mbar_wait(&wempty[ws], ((wit / S) & 1) ^ 1);
            sm90::mbar_arrive_expect_tx(&wfull[ws], T::W_BYTES);
            unsigned char* dst = wring + ws * T::W_BYTES;
            if constexpr (TNSPB == 1) {
#pragma unroll
              for (int j = 0; j < BN / 64; ++j)
                sm90::tma_load_3d(dst + j * 8192, &wmap, &wfull[ws],
                                  n0 + 64 * j, c * 64, tap);
            } else {
              sm90::tma_load_3d(dst, &wmap, &wfull[ws], c * 64, n0, 8 - tap);
            }
          }
        }
      }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    sm90::setmaxnreg_inc<232>();
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const uint32_t patch0 = smem_u32(patch);
    const uint32_t wring0 = smem_u32(wring);
    const uint32_t res0 = smem_u32(res);
    // patch pixel of tap (0, 0) for this lane's A row in m64 tile mt
    int pbase[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      pbase[mt] = (wgi * 4 * MT + mt * 4 + warp) * PW + (lane & 15);
    uint32_t pit = 0, wit = 0;
    int res_n0 = -1;
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      int img, h0, w0, n0;
      origin(t, img, h0, w0, n0);
      if (RES && n0 != res_n0) {  // a new round of resident taps
        res_n0 = n0;
        wit += 9;
      }
      float acc[MT][BN / 2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[mt][i] = 0.f;

      for (int c = 0; c < nch; ++c, ++pit) {
        const int ps = pit % P;
        sm90::mbar_wait(&pfull[ps], (pit / P) & 1);
        const uint32_t pb = patch0 + ps * T::PATCH_BYTES;
        // A fragments of G k16 steps (one group, committed together) per
        // buffer; two buffers, so one group loads while the last runs
        uint32_t afrag[2][G][MT][4];
        int ws_prev = 0;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int shift_px = (tap / 3) * PW + tap % 3;
          int ws = 0;
          uint32_t wb = 0;
          if constexpr (RES) {  // stage tap of round wit / 9
            ws = tap;
            sm90::mbar_wait(&wfull[ws], ((wit - 9) / 9) & 1);
            wb = wring0 + ws * T::W_BYTES;
          } else if constexpr (!HEAD) {
            ws = wit % S;
            sm90::mbar_wait(&wfull[ws], (wit / S) & 1);
            wb = wring0 + ws * T::W_BYTES;
          }
#pragma unroll
          for (int gi = 0; gi < 4 / G; ++gi) {
            const int buf = (tap * (4 / G) + gi) & 1;
#pragma unroll
            for (int j = 0; j < G; ++j)
#pragma unroll
              for (int mt = 0; mt < MT; ++mt)
                sm90::ldmatrix_x4(afrag[buf][j][mt],
                                  sm90::swz128(pb, pbase[mt] + shift_px,
                                               2 * (gi * G + j) + (lane >> 4)));
            sm90::wgmma_fence();
#pragma unroll
            for (int j = 0; j < G; ++j) {
              const int kk = gi * G + j;
              uint64_t desc;
              if constexpr (HEAD)
                desc = sm90::wgmma_desc(
                    res0 + ((c * 9 + tap) * 4 + kk) * (BN * 32), 128, 256,
                    0);
              else
                desc = b_desc<TNSPB>(wb, kk);
#pragma unroll
              for (int mt = 0; mt < MT; ++mt)
                sm90::wgmma_rs<BN, TNSPB>(acc[mt], afrag[buf][j][mt], desc);
            }
            sm90::wgmma_commit();
            sm90::wgmma_wait<1>();
            // the previous group, the previous tap's last, has completed:
            // its weights go
            if constexpr (!HEAD && !RES)
              if (gi == 0 && tap > 0 && lane == 0)
                sm90::mbar_arrive(&wempty[ws_prev]);
          }
          if constexpr (!HEAD && !RES) {
            ws_prev = ws;
            ++wit;
          }
        }
        sm90::wgmma_wait<0>();
        if (lane == 0) {
          if constexpr (!HEAD && !RES) sm90::mbar_arrive(&wempty[ws_prev]);
          sm90::mbar_arrive(&pempty[ps]);
        }
      }
      if constexpr (RES) {
        // the round ends with this block's last tile of these channels
        const int next = t + gridDim.x;
        if (lane == 0 && (next >= total || next % tiles_n * BN != n0))
          for (int tap = 0; tap < 9; ++tap) sm90::mbar_arrive(&wempty[tap]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) sm90::fence_regs(acc[mt]);

      // Epilogue. Accumulator i of m64 tile mt: row 16*warp + lane/4
      // (+8 for i%4 >= 2), i.e. output row h, column lane/4 (+8); channel
      // 8*(i/4) + 2*(lane%4) + i%2. Each (A, B) pair is read once per tile.
      if constexpr (HEAD) {
        // the head: output rows of Cout x 2 bytes (24 at 12 classes, 42 at
        // 21), stored directly, masked; a channel pair as one 4-byte
        // store where its address is 4-byte aligned (every pair at even
        // Cout, every other pixel's at odd Cout)
        // EVEN (Cout % 2 == 0) a compile-time constant, so the 12-class
        // head's stores take no alignment test (it cost 1.9%)
        auto store = [&](auto even_t) {
          constexpr bool EVEN = decltype(even_t)::value;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int co = n0 + 8 * j + 2 * (lane & 3);
            if (co >= Cout) continue;
            const bool two = co + 1 < Cout;
            const float a0 = scale[co], b0 = shift[co];
            const float a1 = two ? scale[co + 1] : 0.f;
            const float b1 = two ? shift[co + 1] : 0.f;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              const int h = h0 + wgi * 4 * MT + mt * 4 + warp;
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const int ww = w0 + (lane >> 2) + 8 * half;
                if (h >= H || ww >= W) continue;
                __nv_bfloat16* o =
                    out +
                    ((static_cast<int64_t>(img) * H + h) * W + ww) * Cout + co;
                float v0 = acc[mt][4 * j + 2 * half] * a0 + b0;
                float v1 = acc[mt][4 * j + 2 * half + 1] * a1 + b1;
                if (relu) {
                  v0 = fmaxf(v0, 0.f);
                  v1 = fmaxf(v1, 0.f);
                }
                if (two &&
                    (EVEN || (reinterpret_cast<uintptr_t>(o) & 3) == 0)) {
                  *reinterpret_cast<__nv_bfloat162*>(o) =
                      __floats2bfloat162_rn(v0, v1);
                } else {
                  o[0] = __float2bfloat16(v0);
                  if (two) o[1] = __float2bfloat16(v1);
                }
              }
            }
          }
        };
        if (Cout % 2 == 0)
          store(std::true_type{});
        else
          store(std::false_type{});
      } else {
        // Each warp writes its output row (16 pixels x BN channels) into
        // its staging boxes with the 128-byte swizzle (conflict-free: the
        // 8 rows of a fragment land in 8 different 16-byte chunks) and
        // hands them to a TMA store, which runs while the next tile's
        // wgmmas do; TMA drops what lies past H, W or Cout.
        unsigned char* st = ostage + (wgi * 4 + warp) * T::OUT_WARP_BYTES;
        const uint32_t st0 = smem_u32(st);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (lane == 0) sm90::bulk_wait<0, true>();  // the box was read
          __syncwarp();
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int co = n0 + 8 * j + 2 * (lane & 3);
            const bool in = co < Cout;  // Cout % 8 == 0: co + 1 too
            const float a0 = in ? scale[co] : 0.f, b0 = in ? shift[co] : 0.f;
            const float a1 = in ? scale[co + 1] : 0.f;
            const float b1 = in ? shift[co + 1] : 0.f;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              float v0 = acc[mt][4 * j + 2 * half] * a0 + b0;
              float v1 = acc[mt][4 * j + 2 * half + 1] * a1 + b1;
              if (relu) {
                v0 = fmaxf(v0, 0.f);
                v1 = fmaxf(v1, 0.f);
              }
              const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
              const int p = (lane >> 2) + 8 * half;
              const uint32_t addr = sm90::swz128(st0 + (j / 8) * 2048, p,
                                                 j % 8) +
                                    4 * (lane & 3);
              asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr),
                           "r"(*reinterpret_cast<const uint32_t*>(&v))
                           : "memory");
            }
          }
          sm90::fence_proxy_async();
          __syncwarp();
          if (lane == 0) {
            const int h = h0 + wgi * 4 * MT + mt * 4 + warp;
#pragma unroll
            for (int b = 0; b < BN / 64; ++b)
              sm90::tma_store_4d(&omap, st + b * 2048, n0 + 64 * b, w0, h,
                                 img);
            sm90::bulk_commit();
          }
        }
      }
    }
    if constexpr (!HEAD)
      if (lane == 0) sm90::bulk_wait<0, false>();  // the stores are done
  }
}

// Tile N for (Cin, Cout): the head tile, 16 or 24 (resident weights, Cin
// <= RES_MAX_CIN), else 64, 128 or 256.
int tile_n(int Cin, int Cout) {
  if (Cout <= HEAD_MAX_COUT && Cin <= RES_MAX_CIN)
    return Cout <= 16 ? 16 : 24;
  return Cout <= 64 ? 64 : Cout <= 128 ? 128 : 256;
}

template <int BN, int TNSPB, bool RES = false>
cudaError_t launch(const __nv_bfloat16* x, const __nv_bfloat16* w,
                   const float* a, const float* b, __nv_bfloat16* out, int N,
                   int H, int W, int Cin, int Cout, int relu, int flip,
                   cudaStream_t stream) {
  using T = Tile<BN, RES>;
  CUtensorMap xmap, wmap;
  const uint64_t xd[4] = {static_cast<uint64_t>(Cin),
                          static_cast<uint64_t>(W), static_cast<uint64_t>(H),
                          static_cast<uint64_t>(N)};
  const uint64_t xs[3] = {2ull * Cin, 2ull * Cin * W, 2ull * Cin * W * H};
  const uint32_t xb[4] = {64, PW, T::PH, 1};
  if (!sm90::encode_bf16_map(&xmap, x, 4, xd, xs, xb))
    return cudaErrorInvalidValue;
  if constexpr (!T::HEAD) {
    // forward: (Cout, Cin, 9) in 64 x 64 boxes; flip: (Cin, Cout, 9) with
    // this call's Cin innermost, in 64 x BN boxes
    const uint64_t inner = TNSPB == 1 ? Cout : Cin;
    const uint64_t outer = TNSPB == 1 ? Cin : Cout;
    const uint64_t wd[3] = {inner, outer, 9};
    const uint64_t wstr[2] = {2 * inner, 2 * inner * outer};
    const uint32_t wbox[3] = {64, TNSPB == 1 ? 64u : static_cast<uint32_t>(BN),
                              1};
    if (!sm90::encode_bf16_map(&wmap, w, 3, wd, wstr, wbox))
      return cudaErrorInvalidValue;
  } else {
    wmap = xmap;  // unused
  }
  CUtensorMap omap = xmap;  // the head tile stores directly
  if constexpr (!T::HEAD) {
    const uint64_t od[4] = {static_cast<uint64_t>(Cout),
                            static_cast<uint64_t>(W), static_cast<uint64_t>(H),
                            static_cast<uint64_t>(N)};
    const uint64_t os[3] = {2ull * Cout, 2ull * Cout * W,
                            2ull * Cout * W * H};
    const uint32_t ob[4] = {64, TW, 1, 1};
    if (!sm90::encode_bf16_map(&omap, out, 4, od, os, ob))
      return cudaErrorInvalidValue;
  }
  auto kern = conv3x3_bn_relu_wgmma_kernel<BN, TNSPB, RES>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const int64_t tiles = static_cast<int64_t>(N) * ((H + T::TH - 1) / T::TH) *
                        ((W + TW - 1) / TW) * ((Cout + BN - 1) / BN);
  if (tiles > 2147483647LL) return cudaErrorInvalidConfiguration;
  // with RES, a grid that is a multiple of the output-channel tiles keeps
  // each block on one tile of channels, so its taps load once
  const int tiles_n = (Cout + BN - 1) / BN;
  int grid = static_cast<int>(tiles < sms ? tiles : sms);
  if (RES && grid > tiles_n) grid -= grid % tiles_n;
  kern<<<grid, THREADS, T::SMEM, stream>>>(xmap, wmap, omap, w, a, b, out, N,
                                           H, W, Cin, Cout, relu, flip);
  return cudaGetLastError();
}

cudaError_t run(const __nv_bfloat16* x, const __nv_bfloat16* w,
                const float* a, const float* b, __nv_bfloat16* out, int N,
                int H, int W, int Cin, int Cout, int relu, int flip,
                cudaStream_t st) {
  const int bn = tile_n(Cin, Cout);
  if (Cin <= 64 && (bn == 64 || bn == 128))
    return flip ? launch<64, 0, true>(x, w, a, b, out, N, H, W, Cin, Cout,
                                      relu, flip, st)
                : launch<64, 1, true>(x, w, a, b, out, N, H, W, Cin, Cout,
                                      relu, flip, st);
  switch (bn) {
    case 16:
      return launch<16, 0>(x, w, a, b, out, N, H, W, Cin, Cout, relu, flip,
                           st);
    case 24:
      return launch<24, 0>(x, w, a, b, out, N, H, W, Cin, Cout, relu, flip,
                           st);
    case 64:
      return flip ? launch<64, 0>(x, w, a, b, out, N, H, W, Cin, Cout, relu,
                                  flip, st)
                  : launch<64, 1>(x, w, a, b, out, N, H, W, Cin, Cout, relu,
                                  flip, st);
    case 128:
      return flip ? launch<128, 0>(x, w, a, b, out, N, H, W, Cin, Cout, relu,
                                   flip, st)
                  : launch<128, 1>(x, w, a, b, out, N, H, W, Cin, Cout, relu,
                                   flip, st);
    default:
      return flip ? launch<256, 0>(x, w, a, b, out, N, H, W, Cin, Cout, relu,
                                   flip, st)
                  : launch<256, 1>(x, w, a, b, out, N, H, W, Cin, Cout, relu,
                                   flip, st);
  }
}

}  // namespace wg

}  // namespace

// The path that takes (Cin, Cout): 1 wgmma (Cin % 8 == 0, and the head
// tile's Cout <= 24 with Cin <= 128, or TMA's tiles for Cout % 8 == 0
// above 16), 2 packed (Cin % 8 != 0 with 9 x Cin <= K_MAX and Cout % 8 ==
// 0: the stem, the heads' dx), 0 narrow (the rest: UNet 9/16's 36- and
// 72-channel blocks, a 150-class head).
// ops/fused_conv.py::conv_path holds the same rule.
extern "C" int conv3x3_bn_relu_path(int Cin, int Cout) {
  if (Cin % 8 == 0) {
    if (Cout <= wg::HEAD_MAX_COUT && Cin <= wg::RES_MAX_CIN) return 1;
    return Cout > 16 && Cout % 8 == 0 ? 1 : 0;
  }
  return 9 * Cin <= packed::K_MAX && Cout % 8 == 0 ? 2 : 0;
}

// The narrow path's plan of (Cin, Cout) into out[4]: N tile, channel
// tiles, patch stages, shared memory bytes (0 where none fits).
// ops/fused_conv.py::narrow_fwd_plan holds the same rule.
extern "C" void conv3x3_bn_relu_narrow_plan(int Cin, int Cout, int* out) {
  const narrow::Plan p = narrow::plan(Cin, Cout);
  out[0] = p.bn;
  out[1] = p.tiles_n;
  out[2] = p.stages;
  out[3] = p.smem;
}

// out (N,H,W,Cout) <- x (N,H,W,Cin), w (3,3,Cin,Cout) HWIO, or with flip
// w (3,3,Cout,Cin) read tap-reversed and transposed; a, b (Cout,) f32.
// *route: the kernel launched, the path's code (conv3x3_bn_relu_path) or 3
// where the narrow path's plan holds no tile and mma_sync takes the call.
extern "C" int conv3x3_bn_relu_bf16(const void* x, const void* w,
                                    const void* a, const void* b, void* out,
                                    int N, int H, int W, int Cin, int Cout,
                                    int relu, int flip, void* stream,
                                    int* route) {
  *route = -1;
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto xb = static_cast<const __nv_bfloat16*>(x);
  auto wb = static_cast<const __nv_bfloat16*>(w);
  auto af = static_cast<const float*>(a);
  auto bf = static_cast<const float*>(b);
  auto ob = static_cast<__nv_bfloat16*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (*route = conv3x3_bn_relu_path(Cin, Cout)) {
    case 1:
      err = wg::run(xb, wb, af, bf, ob, N, H, W, Cin, Cout, relu, flip, st);
      break;
    case 2:
      err = packed::run(xb, wb, af, bf, ob, N, H, W, Cin, Cout, relu, flip,
                        st);
      break;
    default:
      err = narrow::run(xb, wb, af, bf, ob, N, H, W, Cin, Cout, relu, flip,
                        st, route);
  }
  return static_cast<int>(err);
}
