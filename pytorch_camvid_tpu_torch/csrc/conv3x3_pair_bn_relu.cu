// Fused conv3x3 (pad 1, stride 1) + per-channel affine + optional ReLU for
// shallow convs (Cin <= 128, Cout <= 64), NHWC bf16 in / bf16 out, f32
// accumulation, for Hopper (sm_90a): K5.
//
//     out[n,h,w,co] = relu( sum_{dy,dx,ci} x[n,h+dy-1,w+dx-1,ci] * W[dy,dx,ci,co]
//                           * A[co] + B[co] )
//
// Replaces the TPU kernel pytorch_camvid_tpu/ops/pallas_conv_pair.py::
// _conv3x3_pair_impl (body _pair_kernel). That kernel packs each pair of
// output rows into the lanes of the TPU's 128-wide matrix unit through a
// block-structured pair-tap weight (_build_pair_taps), at twice the true
// FLOPs. The packing is a TPU trick and is not carried over; what carries is
// the point of the kernel: the weights of a shallow conv are small enough to
// stay on chip, and vertically adjacent output rows share input rows.
//
// Design (the machinery of conv3x3_bn_relu.cu's wgmma path, sm90_common.cuh):
// - Persistent, warp-specialised blocks, one per SM, of two consumer
//   warpgroups and two producer warps (320 threads). The consumers take the
//   block's tiles in turn (tile i of the block goes to warpgroup i % 2), so
//   one's epilogue and loads run while the other's wgmmas do. Producer
//   thread 256 loads the weights and warpgroup 0's patches, thread 288
//   warpgroup 1's, each into its consumer's ring of SPW = 2 patch stages
//   guarded by full/empty mbarriers. ptxas compiles every thread to 168
//   registers (the SM's four schedulers hold 16,384 each, and three of the
//   ten warps share one), so the consumers' 128 accumulators leave room for
//   one patch row's A fragment per commit group (RG = 1): with two or three
//   rows per group ptxas spills and serializes the wgmmas. One consumer
//   warpgroup (160 threads, 255 registers) fits more rows per group but
//   loses the overlap and is slower; k5_variants.py times these variants
//   on the card (PERF.md).
// - Weights: all 9 x Cin x 64 stay resident, loaded once per block by TMA
//   (one 64 (Cin) x 64 (Cout) box of 8192 bytes per tap and 64 input
//   channels, 128-byte swizzle, zero past Cin and Cout), N-major as the
//   forward of conv3x3_bn_relu.cu reads them (the descriptor's transpose
//   bit): 73,728 B at Cin <= 64, 147,456 B at Cin <= 128. No weight copy,
//   one launch per call.
// - A tile is TH = 4 output rows x TW = 64 columns x all 64 output channels
//   (Cout < 64: the zero weights past Cout, and the store clips). Its input
//   is a 6-row x 66-column patch that TMA loads KC input channels at a time
//   through a 4-D tensor map over x (C, W, H, N); the halo's coordinates lie
//   outside the image and TMA fills them with zeros, as it does past Cin.
// - The MMAs: wgmma.m64n64k16, bf16, f32 accumulators, A in registers. A
//   warpgroup's m64 tile is one output row of 64 columns (warp w: columns
//   16w .. 16w+15); a consumer thread holds all TH = 4 rows, 4 x 32 = 128
//   accumulators.
// - The H-pair reuse, K5's own idea: for each 16-channel step and tap dx,
//   the A fragment of patch row r (ldmatrix from the swizzled patch at the
//   tap's column shift) is loaded once and feeds up to three wgmmas, one
//   per tap dy, each into the accumulator of output row r - dy, with B by
//   that tap's descriptor. That is (TH + 2) = 6 A loads per 12 wgmmas, where
//   K4 loads A anew for each of its 9 taps (36 per 36 at TH = 4): half of
//   the A side of the shared-memory traffic that bounds K4's N = 64 tiles.
//   Each patch row's (up to three) wgmmas form a commit group; the A
//   fragments are double-buffered across groups (wgmma.wait_group 1).
// - Epilogue: acc * A[co] + B[co], the optional ReLU and bf16; each warp
//   writes one output row of 16 pixels x 64 channels (2048 B, 128-byte
//   swizzle) into its staging box and hands it to a TMA store, which clips
//   H, W and Cout and runs while the next rows are written and the other
//   warpgroup's wgmmas run.
// - The shared-memory budget is the crux. At Cin 128 the resident weights
//   leave 84,992 of the 232,448 B a block may have, where two 64-channel
//   patch stages (2 x 50,688 B) per consumer do not fit. So the patch stage
//   narrows with Cin, KC input channels per stage, the swizzle matching the
//   stage's row of KC x 2 bytes; each consumer keeps two stages:
//     Cin <= 64:  KC = 32 (64-byte swizzle), 25,344 B a stage, 25,600
//                 aligned: 1024 + 73,728 + 8 x 2048 + 4 x 25,600 + 72
//                 = 193,608 B;
//     Cin <= 128: KC = 16 (32-byte swizzle), 12,672 B a stage, 13,312
//                 aligned: 1024 + 147,456 + 8 x 2048 + 4 x 13,312 + 72
//                 = 218,184 B.
//   smem_bytes() computes these; a static_assert holds the largest and the
//   launch refuses a plan above the card's limit (no fallback).
//   ops/fused_conv_pair.py::tile_plan holds the same figures.
//
// What bounds it on the H100 (989 TFLOP/s bf16, 3.35 TB/s): at 360x480,
// 64->64 does 288 FLOP per byte of input + output and is bound by bytes;
// 128->64 (384 FLOP/byte) by operations. Per 12 wgmmas (384 tensor cycles
// of an SM) the A loads read 12 KB and the wgmmas' B 24 KB of shared
// memory: 94 of the 128 bytes a cycle it gives.
//
// Contract (the wrapper checks it and this file checks it again): H even,
// Cin a multiple of 16 in [16, 128], Cout a multiple of 16 in [16, 64], any
// W; x, w and out 16-byte aligned. TMA addresses x and out with 64-bit
// strides, so inputs past 2^31 elements are right.

#include "sm90_common.cuh"

namespace {

using sm90::smem_u32;

constexpr int TH = 4;             // output rows per tile
constexpr int TW = 64;            // output columns per tile (one m64)
constexpr int PR = TH + 2;        // patch rows (one-row halo each side)
constexpr int PW = TW + 2;        // patch columns (one-pixel halo)
constexpr int BN = 64;            // output channels per tile (all of Cout)
constexpr int SPW = 2;            // patch stages per consumer warpgroup
constexpr int RG = 1;             // patch rows per wgmma commit group
constexpr int THREADS = 320;      // warpgroups 0, 1 consume; warps 8, 9
                                  // produce
constexpr int CONSUMER_WARPS = 8;
constexpr int MAX_CIN = 128;
constexpr int MAX_COUT = BN;
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory of one block
constexpr int W_TILE = 64 * BN * 2;  // one tap x 64 input channels: 8192 B
constexpr int OUT_WARP = 16 * BN * 2;  // a warp's output row: 2048 B
constexpr int BARS = 1 + 2 * 2 * SPW;  // weights; full/empty per stage

constexpr int align1024(int b) { return (b + 1023) / 1024 * 1024; }

// KC input channels per patch stage: 32 up to Cin 64, 16 above.
template <int KC>
struct Plan {
  static constexpr int ROW = KC * 2;               // bytes of a pixel
  static constexpr int PATCH_TX = PR * PW * ROW;   // one TMA box
  static constexpr int PATCH = align1024(PATCH_TX);
  static constexpr int MAX_CIN = KC == 32 ? 64 : 128;
  static constexpr CUtensorMapSwizzle SWIZZLE =
      KC == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
};

// Shared bytes of a block at ``cin``: alignment slack, resident weights,
// output staging, patch stages, barriers.
template <int KC>
constexpr int smem_bytes(int cin) {
  return 1024 + (cin + 63) / 64 * 9 * W_TILE + CONSUMER_WARPS * OUT_WARP +
         2 * SPW * Plan<KC>::PATCH + BARS * 8;
}
static_assert(smem_bytes<32>(64) == 193608, "Cin 64 plan");
static_assert(smem_bytes<16>(128) == 218184, "Cin 128 plan");
static_assert(smem_bytes<32>(64) <= SMEM_LIMIT &&
                  smem_bytes<16>(128) <= SMEM_LIMIT,
              "each plan fits one block's shared memory");

// Byte address of 16-byte chunk ``chunk`` of pixel ``pix`` of a patch that
// TMA wrote with the swizzle of ``row``-byte rows (32, 64 or 128) from a
// 1024-byte aligned ``base``: offset bits 4.. are XORed with bits 7..
template <int ROW>
__device__ __forceinline__ uint32_t swz(uint32_t base, int pix, int chunk) {
  const uint32_t o = pix * ROW + chunk * 16;
  return base + (o ^ ((o >> 3) & (ROW - 16)));
}

template <int KC>
__global__ void __launch_bounds__(THREADS, 1)
    conv3x3_pair_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap wmap,
                        const __grid_constant__ CUtensorMap omap,
                        const float* __restrict__ scale,
                        const float* __restrict__ shift, int N, int H, int W,
                        int Cin, int Cout, int relu) {
  using P = Plan<KC>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const int nw = (Cin + 63) / 64;  // 64-channel weight tiles per tap
  unsigned char* wres = smem;
  unsigned char* ostage = wres + nw * 9 * W_TILE;
  unsigned char* patch = ostage + CONSUMER_WARPS * OUT_WARP;
  uint64_t* wbar = reinterpret_cast<uint64_t*>(patch + 2 * SPW * P::PATCH);
  uint64_t* pfull = wbar + 1;           // [warpgroup][stage]
  uint64_t* pempty = pfull + 2 * SPW;

  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  const int total = N * tiles_h * tiles_w;  // < 2^31 (host)
  const int nch = (Cin + KC - 1) / KC;
  // tile -> (image, first row, first column), the column tile fastest
  auto origin = [&](int t, int& img, int& h0, int& w0) {
    w0 = t % tiles_w * TW;
    t /= tiles_w;
    h0 = t % tiles_h * TH;
    img = t / tiles_h;
  };

  if (threadIdx.x == 0) {
    sm90::mbar_init(wbar, 1);
    for (int i = 0; i < 2 * SPW; ++i) {
      sm90::mbar_init(&pfull[i], 1);
      sm90::mbar_init(&pempty[i], 4);  // the consumer's four warps
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 2) {
    // ----------------------------------------------------- producers
    const int g = threadIdx.x == 256 ? 0 : threadIdx.x == 288 ? 1 : -1;
    if (g < 0) return;
    if (g == 0) {
      sm90::prefetch_tensormap(&wmap);
      sm90::mbar_arrive_expect_tx(wbar, nw * 9 * W_TILE);
      for (int c = 0; c < nw; ++c)
        for (int tap = 0; tap < 9; ++tap)
          sm90::tma_load_3d(wres + (c * 9 + tap) * W_TILE, &wmap, wbar, 0,
                            c * 64, tap);
    }
    sm90::prefetch_tensormap(&xmap);
    uint32_t it = 0;
    for (int t = blockIdx.x + g * gridDim.x; t < total; t += 2 * gridDim.x) {
      int img, h0, w0;
      origin(t, img, h0, w0);
      for (int c = 0; c < nch; ++c, ++it) {
        const int s = g * SPW + it % SPW;
        sm90::mbar_wait(&pempty[s], ((it / SPW) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&pfull[s], P::PATCH_TX);
        sm90::tma_load_4d(patch + s * P::PATCH, &xmap, &pfull[s], c * KC,
                          w0 - 1, h0 - 1, img);
      }
    }
    return;
  }

  // ------------------------------------------------------- consumers
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const uint32_t wres0 = smem_u32(wres);
  const uint32_t patch0 = smem_u32(patch);
  unsigned char* st = ostage + (wgi * 4 + warp) * OUT_WARP;
  const uint32_t st0 = smem_u32(st);
  // patch pixel of row 0, tap dx = 0, for this lane's A row
  const int pbase = warp * 16 + (lane & 15);
  sm90::mbar_wait(wbar, 0);

  uint32_t it = 0;
  for (int t = blockIdx.x + wgi * gridDim.x; t < total; t += 2 * gridDim.x) {
    int img, h0, w0;
    origin(t, img, h0, w0);
    float acc[TH][BN / 2];
#pragma unroll
    for (int o = 0; o < TH; ++o)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[o][i] = 0.f;

    for (int c = 0; c < nch; ++c, ++it) {
      const int s = wgi * SPW + it % SPW;
      sm90::mbar_wait(&pfull[s], (it / SPW) & 1);
      const uint32_t pb = patch0 + s * P::PATCH;
      const int steps = min(KC / 16, (Cin - c * KC) / 16);
      uint32_t afrag[2][RG][4];  // [buffer][row of the group]
#pragma unroll
      for (int j = 0; j < KC / 16; ++j) {
        if (j >= steps) break;  // uniform: Cin % KC == 16
        const int ci = c * KC + 16 * j;  // first input channel of the step
        const uint32_t wb = wres0 + (ci / 64) * 9 * W_TILE + (ci % 64) / 16 *
                                                                 2048;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
          for (int rg = 0; rg < PR / RG; ++rg) {
            const int buf = ((j * 3 + dx) * (PR / RG) + rg) & 1;
#pragma unroll
            for (int q = 0; q < RG; ++q)
              sm90::ldmatrix_x4(
                  afrag[buf][q],
                  swz<P::ROW>(pb, (RG * rg + q) * PW + pbase + dx,
                              2 * j + (lane >> 4)));
            sm90::wgmma_fence();
#pragma unroll
            for (int q = 0; q < RG; ++q) {
              const int r = RG * rg + q;  // patch row: output row r - dy
#pragma unroll
              for (int dy = 0; dy < 3; ++dy) {
                const int o = r - dy;
                if (o < 0 || o >= TH) continue;
                const uint64_t desc = sm90::wgmma_desc(
                    wb + (dy * 3 + dx) * W_TILE, 8192, 1024, 1);
                sm90::wgmma_rs<BN, 1>(acc[o], afrag[buf][q], desc);
              }
            }
            sm90::wgmma_commit();
            sm90::wgmma_wait<1>();
          }
        }
      }
      sm90::wgmma_wait<0>();
      if (lane == 0) sm90::mbar_arrive(&pempty[s]);
    }
#pragma unroll
    for (int o = 0; o < TH; ++o) sm90::fence_regs(acc[o]);

    // Epilogue. Accumulator i: pixel lane/4 (+8 for i%4 >= 2) of this
    // warp's 16, channel 8*(i/4) + 2*(lane%4) + i%2.
#pragma unroll
    for (int o = 0; o < TH; ++o) {
      if (h0 + o >= H) break;  // uniform: the last tile at H % 4 == 2
      if (lane == 0) sm90::bulk_wait<0, true>();  // the box was read
      __syncwarp();
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int co = 8 * j + 2 * (lane & 3);
        const bool in = co < Cout;  // Cout % 16 == 0: co + 1 too
        const float a0 = in ? scale[co] : 0.f, a1 = in ? scale[co + 1] : 0.f;
        const float b0 = in ? shift[co] : 0.f, b1 = in ? shift[co + 1] : 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float v0 = acc[o][4 * j + 2 * half] * a0 + b0;
          float v1 = acc[o][4 * j + 2 * half + 1] * a1 + b1;
          if (relu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
          const int p = (lane >> 2) + 8 * half;
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                           sm90::swz128(st0, p, j) + 4 * (lane & 3)),
                       "r"(*reinterpret_cast<const uint32_t*>(&v))
                       : "memory");
        }
      }
      sm90::fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        sm90::tma_store_4d(&omap, st, 0, w0 + warp * 16, h0 + o, img);
        sm90::bulk_commit();
      }
    }
  }
  if (lane == 0) sm90::bulk_wait<0, false>();  // the stores are done
}

template <int KC>
cudaError_t launch(const void* x, const void* w, const float* a,
                   const float* b, void* out, int N, int H, int W, int Cin,
                   int Cout, int relu, cudaStream_t stream) {
  using P = Plan<KC>;
  const int smem = smem_bytes<KC>(Cin);
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return err;
  if (Cin > P::MAX_CIN || smem > SMEM_LIMIT || smem > optin)
    return cudaErrorInvalidConfiguration;  // the plan does not fit
  const int64_t tiles = static_cast<int64_t>(N) * ((H + TH - 1) / TH) *
                        ((W + TW - 1) / TW);
  if (tiles > 2147483647LL) return cudaErrorInvalidConfiguration;

  CUtensorMap xmap, wmap, omap;
  const uint64_t xd[4] = {static_cast<uint64_t>(Cin),
                          static_cast<uint64_t>(W), static_cast<uint64_t>(H),
                          static_cast<uint64_t>(N)};
  const uint64_t xs[3] = {2ull * Cin, 2ull * Cin * W, 2ull * Cin * W * H};
  const uint32_t xb[4] = {KC, PW, PR, 1};
  if (!sm90::encode_bf16_map(&xmap, x, 4, xd, xs, xb, P::SWIZZLE))
    return cudaErrorInvalidValue;
  // w (3,3,Cin,Cout) HWIO as (Cout, Cin, 9), in 64 x 64 boxes
  const uint64_t wd[3] = {static_cast<uint64_t>(Cout),
                          static_cast<uint64_t>(Cin), 9};
  const uint64_t wstr[2] = {2ull * Cout, 2ull * Cout * Cin};
  const uint32_t wbox[3] = {64, 64, 1};
  if (!sm90::encode_bf16_map(&wmap, w, 3, wd, wstr, wbox))
    return cudaErrorInvalidValue;
  const uint64_t od[4] = {static_cast<uint64_t>(Cout),
                          static_cast<uint64_t>(W), static_cast<uint64_t>(H),
                          static_cast<uint64_t>(N)};
  const uint64_t os[3] = {2ull * Cout, 2ull * Cout * W, 2ull * Cout * W * H};
  const uint32_t ob[4] = {BN, 16, 1, 1};
  if (!sm90::encode_bf16_map(&omap, out, 4, od, os, ob))
    return cudaErrorInvalidValue;

  auto kern = conv3x3_pair_kernel<KC>;
  if ((err = cudaFuncSetAttribute(
           kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
      cudaSuccess)
    return err;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  kern<<<grid, THREADS, smem, stream>>>(xmap, wmap, omap, a, b, N, H, W, Cin,
                                        Cout, relu);
  return cudaGetLastError();
}

}  // namespace

// out (N,H,W,Cout) <- x (N,H,W,Cin), w (3,3,Cin,Cout) HWIO; a, b (Cout,)
// f32.
extern "C" int conv3x3_pair_bn_relu_bf16(const void* x, const void* w,
                                         const void* a, const void* b,
                                         void* out, int N, int H, int W,
                                         int Cin, int Cout, int relu,
                                         void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || H % 2 != 0 || Cin % 16 != 0 ||
      Cin < 16 || Cin > MAX_CIN || Cout % 16 != 0 || Cout < 16 ||
      Cout > MAX_COUT)
    return static_cast<int>(cudaErrorInvalidValue);
  if (((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
        reinterpret_cast<uintptr_t>(out)) &
       15) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  auto af = static_cast<const float*>(a);
  auto bf = static_cast<const float*>(b);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      Cin <= 64
          ? launch<32>(x, w, af, bf, out, N, H, W, Cin, Cout, relu, st)
          : launch<16>(x, w, af, bf, out, N, H, W, Cin, Cout, relu, st);
  return static_cast<int>(err);
}
