// Fused conv3x3 (pad 1, stride 1) + per-channel affine + optional ReLU, NHWC
// bf16 in / bf16 out, f32 accumulation, for Hopper (sm_90a).
//
//     out[n,h,w,co] = relu( sum_{dy,dx,ci} x[n,h+dy-1,w+dx-1,ci] * W[dy,dx,ci,co]
//                           * A[co] + B[co] )
//
// Replaces the TPU kernel pytorch_camvid_tpu/ops/pallas_conv.py::_conv3x3_impl
// (body _conv_kernel): the eval-mode conv+BN+ReLU block with BN folded into
// (A, B). The TPU-only workarounds of that kernel (the Cin<128 zero pad, the
// flat 8-aligned padded layout with its garbage columns, the cross-grid-step
// DMA prefetch, the VMEM tile picker) have no counterpart here: the halo comes
// from bounds checks (cp.async zero-fill), ragged tiles are masked at the
// store, and any Cin / Cout / H / W is taken without padding device memory.
//
// Design: an implicit GEMM. M = output pixels, N = output channels,
// K = 9 taps x Cin. One block of 8 warps computes an output tile of
// TH x TW = 8 x 16 pixels x BN = 64 channels. Per chunk of KC = 32 input
// channels it stages, double-buffered with cp.async, the (TH+2) x (TW+2)
// input patch (one-pixel halo) and the (3,3,KC,BN) weight slice in shared
// memory; each warp then walks the 9 taps, reading its A fragments straight
// out of the patch at the tap's offset (ldmatrix takes one row address per
// lane, so the shifted window needs no copy) and its B fragments with
// ldmatrix.trans, and accumulates on the tensor cores (mma.sync m16n8k16 bf16,
// f32 accumulators in registers). The epilogue applies acc*A+B, ReLU, and
// stores bf16. Offsets into x and out are 64-bit.
//
// What bounds it on the H100 (989 TFLOP/s bf16, 3.35 TB/s: ridge ~295
// FLOP/byte): every UNet shape with Cin, Cout >= 64 has 290 to several
// thousand FLOP per byte of input+output, so it is compute-bound; the design
// keeps the tensor cores fed from shared memory with conflict-free ldmatrix
// strides and reuses each staged patch for 9 taps x 64 channels. The Cin=3
// stem (~26 FLOP/byte) and the Cout=12 head (~90) are bound by bytes: the
// kernel reads each input pixel once per 64 output channels (plus a
// (TH+2)(TW+2)/(TH*TW) = 1.4x halo re-read, mostly from L2) and writes the
// output once, with no im2col or padded copy in device memory. On those two
// shapes this simple tiling still wastes most of its MMA work (3 of 32 input
// channels, 12 of 64 output channels) and stages them with scalar loads;
// wgmma, TMA, narrow tiles and tuning are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
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

// Stage input channels [c0, c0+KC) of the patch around output tile
// (n, h0, w0) and the matching weight slice for output channels [n0, n0+BN).
// VEC_X: Cin % 8 == 0 and x 16-byte aligned -> 16-byte cp.async per 8
// channels; otherwise scalar loads (the Cin=3 stem). VEC_W likewise for
// Cout % 8 == 0 (the Cout=12 head takes the scalar path).
template <bool VEC_X, bool VEC_W>
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
      cp_async16(patch + pix * KCP + v * 8, src, ok ? 16 : 0);
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
      cp_async16(wt + row * BNP + v * 8, src, ok ? 16 : 0);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int i = tid; i < 9 * KC * BN; i += THREADS) {
      const int row = i / BN, j = i % BN;
      const int tap = row / KC, k = row % KC;
      const int ci = c0 + k, co = n0 + j;
      const bool ok = ci < Cin && co < Cout;
      wt[row * BNP + j] =
          ok ? w[(static_cast<int64_t>(tap) * Cin + ci) * Cout + co] : zero;
    }
  }
}

template <bool VEC_X, bool VEC_W>
__global__ void __launch_bounds__(THREADS, 2)
    conv3x3_bn_relu_kernel(const __nv_bfloat16* __restrict__ x,
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
  stage_chunk<VEC_X, VEC_W>(smem, smem + PATCH_ELEMS, x, w, n, h0, w0, n0, 0,
                            H, W, Cin, Cout);
  cp_async_commit();

  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) {
      __nv_bfloat16* nxt = smem + ((c + 1) & 1) * STAGE_ELEMS;
      stage_chunk<VEC_X, VEC_W>(nxt, nxt + PATCH_ELEMS, x, w, n, h0, w0, n0,
                                (c + 1) * KC, H, W, Cin, Cout);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
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
          ldmatrix_x4(a[mt], patch_s + 2 * (a_off[mt] +
                                            (dy * PW + dx) * KCP + kk));
        uint32_t b[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          ldmatrix_x4_trans(b[j], wt_s + 2 * (b_off + (tap * KC + kk) * BNP +
                                              j * 16));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_bf16_16816(acc[mt][nt], a[mt], b[nt >> 1][(nt & 1) * 2],
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

template <bool VEC_X, bool VEC_W>
cudaError_t launch(const __nv_bfloat16* x, const __nv_bfloat16* w,
                   const float* a, const float* b, __nv_bfloat16* out, int N,
                   int H, int W, int Cin, int Cout, int relu,
                   cudaStream_t stream) {
  auto kern = conv3x3_bn_relu_kernel<VEC_X, VEC_W>;
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

}  // namespace

extern "C" int conv3x3_bn_relu_bf16(const void* x, const void* w,
                                    const void* a, const void* b, void* out,
                                    int N, int H, int W, int Cin, int Cout,
                                    int relu, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec_x =
      Cin % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool vec_w =
      Cout % 8 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  auto xb = static_cast<const __nv_bfloat16*>(x);
  auto wb = static_cast<const __nv_bfloat16*>(w);
  auto af = static_cast<const float*>(a);
  auto bf = static_cast<const float*>(b);
  auto ob = static_cast<__nv_bfloat16*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (vec_x && vec_w)
    err = launch<true, true>(xb, wb, af, bf, ob, N, H, W, Cin, Cout, relu, st);
  else if (vec_x)
    err = launch<true, false>(xb, wb, af, bf, ob, N, H, W, Cin, Cout, relu, st);
  else if (vec_w)
    err = launch<false, true>(xb, wb, af, bf, ob, N, H, W, Cin, Cout, relu, st);
  else
    err = launch<false, false>(xb, wb, af, bf, ob, N, H, W, Cin, Cout, relu, st);
  return static_cast<int>(err);
}
