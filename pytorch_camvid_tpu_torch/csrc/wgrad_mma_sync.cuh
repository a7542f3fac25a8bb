// The narrow dW's first design: mma.sync m16n8k16 on 9 taps x 32 input x
// 64 output channels a block, the patch and the cotangent tile staged by
// cp.async where a side's channels are a multiple of 8 and by one 2-byte
// load a pixel and channel where not, split-K at eight blocks an SM. No
// path of the port runs it: dw_variants.py's ``narrow_first`` variant
// includes it into conv3x3_wgrad.cu's anonymous namespace in place of the
// narrow kernel, for the reading the redesign is held against.
#pragma once

namespace mma_sync {

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

}  // namespace mma_sync
