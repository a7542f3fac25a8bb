// One int8 post-training-quantized conv3x3 block (pad 1, stride 1), NHWC, for
// Hopper (sm_90a):
//
//   acc[n,h,w,c] = sum_{ky,kx,ci} x_q[n,h+ky-1,w+kx-1,ci] * w_q[ky,kx,ci,c]
//                  (int8 x int8 -> int32, SAME zero padding)
//   y   = relu(float(acc) * (s_x * s_w[c]) + b_eff[c])
//   out = int8 clip(round_half_even(y / s_out), -127, 127)   mode 0 (s_out)
//       = y as bf16 (mode 1) or f32 (mode 2)
//
// Replaces no Pallas kernel: in the JAX package the int8 block is XLA's
// conv on int8 operands with an int32 result (pytorch_camvid_tpu/ops/
// quant.py:246 conv2d_int8) and the elementwise epilogue XLA fuses after it
// (quant.py:261 quantized_block_apply). PyTorch has no int8 convolution on
// CUDA, so the whole block is this kernel (ops/fused_conv_int8.py wraps it;
// conv3x3_int8_block_plain is its plain version).
//
// The epilogue reproduces the plain version's f32 roundings one by one: the
// int32 -> f32 conversion (cvt.rn, as torch's .float()), the per-channel
// product s_x * s_w[c], the multiply, the add of b_eff, the ReLU, the
// division by s_out (IEEE, not a multiply by a reciprocal: requant takes
// the reciprocal's product only where it provably rounds to the same
// integer) and the round-half-even conversion, each its own rounded
// operation (__fmul_rn / __fadd_rn are never contracted into an FMA). So the
// kernel equals its plain version bit for bit in all three output modes.
//
// The weights come repacked once, at quantize time (fused_conv_int8.py::
// pack_weights), K-major as both 8-bit operands of wgmma and mma.sync must
// be: (9, Cout, Cin) for the wgmma path, (Cout, Kp) with k = tap * Cin + ci
// zero-padded to Kp = 32 * ceil(9 * Cin / 32) for the packed path.
//
// Two paths (conv3x3_int8_path; fused_conv_int8.int8_path holds the rule):
// * wgmma (Cin % 32 == 0: every quantized block of the models but the
//   stem). K4's wgmma design (conv3x3_bn_relu.cu, namespace wg) on int8:
//   an implicit GEMM, M = output pixels, N = output channels, K = 9 taps x
//   Cin in chunks of 128 channels (one 128-byte swizzle row), a persistent
//   block of three warpgroups: two producer threads of the third stream
//   TMA boxes into a patch ring and a weight ring guarded by full/empty
//   mbarriers; the two consumer warpgroups run wgmma.m64nNk32.s32.s8.s8
//   with A from registers (ldmatrix of the tap's shifted patch rows: the
//   16 x 32-byte A tile of a k32 step has the layout of bf16's 16 x 16, so
//   K4's addressing serves unchanged) and B K-major from shared memory (one
//   (tap, chunk) box of N rows x 128 bytes, 128-byte swizzle). TMA fills
//   the halo and the channels past Cin with zeros; the k32 steps past Cin
//   (Cin = 64: half of the chunk) are not issued. Tiles: at Cin <= 128 (one
//   chunk) N = 64 with the 9 taps resident (RES, 16 output rows, the grid a
//   multiple of the channel tiles, so a block loads its taps once): a
//   tap's few k32 steps are too short to hide the load of the next box,
//   which at first (4 streamed stages) left the 64- and 128-channel
//   full-resolution blocks waiting on their weights; past Cin 128 the
//   weights stream a tap at a time, N = 64, 128 or 256 by Cout.
// * packed (Cin < 32: the Cin = 3 stem and narrow test widths). A 3-byte
//   pixel row is no TMA row and K = 27 is no k32 step, so K packs the 9
//   taps x Cin tap-major, zero-padded to whole k32 steps (one at the stem).
//   Persistent blocks of 8 warps (three an SM) walk tiles of 8 output rows
//   x 32 columns x 64 channels: the Kp x 64 weights stay resident while the
//   channel tile does; each tile's (8 + 2) x (32 + 2) x Cin patch comes in
//   by byte loads (zeros outside the image); each A fragment is gathered
//   byte by byte at a table of packed-k offsets, B read as 32-bit words of
//   the K-major weights, and mma.sync.m16n8k32.s32.s8.s8 accumulates.
// Both epilogues stage each warp's 16 pixels x 64 channels in shared
// memory in the output type (the first design's direct 2-byte int8 stores
// took 40% of a full-resolution block on an H100) and write them with
// 16-byte stores, each pixel's channels contiguous, masked at H, W and
// Cout.
//
// What bounds it on the H100 (1,979 TOPS int8 dense, 3.35 TB/s): at
// 360x480 the quantized blocks with Cin >= 128 sit above the ridge (~590
// operations a byte) and are bound by the tensor cores; the stem and the
// 64-channel full-resolution blocks by bytes. The epilogue is not
// overlapped with the next tile's products (no ping-pong), the known cost
// of this design (PERF.md).

#include <type_traits>

#include "sm90_common.cuh"

namespace {

using sm90::smem_u32;

// ------------------------------------------------------------ epilogue

__device__ __forceinline__ float dequant_relu(int acc, float scale,
                                              float bias) {
  const float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias);
  return fmaxf(y, 0.f);
}

// The requantize clip(round_half_even(fl(y / s_out)), -127, 127), y >= 0,
// fl the IEEE quotient, in two steps. requant_fast takes q0 = fl(y * r_out)
// with r_out = fl(1 / s_out): within 3 ulps (2^-24 relative each) of
// fl(y / s_out), so the two round to one integer unless q0 lies within that
// distance of a half-integer k + 1/2 with k < 127 (from 127 up every result
// clips to 127), where it sets ``near`` (margin 2^-22 q0, 4 ulps: about
// 3e-5 of the values). It rounds q0 half to even by adding 1.5 * 2^23
// (exact below 2^22; q0 is clipped to 255 first): the sum's low bits are
// the integer, on the FMA pipe. requant_exact divides: a warp whose lanes
// flagged any value of a staged row takes a second pass over the row in
// which each lane divides for its flagged values (store_row, store_tile),
// one vote a row. The division in line, predicated for every value,
// tripled the int8-out epilogue's time; a vote and branch for each channel
// pair cost 0.1 ms of a 64->64 block at 360x480, b8, on an H100 at 700 W
// (PERF.md).
__device__ __forceinline__ int requant_fast(float y, float r_out,
                                            bool& near) {
  constexpr float MAGIC = 12582912.f;  // 1.5 * 2^23
  const float q0 = fminf(__fmul_rn(y, r_out), 255.f);
  const float t = __fadd_rn(q0, MAGIC);
  const float d = __fsub_rn(q0, __fsub_rn(t, MAGIC));  // exact, |d| <= 1/2
  near = fabsf(__fsub_rn(0.5f, fabsf(d))) <= q0 * 0x1p-22f && q0 < 127.f;
  return min(__float_as_int(t) - __float_as_int(MAGIC), 127);
}

__device__ __noinline__ int requant_exact(float y, float s_out) {
  return min(max(__float2int_rn(__fdiv_rn(y, s_out)), -127), 127);
}

// Output staging: a warp's 16 output pixels x 64 channels in shared
// memory, each pixel's channels at a stride of STAGE_ROW bytes (the widest
// output type, f32, plus a pad that spreads the pixels over the banks),
// filled from the accumulators in the output type and then written to
// global memory with 16-byte stores, each pixel's channels contiguous there.
constexpr int STAGE_ROW = 64 * 4 + 32;
constexpr int STAGE_WARP = 16 * STAGE_ROW;

// Channels (c, c + 1) of staged pixel p from their epilogue values. In the
// int8 mode the fast requantize (``near`` gets the pair's flags) or, with
// EXACT, the division.
template <int MODE, bool EXACT = false>
__device__ __forceinline__ void stage_pair(unsigned char* st, int p, int c,
                                           float v0, float v1, float s_out,
                                           float r_out, bool& near) {
  constexpr int OB = MODE == 0 ? 1 : MODE == 1 ? 2 : 4;
  unsigned char* d = st + p * STAGE_ROW + c * OB;
  if constexpr (MODE == 0) {
    int q0, q1;
    bool n0, n1;
    q0 = requant_fast(v0, r_out, n0);
    q1 = requant_fast(v1, r_out, n1);
    if constexpr (EXACT) {  // a rare pass: a lane's flagged values only
      if (n0) q0 = requant_exact(v0, s_out);
      if (n1) q1 = requant_exact(v1, s_out);
    } else {
      near = near || n0 || n1;
    }
    *reinterpret_cast<char2*>(d) = make_char2(static_cast<signed char>(q0),
                                              static_cast<signed char>(q1));
  } else if constexpr (MODE == 1) {
    *reinterpret_cast<__nv_bfloat162*>(d) = __floats2bfloat162_rn(v0, v1);
  } else {
    *reinterpret_cast<float2*>(d) = make_float2(v0, v1);
  }
}

// The staged 16 pixels x ``nc`` channels (the chunk's channels below Cout)
// to output pixels pix0.. (flat, the row's first; ``np`` of them inside W)
// at channel c0. 16-byte vectors where Cout and nc allow, else elementwise.
template <int MODE>
__device__ __forceinline__ void copy_out(const unsigned char* st, void* out,
                                         int64_t pix0, int np, int c0,
                                         int nc, int Cout, int lane) {
  constexpr int OB = MODE == 0 ? 1 : MODE == 1 ? 2 : 4;
  unsigned char* o = static_cast<unsigned char*>(out);
  if ((Cout * OB) % 16 == 0 && (nc * OB) % 16 == 0) {
    constexpr int VPP = 64 * OB / 16;  // 16-byte vectors a pixel, at most
    const int vpp = nc * OB / 16;
    for (int v = lane; v < 16 * VPP; v += 32) {
      const int p = v / VPP, q = v % VPP;
      if (q >= vpp || p >= np) continue;
      *reinterpret_cast<uint4*>(o + ((pix0 + p) * Cout + c0) * OB +
                                q * 16) =
          *reinterpret_cast<const uint4*>(st + p * STAGE_ROW + q * 16);
    }
  } else {
    for (int e = lane; e < 16 * 64; e += 32) {
      const int p = e / 64, c = e % 64;
      if (c >= nc || p >= np) continue;
      unsigned char* d = o + ((pix0 + p) * Cout + c0 + c) * OB;
      const unsigned char* src = st + p * STAGE_ROW + c * OB;
#pragma unroll
      for (int b = 0; b < OB; ++b) d[b] = src[b];
    }
  }
}

// ---------------------------------------------------------- s8 wgmma

// wgmma.m64nNk32 s8 x s8 -> s32 with A in registers (the four 32-bit
// fragments of mma.m16n8k32 per warp: warp w holds rows 16w..16w+15, a0
// (g, 4t..4t+3), a1 (g + 8, ...), a2 (g, 16 + 4t..), a3 (g + 8, 16 + 4t..)
// for lane 4g + t) and B K-major from shared memory by descriptor (8-bit
// types have no transpose). D accumulates (scale-d 1).
__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (N == 64) wgmma_s8_n64(d, a, desc_b);
  else if constexpr (N == 128) wgmma_s8_n128(d, a, desc_b);
  else wgmma_s8_n256(d, a, desc_b);
}

// Keeps the compiler from moving reads or writes of an accumulator across
// this point (an in-flight wgmma owns the register).
template <int K>
__device__ __forceinline__ void fence_regs(int (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// ================================================================ wgmma

namespace wg {

constexpr int TW = 16;       // output columns per tile: one warp's m16
constexpr int PW = TW + 2;   // patch columns (with halo)
constexpr int KC = 128;      // input channels a chunk: one swizzle row
constexpr int THREADS = 384; // warpgroups 0, 1 consume; 2 produces
constexpr int CONSUMER_WARPS = 8;
constexpr int RES_MAX_CIN = KC;  // one chunk: the 9 taps can stay resident

// RES (Cin <= 128, one chunk): BN = 64, and the block's 9 (tap) weight
// boxes stay resident in a 9-stage ring while its output-channel tile
// stays the same (the grid is a multiple of the channel tiles), so they
// are loaded once a block: streamed a tap at a time, a k32 step of one tap
// is too short to hide the load of the next box.
template <int BN, bool RES>
struct Tile {
  static constexpr int MT = RES ? 2 : 256 / BN;  // m64 tiles a WG
  static constexpr int TH = 8 * MT;    // 2 WGs x MT x 4 output rows
  static constexpr int PH = TH + 2;
  static constexpr int PATCH_TX = PH * PW * KC;  // one 128-channel box
  static constexpr int PATCH_BYTES = (PATCH_TX + 1023) / 1024 * 1024;
  static constexpr int P_STAGES = 2;
  static constexpr int W_STAGES = RES ? 9 : BN == 256 ? 3 : 4;
  static constexpr int W_BYTES = BN * KC;  // one (tap, chunk): BN x 128
  static constexpr int STAGE_OFF = P_STAGES * PATCH_BYTES + W_STAGES * W_BYTES;
  static constexpr int BAR_OFF = STAGE_OFF + CONSUMER_WARPS * STAGE_WARP;
  static constexpr int SMEM = BAR_OFF + 2 * (P_STAGES + W_STAGES) * 8 + 1024;
};
static_assert(Tile<64, true>::SMEM <= 232448, "the resident tile fits");
static_assert(Tile<64, false>::SMEM <= 232448, "the N = 64 tile fits");
static_assert(Tile<128, false>::SMEM <= 232448, "the N = 128 tile fits");
static_assert(Tile<256, false>::SMEM <= 232448, "the N = 256 tile fits");

// A warp's output row: 16 pixels (w0.., row h) x the 64 channels from c0,
// from accumulators acc (its m64 tile), through its staging buffer.
template <int MODE, int NACC>
__device__ __forceinline__ void store_row(const int (&acc)[NACC], int j0,
                                          unsigned char* st, void* out,
                                          int img, int h, int w0, int c0,
                                          int H, int W, int Cout, int lane,
                                          const float* s_w,
                                          const float* b_eff, float s_x,
                                          float s_out, float r_out) {
  __syncwarp();  // the last row's copy-out has read the buffer
  bool near = false;
  auto stage = [&](auto exact) {
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int c = 8 * jj + 2 * (lane & 3);
      const int co = c0 + c;
      const bool in0 = co < Cout, in1 = co + 1 < Cout;
      const float sc0 = in0 ? __fmul_rn(s_x, s_w[co]) : 0.f;
      const float bb0 = in0 ? b_eff[co] : 0.f;
      const float sc1 = in1 ? __fmul_rn(s_x, s_w[co + 1]) : 0.f;
      const float bb1 = in1 ? b_eff[co + 1] : 0.f;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        stage_pair<MODE, decltype(exact)::value>(
            st, (lane >> 2) + 8 * hf, c,
            dequant_relu(acc[4 * (j0 + jj) + 2 * hf], sc0, bb0),
            dequant_relu(acc[4 * (j0 + jj) + 2 * hf + 1], sc1, bb1), s_out,
            r_out, near);
    }
  };
  stage(std::false_type{});
  if constexpr (MODE == 0)
    if (__any_sync(0xffffffffu, near)) stage(std::true_type{});
  __syncwarp();
  if (h < H)
    copy_out<MODE>(st, out, (static_cast<int64_t>(img) * H + h) * W + w0,
                   min(16, W - w0), c0, min(64, Cout - c0), Cout, lane);
}

template <int BN, bool RES>
__global__ void __launch_bounds__(THREADS, 1)
    conv3x3_int8_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                              const __grid_constant__ CUtensorMap wmap,
                              const float* __restrict__ s_w,
                              const float* __restrict__ b_eff,
                              const float* __restrict__ s_x_p,
                              const float* __restrict__ s_out_p,
                              void* __restrict__ out, int mode, int N, int H,
                              int W, int Cin, int Cout) {
  using T = Tile<BN, RES>;
  constexpr int MT = T::MT, TH = T::TH, P = T::P_STAGES, S = T::W_STAGES;
  // k32 steps per wgmma commit group: a tap's 4 where the registers allow
  // (RES, 64 accumulators), else 2
  constexpr int G = RES ? 4 : 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  unsigned char* patch = smem;
  unsigned char* wring = smem + P * T::PATCH_BYTES;
  unsigned char* ostage = smem + T::STAGE_OFF;
  uint64_t* pfull = reinterpret_cast<uint64_t*>(smem + T::BAR_OFF);
  uint64_t* pempty = pfull + P;
  uint64_t* wfull = pempty + P;
  uint64_t* wempty = wfull + S;

  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  const int tiles_n = (Cout + BN - 1) / BN;
  const int total = N * tiles_h * tiles_w * tiles_n;  // < 2^31 (host)
  const int nch = (Cin + KC - 1) / KC;
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
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 2) {
    // ----------------------------------------------------- producers
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
                            c * KC, w0 - 1, h0 - 1, img);
        }
      }
    } else if (threadIdx.x == 288) {
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
            sm90::tma_load_3d(wring + ws * T::W_BYTES, &wmap, &wfull[ws],
                              c * KC, n0, tap);
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
    unsigned char* st = ostage + (wgi * 4 + warp) * STAGE_WARP;
    const float s_x = *s_x_p;
    const float s_out = mode == 0 ? *s_out_p : 1.f;
    const float r_out = __frcp_rn(s_out);
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
      int acc[MT][BN / 2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[mt][i] = 0;

      for (int c = 0; c < nch; ++c, ++pit) {
        const int ps = pit % P;
        sm90::mbar_wait(&pfull[ps], (pit / P) & 1);
        const uint32_t pb = patch0 + ps * T::PATCH_BYTES;
        // k32 steps of this chunk inside Cin (uniform): the rest would add
        // the zeros TMA filled in
        const int steps = min(4, (Cin - c * KC) / 32);
        // A fragments of G k32 steps (one group, committed together) per
        // buffer; two buffers, so one group loads while the last runs
        uint32_t afrag[2][G][MT][4];
        int ws_prev = 0;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int shift_px = (tap / 3) * PW + tap % 3;
          int ws;
          if constexpr (RES) {  // stage tap of round wit / 9
            ws = tap;
            sm90::mbar_wait(&wfull[ws], ((wit - 9) / 9) & 1);
          } else {
            ws = wit % S;
            sm90::mbar_wait(&wfull[ws], (wit / S) & 1);
          }
          const uint32_t wb = wring0 + ws * T::W_BYTES;
#pragma unroll
          for (int gi = 0; gi < 4 / G; ++gi) {
            if (gi * G >= steps) {
              // nothing to add; let the last group finish, so the next
              // group's A buffer (this one's parity) is free
              sm90::wgmma_wait<0>();
              continue;
            }
            const int buf = (tap * (4 / G) + gi) & 1;
#pragma unroll
            for (int j = 0; j < G; ++j)
              if (gi * G + j < steps)
#pragma unroll
                for (int mt = 0; mt < MT; ++mt)
                  sm90::ldmatrix_x4(
                      afrag[buf][j][mt],
                      sm90::swz128(pb, pbase[mt] + shift_px,
                                   2 * (gi * G + j) + (lane >> 4)));
            sm90::wgmma_fence();
#pragma unroll
            for (int j = 0; j < G; ++j) {
              if (gi * G + j >= steps) continue;
              const uint64_t desc =
                  sm90::wgmma_desc(wb + (gi * G + j) * 32, 16, 1024, 1);
#pragma unroll
              for (int mt = 0; mt < MT; ++mt)
                wgmma_s8<BN>(acc[mt], afrag[buf][j][mt], desc);
            }
            sm90::wgmma_commit();
            sm90::wgmma_wait<1>();
            // the previous group, the previous tap's last, has completed:
            // its weights go
            if constexpr (!RES)
              if (gi == 0 && tap > 0 && lane == 0)
                sm90::mbar_arrive(&wempty[ws_prev]);
          }
          if constexpr (!RES) {
            ws_prev = ws;
            ++wit;
          }
        }
        sm90::wgmma_wait<0>();
        if (lane == 0) {
          if constexpr (!RES) sm90::mbar_arrive(&wempty[ws_prev]);
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
      for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);

      // Epilogue: each warp's output row of each m64 tile, 64 channels at
      // a time, through its staging buffer (store_row). Accumulator i of
      // m64 tile mt: output row h, column lane/4 (+8 for i%4 >= 2);
      // channel 8*(i/4) + 2*(lane%4) + i%2.
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int h = h0 + wgi * 4 * MT + mt * 4 + warp;
#pragma unroll
        for (int cb = 0; cb < BN / 64; ++cb) {
          const int c0 = n0 + 64 * cb;
          if (c0 >= Cout) break;
          if (mode == 0)
            store_row<0>(acc[mt], 8 * cb, st, out, img, h, w0, c0, H, W,
                         Cout, lane, s_w, b_eff, s_x, s_out, r_out);
          else if (mode == 1)
            store_row<1>(acc[mt], 8 * cb, st, out, img, h, w0, c0, H, W,
                         Cout, lane, s_w, b_eff, s_x, s_out, r_out);
          else
            store_row<2>(acc[mt], 8 * cb, st, out, img, h, w0, c0, H, W,
                         Cout, lane, s_w, b_eff, s_x, s_out, r_out);
        }
      }
    }
  }
}

// Tile N for (Cin, Cout): 64 with the taps resident (Cin <= 128), else 64,
// 128 or 256 by Cout.
int tile_n(int Cin, int Cout) {
  if (Cin <= RES_MAX_CIN) return 64;
  return Cout <= 64 ? 64 : Cout <= 128 ? 128 : 256;
}

template <int BN, bool RES>
cudaError_t launch(const int8_t* x, const int8_t* wk, const float* s_w,
                   const float* b_eff, const float* s_x, const float* s_out,
                   void* out, int mode, int N, int H, int W, int Cin,
                   int Cout, cudaStream_t stream) {
  using T = Tile<BN, RES>;
  CUtensorMap xmap, wmap;
  const uint64_t xd[4] = {static_cast<uint64_t>(Cin),
                          static_cast<uint64_t>(W), static_cast<uint64_t>(H),
                          static_cast<uint64_t>(N)};
  const uint64_t xs[3] = {1ull * Cin, 1ull * Cin * W, 1ull * Cin * W * H};
  const uint32_t xb[4] = {KC, PW, T::PH, 1};
  if (!sm90::encode_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, x, 4, xd, xs,
                        xb, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  // the repacked weights (9, Cout, Cin), Cin innermost, in KC x BN boxes
  const uint64_t wd[3] = {static_cast<uint64_t>(Cin),
                          static_cast<uint64_t>(Cout), 9};
  const uint64_t wstr[2] = {1ull * Cin, 1ull * Cin * Cout};
  const uint32_t wbox[3] = {KC, static_cast<uint32_t>(BN), 1};
  if (!sm90::encode_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, wk, 3, wd,
                        wstr, wbox, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  auto kern = conv3x3_int8_wgmma_kernel<BN, RES>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const int tiles_n = (Cout + BN - 1) / BN;
  const int64_t tiles = static_cast<int64_t>(N) * ((H + T::TH - 1) / T::TH) *
                        ((W + TW - 1) / TW) * tiles_n;
  if (tiles > 2147483647LL) return cudaErrorInvalidConfiguration;
  // with RES, a grid that is a multiple of the output-channel tiles keeps
  // each block on one tile of channels, so its taps load once
  int grid = static_cast<int>(tiles < sms ? tiles : sms);
  if (RES && grid > tiles_n) grid -= grid % tiles_n;
  kern<<<grid, THREADS, T::SMEM, stream>>>(xmap, wmap, s_w, b_eff, s_x, s_out,
                                           out, mode, N, H, W, Cin, Cout);
  return cudaGetLastError();
}

cudaError_t run(const int8_t* x, const int8_t* wk, const float* s_w,
                const float* b_eff, const float* s_x, const float* s_out,
                void* out, int mode, int N, int H, int W, int Cin, int Cout,
                cudaStream_t st) {
  if (Cin <= RES_MAX_CIN)
    return launch<64, true>(x, wk, s_w, b_eff, s_x, s_out, out, mode, N, H,
                            W, Cin, Cout, st);
  switch (tile_n(Cin, Cout)) {
    case 64:
      return launch<64, false>(x, wk, s_w, b_eff, s_x, s_out, out, mode, N,
                               H, W, Cin, Cout, st);
    case 128:
      return launch<128, false>(x, wk, s_w, b_eff, s_x, s_out, out, mode, N,
                                H, W, Cin, Cout, st);
    default:
      return launch<256, false>(x, wk, s_w, b_eff, s_x, s_out, out, mode, N,
                                H, W, Cin, Cout, st);
  }
}

}  // namespace wg

// =============================================================== packed

namespace packed {

constexpr int TH = 8;          // output rows a tile: one a warp
constexpr int TW = 32;         // output columns: two m16 tiles a warp
constexpr int PW = TW + 2;
constexpr int BN = 64;         // output channels a tile: 8 n8 tiles
constexpr int THREADS = 256;
constexpr int MAX_CIN = 31;
constexpr int KP_MAX = 288;    // 9 x 31 = 279 packed k, in whole k32 steps
constexpr int BLOCKS_PER_SM = 3;

// Kp: 9 taps x Cin packed, padded to whole k32 steps.
__host__ __device__ constexpr int kp(int Cin) { return (9 * Cin + 31) / 32 * 32; }
static_assert(kp(MAX_CIN) == KP_MAX, "the widest packed K");

// Shared memory: the resident weights, K-major rows of Kp bytes at a
// stride of Kp + 16 (the 8 rows a B fragment reads fall in distinct banks
// at Kp = 32); the tile's (8 + 2) x (32 + 2) x Cin patch; the packed-k
// offset table; the eight warps' staging buffers.
constexpr int W_BYTES = BN * (KP_MAX + 16);
constexpr int PATCH_BYTES = (TH + 2) * PW * MAX_CIN;
constexpr int PATCH_OFF = W_BYTES;
constexpr int KOFF_OFF = (PATCH_OFF + PATCH_BYTES + 15) / 16 * 16;
constexpr int STAGE_OFF = (KOFF_OFF + 2 * KP_MAX + 15) / 16 * 16;
constexpr int SMEM = STAGE_OFF + 8 * STAGE_WARP;
static_assert(BLOCKS_PER_SM * (SMEM + 1024) <= 228 * 1024,
              "three blocks an SM");

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One m16 column tile's output (16 pixels x 64 channels) of a warp from
// its accumulators acc[nt] (pixel g: channels 2t, 2t+1 of n8 tile nt in
// [0], [1]; pixel g + 8 in [2], [3]), through the warp's staging buffer.
template <int MODE>
__device__ __forceinline__ void store_tile(const int (&acc)[8][4],
                                           unsigned char* st, void* out,
                                           int64_t pix0, int np, int n0,
                                           int Cout, int lane,
                                           const float* s_w,
                                           const float* b_eff, float s_x,
                                           float s_out, float r_out) {
  const int g = lane >> 2, tq = lane & 3;
  __syncwarp();  // the last tile's copy-out has read the buffer
  bool near = false;
  auto stage = [&](auto exact) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = nt * 8 + 2 * tq;
      const int co = n0 + c;
      const bool in0 = co < Cout, in1 = co + 1 < Cout;
      const float sc0 = in0 ? __fmul_rn(s_x, s_w[co]) : 0.f;
      const float bb0 = in0 ? b_eff[co] : 0.f;
      const float sc1 = in1 ? __fmul_rn(s_x, s_w[co + 1]) : 0.f;
      const float bb1 = in1 ? b_eff[co + 1] : 0.f;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        stage_pair<MODE, decltype(exact)::value>(
            st, g + 8 * hf, c, dequant_relu(acc[nt][2 * hf], sc0, bb0),
            dequant_relu(acc[nt][2 * hf + 1], sc1, bb1), s_out, r_out,
            near);
    }
  };
  stage(std::false_type{});
  if constexpr (MODE == 0)
    if (__any_sync(0xffffffffu, near)) stage(std::true_type{});
  __syncwarp();
  copy_out<MODE>(st, out, pix0, np, n0, min(BN, Cout - n0), Cout, lane);
}

// A persistent block walks tiles of 8 rows x 32 columns x 64 channels,
// the channel tile fastest; it loads its channel tile's weights only when
// that changes (never, at Cout <= 64), each tile's patch with byte loads.
__global__ void __launch_bounds__(THREADS)
    conv3x3_int8_packed_kernel(const int8_t* __restrict__ x,
                               const int8_t* __restrict__ wk,
                               const float* __restrict__ s_w,
                               const float* __restrict__ b_eff,
                               const float* __restrict__ s_x_p,
                               const float* __restrict__ s_out_p,
                               void* __restrict__ out, int mode, int N, int H,
                               int W, int Cin, int Cout) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* w_s = reinterpret_cast<int8_t*>(smem);
  int8_t* patch = reinterpret_cast<int8_t*>(smem + PATCH_OFF);
  int16_t* koff = reinterpret_cast<int16_t*>(smem + KOFF_OFF);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  unsigned char* st = smem + STAGE_OFF + warp * STAGE_WARP;
  const int Kp = kp(Cin);
  const int wstride = Kp + 16;
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  const int tiles_n = (Cout + BN - 1) / BN;
  const int total = N * tiles_h * tiles_w * tiles_n;  // < 2^31 (host)
  const float s_x = *s_x_p;
  const float s_out = mode == 0 ? *s_out_p : 1.f;
  const float r_out = __frcp_rn(s_out);
  const int prow = PW * Cin;  // bytes of one patch row

  for (int k = threadIdx.x; k < Kp; k += THREADS) {
    int o = -1;
    if (k < 9 * Cin) {
      const int tap = k / Cin;
      o = ((tap / 3) * PW + tap % 3) * Cin + k % Cin;
    }
    koff[k] = static_cast<int16_t>(o);
  }
  int res_n0 = -1;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    int r = t;
    const int n0 = r % tiles_n * BN;
    r /= tiles_n;
    const int w0 = r % tiles_w * TW;
    r /= tiles_w;
    const int h0 = r % tiles_h * TH;
    const int img = r / tiles_h;
    __syncthreads();  // the last tile's reads of the patch (and weights)
    if (n0 != res_n0) {
      res_n0 = n0;
      for (int i = threadIdx.x; i < BN * Kp; i += THREADS) {
        const int n = i / Kp, k = i % Kp;
        w_s[n * wstride + k] =
            n0 + n < Cout ? wk[static_cast<int64_t>(n0 + n) * Kp + k] : 0;
      }
    }
    for (int i = threadIdx.x; i < (TH + 2) * prow; i += THREADS) {
      const int pr = i / prow, rem = i % prow;
      const int h = h0 - 1 + pr, ww = w0 - 1 + rem / Cin;
      int8_t v = 0;
      if (h >= 0 && h < H && ww >= 0 && ww < W)
        v = x[((static_cast<int64_t>(img) * H + h) * W + ww) * Cin +
              rem % Cin];
      patch[i] = v;
    }
    __syncthreads();

    int acc[2][8][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][nt][i] = 0;
    const int rowbase = warp * prow;  // the warp's output row's patch row
    for (int ks = 0; ks < Kp / 32; ++ks) {
      int kof[2][4];  // offsets of k = 32 ks + 16 hk + 4 tq + e
#pragma unroll
      for (int hk = 0; hk < 2; ++hk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          kof[hk][e] = koff[ks * 32 + 16 * hk + 4 * tq + e];
      uint32_t a[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // a0 (g, k 4t..), a1 (g + 8, k 4t..), a2 (g, k 16 + 4t..), a3
          const int base = rowbase + (m * 16 + g + 8 * (q & 1)) * Cin;
          uint32_t v = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int o = kof[q >> 1][e];
            const uint32_t byte =
                o >= 0 ? static_cast<uint8_t>(patch[base + o]) : 0u;
            v |= byte << (8 * e);
          }
          a[m][q] = v;
        }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int8_t* wr = w_s + (nt * 8 + g) * wstride + ks * 32 + 4 * tq;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(wr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(wr + 16);
#pragma unroll
        for (int m = 0; m < 2; ++m) mma_s8(acc[m][nt], a[m], b0, b1);
      }
    }

    const int h = h0 + warp;
    if (h >= H) continue;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int wc = w0 + m * 16;
      if (wc >= W) break;
      const int64_t pix0 = (static_cast<int64_t>(img) * H + h) * W + wc;
      const int np = min(16, W - wc);
      if (mode == 0)
        store_tile<0>(acc[m], st, out, pix0, np, n0, Cout, lane, s_w, b_eff,
                      s_x, s_out, r_out);
      else if (mode == 1)
        store_tile<1>(acc[m], st, out, pix0, np, n0, Cout, lane, s_w, b_eff,
                      s_x, s_out, r_out);
      else
        store_tile<2>(acc[m], st, out, pix0, np, n0, Cout, lane, s_w, b_eff,
                      s_x, s_out, r_out);
    }
  }
}

cudaError_t run(const int8_t* x, const int8_t* wk, const float* s_w,
                const float* b_eff, const float* s_x, const float* s_out,
                void* out, int mode, int N, int H, int W, int Cin, int Cout,
                cudaStream_t st) {
  const int64_t tiles = static_cast<int64_t>(N) * ((H + TH - 1) / TH) *
                        ((W + TW - 1) / TW) * ((Cout + BN - 1) / BN);
  if (tiles > 2147483647LL) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_int8_packed_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const int64_t cap = static_cast<int64_t>(sms) * BLOCKS_PER_SM;
  const int grid = static_cast<int>(tiles < cap ? tiles : cap);
  conv3x3_int8_packed_kernel<<<grid, THREADS, SMEM, st>>>(
      x, wk, s_w, b_eff, s_x, s_out, out, mode, N, H, W, Cin, Cout);
  return cudaGetLastError();
}

}  // namespace packed

// ============================================================= quantize

// The blocks' input quantize, clip(round_half_even(x / s), -127, 127) to
// int8, for an x in bf16 or f32 (the quantized block's input where it does
// not come as int8 from its producer: the stem, and every stage entry of
// UNet, whose skips and upsamples stay float). In the JAX package an
// elementwise op that XLA fuses into its neighbours (quant.py:275); as
// stock torch ops it was five passes over an f32 copy, 10.7 of UNet's
// 16.5 ms int8 forward at 360x480, b8, on an H100 at 700 W. One pass
// here, bound by its bytes: each thread reads 8 elements (16 or 32 bytes)
// and writes 8. The division is IEEE (__fdiv_rn), as torch's by a tensor
// on the device; the rounding rintf, half to even, as torch.round.
namespace qz {

constexpr int THREADS = 256;
constexpr int V = 8;  // elements a thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ int8_t quantize1(float v, float s) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(q));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    quantize_kernel(const T* __restrict__ x, const float* __restrict__ s_p,
                    int8_t* __restrict__ out, int64_t n) {
  const float s = *s_p;
  const int64_t i0 =
      (static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x) * V;
  if (i0 + V <= n) {
    alignas(16) T v[V];
    // 16-byte loads: the wrapper's x and out start on 16-byte boundaries
#pragma unroll
    for (int k = 0; k < V * static_cast<int>(sizeof(T)) / 16; ++k)
      reinterpret_cast<uint4*>(v)[k] =
          reinterpret_cast<const uint4*>(x + i0)[k];
    alignas(8) int8_t q[V];
#pragma unroll
    for (int e = 0; e < V; ++e) q[e] = quantize1(to_f32(v[e]), s);
    *reinterpret_cast<uint2*>(out + i0) = *reinterpret_cast<const uint2*>(q);
  } else {
    for (int64_t i = i0; i < n; ++i) out[i] = quantize1(to_f32(x[i]), s);
  }
}

template <typename T>
cudaError_t run(const void* x, const float* s, int8_t* out, int64_t n,
                cudaStream_t st) {
  const int64_t blocks = (n + THREADS * V - 1) / (THREADS * V);
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  quantize_kernel<T><<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(
      static_cast<const T*>(x), s, out, n);
  return cudaGetLastError();
}

}  // namespace qz

}  // namespace

// The path that takes Cin: 1 wgmma (Cin % 32 == 0), 2 packed (Cin < 32),
// 0 none (the wrapper refuses such a call). fused_conv_int8.int8_path
// holds the same rule.
extern "C" int conv3x3_int8_path(int Cin) {
  if (Cin <= 0) return 0;
  if (Cin % 32 == 0) return 1;
  return Cin <= packed::MAX_CIN ? 2 : 0;
}

// The packed path's K (9 x Cin in whole k32 steps): the repacked weights'
// row length there.
extern "C" int conv3x3_int8_packed_k(int Cin) { return packed::kp(Cin); }

// out (N,H,W,Cout) <- x (N,H,W,Cin) int8, the repacked weights wk, s_w and
// b_eff (Cout,) f32, s_x and (mode 0) s_out f32 scalars on the device;
// mode 0 int8 out (requantized at s_out), 1 bf16, 2 f32.
extern "C" int conv3x3_int8(const void* x, const void* wk, const void* s_w,
                            const void* b_eff, const void* s_x,
                            const void* s_out, void* out, int mode, int N,
                            int H, int W, int Cin, int Cout, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cout <= 0 || mode < 0 || mode > 2 ||
      (mode == 0 && s_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto xs = static_cast<const int8_t*>(x);
  auto ws = static_cast<const int8_t*>(wk);
  auto sw = static_cast<const float*>(s_w);
  auto bb = static_cast<const float*>(b_eff);
  auto sx = static_cast<const float*>(s_x);
  auto so = static_cast<const float*>(s_out);
  switch (conv3x3_int8_path(Cin)) {
    case 1:
      return static_cast<int>(
          wg::run(xs, ws, sw, bb, sx, so, out, mode, N, H, W, Cin, Cout, st));
    case 2:
      return static_cast<int>(packed::run(xs, ws, sw, bb, sx, so, out, mode,
                                          N, H, W, Cin, Cout, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out (n,) int8 <- clip(round_half_even(x / s), -127, 127), x (n,) bf16
// (dtype 0) or f32 (dtype 1), s an f32 scalar on the device; x and out
// 16-byte aligned.
extern "C" int quantize_int8(const void* x, const void* s, void* out,
                             long long n, int dtype, void* stream) {
  if (n <= 0 || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto sp = static_cast<const float*>(s);
  auto o = static_cast<int8_t*>(out);
  return static_cast<int>(dtype == 0 ? qz::run<__nv_bfloat16>(x, sp, o, n, st)
                                     : qz::run<float>(x, sp, o, n, st));
}
