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
// be: (9, Cout, Cs) for the wgmma path, Cs = 16 * ceil(Cin / 16) (zero
// columns past Cin); (Cout, Kp) for the packed path, k = tap * Cin4 + ci
// with each tap's channels padded to Cin4 = 4 * ceil(Cin / 4) and Kp = 32 *
// ceil(9 * Cin4 / 32), zeros in the padding.
//
// What bounds it on the H100 (1,979 TOPS int8 dense, 3.35 TB/s, ~590
// operations a byte at the ridge): the stem (Cin 3) writes 88 MB of int8
// at 360x480, b8, for 8 GOPS, and the 64-channel full-resolution blocks
// move about as many bytes as their operations take at the tensor rate, so
// both are bound by bytes; from Cin 128 up every block of the models is
// bound by operations. The tensor cores are fed from shared memory: a
// wgmma.m64nNk32 s8 reads its 32N-byte B there and its A fragments cost
// 2048 bytes more (ldmatrix), so at the int8 rate (8,192 operations a
// cycle an SM) N = 64 needs 128 bytes a cycle, the SM's whole bandwidth,
// N = 128 96 and N = 256 80: the N = 64 blocks cannot reach the tensor
// rate, the wider ones can come near it. The int8-out epilogue is about
// 17 instructions a value (dequant 4, the requantize 11, staging 2, by
// count of the source): at the stem's and a 64-channel full-resolution
// block's 88.5 M output values that count alone is some 50 us of issue on
// 132 SMs, twice the stem's byte bound.
//
// Two paths (conv3x3_int8_path; fused_conv_int8.int8_path holds the rule):
// * wgmma (Cin >= 32). TMA's global strides are multiples of 16 bytes, so
//   x comes with a pixel stride of Cs = 16 * ceil(Cin / 16) bytes (the
//   wrapper's padded buffer, or the quantize kernel's padded output; Cs =
//   Cin where Cin % 16 == 0): its tensor map has channel extent Cin and
//   stride Cs, so the channels Cin..Cs of a pixel are never read and TMA
//   fills zeros there; the weights' map reads their zero columns. An
//   implicit GEMM, M = output pixels, N = output channels, K = 9 taps x Cin
//   in chunks of KC channels, one TMA box row: KC = 64 (the 64-byte
//   swizzle) up to Cin 64, 128 (the 128-byte swizzle) above, so no box is
//   half TMA's zero fill at Cin 64; the k32 steps of a chunk are a
//   compile-time count and the last chunk's steps past Cin multiply the
//   zeros TMA filled in (Cin 48: 16 of 64 channels; Cin 40: 24). A
//   persistent block of three warpgroups: two producer threads of the
//   third stream TMA boxes into a patch ring and a weight ring guarded by full/empty mbarriers; two consumer
//   warpgroups run wgmma.m64nNk32.s32.s8.s8 with A from registers
//   (ldmatrix of the tap's shifted patch rows, the swizzle XOR in the
//   address, so one staged patch serves all 9 taps) and B K-major from
//   shared memory. Each group of k32 steps loads its A fragments into the
//   buffer that the group before last used, which the last wait_group
//   freed, and no step is skipped at run time: ptxas serializes no wgmma
//   for want of knowing which registers an in-flight group owns.
//   - Cin <= 128 (RES): N = 64 with the block's 9 weight taps resident (the
//     grid is a multiple of the channel tiles, so a block's channels never
//     change), and the two consumer warpgroups ping-pong: each takes every
//     other tile of 8 rows x 16 columns, and a named barrier hands the
//     tensor cores from one warpgroup's mainloop to the other's, so one
//     warpgroup's dequant/ReLU/requant epilogue runs under the other's
//     wgmmas (without the handoff both warpgroups multiply at once: up to
//     3.6% slower a block on an H100 at 700 W, int8_variants.py).
//   - Cin > 128: the weights stream a tap at a time through a 4-stage
//     ring, and both consumer warpgroups work on one tile, its weights
//     read once for both: a ping-pong would stream every weight twice, and
//     there the epilogue is a small share of a tile's 72 or more k32
//     steps. N = 64 (two m64 tiles a warpgroup) up to Cout 64, else 128
//     (one): 128 accumulators a thread (N = 256, or N = 128 with two m64
//     tiles) within the 168 registers a thread of a 384-thread block
//     holds made ptxas serialize the wgmmas (C7512), up to 37% and 50%
//     slower a block on an H100 at 700 W (int8_variants.py, PERF.md).
// * packed (Cin < 32: the Cin = 3 stem and narrow test widths). A 3-byte
//   pixel row is no TMA row and K = 27 is no k32 step, so K packs the 9
//   taps x Cin4 tap-major, zero-padded to whole k32 steps (two at the
//   stem). Persistent blocks of 8 warps (BLOCKS an SM) keep one tile of 64
//   output channels and its Kp x 64 weights resident and walk tiles of 8
//   output rows x 32 columns. A tile's 10 input rows, (32 + 2) x Cin
//   contiguous bytes each, are read as 16-byte vectors into registers
//   while the previous tile computes and written after it into a
//   double-buffered patch whose pixels are Cin4 bytes (the pad channels
//   zero), so every A fragment word is one pixel's 4 channels of one tap:
//   one 32-bit shared load at a per-lane offset held in registers; B
//   comes as 32-bit words of the resident weights and mma.sync
//   .m16n8k32.s32.s8.s8 accumulates.
// Both paths stage each warp's output row (16 or 32 pixels x 64 channels)
// in shared memory in the output type with the 64-byte (int8) or 128-byte
// (bf16, f32 in two 32-channel boxes) swizzle and hand it to a TMA store,
// which runs under the next products and drops what lies past H, W or
// Cout; where Cout x the output's bytes is no multiple of 16 (TMA's row
// stride: the 12- and 21-class heads in int8) the warp copies the staged
// row out element by element.

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
// which each lane divides for its flagged values (wg_row, packed_row), one
// vote a row. The division in line, predicated for every value, tripled
// the int8-out epilogue's time; a vote and branch for each channel pair
// cost 0.1 ms of a 64->64 block at 360x480, b8, on an H100 at 700 W
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

// Output staging: one output row of NP pixels x 64 channels in shared
// memory as the TMA store's box(es) lay it out: int8 one box of 64-byte
// rows with the 64-byte swizzle, bf16 one of 128-byte rows and f32 two
// (32 channels each) with the 128-byte swizzle; the 16-byte chunk index is
// XORed with the row's bits, so the 8 pixels a fragment writes fall in
// different banks. The byte offset of (pixel p, channel c):
template <int MODE, int NP>
__device__ __forceinline__ int stage_off(int p, int c) {
  if constexpr (MODE == 0)
    return p * 64 + ((((c >> 4) ^ (p >> 1)) & 3) << 4) + (c & 15);
  else if constexpr (MODE == 1)
    return p * 128 + ((((c >> 3) ^ p) & 7) << 4) + ((c & 7) << 1);
  else
    return (c >> 5) * (NP * 128) + p * 128 +
           (((((c & 31) >> 2) ^ p) & 7) << 4) + ((c & 3) << 2);
}

// Channels (c, c + 1) of staged pixel p from their epilogue values. In the
// int8 mode the fast requantize (``near`` gets the pair's flags) or, with
// EXACT, the division.
template <int MODE, int NP, bool EXACT = false>
__device__ __forceinline__ void stage_pair(unsigned char* st, int p, int c,
                                           float v0, float v1, float s_out,
                                           float r_out, bool& near) {
  unsigned char* d = st + stage_off<MODE, NP>(p, c);
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

// A warp's staging buffer ``st`` may be written: lane 0's TMA stores but
// the last PENDING have read theirs, and the warp's copy-out is done.
template <int PENDING>
__device__ __forceinline__ void staging_free(int lane) {
  if (lane == 0) sm90::bulk_wait<PENDING, true>();
  __syncwarp();
}

// The staged row (NP pixels from w0 of row h, image img, channels c0..) to
// the output: with ``tma`` one TMA store a box, in one bulk group of lane
// 0 (committed even when the row lies past H, so each row is one group);
// else element by element, masked at H, W and Cout.
template <int MODE, int NP>
__device__ __forceinline__ void store_staged(const CUtensorMap* omap,
                                             const unsigned char* st,
                                             void* out, bool tma, int img,
                                             int h, int w0, int c0, int H,
                                             int W, int Cout, int lane) {
  if (tma) {
    sm90::fence_proxy_async();
    __syncwarp();
    if (lane == 0) {
      if (h < H) {
        sm90::tma_store_4d(omap, st, c0, w0, h, img);
        if constexpr (MODE == 2)
          if (c0 + 32 < Cout)
            sm90::tma_store_4d(omap, st + NP * 128, c0 + 32, w0, h, img);
      }
      sm90::bulk_commit();
    }
    return;
  }
  __syncwarp();
  if (h >= H) return;
  constexpr int OB = MODE == 0 ? 1 : MODE == 1 ? 2 : 4;
  const int np = min(NP, W - w0), nc = min(64, Cout - c0);
  const int64_t pix0 = (static_cast<int64_t>(img) * H + h) * W + w0;
  unsigned char* o = static_cast<unsigned char*>(out);
  for (int e = lane; e < NP * 64; e += 32) {
    const int p = e >> 6, c = e & 63;
    if (c >= nc || p >= np) continue;
    unsigned char* d = o + ((pix0 + p) * Cout + c0 + c) * OB;
    const unsigned char* s = st + stage_off<MODE, NP>(p, c);
#pragma unroll
    for (int b = 0; b < OB; ++b) d[b] = s[b];
  }
}

// The output's tensor map for the TMA stores: (Cout, W, H, N) in the
// output type, boxes of 64 channels (f32: 32) x np pixels, swizzled as
// stage_off lays them out. tma_ok: TMA can address the rows.
inline bool tma_ok(int mode, int Cout) {
  return Cout * (mode == 0 ? 1 : mode == 1 ? 2 : 4) % 16 == 0;
}

inline bool encode_out_map(CUtensorMap* map, void* out, int mode, int N,
                           int H, int W, int Cout, int np) {
  const uint64_t ob = mode == 0 ? 1 : mode == 1 ? 2 : 4;
  const uint64_t dims[4] = {static_cast<uint64_t>(Cout),
                            static_cast<uint64_t>(W),
                            static_cast<uint64_t>(H),
                            static_cast<uint64_t>(N)};
  const uint64_t strides[3] = {ob * Cout, ob * Cout * W, ob * Cout * W * H};
  const uint32_t box[4] = {mode == 2 ? 32u : 64u, static_cast<uint32_t>(np),
                           1, 1};
  return sm90::encode_map(
      map,
      mode == 0   ? CU_TENSOR_MAP_DATA_TYPE_UINT8
      : mode == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                  : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      out, 4, dims, strides, box,
      mode == 0 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B);
}

// Named barriers 1 and 2 (0 is __syncthreads'): ``n`` threads in all.
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
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

template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (N == 64) wgmma_s8_n64(d, a, desc_b);
  else wgmma_s8_n128(d, a, desc_b);
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
constexpr int THREADS = 384; // warpgroups 0, 1 consume; 2 produces
constexpr int RES_MAX_CIN = 128;  // one chunk: the 9 taps can stay resident
// output staging: 8 KB a consumer warp, buffers of one output row of 16
// pixels x 64 channels in the output type (1, 2 or 4 KB), used in turn, so
// a warp waits for a TMA store to read its buffer only 8, 4 or 2 rows on
constexpr int OUT_WARP = 8192;

// RES (Cin <= 128): BN = 64, the 9 taps resident, the consumer warpgroups
// ping-pong on tiles of MT m64 tiles each (8 rows); else both warpgroups
// work on one tile of 2 x MT m64 tiles. KC: the box's channels (bytes).
template <int BN, bool RES, int KC>
struct Tile {
  static constexpr int MT = RES || BN == 64 ? 2 : 1;  // m64 a WG
  static constexpr int TH = RES ? 4 * MT : 8 * MT;  // output rows a tile
  static constexpr int PH = TH + 2;
  static constexpr int KSTEPS = KC / 32;  // k32 steps a (tap, chunk)
  static constexpr int PATCH_TX = PH * PW * KC;
  static constexpr int PATCH_BYTES = (PATCH_TX + 1023) / 1024 * 1024;
  static constexpr int P_STAGES = RES ? (KC == 64 ? 4 : 3) : 2;
  static constexpr int W_STAGES = RES ? 9 : 4;
  static constexpr int W_BYTES = BN * KC;  // one (tap, chunk): BN x KC
  static constexpr int OUT_OFF = P_STAGES * PATCH_BYTES + W_STAGES * W_BYTES;
  static constexpr int SC_OFF = OUT_OFF + 8 * OUT_WARP;  // 2 x BN f32
  static constexpr int BAR_OFF = SC_OFF + 2 * BN * 4;
  static constexpr int SMEM = BAR_OFF + 2 * (P_STAGES + W_STAGES) * 8 + 1024;
};
static_assert(Tile<64, true, 64>::SMEM <= 232448, "RES at Cin <= 64 fits");
static_assert(Tile<64, true, 128>::SMEM <= 232448, "RES at Cin <= 128 fits");
static_assert(Tile<64, false, 128>::SMEM <= 232448, "the N = 64 tile fits");
static_assert(Tile<128, false, 128>::SMEM <= 232448, "the N = 128 tile fits");

// Byte address of 16-byte chunk ``chunk`` of row ``row`` of a box that TMA
// wrote with the KC-byte swizzle from an aligned ``base``.
template <int KC>
__device__ __forceinline__ uint32_t swz(uint32_t base, int row, int chunk) {
  if constexpr (KC == 128)
    return sm90::swz128(base, row, chunk);
  else
    return base + (row << 6) + (((chunk ^ (row >> 1)) & 3) << 4);
}

// B's descriptor for k32 step s of a weight stage: BN K-major rows of KC
// bytes, 8 rows a swizzle atom (8 x KC bytes apart).
template <int KC>
__device__ __forceinline__ uint64_t b_desc(uint32_t stage, int s) {
  return sm90::wgmma_desc(stage + s * 32, 16, 8 * KC, KC == 128 ? 1 : 2);
}

// A warp's output row: 16 pixels (w0.., row h) x the 64 channels from c0,
// from accumulators acc (its m64 tile) and the chunk's dequant factors
// ssc, sbb (shared memory), staged in the warp's buffer for its ``row``-th
// row, then stored.
template <int MODE, int NACC>
__device__ __forceinline__ void wg_row(const int (&acc)[NACC], int j0,
                                       const float* ssc, const float* sbb,
                                       unsigned char* st0, int row,
                                       const CUtensorMap* omap, void* out,
                                       bool tma, int img, int h, int w0,
                                       int c0, int H, int W, int Cout,
                                       int lane, float s_out, float r_out) {
  constexpr int BYTES = 16 * 64 * (MODE == 0 ? 1 : MODE == 1 ? 2 : 4);
  constexpr int NB = OUT_WARP / BYTES;
  unsigned char* st = st0 + row % NB * BYTES;
  staging_free<NB - 1>(lane);
  bool near = false;
  auto stage = [&](auto exact) {
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int c = 8 * jj + 2 * (lane & 3);
      const float sc0 = ssc[c], bb0 = sbb[c];
      const float sc1 = ssc[c + 1], bb1 = sbb[c + 1];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        stage_pair<MODE, 16, decltype(exact)::value>(
            st, (lane >> 2) + 8 * hf, c,
            dequant_relu(acc[4 * (j0 + jj) + 2 * hf], sc0, bb0),
            dequant_relu(acc[4 * (j0 + jj) + 2 * hf + 1], sc1, bb1), s_out,
            r_out, near);
    }
  };
  stage(std::false_type{});
  if constexpr (MODE == 0)
    if (__any_sync(0xffffffffu, near)) stage(std::true_type{});
  store_staged<MODE, 16>(omap, st, out, tma, img, h, w0, c0, H, W, Cout,
                         lane);
}

template <int BN, bool RES, int KC>
__global__ void __launch_bounds__(THREADS, 1)
    conv3x3_int8_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                              const __grid_constant__ CUtensorMap wmap,
                              const __grid_constant__ CUtensorMap omap,
                              const float* __restrict__ s_w,
                              const float* __restrict__ b_eff,
                              const float* __restrict__ s_x_p,
                              const float* __restrict__ s_out_p,
                              void* __restrict__ out, int mode, int tma_out,
                              int N, int H, int W, int Cin, int Cout) {
  using T = Tile<BN, RES, KC>;
  constexpr int MT = T::MT, TH = T::TH, P = T::P_STAGES, S = T::W_STAGES;
  constexpr int KS = T::KSTEPS;
  // k32 steps a wgmma commit group: a tap's where the registers allow
  // (RES, 64 accumulators), else 2
  constexpr int G = RES ? KS : 2;
  constexpr int NG = KS / G;  // groups a (tap, chunk)
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  unsigned char* patch = smem;
  unsigned char* wring = smem + P * T::PATCH_BYTES;
  unsigned char* ostage = smem + T::OUT_OFF;
  float* ssc = reinterpret_cast<float*>(smem + T::SC_OFF);
  float* sbb = ssc + BN;
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
      // RES: a patch stage is one warpgroup's; else both read it
      sm90::mbar_init(&pempty[i], RES ? 4 : 8);
    }
    for (int i = 0; i < S; ++i) {
      sm90::mbar_init(&wfull[i], 1);
      sm90::mbar_init(&wempty[i], 8);
    }
    sm90::fence_barrier_init();
  }
  // the dequant factors s_x * s_w and b_eff of the block's output channels
  // (the grid is a multiple of the channel tiles: a block keeps its n0)
  const int bn0 = blockIdx.x % tiles_n * BN;
  for (int c = threadIdx.x; c < BN; c += THREADS) {
    const bool in = bn0 + c < Cout;
    ssc[c] = in ? __fmul_rn(*s_x_p, s_w[bn0 + c]) : 0.f;
    sbb[c] = in ? b_eff[bn0 + c] : 0.f;
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
      if constexpr (RES) {
        // the block's channel tile never changes: its 9 taps load once
        for (int tap = 0; tap < 9; ++tap) {
          sm90::mbar_arrive_expect_tx(&wfull[tap], T::W_BYTES);
          sm90::tma_load_3d(wring + tap * T::W_BYTES, &wmap, &wfull[tap], 0,
                            bn0, tap);
        }
      } else {
        uint32_t wit = 0;
        for (int t = blockIdx.x; t < total; t += gridDim.x) {
          for (int c = 0; c < nch; ++c) {
            for (int tap = 0; tap < 9; ++tap, ++wit) {
              const int ws = wit % S;
              sm90::mbar_wait(&wempty[ws], ((wit / S) & 1) ^ 1);
              sm90::mbar_arrive_expect_tx(&wfull[ws], T::W_BYTES);
              sm90::tma_load_3d(wring + ws * T::W_BYTES, &wmap, &wfull[ws],
                                c * KC, bn0, tap);
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
    unsigned char* st0 = ostage + (wgi * 4 + warp) * OUT_WARP;
    const bool tma = tma_out != 0;
    const float s_out = mode == 0 ? *s_out_p : 1.f;
    const float r_out = __frcp_rn(s_out);
    // this warpgroup's first output row in its tile
    const int rbase = RES ? 0 : wgi * 4 * MT;
    // patch pixel of tap (0, 0) for this lane's A row in m64 tile mt
    int pbase[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      pbase[mt] = (rbase + mt * 4 + warp) * PW + (lane & 15);
    uint32_t pit = 0, wit = 0;
    int nrow = 0;  // output rows this warp has staged
    // RES: the block's tiles j = wgi, wgi + 2, ...; else every tile
    for (int j = RES ? wgi : 0;; j += RES ? 2 : 1) {
      const int t = blockIdx.x + j * gridDim.x;
      if (t >= total) break;
      int img, h0, w0, n0;
      origin(t, img, h0, w0, n0);  // where this tile's rows go
      int acc[MT][BN / 2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[mt][i] = 0;

      if constexpr (RES) {
        // ping-pong: this mainloop starts when the other warpgroup's of
        // tile j - 1 has ended
        if (j > 0) named_sync(1 + wgi, 256);
        const int ps = j % P;
        sm90::mbar_wait(&pfull[ps], (j / P) & 1);
        const uint32_t pb = patch0 + ps * T::PATCH_BYTES;
        // A fragments of one tap per buffer; two buffers, so one tap's
        // fragments load while the last tap's group runs
        uint32_t afrag[2][KS][MT][4];
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int shift_px = (tap / 3) * PW + tap % 3;
          sm90::mbar_wait(&wfull[tap], 0);
          const uint32_t wb = wring0 + tap * T::W_BYTES;
          const int buf = tap & 1;
#pragma unroll
          for (int s = 0; s < KS; ++s)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              sm90::ldmatrix_x4(afrag[buf][s][mt],
                                swz<KC>(pb, pbase[mt] + shift_px,
                                        2 * s + (lane >> 4)));
          sm90::wgmma_fence();
#pragma unroll
          for (int s = 0; s < KS; ++s) {
            const uint64_t desc = b_desc<KC>(wb, s);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              wgmma_s8<BN>(acc[mt], afrag[buf][s][mt], desc);
          }
          sm90::wgmma_commit();
          sm90::wgmma_wait<1>();
        }
        sm90::wgmma_wait<0>();
        if (lane == 0) sm90::mbar_arrive(&pempty[ps]);
        if (t + gridDim.x < total) named_arrive(2 - wgi, 256);
      } else {
        for (int c = 0; c < nch; ++c, ++pit) {
          const int ps = pit % P;
          sm90::mbar_wait(&pfull[ps], (pit / P) & 1);
          const uint32_t pb = patch0 + ps * T::PATCH_BYTES;
          // A fragments of G k32 steps (one group, committed together) per
          // buffer; two buffers, so one group loads while the last runs
          uint32_t afrag[2][G][MT][4];
          int ws_prev = 0;
#pragma unroll
          for (int tap = 0; tap < 9; ++tap) {
            const int shift_px = (tap / 3) * PW + tap % 3;
            const int ws = wit % S;
            sm90::mbar_wait(&wfull[ws], (wit / S) & 1);
            const uint32_t wb = wring0 + ws * T::W_BYTES;
#pragma unroll
            for (int gi = 0; gi < NG; ++gi) {
              const int buf = (tap * NG + gi) & 1;
#pragma unroll
              for (int jj = 0; jj < G; ++jj)
#pragma unroll
                for (int mt = 0; mt < MT; ++mt)
                  sm90::ldmatrix_x4(
                      afrag[buf][jj][mt],
                      swz<KC>(pb, pbase[mt] + shift_px,
                              2 * (gi * G + jj) + (lane >> 4)));
              sm90::wgmma_fence();
#pragma unroll
              for (int jj = 0; jj < G; ++jj) {
                const uint64_t desc = b_desc<KC>(wb, gi * G + jj);
#pragma unroll
                for (int mt = 0; mt < MT; ++mt)
                  wgmma_s8<BN>(acc[mt], afrag[buf][jj][mt], desc);
              }
              sm90::wgmma_commit();
              sm90::wgmma_wait<1>();
              // the previous group, the previous tap's last, has
              // completed: its weights go
              if (gi == 0 && tap > 0 && lane == 0)
                sm90::mbar_arrive(&wempty[ws_prev]);
            }
            ws_prev = ws;
            ++wit;
          }
          sm90::wgmma_wait<0>();
          if (lane == 0) {
            sm90::mbar_arrive(&wempty[ws_prev]);
            sm90::mbar_arrive(&pempty[ps]);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);

      // Epilogue: each warp's output row of each m64 tile, 64 channels at
      // a time, through its staging buffers in turn (wg_row).
      // Accumulator i of m64 tile mt: output row h, column lane/4 (+8 for
      // i%4 >= 2); channel 8*(i/4) + 2*(lane%4) + i%2.
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int h = h0 + rbase + mt * 4 + warp;
#pragma unroll
        for (int cb = 0; cb < BN / 64; ++cb) {
          const int c0 = n0 + 64 * cb;
          if (c0 >= Cout) break;
          const float* sc = ssc + 64 * cb;
          const float* bb = sbb + 64 * cb;
          if (mode == 0)
            wg_row<0>(acc[mt], 8 * cb, sc, bb, st0, nrow, &omap, out, tma,
                      img, h, w0, c0, H, W, Cout, lane, s_out, r_out);
          else if (mode == 1)
            wg_row<1>(acc[mt], 8 * cb, sc, bb, st0, nrow, &omap, out, tma,
                      img, h, w0, c0, H, W, Cout, lane, s_out, r_out);
          else
            wg_row<2>(acc[mt], 8 * cb, sc, bb, st0, nrow, &omap, out, tma,
                      img, h, w0, c0, H, W, Cout, lane, s_out, r_out);
          ++nrow;
        }
      }
    }
    if (lane == 0) sm90::bulk_wait<0, false>();  // the stores are done
  }
}


// x's pixel stride and the repacked weights' row on this path, in bytes:
// TMA's global strides are multiples of 16.
constexpr int pixel_stride(int Cin) { return (Cin + 15) / 16 * 16; }

template <int BN, bool RES, int KC>
cudaError_t launch(const int8_t* x, const int8_t* wk, const float* s_w,
                   const float* b_eff, const float* s_x, const float* s_out,
                   void* out, int mode, int N, int H, int W, int Cin,
                   int Cout, cudaStream_t stream) {
  using T = Tile<BN, RES, KC>;
  const CUtensorMapSwizzle swizzle =
      KC == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap xmap, wmap, omap{};
  // x (Cin, W, H, N) at pixel stride Cs: TMA reads Cin channels of each
  // pixel and fills zeros past them
  const uint64_t cs = static_cast<uint64_t>(pixel_stride(Cin));
  const uint64_t xd[4] = {static_cast<uint64_t>(Cin),
                          static_cast<uint64_t>(W), static_cast<uint64_t>(H),
                          static_cast<uint64_t>(N)};
  const uint64_t xs[3] = {cs, cs * W, cs * W * H};
  const uint32_t xb[4] = {KC, PW, T::PH, 1};
  if (!sm90::encode_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, x, 4, xd, xs,
                        xb, swizzle))
    return cudaErrorInvalidValue;
  // the repacked weights (9, Cout, Cs), channels innermost (their zero
  // columns past Cin included), in KC x BN boxes
  const uint64_t wd[3] = {cs, static_cast<uint64_t>(Cout), 9};
  const uint64_t wstr[2] = {cs, cs * Cout};
  const uint32_t wbox[3] = {KC, static_cast<uint32_t>(BN), 1};
  if (!sm90::encode_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, wk, 3, wd,
                        wstr, wbox, swizzle))
    return cudaErrorInvalidValue;
  const bool tma = tma_ok(mode, Cout);
  if (tma && !encode_out_map(&omap, out, mode, N, H, W, Cout, TW))
    return cudaErrorInvalidValue;
  auto kern = conv3x3_int8_wgmma_kernel<BN, RES, KC>;
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
  // a multiple of the output-channel tiles (the tiles are one), so each
  // block keeps one tile of channels: its dequant factors and, with RES,
  // its weight taps load once
  int grid = static_cast<int>(tiles < sms ? tiles : sms);
  grid = grid < tiles_n ? tiles_n : grid - grid % tiles_n;
  kern<<<grid, THREADS, T::SMEM, stream>>>(xmap, wmap, omap, s_w, b_eff, s_x,
                                           s_out, out, mode, tma ? 1 : 0, N,
                                           H, W, Cin, Cout);
  return cudaGetLastError();
}

cudaError_t run(const int8_t* x, const int8_t* wk, const float* s_w,
                const float* b_eff, const float* s_x, const float* s_out,
                void* out, int mode, int N, int H, int W, int Cin, int Cout,
                cudaStream_t st) {
  if (Cin <= 64)
    return launch<64, true, 64>(x, wk, s_w, b_eff, s_x, s_out, out, mode, N,
                                H, W, Cin, Cout, st);
  if (Cin <= RES_MAX_CIN)
    return launch<64, true, 128>(x, wk, s_w, b_eff, s_x, s_out, out, mode,
                                 N, H, W, Cin, Cout, st);
  // streamed weights: N = 64 (two m64 tiles a warpgroup) up to Cout 64,
  // else 128 (one)
  if (Cout <= 64)
    return launch<64, false, 128>(x, wk, s_w, b_eff, s_x, s_out, out, mode,
                                  N, H, W, Cin, Cout, st);
  return launch<128, false, 128>(x, wk, s_w, b_eff, s_x, s_out, out, mode, N,
                                 H, W, Cin, Cout, st);
}

}  // namespace wg

// =============================================================== packed

namespace packed {

constexpr int TH = 8;          // output rows a tile: one a warp
constexpr int TW = 32;         // output columns: MT m16 tiles a warp
constexpr int MT = TW / 16;
constexpr int BLOCKS = 2;      // resident blocks an SM (registers <= 128)
constexpr int PW = TW + 2;
constexpr int PH = TH + 2;
constexpr int BN = 64;         // output channels a tile: 8 n8 tiles
constexpr int THREADS = 256;
constexpr int MAX_CIN = 31;
// output staging: one buffer a warp, an output row of TW pixels x 64
// channels in the widest type (f32)
constexpr int STAGE_WARP = TW * 64 * 4;

// Cin4: a pixel's channels in the patch and a tap's in K, a multiple of 4
// (one 32-bit A word); Kp: 9 taps x Cin4, padded to whole k32 steps.
__host__ __device__ constexpr int cin4(int Cin) { return (Cin + 3) / 4 * 4; }
__host__ __device__ constexpr int kp(int Cin) {
  return (9 * cin4(Cin) + 31) / 32 * 32;
}

// Shared memory (bytes): the eight warps' staging buffers (1024-aligned for
// the swizzle), the resident weights (K-major rows of KP bytes at a stride
// of KP + 16: the 8 rows a B fragment reads fall in distinct banks), two
// patch buffers of PH rows x PW pixels x C4 bytes, the channel tile's
// dequant factors s_x * s_w and b_eff.
template <int C4>
struct Geo {
  static constexpr int KP = kp(C4);
  static constexpr int KSTEPS = KP / 32;
  static constexpr int RS = PW * C4;  // patch row
  static constexpr int BUF = PH * RS;
  static constexpr int WS = KP + 16;  // weight row stride
  // 16-byte chunks an input row (PW x Cin <= PW x C4 bytes) spans
  static constexpr int CPR = (PW * C4 + 30) / 16;
  static constexpr int ITEMS = PH * CPR;
  static constexpr int LPT = (ITEMS + THREADS - 1) / THREADS;
  static constexpr int W_OFF = 8 * STAGE_WARP;
  static constexpr int P_OFF = W_OFF + BN * WS;
  static constexpr int SC_OFF = P_OFF + 2 * BUF;
  static constexpr int SMEM = SC_OFF + 2 * BN * 4 + 1024;
};
static_assert(Geo<4>::KSTEPS == 2, "the stem: two k32 steps");
static_assert(Geo<32>::KP == 288 &&
                  BLOCKS * (Geo<32>::SMEM + 1024) <= 233472,
              "BLOCKS blocks an SM at the widest Cin4");

// The patch offset (bytes) of packed k for the pixel at patch (0, 0): tap
// (dy, dx) = k / C4, channel k % C4 (a multiple of 4: one A word); past
// 9 x C4 any word serves, as the weights there are zero.
template <int C4>
__device__ __forceinline__ int koff(int k) {
  if (k >= 9 * C4) return 0;
  const int tap = k / C4, ci = k % C4;
  return (tap / 3) * Geo<C4>::RS + (tap % 3) * C4 + ci;
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp's output row (TW pixels from w0 x 64 channels from n0) from its
// accumulators acc[m][nt] (pixel 16 m + g: channels 2t, 2t+1 of n8 tile nt
// in [0], [1]; pixel 16 m + g + 8 in [2], [3]), staged in ``st``, stored.
template <int MODE>
__device__ __forceinline__ void packed_row(const int (&acc)[MT][8][4],
                                           unsigned char* st,
                                           const CUtensorMap* omap,
                                           void* out, bool tma, int img,
                                           int h, int w0, int n0, int H,
                                           int W, int Cout, int lane,
                                           const float* ssc,
                                           const float* sbb, float s_out,
                                           float r_out) {
  const int g = lane >> 2, tq = lane & 3;
  bool near = false;
  auto stage = [&](auto exact) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = nt * 8 + 2 * tq;
      const float sc0 = ssc[c], bb0 = sbb[c];
      const float sc1 = ssc[c + 1], bb1 = sbb[c + 1];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          stage_pair<MODE, TW, decltype(exact)::value>(
              st, 16 * m + g + 8 * hf, c,
              dequant_relu(acc[m][nt][2 * hf], sc0, bb0),
              dequant_relu(acc[m][nt][2 * hf + 1], sc1, bb1), s_out, r_out,
              near);
    }
  };
  stage(std::false_type{});
  if constexpr (MODE == 0)
    if (__any_sync(0xffffffffu, near)) stage(std::true_type{});
  store_staged<MODE, TW>(omap, st, out, tma, img, h, w0, n0, H, W, Cout,
                         lane);
}

// A persistent block keeps one tile of 64 output channels (the grid is a
// multiple of the channel tiles) with its weights resident and walks tiles
// of 8 rows x 32 columns; it reads a tile's input rows while the one
// before computes.
template <int C4>
__global__ void __launch_bounds__(THREADS, BLOCKS)
    conv3x3_int8_packed_kernel(const __grid_constant__ CUtensorMap omap,
                               const int8_t* __restrict__ x,
                               const int8_t* __restrict__ wk,
                               const float* __restrict__ s_w,
                               const float* __restrict__ b_eff,
                               const float* __restrict__ s_x_p,
                               const float* __restrict__ s_out_p,
                               void* __restrict__ out, int mode, int tma_out,
                               int N, int H, int W, int Cin, int Cout) {
  using G = Geo<C4>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  unsigned char* w_s = smem + G::W_OFF;
  unsigned char* patch = smem + G::P_OFF;
  float* ssc = reinterpret_cast<float*>(smem + G::SC_OFF);
  float* sbb = ssc + BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  const int tiles_n = (Cout + BN - 1) / BN;
  const int total = N * tiles_h * tiles_w * tiles_n;  // < 2^31 (host)
  const int n0 = blockIdx.x % tiles_n * BN;
  auto origin = [&](int t, int& img, int& h0, int& w0) {
    t /= tiles_n;
    w0 = t % tiles_w * TW;
    t /= tiles_w;
    h0 = t % tiles_h * TH;
    img = t / tiles_h;
  };
  const float s_x = *s_x_p;
  const float s_out = mode == 0 ? *s_out_p : 1.f;
  const float r_out = __frcp_rn(s_out);
  const bool tma = tma_out != 0;

  // Resident weights, once a block, as 16-byte vectors (zero past Cout);
  // both patch buffers zeroed, so the pad channels past Cin read zero.
  for (int i = threadIdx.x; i < BN * (G::KP / 16); i += THREADS) {
    const int n = i / (G::KP / 16), v = i % (G::KP / 16);
    uint4 val = make_uint4(0, 0, 0, 0);
    if (n0 + n < Cout)
      val = __ldg(reinterpret_cast<const uint4*>(
          wk + static_cast<int64_t>(n0 + n) * G::KP + 16 * v));
    *reinterpret_cast<uint4*>(w_s + n * G::WS + 16 * v) = val;
  }
  for (int i = threadIdx.x; i < 2 * G::BUF / 16; i += THREADS)
    reinterpret_cast<uint4*>(patch)[i] = make_uint4(0, 0, 0, 0);
  for (int c = threadIdx.x; c < BN; c += THREADS) {
    const bool in = n0 + c < Cout;
    ssc[c] = in ? __fmul_rn(s_x, s_w[n0 + c]) : 0.f;
    sbb[c] = in ? b_eff[n0 + c] : 0.f;
  }
  __syncthreads();  // the zeros before any patch byte

  // Patch row pr of tile (img, h0, w0) is input row h0 + pr - 1, columns
  // w0 - 1 .. w0 + TW: PW x Cin bytes, contiguous in NHWC from byte grs.
  // Its 16-byte chunks (aligned in x) are loaded as vectors into
  // registers; a chunk that straddles the image's edge (a halo column
  // outside the image, or the row before or after) loads only its bytes
  // inside it, and rows outside the image load nothing: what is not
  // loaded is zero.
  const int L = PW * Cin;
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
      const int64_t grs = (rowpix + w0 - 1) * Cin;
      const int64_t g0 = (grs & ~static_cast<int64_t>(15)) + 16 * q;
      const int64_t e0 = (rowpix + max(w0 - 1, 0)) * Cin;
      const int64_t e1 = (rowpix + min(w0 + TW + 1, W)) * Cin;
      if (g0 >= e0 && g0 + 16 <= e1) {
        pre[j] = __ldg(reinterpret_cast<const uint4*>(x + g0));
      } else if (g0 + 16 > e0 && g0 < e1) {
        uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
        for (int u = 0; u < 16; ++u)
          if (g0 + u >= e0 && g0 + u < e1)
            v[u / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(
                            __ldg(x + g0 + u)))
                        << (8 * (u % 4));
        pre[j] = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
  };
  // ... and written to the patch: byte d of the row (0 <= d < L) is pixel
  // d / Cin's channel d % Cin, at (d / Cin) * C4 + d % Cin
  auto put = [&](int t, unsigned char* buf) {
    int img, h0, w0;
    origin(t, img, h0, w0);
#pragma unroll
    for (int j = 0; j < G::LPT; ++j) {
      const int i = threadIdx.x + j * THREADS;
      if (i >= G::ITEMS) continue;
      const int pr = i / G::CPR, q = i % G::CPR;
      const int64_t grs =
          ((static_cast<int64_t>(img) * H + h0 + pr - 1) * W + w0 - 1) * Cin;
      const int d0 = 16 * q - static_cast<int>(grs & 15);
      if (d0 >= L || d0 + 16 <= 0) continue;
      unsigned char* row = buf + pr * G::RS;
      const uint32_t v[4] = {pre[j].x, pre[j].y, pre[j].z, pre[j].w};
      const int u0 = d0 < 0 ? -d0 : 0;  // the chunk's first byte in the row
      int px = (d0 + u0) / Cin, ci = d0 + u0 - px * Cin;
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        if (u < u0 || d0 + u >= L) continue;
        row[px * C4 + ci] = static_cast<unsigned char>(v[u / 4] >>
                                                       (8 * (u % 4)));
        if (++ci == Cin) {
          ci = 0;
          ++px;
        }
      }
    }
  };

  // byte offsets in the patch of this lane's A words per k32 step: k = 32
  // s + 4 tq (a0, a1: pixels g, g + 8) and k + 16 (a2, a3)
  int off[G::KSTEPS][2];
#pragma unroll
  for (int s = 0; s < G::KSTEPS; ++s)
#pragma unroll
    for (int hk = 0; hk < 2; ++hk)
      off[s][hk] = koff<C4>(32 * s + 16 * hk + 4 * tq);
  unsigned char* st = smem + warp * STAGE_WARP;

  int t = blockIdx.x;
  if (t < total) {
    fetch(t);
    put(t, patch);
  }
  __syncthreads();  // weights, zeros and the first patch
  for (int it = 0; t < total; t += gridDim.x, ++it) {
    const int tn = t + gridDim.x;
    if (tn < total) fetch(tn);  // in flight while this tile computes

    // Implicit GEMM: warp ``warp`` computes output row h0 + warp, TW
    // pixels (MT m16 tiles) x 64 channels; A words from the patch at
    // each packed k, B words from the resident weights.
    int acc[MT][8][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][nt][e] = 0;
    const uint32_t pix =
        smem_u32(patch + (it & 1) * G::BUF) + warp * G::RS + g * C4;
#pragma unroll
    for (int s = 0; s < G::KSTEPS; ++s) {
      uint32_t a[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const uint32_t p0 = pix + 16 * m * C4, p1 = p0 + 8 * C4;
        a[m][0] = lds32(p0 + off[s][0]);
        a[m][1] = lds32(p1 + off[s][0]);
        a[m][2] = lds32(p0 + off[s][1]);
        a[m][3] = lds32(p1 + off[s][1]);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const unsigned char* wr = w_s + (nt * 8 + g) * G::WS + 32 * s + 4 * tq;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(wr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(wr + 16);
#pragma unroll
        for (int m = 0; m < MT; ++m) mma_s8(acc[m][nt], a[m], b0, b1);
      }
    }

    int img, h0, w0;
    origin(t, img, h0, w0);
    staging_free<0>(lane);  // the last tile's store has read the buffer
    if (mode == 0)
      packed_row<0>(acc, st, &omap, out, tma, img, h0 + warp, w0, n0, H, W,
                    Cout, lane, ssc, sbb, s_out, r_out);
    else if (mode == 1)
      packed_row<1>(acc, st, &omap, out, tma, img, h0 + warp, w0, n0, H, W,
                    Cout, lane, ssc, sbb, s_out, r_out);
    else
      packed_row<2>(acc, st, &omap, out, tma, img, h0 + warp, w0, n0, H, W,
                    Cout, lane, ssc, sbb, s_out, r_out);

    if (tn < total) put(tn, patch + ((it + 1) & 1) * G::BUF);
    __syncthreads();  // the next patch is in place; this one may go
  }
  if (lane == 0) sm90::bulk_wait<0, false>();  // the stores are done
}

template <int C4>
cudaError_t launch(const int8_t* x, const int8_t* wk, const float* s_w,
                   const float* b_eff, const float* s_x, const float* s_out,
                   void* out, int mode, int N, int H, int W, int Cin,
                   int Cout, cudaStream_t st) {
  using G = Geo<C4>;
  CUtensorMap omap{};
  const bool tma = tma_ok(mode, Cout);
  if (tma && !encode_out_map(&omap, out, mode, N, H, W, Cout, TW))
    return cudaErrorInvalidValue;
  auto kern = conv3x3_int8_packed_kernel<C4>;
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
  kern<<<static_cast<unsigned>(grid), THREADS, G::SMEM, st>>>(
      omap, x, wk, s_w, b_eff, s_x, s_out, out, mode, tma ? 1 : 0, N, H, W,
      Cin, Cout);
  return cudaGetLastError();
}

cudaError_t run(const int8_t* x, const int8_t* wk, const float* s_w,
                const float* b_eff, const float* s_x, const float* s_out,
                void* out, int mode, int N, int H, int W, int Cin, int Cout,
                cudaStream_t st) {
#define PACKED_CASE(C4)                                                   \
  case C4:                                                                \
    return launch<C4>(x, wk, s_w, b_eff, s_x, s_out, out, mode, N, H, W, \
                      Cin, Cout, st);
  switch (cin4(Cin)) {
    PACKED_CASE(4) PACKED_CASE(8) PACKED_CASE(12) PACKED_CASE(16)
    PACKED_CASE(20) PACKED_CASE(24) PACKED_CASE(28) PACKED_CASE(32)
    default:
      return cudaErrorInvalidValue;
  }
#undef PACKED_CASE
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
// on the device; the rounding rintf, half to even, as torch.round. The
// output has its own pixel stride OS (x's last dimension C a pixel): OS =
// Cs for the input of a wgmma block whose Cin % 16 != 0, so the block
// reads it as it is; element i goes to (i / C) * OS + i % C, an 8-byte
// store where a thread's 8 elements share a pixel (C % 8 == 0 or OS ==
// C), else one at a time.
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
                    int8_t* __restrict__ out, int64_t n, int C, int OS) {
  const float s = *s_p;
  const int64_t i0 =
      (static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x) * V;
  if (i0 >= n) return;
  // element i0 at out + pix * OS + c (where OS == C any split of i0 gives
  // that address, so the division is skipped)
  int64_t pix = 0, c = i0;
  if (OS != C) {
    pix = i0 / C;
    c = i0 - pix * C;
  }
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
    if (OS == C || C % V == 0) {
      *reinterpret_cast<uint2*>(out + pix * OS + c) =
          *reinterpret_cast<const uint2*>(q);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        out[pix * OS + c] = q[e];
        if (++c == C) c = 0, ++pix;
      }
    }
  } else {
    for (int64_t i = i0; i < n; ++i) {
      out[pix * OS + c] = quantize1(to_f32(x[i]), s);
      if (++c == C) c = 0, ++pix;
    }
  }
}

template <typename T>
cudaError_t run(const void* x, const float* s, int8_t* out, int64_t n,
                int C, int OS, cudaStream_t st) {
  const int64_t blocks = (n + THREADS * V - 1) / (THREADS * V);
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  quantize_kernel<T><<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(
      static_cast<const T*>(x), s, out, n, C, OS);
  return cudaGetLastError();
}

}  // namespace qz

}  // namespace

// The path that takes Cin: 1 wgmma (Cin >= 32), 2 packed (Cin < 32), 0
// none (Cin <= 0; the wrapper refuses such a call). fused_conv_int8.
// int8_path holds the same rule.
extern "C" int conv3x3_int8_path(int Cin) {
  if (Cin <= 0) return 0;
  return Cin <= packed::MAX_CIN ? 2 : 1;
}

// x's pixel stride in bytes that the path of Cin reads: 16 * ceil(Cin / 16)
// on the wgmma path (TMA's 16-byte strides), Cin on the packed path, 0 for
// none. fused_conv_int8.pixel_stride holds the same rule.
extern "C" int conv3x3_int8_pixel_stride(int Cin) {
  switch (conv3x3_int8_path(Cin)) {
    case 1: return wg::pixel_stride(Cin);
    case 2: return Cin;
    default: return 0;
  }
}

// The packed path's K (9 x Cin4 in whole k32 steps): the repacked
// weights' row length there.
extern "C" int conv3x3_int8_packed_k(int Cin) { return packed::kp(Cin); }

// out (N,H,W,Cout) <- x (N,H,W,Cin) int8 at the pixel stride
// conv3x3_int8_pixel_stride(Cin), the repacked weights wk, s_w and b_eff
// (Cout,) f32, s_x and (mode 0) s_out f32 scalars on the device; mode 0
// int8 out (requantized at s_out), 1 bf16, 2 f32.
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

// out <- clip(round_half_even(x / s), -127, 127), x (n,) bf16 (dtype 0) or
// f32 (dtype 1), C elements a pixel, out at pixel stride OS >= C (OS % 16
// == 0 where OS != C), s an f32 scalar on the device; x and out 16-byte
// aligned.
extern "C" int quantize_int8(const void* x, const void* s, void* out,
                             long long n, int C, int OS, int dtype,
                             void* stream) {
  if (n <= 0 || C <= 0 || n % C != 0 || OS < C || (OS != C && OS % 16) ||
      dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto sp = static_cast<const float*>(s);
  auto o = static_cast<int8_t*>(out);
  return static_cast<int>(
      dtype == 0 ? qz::run<__nv_bfloat16>(x, sp, o, n, C, OS, st)
                 : qz::run<float>(x, sp, o, n, C, OS, st));
}
