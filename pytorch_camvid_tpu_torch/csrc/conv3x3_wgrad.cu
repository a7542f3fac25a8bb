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
//   of 8: UNet at width 9/16's training step sends it the dW of seven
//   blocks, 3->36, 36->36 x2, 72->36 x2, 36->72 and 36->12; a 150-class
//   head its 64->150; 64->28, 3->12). Bound by bytes: at 360x480, batch
//   24, the seven read x and g once for 1.174 ms at 3.35 TB/s, at up to
//   ~215 FLOP a byte (72->36), under the ridge. So x and g are each read
//   once a channel tile, in 16-byte chunks at any channel alignment, and
//   the MMA padding is kept small: M packs 9 taps x the channels of the
//   side with fewer (a tile of up to MAX_CM = 64) tap-major, m = (3 dy +
//   dx) cm + c,
//   in whole m64 tiles (27 -> 64 at the stem, 324 -> 384 at 36), split
//   over two consumer warpgroups; N is the other side's channels rounded
//   to 8 (36 -> 40, 72 -> 72) as a sum of wgmma sizes, in channel tiles
//   past what a warpgroup's accumulators hold (64->150: 4 x 40); K is 16
//   pixels of a tile row. Where x is the narrower side D[(t, c)][n] is
//   dW[t][c][n]; where g is, it is dW[8 - t][n][c] (as the packed path).
//   A block of 384 threads (two consumer warpgroups and a producer; 512
//   would cap the consumers at 128 registers) walks its split's pixel
//   tiles of th rows x 16 columns (th 8, or 4 or 2 where 8 does not
//   fit); per tile the consumer warps copy its rows,
//   the M side's th + 2 (with the halo) and the N side's th, as the
//   16-byte chunks that hold them (cp.async, a row a warp, two tiles
//   ahead of the transposition, at a row stride congruent to W x channels
//   mod 8 so that each chunk lands on a 16-byte boundary); the producer
//   warpgroup transposes each (patch row, channel) line of the M side,
//   zero outside the image, into three column-shifted channel-major
//   planes (dx = 0, 1, 2; each row 16 pixels = 32 bytes, an odd number of
//   16-byte units a plane so the rows ldmatrix reads and the stores meet
//   distinct banks) and each (tile row, channel) line of the N side
//   into B in wgmma's K-major layout without swizzle; the consumers load
//   each warp's 16 (tap, channel) rows of A by ldmatrix from plane (tap %
//   3, c) at patch row tap / 3 + r (pad rows from a zero plane) and issue
//   wgmma.m64nNk16 with A in registers, two tile rows' loads in flight.
//   Ring stages (planes and B) under full / empty mbarriers, raw buffers
//   under cp.async's mbarrier arrivals. Split-K over pixel tiles in one
//   whole wave of the resident blocks (ops/conv_train.py::wgrad_splits).
//   Measured choices (dw_variants.py's narrow_* variants; PERF.md §6):
//   route (b), the planes read by ldmatrix, against (a), A gathered per
//   lane from the raw rows; the copies on the consumer warps against the
//   producers' own, one copier warp or the bulk copy engine a row at a
//   time, or two channels a line by 32-bit loads (earlier forms of this
//   source); two ring stages or three, three raw buffers or four.
//   Where the M side has more than MAX_CM = 64 channels they are split
//   into channel tiles too (a grid dimension, as N's): each block packs
//   its tile's channels and reads the whole M rows, as an N tile reads the
//   whole N rows. Where a tile's whole rows pass shared memory (both sides
//   wide, from about 250 channels), each pixel's run of the tile's
//   channels is copied instead (``runs``: the chunks that hold it, at a
//   pixel stride congruent to the channel count mod 8). So every shape the
//   rule sends has a tile. Those shapes take instances of their own
//   (TILED), so a one-tile shape runs the code it ran before: in one
//   instance with them the tile and run arithmetic cost UNet 9/16's seven
//   dW 4-5% (PERF.md §6). The plan is ops/conv_train.py::wgrad_narrow_plan,
//   held to the static_asserts below.
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

#include <mutex>

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

constexpr int TW = 16;             // pixel columns a tile (= one k16 step)
constexpr int PW = TW + 2;         // M-side patch columns (with halo)
constexpr int CONSUMER_WGS = 2;    // warpgroups 0 and 1 run the wgmmas
constexpr int PRODUCERS = 128;     // warpgroup 2 transposes
constexpr int COPIERS = 128 * CONSUMER_WGS;  // the consumers copy too
constexpr int THREADS = 128 * CONSUMER_WGS + PRODUCERS;
constexpr int CONSUMER_WARPS = 4 * CONSUMER_WGS;
// setmaxnreg's budget: the block holds 384 x 168 registers (65,536 a
// thread count of 384 allows, in steps of 8), 128 x 96 + 256 x 200 of them
constexpr int PRODUCER_REGS = 96;
constexpr int CONSUMER_REGS = 200;
static_assert(PRODUCERS * PRODUCER_REGS + 128 * CONSUMER_WGS * CONSUMER_REGS
                  <= THREADS * 168,
              "setmaxnreg.inc would wait for registers no warp gives back");
constexpr int MAX_CM = 64;         // an M tile's channels: 9 m64 tiles
constexpr int RAW = 3;             // raw tile buffers: two tiles ahead
constexpr int MAX_STAGES = 3;      // ring stages of planes and B
constexpr int SMEM_MAX = 232448;   // a block's shared memory
constexpr int ACC_MAX = 128;       // accumulators a consumer thread
constexpr int THS[] = {8, 4, 2};   // pixel rows a tile, in order of choice
constexpr int MTWS[] = {1, 2, 3, 5};  // m64 tiles a consumer warpgroup
// the instances (m64 tiles a consumer warpgroup, N tile); ops/conv_train.py
// NARROW_INSTANCES holds the same list
struct Inst {
  int mtw, bn;
};
constexpr Inst INSTANCES[] = {{1, 16}, {1, 40}, {1, 64}, {1, 72}, {1, 128},
                              {2, 16}, {2, 40}, {2, 64}, {3, 40}, {3, 72},
                              {5, 40}};
constexpr int NINST = sizeof(INSTANCES) / sizeof(INSTANCES[0]);
constexpr bool accumulators_fit() {
  for (const Inst& i : INSTANCES)
    if (i.mtw * i.bn / 2 > ACC_MAX) return false;
  return true;
}
static_assert(accumulators_fit(), "an instance's accumulators");

constexpr int up(int v, int m) { return (v + m - 1) / m * m; }

// A call's plan (ops/conv_train.py::wgrad_narrow_plan holds the same rule):
// M = 9 taps x the channels of the side with fewer (side 0: x, the
// stem-like case, D[(t, c)][n] = dW[t][c][n]; side 1: g, the head-like
// case, D[(t, c)][n] = dW[8 - t][n][c]): its cm channels in tiles_m tiles
// of cmt (at most MAX_CM), 9 cmt rows in mt m64 tiles, mtw of them a
// consumer warpgroup; N = the other side's cn channels in tiles_n tiles of
// bn; pixel tiles of th rows x 16 columns. Shared memory: ``stages`` ring
// stages, each the M tile's three column-shifted channel-major copies and
// a zero plane (3 cmt + 1 planes of (th + 2) rows x 32 B + 16 B: an odd
// number of 16-byte units, so the rows one ldmatrix reads fall in distinct
// banks) and B, th k16 steps of bn x 32 B in wgmma's K-major layout
// without swizzle; RAW raw buffers, the M side's th + 2 rows of 18 pixels
// and the N side's th rows of 16, as the 16-byte chunks of the tensors
// that hold them: whole rows of all the side's channels (a row at a
// stride of its length + 14 to 21, congruent to W x channels mod 8, so
// that every chunk lands on a 16-byte boundary) or, with ``runs`` where
// those do not fit, each pixel's run of the tile's channels (a run at a
// stride of its length + 14 to 21, congruent to the channels mod 8; a
// row at one of its runs' span + 14 to 21, congruent to W x channels);
// 128 B of mbarriers. Every shape has a plan.
struct Plan {
  int side, cm, cn, cmt, tiles_m, mt, mtw, bn, tiles_n, th, runs, stages,
      plane, planes_bytes, stage_bytes, raw_m, raw_n, smem;
};

constexpr Plan geometry(int side, int cm, int cn, int tiles_m, int mtw,
                        int bn, int th, int runs) {
  Plan p{};
  p.side = side;
  p.cm = cm;
  p.cn = cn;
  p.tiles_m = tiles_m;
  p.cmt = (cm + tiles_m - 1) / tiles_m;
  p.mt = (9 * p.cmt + 63) / 64;
  p.mtw = mtw;
  p.bn = bn;
  p.tiles_n = (cn + bn - 1) / bn;
  p.th = th;
  p.runs = runs;
  p.plane = 32 * (th + 2) + 16;
  p.planes_bytes = up((3 * p.cmt + 1) * p.plane, 128);
  p.stage_bytes = p.planes_bytes + th * bn * 32;
  // a raw row's elements at most: whole, 18 x cm + 21; in runs, 17 run
  // strides of cmt + 21 and a run, + 21
  p.raw_m = up(2 * ((th + 2) * (runs ? 18 * p.cmt + 378 : 18 * cm + 21) +
                    16), 128);
  p.raw_n = up(2 * (th * (runs ? 16 * bn + 336 : 16 * cn + 21) + 16), 128);
  const int st =
      (SMEM_MAX - RAW * (p.raw_m + p.raw_n) - 128) / p.stage_bytes;
  p.stages = st < MAX_STAGES ? st : MAX_STAGES;
  p.smem = p.stages * p.stage_bytes + RAW * (p.raw_m + p.raw_n) + 128;
  return p;
}

constexpr Plan plan(int cin, int cout) {
  const int side = cin <= cout ? 0 : 1;
  const int cm = side ? cout : cin, cn = side ? cin : cout;
  const int tiles_m = (cm + MAX_CM - 1) / MAX_CM;
  const int mt = (9 * ((cm + tiles_m - 1) / tiles_m) + 63) / 64;
  int mtw = 0;
  for (int i = 3; i >= 0; --i)
    if (MTWS[i] >= (mt + 1) / 2) mtw = MTWS[i];
  int widest = 0, narrowest = 1 << 30;
  for (int i = 0; i < NINST; ++i)
    if (INSTANCES[i].mtw == mtw) {
      widest = INSTANCES[i].bn > widest ? INSTANCES[i].bn : widest;
      narrowest = INSTANCES[i].bn < narrowest ? INSTANCES[i].bn : narrowest;
    }
  // whole rows where they fit, else runs; the fewest N tiles, then the
  // most pixel rows
  for (int runs = 0; runs < 2; ++runs)
    for (int tn = (cn + widest - 1) / widest;; ++tn) {
      const int want = (cn + tn - 1) / tn;
      int bn = widest;
      for (int i = 0; i < NINST; ++i)
        if (INSTANCES[i].mtw == mtw && INSTANCES[i].bn >= want &&
            INSTANCES[i].bn < bn)
          bn = INSTANCES[i].bn;
      for (int th : THS) {
        const Plan p = geometry(side, cm, cn, tiles_m, mtw, bn, th, runs);
        if (p.stages >= 2) return p;
      }
      if (bn == narrowest) break;
    }
  return Plan{};
}
static_assert(plan(3, 36).smem == 74624, "UNet 9/16's stem");
static_assert(plan(36, 36).smem == 210176, "UNet 9/16's 36->36");
static_assert(plan(72, 36).smem == 207232, "UNet 9/16's 72->36");
static_assert(plan(36, 72).smem == 207232, "UNet 9/16's 36->72");
static_assert(plan(36, 12).smem == 111872, "UNet 9/16's head");
static_assert(plan(64, 150).smem == 191744, "a 150-class head");
static_assert(plan(64, 28).smem == 217472, "64->28");
static_assert(plan(350, 12).smem == 216704, "350->12");
static_assert(plan(72, 100).smem == 182912, "72->100: two M tiles");
static_assert(plan(340, 340).smem == 197504, "340->340: runs");
static_assert((2 * MAX_STAGES + RAW) * 8 <= 128, "the mbarriers' 128 bytes");
// the copiers take a tile's 2 th + 2 rows in th / 2 slots of a warp each
constexpr bool rows_in_slots() {
  for (int th : THS)
    if (COPIERS / 32 * (th / 2) < 2 * th + 2) return false;
  return true;
}
static_assert(rows_in_slots(), "a tile's rows in th / 2 copy slots");

// The call's figures, by value in the kernel's parameters; rsm and rsn
// the raw rows' strides, psm and psn the raw pixels' (elements).
struct Geo {
  int side, cm, cn, cmt, mt, th, runs, stages, plane, planes_bytes,
      stage_bytes, raw_m, raw_n, rsm, rsn, psm, psn;
};

__device__ __forceinline__ uint32_t lds16(uint32_t addr) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ void sts128(uint32_t addr, uint32_t a, uint32_t b,
                                       uint32_t c, uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

// Block (N tile blockIdx.x, split blockIdx.y, M tile blockIdx.z): D (9 cmb
// x bn, cmb the M tile's channels) summed over the split's pixel tiles, K =
// the 16 pixels of one tile row a k16 step.
// Warpgroups 0 and 1 copy each tile's rows into a raw buffer two tiles
// ahead (``copy_rows``) and consume: warpgroup w owns m64 tiles w x MTW ..
// w x MTW + MTW - 1 (rows past 9 cmb read the zero plane; a warpgroup
// without a tile idles), each warp's 16 rows (tap, c) loaded by ldmatrix
// from plane (tap % 3, c) at patch row tap / 3 + r, one wgmma.m64nBNk16 (a
// sum of wgmma sizes) a tile and row. Warpgroup 2 produces: each (patch
// row, channel) line of 18 values of the M tile, zero outside the image,
// into the three column-shifted planes of a ring stage, and each (tile
// row, channel) line of the N side's 16 into B. TILED: M in channel tiles
// or the raw rows as pixel runs (geo.runs); else one M tile of whole rows.
template <int MTW, int BN, bool TILED>
__global__ void __launch_bounds__(THREADS, 1)
    conv3x3_wgrad_narrow_kernel(const __nv_bfloat16* __restrict__ x,
                                const __nv_bfloat16* __restrict__ g,
                                float* __restrict__ out, int N, int H, int W,
                                int Cin, int Cout, int splits, const Geo geo) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int th = geo.th, ph = th + 2, cm = geo.cm, cn = geo.cn;
  const int n0 = blockIdx.x * BN;  // the block's N channels
  const int bnc = min(BN, cn - n0);
  const int m0 = TILED ? blockIdx.z * geo.cmt : 0;  // and M channels
  const int cmb = TILED ? min(geo.cmt, cm - m0) : cm;
  const bool runs = TILED && geo.runs;
  const int split = blockIdx.y;
  const int tiles_h = (H + th - 1) / th, tiles_w = (W + TW - 1) / TW;
  const int total = N * tiles_h * tiles_w;  // < 2^31 (host)
  const int t_begin =
      static_cast<int>(static_cast<int64_t>(total) * split / splits);
  const int t_end =
      static_cast<int>(static_cast<int64_t>(total) * (split + 1) / splits);
  const int S = geo.stages, raw_bytes = geo.raw_m + geo.raw_n;
  unsigned char* raw0 = smem + S * geo.stage_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(raw0 + RAW * raw_bytes);
  uint64_t* empty = full + S;
  uint64_t* raw_full = empty + S;   // a raw buffer's rows have landed

  // once: each stage's zero plane (the pad rows of M) and B's columns past
  // the tile's channels
  for (int s = 0; s < S; ++s) {
    unsigned char* st = smem + s * geo.stage_bytes;
    for (int i = threadIdx.x; i < geo.plane / 16; i += THREADS)
      reinterpret_cast<uint4*>(st + 3 * geo.cmt * geo.plane)[i] =
          make_uint4(0, 0, 0, 0);
    for (int i = threadIdx.x; i < th * (BN - bnc) * 2; i += THREADS) {
      const int r = i / (2 * (BN - bnc)), j = i % (2 * (BN - bnc));
      const int n = bnc + j / 2;
      *reinterpret_cast<uint4*>(st + geo.planes_bytes + r * (BN * 32) +
                                (n >> 3) * 256 + (j & 1) * 128 +
                                (n & 7) * 16) = make_uint4(0, 0, 0, 0);
    }
  }
  sm90::fence_proxy_async();  // B's zeros, read by the wgmmas
  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      sm90::mbar_init(&full[i], PRODUCERS);
      sm90::mbar_init(&empty[i], CONSUMER_WARPS);
    }
    for (int i = 0; i < RAW; ++i)   // each copier's copies of a tile
      sm90::mbar_init(&raw_full[i], COPIERS);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  auto origin = [&](int t, int& img, int& h0, int& w0) {
    w0 = t % tiles_w * TW;
    t /= tiles_w;
    h0 = t % tiles_h * th;
    img = t / tiles_h;
  };
  const int64_t pitch_m = static_cast<int64_t>(W) * cm;
  const int64_t pitch_n = static_cast<int64_t>(W) * cn;
  // the element of the M side at patch row 0, column 0, and of the N side
  // at the tile's first pixel (either may lie before the tensor)
  auto corner_m = [&](int img, int h0, int w0) {
    return (static_cast<int64_t>(img) * H + h0 - 1) * pitch_m +
           static_cast<int64_t>(w0 - 1) * cm;
  };
  auto corner_n = [&](int img, int h0, int w0) {
    return (static_cast<int64_t>(img) * H + h0) * pitch_n +
           static_cast<int64_t>(w0) * cn;
  };

  const unsigned short* ms =
      reinterpret_cast<const unsigned short*>(geo.side ? g : x);
  const unsigned short* ns =
      reinterpret_cast<const unsigned short*>(geo.side ? x : g);
  const int lm = PW * cm, ln = TW * cn;  // row lengths, elements
  const int64_t total_m = static_cast<int64_t>(N) * H * pitch_m;
  const int64_t total_n = static_cast<int64_t>(N) * H * pitch_n;
  const uint32_t raw_s = smem_u32(raw0);
  // Tile t's rows into its raw buffer by the copiers (the consumer warps,
  // whose wgmmas leave them idle most of a tile), a row a warp, the lanes
  // on consecutive 16-byte chunks (cp.async); each copier's copies
  // complete its arrival on the buffer's raw_full (``copied``). Row r of
  // a side (image row h0 + r - 1 of the M side, with the halo, or h0 + r
  // of the N side) is len elements from corner + r x pitch; chunk q of it
  // lands at element (corner mod 8) + r x rs - (its offset in its first
  // chunk) + 8 q. With runs, pixel j's run of the tile's channels (from
  // channel c0) is the element e = corner + c0 + r x pitch + j x channels
  // on, and lands at ((corner + c0) mod 8) + r x rs + j x ps: its chunk q
  // at that - (e mod 8) + 8 q. Rows outside the image and chunks outside
  // the tensor are skipped (the transposition reads zero there); x's and
  // g's last chunks lie in their storage (the launcher's whole_chunks).
  struct Raw {
    uint32_t rb;
    int64_t cmr, cnr;
    int h0;
  };
  auto raw_of = [&](int t) {
    Raw q;
    int img, w0;
    origin(t, img, q.h0, w0);
    q.rb = raw_s + (t - t_begin) % RAW * raw_bytes;
    q.cmr = corner_m(img, q.h0, w0);
    q.cnr = corner_n(img, q.h0, w0);
    return q;
  };
  // rows warp + 8 slot of a tile: its rows spread over th / 2 slots
  auto copy_rows = [&](const Raw& q, int slot) {
    const int row = (threadIdx.x >> 5) + slot * (COPIERS / 32);
    if (row >= ph + th) return;
    const bool m = row < ph;
    const int r = m ? row : row - ph;
    const int h = m ? q.h0 + r - 1 : q.h0 + r;
    if (h < 0 || h >= H) return;
    const int64_t corner = m ? q.cmr : q.cnr;
    const int64_t numel = m ? total_m : total_n;
    const unsigned short* src = m ? ms : ns;
    if (runs) {
      const int64_t base = corner + (m ? m0 : n0);
      const int64_t gr = base + r * (m ? pitch_m : pitch_n);
      const int len = m ? cmb : bnc, cs = m ? cm : cn;
      const int ps = m ? geo.psm : geo.psn;
      const int per = (len + 14) / 8;  // chunks a run spans at most
      const uint32_t dst = (m ? q.rb : q.rb + geo.raw_m) +
                           2 * static_cast<int>((base & 7) +
                                                r * (m ? geo.rsm : geo.rsn));
      for (int j = threadIdx.x & 31; j < (m ? PW : TW) * per; j += 32) {
        const int px = j / per, k = j - px * per;
        const int64_t e = gr + static_cast<int64_t>(px) * cs;
        const int64_t a = (e & ~static_cast<int64_t>(7)) + 8 * k;
        if (a < e + len && a >= 0 && a < numel)
          sm90::cp_async16(
              dst + 2 * (px * ps - static_cast<int>(e & 7) + 8 * k),
              src + a, 16);
      }
      return;
    }
    const int64_t gr = corner + r * (m ? pitch_m : pitch_n);
    const int64_t end = gr + (m ? lm : ln);
    const int64_t a0 = gr & ~static_cast<int64_t>(7);
    const uint32_t dst =
        (m ? q.rb : q.rb + geo.raw_m) +
        2 * static_cast<int>((corner & 7) + r * (m ? geo.rsm : geo.rsn) -
                             (gr - a0));
    for (int64_t a = a0 + 8 * (threadIdx.x & 31); a < end; a += 256)
      if (a >= 0 && a < numel)
        sm90::cp_async16(dst + 2 * static_cast<int>(a - a0), src + a, 16);
  };
  auto copied = [&](int t) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                     "r"(smem_u32(&raw_full[(t - t_begin) % RAW]))
                 : "memory");
  };

  if (threadIdx.x >= 128 * CONSUMER_WGS) {
    // ------------------------------------------------------ producers
    sm90::setmaxnreg_dec<PRODUCER_REGS>();
    const int p = threadIdx.x - 128 * CONSUMER_WGS;
    // Tile t into stage st: M line (pr, c) of the tile's channels, its 18
    // values zero outside the image, into planes (dx, c) row pr as pixels
    // dx .. dx + 15 (c < cmb; the zero plane at 3 cmt); N line
    // (r, n) of the block's channels into B's step r, channel n: pixels
    // 0-7 and 8-15 at (n / 8) 256 + (n % 8) 16 and 128 bytes on. A warp's
    // lanes take consecutive channels: consecutive planes (an odd number
    // of 16-byte units each) and B rows, conflict-free stores.
    auto put = [&](int t, uint32_t st) {
      int img, h0, w0;
      origin(t, img, h0, w0);
      const uint32_t rb = raw_s + (t - t_begin) % RAW * raw_bytes;
      // a raw pixel holds all the side's channels (whole rows) or the
      // tile's from its first (runs)
      const int cbm = runs ? 0 : m0, cbn = runs ? 0 : n0;
      const int psm = TILED ? geo.psm : cm, psn = TILED ? geo.psn : cn;
      const int bm =
          static_cast<int>((corner_m(img, h0, w0) + m0 - cbm) & 7);
      const int bn =
          static_cast<int>((corner_n(img, h0, w0) + n0 - cbn) & 7);
      // 16 pixels' values from v[first] on as 8 words, two a word, into
      // a row at a and a + half
      auto store = [](uint32_t a, const uint32_t* v, uint32_t half) {
        uint32_t u[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) u[e] = v[2 * e] | v[2 * e + 1] << 16;
        sts128(a, u[0], u[1], u[2], u[3]);
        sts128(a + half, u[4], u[5], u[6], u[7]);
      };
      for (int l = p; l < ph * cmb; l += PRODUCERS) {
        const int pr = l / cmb, c = l - pr * cmb;
        const int h = h0 + pr - 1;
        const bool row = h >= 0 && h < H;
        const uint32_t src = rb + 2 * (bm + pr * geo.rsm + cbm + c);
        uint32_t v[PW];
#pragma unroll
        for (int q = 0; q < PW; ++q) {
          const int w = w0 + q - 1;
          v[q] = row && w >= 0 && w < W ? lds16(src + 2 * q * psm) : 0u;
        }
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          store(st + (dx * cmb + c) * geo.plane + pr * 32, v + dx, 16);
      }
      const uint32_t nsrc = rb + geo.raw_m + 2 * (bn + cbn);
      const uint32_t bst = st + geo.planes_bytes;
      for (int l = p; l < th * bnc; l += PRODUCERS) {
        const int r = l / bnc, n = l - r * bnc;
        const bool row = h0 + r < H;
        const uint32_t src = nsrc + 2 * (r * geo.rsn + n);
        uint32_t v[TW];
#pragma unroll
        for (int q = 0; q < TW; ++q)
          v[q] = row && w0 + q < W ? lds16(src + 2 * q * psn) : 0u;
        store(bst + r * (BN * 32) + (n >> 3) * 256 + (n & 7) * 16, v, 128);
      }
    };
    const uint32_t smem_s = smem_u32(smem);
    int s = 0;
    uint32_t phase = 0;
    for (int t = t_begin; t < t_end; ++t) {
      sm90::mbar_wait(&raw_full[(t - t_begin) % RAW],
                      ((t - t_begin) / RAW) & 1);  // this tile's rows
      sm90::mbar_wait(&empty[s], phase ^ 1);
      put(t, smem_s + s * geo.stage_bytes);
      sm90::fence_proxy_async();  // B, read by the wgmmas
      sm90::mbar_arrive(&full[s]);
      if (++s == S) {
        s = 0;
        phase ^= 1;
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    sm90::setmaxnreg_inc<CONSUMER_REGS>();
    const int wgi = threadIdx.x >> 7;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int mfirst = wgi * MTW;  // this warpgroup's first m64 tile
    const bool busy = mfirst < geo.mt;
    // this lane's ldmatrix row: M row m (matrix lane / 8: rows +8 for
    // odd, k +8 for lane >= 16) at its tap's shifted plane and patch row
    // dy; a pad row reads the zero plane
    uint32_t aoff[MTW];
#pragma unroll
    for (int mi = 0; mi < MTW; ++mi) {
      const int m = 64 * (mfirst + mi) + 16 * warp + 8 * ((lane >> 3) & 1) +
                    (lane & 7);
      const int tap = m / cmb, c = m - tap * cmb;
      aoff[mi] = (m < 9 * cmb ? ((tap % 3) * cmb + c) * geo.plane +
                                    (tap / 3) * 32
                              : 3 * geo.cmt * geo.plane) +
                 16 * (lane >> 4);
    }
    float acc[MTW][BN / 2];
#pragma unroll
    for (int mi = 0; mi < MTW; ++mi)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[mi][i] = 0.f;
    const uint32_t smem_s = smem_u32(smem);
    for (int t = t_begin; t < t_begin + RAW - 1; ++t) {
      if (t < t_end) {
        const Raw q = raw_of(t);
        for (int slot = 0; slot < th / 2; ++slot) copy_rows(q, slot);
      }
      copied(t);
    }
    int s = 0;
    uint32_t phase = 0;
    for (int t = t_begin; t < t_end; ++t) {
      sm90::mbar_wait(&full[s], phase);
      // tile t is transposed, so is tile t - 1: its buffer takes tile tc
      const int tc = t + RAW - 1;
      if (tc < t_end) {
        const Raw q = raw_of(tc);
        for (int slot = 0; slot < th / 2; ++slot) copy_rows(q, slot);
      }
      copied(tc);
      if (busy) {
        const uint32_t st = smem_s + s * geo.stage_bytes;
        const uint32_t bs = st + geo.planes_bytes;
        uint32_t fa[MTW][4], fb[MTW][4];
        // tile rows in pairs (th is even), their A fragments in two
        // buffers: a row's loads run while the row before's wgmmas do
        for (int r = 0; r < th; r += 2) {
#pragma unroll
          for (int mi = 0; mi < MTW; ++mi)
            sm90::ldmatrix_x4(fa[mi], st + aoff[mi] + r * 32);
          sm90::wgmma_fence();
#pragma unroll
          for (int mi = 0; mi < MTW; ++mi)
            sm90::wgmma_rs_kmajor<BN>(acc[mi], fa[mi], bs + r * (BN * 32));
          sm90::wgmma_commit();
          sm90::wgmma_wait<1>();
#pragma unroll
          for (int mi = 0; mi < MTW; ++mi)
            sm90::ldmatrix_x4(fb[mi], st + aoff[mi] + (r + 1) * 32);
          sm90::wgmma_fence();
#pragma unroll
          for (int mi = 0; mi < MTW; ++mi)
            sm90::wgmma_rs_kmajor<BN>(acc[mi], fb[mi],
                                      bs + (r + 1) * (BN * 32));
          sm90::wgmma_commit();
          sm90::wgmma_wait<1>();
        }
        sm90::wgmma_wait<0>();
      }
      if (lane == 0) sm90::mbar_arrive(&empty[s]);
      if (++s == S) {
        s = 0;
        phase ^= 1;
      }
    }
    sm90::cp_async_wait<0>();
#pragma unroll
    for (int mi = 0; mi < MTW; ++mi) sm90::fence_regs(acc[mi]);
    if (!busy) return;

    // Accumulator i of m64 tile mi: row m = 64 (mfirst + mi) + 16 warp +
    // lane / 4 (+8 for i % 4 >= 2) = (tap, c), column n = 8 (i / 4) + 2
    // (lane % 4) + i % 2 of the block's channels. Side x: dW[tap][m0 +
    // c][n0 + n]; side g: dW[8 - tap][n0 + n][m0 + c].
    float* dst = out + static_cast<int64_t>(split) * 9 * Cin * Cout;
#pragma unroll
    for (int mi = 0; mi < MTW; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = 64 * (mfirst + mi) + 16 * warp + (lane >> 2) + 8 * half;
        if (m >= 9 * cmb) continue;
        const int tap = m / cmb, c = m0 + m - tap * cmb;
#pragma unroll
        for (int i = 0; i < BN / 4; ++i) {
          const int n = 8 * (i / 2) + 2 * (lane & 3) + (i & 1);
          if (n >= bnc) continue;
          const float v = acc[mi][4 * (i / 2) + 2 * half + (i & 1)];
          if (geo.side)
            dst[(static_cast<int64_t>(8 - tap) * Cin + n0 + n) * Cout + c] =
                v;
          else
            dst[(static_cast<int64_t>(tap) * Cin + c) * Cout + n0 + n] = v;
        }
      }
  }
}

template <int MTW, int BN, bool TILED>
cudaError_t launch(const __nv_bfloat16* x, const __nv_bfloat16* g,
                   float* dst, int N, int H, int W, int Cin, int Cout,
                   int splits, const Plan& p, cudaStream_t stream) {
  auto mod8 = [](int64_t v) { return static_cast<int>((v % 8 + 8) % 8); };
  // a stride of len + 14 to 21 elements congruent to the one it copies
  auto stride = [&](int64_t of, int len) {
    return len + 14 + mod8(of - len - 14);
  };
  const int64_t wm = static_cast<int64_t>(W) * p.cm;
  const int64_t wn = static_cast<int64_t>(W) * p.cn;
  int rsm, rsn, psm, psn;
  if (p.runs) {
    psm = stride(p.cm, p.cmt);
    psn = stride(p.cn, p.bn);
    rsm = stride(wm, (PW - 1) * psm + p.cmt);
    rsn = stride(wn, (TW - 1) * psn + p.bn);
  } else {
    psm = p.cm;
    psn = p.cn;
    rsm = stride(wm, PW * p.cm);
    rsn = stride(wn, TW * p.cn);
  }
  const Geo geo{p.side,   p.cm,           p.cn,          p.cmt,   p.mt,
                p.th,     p.runs,         p.stages,      p.plane,
                p.planes_bytes,           p.stage_bytes, p.raw_m, p.raw_n,
                rsm,      rsn,            psm,           psn};
  auto kern = conv3x3_wgrad_narrow_kernel<MTW, BN, TILED>;
  // the instance's shared-memory ceiling, set once a (device, bytes)
  static std::mutex mu;
  static int set_dev = -1, set_smem = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (dev != set_dev || p.smem != set_smem) {
      set_dev = -1;
      if ((err = cudaFuncSetAttribute(
               kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
               p.smem)) != cudaSuccess)
        return err;
      set_dev = dev;
      set_smem = p.smem;
    }
  }
  kern<<<dim3(p.tiles_n, splits, p.tiles_m), THREADS, p.smem, stream>>>(
      x, g, dst, N, H, W, Cin, Cout, splits, geo);
  return cudaGetLastError();
}

cudaError_t run(const __nv_bfloat16* x, const __nv_bfloat16* g, float* dst,
                int N, int H, int W, int Cin, int Cout, int splits,
                cudaStream_t st) {
  const Plan p = plan(Cin, Cout);
  if (p.smem == 0 || p.tiles_m > 65535) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g)) & 15)
    return cudaErrorInvalidValue;  // the 16-byte chunk copies
  if (static_cast<int64_t>(N) * ((H + p.th - 1) / p.th) *
          ((W + TW - 1) / TW) >
      2147483647LL)
    return cudaErrorInvalidConfiguration;
#define NARROW_CASE(MTW, BN)                                              \
  case MTW * 1000 + BN:                                                    \
    return p.tiles_m > 1 || p.runs                                         \
               ? launch<MTW, BN, true>(x, g, dst, N, H, W, Cin, Cout,      \
                                       splits, p, st)                      \
               : launch<MTW, BN, false>(x, g, dst, N, H, W, Cin, Cout,     \
                                        splits, p, st);
  switch (p.mtw * 1000 + p.bn) {
    NARROW_CASE(1, 16) NARROW_CASE(1, 40) NARROW_CASE(1, 64)
    NARROW_CASE(1, 72) NARROW_CASE(1, 128) NARROW_CASE(2, 16)
    NARROW_CASE(2, 40) NARROW_CASE(2, 64) NARROW_CASE(3, 40)
    NARROW_CASE(3, 72) NARROW_CASE(5, 40)
    default:
      return cudaErrorInvalidValue;
  }
#undef NARROW_CASE
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
          sm90::cp_async16(smem_u32(rb + i * 16), xs + g0, 2 * n8);
        }
      }
      sm90::cp_async_commit();   // one group a tile, empty past the end
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
      sm90::cp_async_wait<RAW - 2>();   // this tile's copies, then all
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

// The narrow path's plan of (Cin, Cout) into out[9]: the side whose taps
// make M (0 x, 1 g), m64 tiles a consumer warpgroup, N tile, N channel
// tiles, M channel tiles, pixel rows a tile, runs (1) or whole rows (0),
// ring stages, shared memory bytes.
// ops/conv_train.py::wgrad_narrow_plan holds the same rule.
extern "C" void conv3x3_wgrad_narrow_plan(int Cin, int Cout, int* out) {
  const narrow::Plan p = narrow::plan(Cin, Cout);
  out[0] = p.side;
  out[1] = p.mtw;
  out[2] = p.bn;
  out[3] = p.tiles_n;
  out[4] = p.tiles_m;
  out[5] = p.th;
  out[6] = p.runs;
  out[7] = p.stages;
  out[8] = p.smem;
}

// Pixel tiles of 8 x 16 (the wgmma and packed kernels' tile; the
// narrow kernel's are 8 x 16 or smaller): the wrapper picks splits <= this.
extern "C" long long conv3x3_wgrad_pixel_tiles(int N, int H, int W) {
  return static_cast<long long>(N) * ((H + wg::TH - 1) / wg::TH) *
         ((W + wg::TW - 1) / wg::TW);
}

// Output tiles (blocks per split) of the kernel that takes (Cin, Cout):
// the wrapper sizes the split-K from this.
extern "C" long long conv3x3_wgrad_out_tiles(int Cin, int Cout) {
  const int path = conv3x3_wgrad_path(Cin, Cout);
  if (path == 2)   // the wide side's 64-channel tiles
    return ((Cout % 8 != 0 ? Cin : Cout) + 63) / 64;
  if (path == 1)
    return static_cast<long long>((Cin + wg::BM - 1) / wg::BM) *
           ((Cout + wg::BN - 1) / wg::BN);
  const narrow::Plan p = narrow::plan(Cin, Cout);   // N x M channel tiles
  return static_cast<long long>(p.tiles_n) * p.tiles_m;
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
