// f32 conv3x3 (pad 1, NHWC) for Hopper (sm_90a) on split-TF32 tensor-core
// products: the float32 instances of K4, of K1's three pieces and of K5.
//
// Replaces, at float32 (the JAX package's default compute dtype):
//   K4       pytorch_camvid_tpu/ops/pallas_conv.py:230 (_conv3x3_impl :190)
//            relu(conv3x3(x, W) * A + B), out at x's dtype        -> fwd
//   K1 fwd   the same kernel, unit affine, no ReLU (_conv3x3_fwd :70) -> fwd
//   K1 dx    the same kernel on the cotangent with the flipped weight
//            (_vjp_bwd :208)                                   -> fwd, flip
//   K1 dW    pytorch_camvid_tpu/ops/pallas_conv_train.py:172
//            (_conv3x3_dw :147), f32 (3,3,Cin,Cout) out            -> wgrad
//   K5       pytorch_camvid_tpu/ops/pallas_conv_pair.py:229
//            (_conv3x3_pair_impl :182), K4's function for the shallow
//            full-resolution convs, reusing each H pair of rows  -> k5
//
// Precision. A TF32 operand keeps 10 mantissa bits, so one TF32 product
// per term is ~5e-4 relative: a different function from f32. Each f32
// operand v is split into hi = tf32(v) and lo = tf32(v - hi) (cvt.rna),
// and three products are summed per term, the small ones first: lo*hi +
// hi*lo + hi*hi (lo*lo is below f32's rounding). The tensor core truncates
// the sums it forms, and its truncation errors all lean one way, so in a
// running accumulator they grow with K: that broke phase 14's error rule
// at 7 of 12 checks, up to 63x cuDNN's f32 error, on an H100
// (``f32_variants``). So the products of a step are summed from zero in a
// scratch accumulator (the first with scale-d 0) and added to the running
// f32 accumulator with FADD, which rounds to nearest: the step sums, of
// STEP_K8 = 4 k8 steps (k32, 12 products) each. Their depth was k8 in the
// first design; at k32 every block shape and edge of phase 14 keeps the
// error rule, and the wgmma pipeline holds four times the work between
// waits (f32_variants: k8 1.17-1.40x slower in the forward on an H100).
//
// What bounds it. Three tensor-core products per term: 494.7 / 3 = 165
// TFLOP/s of f32 work at most on an H100 SXM, against 67 TFLOP/s for
// FFMA; bytes matter only at the narrow head and the stem.
//
// Constraints of the card that shape the design:
// - The instruction. wgmma.mma_async.m64nNk8.f32.tf32.tf32 takes B (and an
//   A from shared memory) K-major only: its transpose bits exist for
//   16-bit types, and ldmatrix(.trans) moves 16-bit elements, so neither
//   transposes tf32. A may come from registers, and does here in both
//   kernels: each thread loads its fragment from the TMA-landed tile at
//   any 4-byte offset, splits it in registers and feeds the three wgmmas.
// - Alignment. A descriptor's start address is 16-byte aligned, so a
//   one-pixel shift along K cannot be a descriptor offset: the shifted
//   operand (x, the im2col side, in both kernels) is the register one.
// - The rate. At 67 TFLOP/s of FFMA (cuDNN's f32 reaches about that) the
//   split product has to sustain 39% of its 165 TFLOP/s to win.
// - Precision. The step sums above. In the forward two scratch
//   accumulators alternate up to N = 64 (PINGPONG): step sum s's products
//   are issued, wgmma.wait_group 1 waits for s - 1's, and its FADDs run
//   while s's wgmmas do. The dW keeps one scratch (DW_PINGPONG, below):
//   its three consumer warpgroups overlap one another's FADDs and wgmmas.
// - Registers. A 64 x N accumulator is N/2 floats a thread. ptxas gives
//   every thread the launch's share, 168 of a 384-thread block and 128 of
//   a 512-thread one, setmaxnreg notwithstanding (it still moves the
//   producers' registers at run time). Ping-pong holds three accumulators
//   and, with A from registers, a step sum's 32 A registers stay live
//   until its wait: at N = 64 that fits the forward's 168 and spills in
//   the dW's 128 (10-13% slower), at N = 128 (192 accumulators) in
//   neither, so the forward's N = 128 tile and the dW run one scratch.
//
// Two routes, chosen by conv3x3_f32_route (ops/fused_conv.py::f32_route,
// ops/conv_train.py::wgrad_f32_route hold the same rule); a call's layout
// (the pixel strides its C entry is given) names the route it takes:
//
// * wgmma ("f32"): every call the packed route does not take. TMA's
//   global strides are multiples of 16 bytes, so a side whose channels C
//   are no multiple of 4 comes as the wrapper's padded copy, a pixel
//   stride of 4 ceil(C / 4) with zeros past C (pad_channels_kernel, one
//   copy per tensor and backward: conv_train shares g's between dx and
//   dW); each tensor map has channel extent C at that stride, so TMA reads
//   C channels of a pixel and fills zeros past them, and the kernels stay
//   as they are for C % 4 == 0 (the 12-class head's dx runs here at Cin
//   12, a part 32-channel chunk). The forward where Cin % 4 == 0 or 9 x
//   Cin > 192 (the 23- and 150-class heads' dx); the dW of every shape
//   but the packed route's (the 150-class head's 64 -> 150, 23 -> 64, 6
//   -> 150).
//   - fwd (namespace fw): an implicit GEMM, M = output pixels, N = Cout,
//     K = 9 taps x Cin in 32-channel chunks. A small kernel first splits
//     the weights once per call into K-major hi and lo copies in global
//     memory, [2][Cout][9][xc] at x's pixel stride xc, zeros past Cin
//     (tap-reversed and transposed for flip:
//     B[(t, c)][n] = w[8 - t][n][c]), so B needs no split in the main
//     kernel. A persistent block of three warpgroups: a producer (one
//     thread streams the (TH+2) x 18 x 32 input patch through a 4-D
//     tensor map over x (C, W, H, N), whose halo lies outside the image
//     and is filled with zero: the pad 1; another the weights, one (tap,
//     chunk) hi box and lo box of N x 32 at a time, through a 4-D map over
//     the copies), both with the 128-byte swizzle into rings under full /
//     empty mbarriers; two consumer warpgroups, each one m64 tile of 4
//     output rows x 16 columns, so one staged patch serves all 9 taps and
//     a block tile is 128 pixels x N. Each consumer thread loads its A
//     fragment at the tap's shifted patch row (swizzle XOR in the
//     address), splits it once for the whole N tile and issues the three
//     wgmma.m64nNk8 of the k8 step. N by Cout: 16 (the 64->12 head), 24
//     (VOC's 21), 64, else 128 (against 64 there: 1.12-1.29x faster).
//     Epilogue acc * a + b, ReLU, f32 stores masked at H, W and Cout.
//   - dW (namespace wgf): dW[t][ci][co] = sum_p x[p + off(t)][ci] g[p][co],
//     per tap a GEMM with M = Cin (64 a block), N = Cout (64, or 16 for
//     the head), K = pixels in tiles of TH x TW = 4 x 16. A block owns
//     one kernel row dy, 64 input and N output channels; its three
//     consumer warpgroups own one tap dx each. The producer warpgroup's
//     first thread keeps two TMA rings full: the 4 x 18 x 64 x patch of
//     the tile's rows shifted by dy (halo zero-filled), and g's 4 x 16 x
//     32-channel boxes, unshifted. g is B, and its K is pixels, so it has
//     to be K-major: the producer's other three warps transpose each g
//     tile once into [co][pixel] hi and lo planes (no swizzle, 8 x 16-byte
//     core matrices, channel groups 272 bytes apart), fence.proxy.async,
//     and hand the planes (double buffered) to all three consumers, so the
//     split is done once per element. A transposer thread reads 4 pixels
//     x 4 channels as four 16-byte vectors and writes 4 rows of 16 bytes
//     (with one 4-byte access an element, as first written, the
//     transposers bounded the kernel). x is A from registers at the
//     tap's shift. Pixels enter K
//     in the order 0, 2, 4, 6, 1, 3, 5, 7 within each k8 step, in both
//     operands, so a warp's A loads fall on 8 distinct swizzled chunks
//     (no bank conflict). Split-K over pixel tiles: each split writes its
//     own slice of an f32 workspace and sum_splits_kernel adds the slices
//     in split order: two launches on the same inputs give the same bits,
//     no float atomics. The splits fill waves of one block per SM
//     (ops/conv_train.py::wgrad_f32_splits).
// * packed ("f32_packed", namespace pk): where one side's channels are
//   not a multiple of 4, so TMA cannot describe its 12- or 84-byte pixel
//   rows, but 9 taps x those channels fit K_MAX = 192: the forward where
//   Cin % 4 != 0 with 9 x Cin <= 192 (the Cin = 3 stem, VOC's 21 -> 64
//   dx), the dW where one side is so and the other's channels % 4 == 0
//   (the stem's 3 -> 64, VOC's 64 -> 21) or both sides are so (UNet 5/64's
//   5 -> 5, 10 -> 5; the side with fewer channels stays narrow, the other
//   comes padded as the wide side, 4-12 channels of the block's 64, masked
//   where it stores). The narrow side is read as raw 16-byte chunks of
//   its patch rows, whatever their alignment, the way the bf16 packed
//   paths read theirs.
//   - fwd (conv_f32_packed_kernel<NG>): M = output pixels (tiles of 8 x
//     16, one row a consumer warp, as fw's), N = 64 output channels, K = 9
//     taps x Cin packed tap-major, k = (3 dy + dx) Cin + c, zero-padded to
//     NG step sums of 32 (32 at the stem, 192 at Cin 21). The weights are
//     split once per call by split_weights_kernel (flip there) and loaded
//     once per block, zero-padded, into a resident K-major B (96 KiB at
//     Cin 21: a 756-byte row is no TMA row). The producer warpgroup copies
//     each tile's 10 patch rows as they lie in x (cp.async, two tiles in
//     flight, rows outside the image and chunks past x as zeros), zeroes
//     the columns outside the image at the left and right edges and hands
//     the stage over. Each consumer thread gathers its fragment at a
//     table's (dy, dx c + c) offsets from the raw stage at each patch
//     row's misalignment (a per-row word offset, (s0 + pr W Cin) mod 4),
//     splits it and issues wgmma.m64n64k8 (three split products, the step
//     sums, ping-pong). The epilogue stages each warp's 16 x 64 output row
//     (two 128-byte-swizzled boxes) for a TMA store that runs while the
//     next tile computes (Cout % 4 == 0; else 8-byte stores).
//   - dW (wgrad_f32_packed_kernel<BN>): tf32 wgmma takes B K-major only,
//     so the roles of the bf16 packed dW swap: the wide side (64 channels
//     a block) is A, M = wide channels, K = pixels of a 4 x 16 tile, read
//     unshifted by TMA (two 32-channel boxes, 128-byte swizzle) and split
//     in registers as wgf reads x; the narrow side's (tap, channel) rows
//     are B, built once per tile by three builder warps into K-major hi
//     and lo planes: per (patch row, channel) line its 18 values, zero
//     outside the image, each split once and written as the rows of all
//     three tap columns dx, 16-byte core-matrix rows in the pixel order
//     0, 2, 4, 6, 1, 3, 5, 7; kernel row dy is then a patch-row offset, so
//     consumer warpgroup dy reads its N = 3 x Cn rows (the stem's 9 in an
//     N = 16 tile, VOC's 63 in 64) from the same planes. For the stem (x narrow) D is dW[t][c][co]; for the head (g narrow)
//     the sum runs at g's shift, g[q + off(t)] = g[p - off(8 - t)], so D
//     is dW[8 - t][ci][co]. Split-K as wgf, one wave of blocks, the
//     ordered split sum.
//   What bounds them: the stem's forward writes 442 MB at b10 (0.132 ms at
//   3.35 TB/s), its dW reads g's 442 MB; VOC's dx and dW are bound by the
//   split product (0.254 ms at 165 TFLOP/s). On an H100 neither reaches
//   its bound: the data path alone (gathers, copies, planes, handoffs;
//   f32_variants' pk_no_mma) takes most of each one's time, and the
//   wgmmas add to it rather than hide under it (PERF.md).
// * the padded copy (pad_channels_kernel), in front of route "f32" where
//   a side's channels are no multiple of 4: bound by bytes, P x (C + 4
//   ceil(C / 4)) x 4; it reads x at any 4-byte alignment, so a misaligned
//   view needs no other copy. With it route "f32" took these shapes from
//   the first, mma.sync design (PERF.md: the times of both).
//
// 64-bit element offsets throughout; pixels (N*H*W) stay below 2^31 - 128.

#include "sm90_common.cuh"

namespace f32c {

using sm90::smem_u32;

// The step sums (see the note above): k8 steps a step sum, the step sums
// themselves (off: the running accumulator) and the scratch ping-pong,
// which holds three 64 x N accumulators a thread: the forward takes it up
// to N = PINGPONG_MAX_N (at its widest N tile, MAX_TILE_N = 128, they
// would be 192 of the 168 registers a thread of its 384 gets), the dW
// (DW_PINGPONG) not: ptxas gives each of its 512 threads 128 registers,
// setmaxnreg notwithstanding, and 96 accumulators and a step sum's 32 A
// registers spill there (f32_variants: 10-13% slower on an H100).
constexpr int STEP_K8 = 4;
constexpr bool STEP_SUMS = true;
constexpr bool PINGPONG = true;
constexpr int PINGPONG_MAX_N = 64;
constexpr bool DW_PINGPONG = false;
constexpr int MAX_TILE_N = 128;

template <int N>
constexpr bool kPingpong = PINGPONG && N <= PINGPONG_MAX_N;

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo, both TF32: hi keeps v's top 11 significant bits, lo the
// next 11.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ bool inside(int v, int n) {
  return static_cast<unsigned>(v) < static_cast<unsigned>(n);
}

// out[i] = ws[0][i] + ws[1][i] + ... in split order: the same bits on
// every launch. The loads go out eight at a time (a split count in the
// hundreds, one dependent load after another, had taken tens of us).
__global__ void sum_splits_kernel(const float* __restrict__ ws,
                                  float* __restrict__ out, int64_t n,
                                  int splits) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float s = ws[i];
    int k = 1;
    for (; k + 8 <= splits; k += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = ws[(k + u) * n + i];
#pragma unroll
      for (int u = 0; u < 8; ++u) s += v[u];
    }
    for (; k < splits; ++k) s += ws[k * n + i];
    out[i] = s;
  }
}

// The padded copy: out (P, 4 Q) <- x (P, C), Q = ceil(C / 4), zeros past
// C. A thread writes 16-byte chunk i of out (channels 4q .. 4q + 3 of one
// pixel) from four 4-byte loads of x, whose rows lie at any 4-byte
// alignment (a view such as x[1:], or C odd); a warp's loads and stores
// cover about 512 contiguous bytes each. Bound by bytes: P (C + 4 Q) x 4.
__global__ void pad_channels_kernel(const float* __restrict__ x,
                                    float4* __restrict__ out, int64_t chunks,
                                    int C, int Q) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < chunks; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t p = i / Q;
    const int c = static_cast<int>(i - p * Q) * 4;
    const float* src = x + p * C + c;
    float4 v;
    v.x = src[0];
    v.y = c + 1 < C ? src[1] : 0.f;
    v.z = c + 2 < C ? src[2] : 0.f;
    v.w = c + 3 < C ? src[3] : 0.f;
    out[i] = v;
  }
}

cudaError_t pad_channels(const float* x, float* out, int64_t P, int C,
                         cudaStream_t st) {
  const int Q = (C + 3) / 4;
  const int64_t chunks = P * Q;
  const int64_t blocks = (chunks + 255) / 256;
  pad_channels_kernel<<<static_cast<unsigned>(blocks < 16384 ? blocks
                                                             : 16384),
                        256, 0, st>>>(x, reinterpret_cast<float4*>(out),
                                      chunks, C, Q);
  return cudaGetLastError();
}

// ============================================================ wgmma: both

// One k8 step's split product into d: lo*hi + hi*lo + hi*hi, the small
// ones first; ``first`` starts d from zero (scale-d 0), the others add.
template <int N>
__device__ __forceinline__ void split_products(float (&d)[N / 2],
                                               const uint32_t (&ah)[4],
                                               const uint32_t (&al)[4],
                                               uint64_t bh, uint64_t bl,
                                               bool first) {
  sm90::wgmma_tf32<N>(d, al, bh, first ? 0 : 1);   // lo * hi
  sm90::wgmma_tf32<N>(d, ah, bl, 1);               // hi * lo
  sm90::wgmma_tf32<N>(d, ah, bh, 1);               // hi * hi
}

template <int K>
__device__ __forceinline__ void add_into(float (&acc)[K], float (&s)[K]) {
  sm90::fence_regs(s);   // after the wait: the wgmmas wrote s
#pragma unroll
  for (int i = 0; i < K; ++i) acc[i] += s[i];
}

// k8 step ``u`` of a sequence (u from 0; a constant once the caller's loop
// is unrolled) with A fragment (ah, al) and B descriptors (bh, bl): its
// products go into the scratch of its step sum (with STEP_SUMS off,
// straight into acc). At a step sum's last k8 step the wgmmas are
// committed; with ping-pong the previous step sum is waited for and added
// to acc while this one runs, without, this one is.
template <int N, bool PP>
__device__ __forceinline__ void k8_step(float (&acc)[N / 2],
                                        float (&sc)[2][N / 2], int u,
                                        const uint32_t (&ah)[4],
                                        const uint32_t (&al)[4], uint64_t bh,
                                        uint64_t bl) {
  const int grp = u / STEP_K8, pos = u % STEP_K8;
  sm90::wgmma_fence();   // the A registers (and a scratch) were written
  if constexpr (STEP_SUMS)
    split_products<N>(sc[PP ? grp & 1 : 0], ah, al, bh, bl, pos == 0);
  else
    split_products<N>(acc, ah, al, bh, bl, false);
  if (pos == STEP_K8 - 1) {
    sm90::wgmma_commit();
    if constexpr (!STEP_SUMS) {
      sm90::wgmma_wait<1>();
    } else if constexpr (PP) {
      sm90::wgmma_wait<1>();
      if (grp > 0) add_into(acc, sc[(grp - 1) & 1]);
    } else {
      sm90::wgmma_wait<0>();
      add_into(acc, sc[0]);
    }
  }
}

// The end of a sequence of ``steps`` k8 steps: every wgmma waited for and
// the last step sum added.
template <int N, bool PP>
__device__ __forceinline__ void k8_drain(float (&acc)[N / 2],
                                         float (&sc)[2][N / 2], int steps) {
  sm90::wgmma_wait<0>();
  if constexpr (STEP_SUMS && PP)
    add_into(acc, sc[(steps / STEP_K8 - 1) & 1]);
  if constexpr (!STEP_SUMS) sm90::fence_regs(acc);
}

__device__ __forceinline__ void split4(const float (&v)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(v[i], hi[i], lo[i]);
}

// Byte offset of 16-byte chunk ``chunk`` of 128-byte row ``row`` of a
// tile that TMA wrote with the 128-byte swizzle from a 1024-byte aligned
// base.
__device__ __forceinline__ int swz(int row, int chunk) {
  return (row << 7) + (((chunk ^ row) & 7) << 4);
}

__device__ __forceinline__ float lds(const unsigned char* base, int off) {
  return *reinterpret_cast<const float*>(base + off);
}

// ------------------------------------------------------------- weights

// The forward's B, split once per call: w2[h][n][t][c] (h 0: hi, 1: lo;
// K-major, k = (t, c), rows of Cs >= Cin: x's pixel stride, zeros past
// Cin) = split(w[t][c][n]) of w (3,3,Cin,Cout), or with flip split(w[8 -
// t][n][c]) of w (3,3,Cout,Cin): the tap-reversed transpose, K1's dx.
__global__ void split_weights_kernel(const float* __restrict__ w,
                                     float* __restrict__ w2, int Cin,
                                     int Cs, int Cout, int flip) {
  const int64_t n_el = 9LL * Cs * Cout;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n_el; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(i % Cs);
    const int64_t r = i / Cs;
    const int t = static_cast<int>(r % 9);
    const int n = static_cast<int>(r / 9);
    const float v =
        c >= Cin ? 0.f
        : flip   ? w[(static_cast<int64_t>(8 - t) * Cout + n) * Cin + c]
                 : w[(static_cast<int64_t>(t) * Cin + c) * Cout + n];
    uint32_t hi, lo;
    split_tf32(v, hi, lo);
    w2[i] = __uint_as_float(hi);
    w2[n_el + i] = __uint_as_float(lo);
  }
}

// split_weights_kernel on the caller's stream; the CUDA error of the launch.
cudaError_t split_weights(const float* w, float* w2, int Cin, int Cs,
                          int Cout, int flip, cudaStream_t st) {
  const int64_t n_el = 9LL * Cs * Cout;
  const int64_t blocks = (n_el + 255) / 256;
  split_weights_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks
                                                             : 4096),
                         256, 0, st>>>(w, w2, Cin, Cs, Cout, flip);
  return cudaGetLastError();
}

// ================================================================= fwd

namespace fw {

constexpr int TW = 16;              // output columns a tile: one warp's m16
constexpr int TH = 8;               // output rows: 2 consumer WGs x 4 warps
constexpr int PW = TW + 2, PH = TH + 2;
constexpr int KC = 32;              // channels a chunk: one swizzle row
constexpr int THREADS = 384;        // warpgroups 0, 1 consume; 2 produces
constexpr int CONSUMER_WARPS = 8;
constexpr int PATCH_TX = PH * PW * 128;                     // 23040
constexpr int PATCH_BYTES = (PATCH_TX + 1023) / 1024 * 1024;  // 23552
constexpr int P_STAGES = 2;

template <int BN>
struct Plan {
  static constexpr int W_BOX = BN * 128;     // N x 32 f32 of one (tap, chunk)
  static constexpr int W_TX = 2 * W_BOX;     // its hi and lo boxes
  static constexpr int W_STAGES = BN == 128 ? 4 : 6;
  static constexpr int BAR_OFF = P_STAGES * PATCH_BYTES + W_STAGES * W_TX;
  static constexpr int SMEM = BAR_OFF + 2 * (P_STAGES + W_STAGES) * 8 + 1024;
};
// ops/fused_conv.py::f32_fwd_plan holds the same figures
static_assert(Plan<128>::SMEM == 179296, "fwd plan at N 128");
static_assert(Plan<64>::SMEM == 146560, "fwd plan at N 64");
static_assert(Plan<24>::SMEM == 85120, "fwd plan at N 24");
static_assert(Plan<16>::SMEM == 72832, "fwd plan at N 16");

// Tile N for Cout.
inline int tile_n(int Cout) {
  return Cout <= 16 ? 16 : Cout <= 24 ? 24 : Cout <= 64 ? 64 : MAX_TILE_N;
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
    conv_f32_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                          const __grid_constant__ CUtensorMap wmap,
                          const float* __restrict__ scale,
                          const float* __restrict__ shift,
                          float* __restrict__ out, int N, int H, int W,
                          int Cin, int Cout, int relu) {
  using T = Plan<BN>;
  constexpr int S = T::W_STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  unsigned char* patch = smem;
  unsigned char* wring = smem + P_STAGES * PATCH_BYTES;
  uint64_t* pfull = reinterpret_cast<uint64_t*>(smem + T::BAR_OFF);
  uint64_t* pempty = pfull + P_STAGES;
  uint64_t* wfull = pempty + P_STAGES;
  uint64_t* wempty = wfull + S;

  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  const int tiles_n = (Cout + BN - 1) / BN;
  const int total = N * tiles_h * tiles_w * tiles_n;   // < 2^31 (host)
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
    for (int i = 0; i < P_STAGES; ++i) {
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
          const int ps = pit % P_STAGES;
          sm90::mbar_wait(&pempty[ps], ((pit / P_STAGES) & 1) ^ 1);
          sm90::mbar_arrive_expect_tx(&pfull[ps], PATCH_TX);
          sm90::tma_load_4d(patch + ps * PATCH_BYTES, &xmap, &pfull[ps],
                            c * KC, w0 - 1, h0 - 1, img);
        }
      }
    } else if (threadIdx.x == 288) {
      sm90::prefetch_tensormap(&wmap);
      uint32_t wit = 0;
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        const int n0 = t % tiles_n * BN;
        for (int c = 0; c < nch; ++c) {
          for (int tap = 0; tap < 9; ++tap, ++wit) {
            const int ws = wit % S;
            sm90::mbar_wait(&wempty[ws], ((wit / S) & 1) ^ 1);
            sm90::mbar_arrive_expect_tx(&wfull[ws], T::W_TX);
            unsigned char* dst = wring + ws * T::W_TX;
            sm90::tma_load_4d(dst, &wmap, &wfull[ws], c * KC, tap, n0, 0);
            sm90::tma_load_4d(dst + T::W_BOX, &wmap, &wfull[ws], c * KC, tap,
                              n0, 1);
          }
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    sm90::setmaxnreg_inc<232>();
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, tq = lane & 3;
    const uint32_t wring0 = smem_u32(wring);
    // patch row of tap (0, 0) for this lane's A rows: output row wgi*4 +
    // warp, columns g (a0, a2) and g + 8 (a1, a3)
    const int prow0 = (wgi * 4 + warp) * PW + g;
    float sc[2][BN / 2];   // the step sums' scratch
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[0][i] = sc[1][i] = 0.f;
    uint32_t pit = 0, wit = 0;
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      int img, h0, w0, n0;
      origin(t, img, h0, w0, n0);
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

      for (int c = 0; c < nch; ++c, ++pit) {
        const int ps = pit % P_STAGES;
        sm90::mbar_wait(&pfull[ps], (pit / P_STAGES) & 1);
        const unsigned char* pb = patch + ps * PATCH_BYTES;
        int ws_prev = 0;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int ws = wit % S;
          sm90::mbar_wait(&wfull[ws], (wit / S) & 1);
          const uint32_t wb = wring0 + ws * T::W_TX;
          const int r = prow0 + (tap / 3) * PW + tap % 3;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            // channels 8kk + tq (a0, a1) and 8kk + tq + 4 (a2, a3)
            const float v[4] = {lds(pb, swz(r, 2 * kk) + 4 * tq),
                                lds(pb, swz(r + 8, 2 * kk) + 4 * tq),
                                lds(pb, swz(r, 2 * kk + 1) + 4 * tq),
                                lds(pb, swz(r + 8, 2 * kk + 1) + 4 * tq)};
            uint32_t ah[4], al[4];
            split4(v, ah, al);
            // B: N rows of 128 bytes (32 K), 8 rows 1024 bytes apart; a
            // k8 step is 32 bytes along the swizzled row
            const uint64_t bh = sm90::wgmma_desc(wb + kk * 32, 16, 1024, 1);
            const uint64_t bl =
                sm90::wgmma_desc(wb + T::W_BOX + kk * 32, 16, 1024, 1);
            k8_step<BN, kPingpong<BN>>(acc, sc, tap * 4 + kk, ah, al, bh,
                                       bl);
            // the previous tap's wgmmas have completed: its weights go
            if (kk == STEP_K8 - 1 && tap > 0 && lane == 0)
              sm90::mbar_arrive(&wempty[ws_prev]);
          }
          ws_prev = ws;
          ++wit;
        }
        k8_drain<BN, kPingpong<BN>>(acc, sc, 36);
        if (lane == 0) {
          sm90::mbar_arrive(&wempty[ws_prev]);
          sm90::mbar_arrive(&pempty[ps]);
        }
      }

      // Epilogue. Accumulator i: output row h0 + wgi*4 + warp, column
      // w0 + g (+8 for i%4 >= 2); channel n0 + 8*(i/4) + 2*tq + i%2.
      const int h = h0 + wgi * 4 + warp;
      const bool pair = Cout % 2 == 0;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int co = n0 + 8 * j + 2 * tq;
        if (co >= Cout) continue;
        const bool two = co + 1 < Cout;
        const float a0 = scale[co], b0 = shift[co];
        const float a1 = two ? scale[co + 1] : 0.f;
        const float b1 = two ? shift[co + 1] : 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int ww = w0 + g + 8 * half;
          if (h >= H || ww >= W) continue;
          float* o =
              out + ((static_cast<int64_t>(img) * H + h) * W + ww) * Cout + co;
          float v0 = acc[4 * j + 2 * half] * a0 + b0;
          float v1 = acc[4 * j + 2 * half + 1] * a1 + b1;
          if (relu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          if (two && pair) {
            *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
          } else {
            o[0] = v0;
            if (two) o[1] = v1;
          }
        }
      }
    }
  }
}

template <int BN>
cudaError_t launch(const float* x, const float* w2, const float* a,
                   const float* b, float* out, int N, int H, int W, int Cin,
                   int xc, int Cout, int relu, cudaStream_t stream) {
  using T = Plan<BN>;
  CUtensorMap xmap, wmap;
  // x (Cin, W, H, N) at pixel stride xc: TMA reads Cin channels of each
  // pixel and fills zeros past them (past a padded copy's too)
  const uint64_t xd[4] = {static_cast<uint64_t>(Cin),
                          static_cast<uint64_t>(W), static_cast<uint64_t>(H),
                          static_cast<uint64_t>(N)};
  const uint64_t xs[3] = {4ull * xc, 4ull * xc * W, 4ull * xc * W * H};
  const uint32_t xb[4] = {KC, PW, PH, 1};
  // the split copies [2][Cout][9][xc] as (Cin, 9, Cout, 2)
  const uint64_t wd[4] = {static_cast<uint64_t>(Cin), 9,
                          static_cast<uint64_t>(Cout), 2};
  const uint64_t wstr[3] = {4ull * xc, 36ull * xc, 36ull * xc * Cout};
  const uint32_t wbox[4] = {KC, 1, BN, 1};
  if (!sm90::encode_f32_map(&xmap, x, 4, xd, xs, xb) ||
      !sm90::encode_f32_map(&wmap, w2, 4, wd, wstr, wbox))
    return cudaErrorInvalidValue;
  auto kern = conv_f32_wgmma_kernel<BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const int64_t tiles = static_cast<int64_t>(N) * ((H + TH - 1) / TH) *
                        ((W + TW - 1) / TW) * ((Cout + BN - 1) / BN);
  if (tiles > 2147483647LL) return cudaErrorInvalidConfiguration;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  kern<<<grid, THREADS, T::SMEM, stream>>>(xmap, wmap, a, b, out, N, H, W,
                                           Cin, Cout, relu);
  return cudaGetLastError();
}

cudaError_t run(const float* x, const float* w, const float* a,
                const float* b, float* out, float* w2, int N, int H, int W,
                int Cin, int xc, int Cout, int relu, int flip,
                cudaStream_t st) {
  const cudaError_t err = split_weights(w, w2, Cin, xc, Cout, flip, st);
  if (err != cudaSuccess) return err;
  switch (tile_n(Cout)) {
    case 16:
      return launch<16>(x, w2, a, b, out, N, H, W, Cin, xc, Cout, relu, st);
    case 24:
      return launch<24>(x, w2, a, b, out, N, H, W, Cin, xc, Cout, relu, st);
    case 64:
      return launch<64>(x, w2, a, b, out, N, H, W, Cin, xc, Cout, relu, st);
    default:
      if constexpr (MAX_TILE_N == 128)
        return launch<128>(x, w2, a, b, out, N, H, W, Cin, xc, Cout, relu,
                           st);
      return cudaErrorInvalidValue;
  }
}

}  // namespace fw

// ================================================================== dW

namespace wgf {

constexpr int TH = 4, TW = 16;      // a pixel tile: 64 pixels, 8 k8 steps
constexpr int PW = TW + 2;          // x patch columns (with halo)
constexpr int BM = 64;              // input channels a block: 2 x 32
constexpr int THREADS = 512;        // WGs 0-2 consume (dx); WG 3 produces
constexpr int CONSUMER_WARPS = 12;
constexpr int TRANSPOSERS = 96;     // warps 13-15
constexpr int X_HALF = TH * PW * 128;   // 9216: one 32-channel x box
constexpr int X_TX = 2 * X_HALF;
constexpr int G_BOX = TH * TW * 128;    // 8192: one 32-channel g box
constexpr int X_STAGES = 4, G_STAGES = 3;
// registers a thread after setmaxnreg: the producer warpgroup (TMA and the
// transposers), the consumers; 128 x PRODUCER_REGS + 384 x CONSUMER_REGS
// <= 65,536
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 152;
static_assert(128 * PRODUCER_REGS + 384 * CONSUMER_REGS <= 65536, "regs");

template <int BN>
struct Plan {
  static constexpr int G_BOXES = (BN + 31) / 32;
  static constexpr int G_TX = G_BOXES * G_BOX;
  // a plane's k8 step: N/8 channel groups of two 128-byte core matrices
  // (K halves), SBO apart: 256 + 16, so the 16-byte rows the transposers
  // write to neighbouring groups fall in different banks
  static constexpr int SBO = 272;
  static constexpr int STEP_B = BN / 8 * SBO;
  static constexpr int PLANE = 8 * STEP_B;   // the tile's 64 pixels
  static constexpr int PBUF = 2 * PLANE;     // hi and lo
  static constexpr int G_OFF = X_STAGES * X_TX;
  static constexpr int P_OFF = G_OFF + G_STAGES * G_TX;
  static constexpr int BAR_OFF = P_OFF + 2 * PBUF;
  static constexpr int SMEM =
      BAR_OFF + 2 * (X_STAGES + G_STAGES + 2) * 8 + 1024;
};
// ops/conv_train.py::wgrad_f32_plan holds the same figures
static_assert(Plan<64>::SMEM == 193680, "dW plan at N 64");
static_assert(Plan<16>::SMEM == 116880, "dW plan at N 16");

inline int tile_n(int Cout) { return Cout <= 16 ? 16 : 64; }

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
    wgrad_f32_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                           const __grid_constant__ CUtensorMap gmap,
                           float* __restrict__ out, int N, int H, int W,
                           int Cin, int Cout, int splits) {
  using T = Plan<BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint64_t* xfull = reinterpret_cast<uint64_t*>(smem + T::BAR_OFF);
  uint64_t* xempty = xfull + X_STAGES;
  uint64_t* gfull = xempty + X_STAGES;
  uint64_t* gempty = gfull + G_STAGES;
  uint64_t* pfull = gempty + G_STAGES;
  uint64_t* pempty = pfull + 2;

  // blockIdx.x -> (Cin tile, Cout tile, dy), dy fastest; blockIdx.y is the
  // split. Blocks of one split read the same pixels, so they run close
  // together and share x and g in L2.
  const int dy = blockIdx.x % 3;
  const int tiles_co = (Cout + BN - 1) / BN;
  const int n0 = (blockIdx.x / 3 % tiles_co) * BN;
  const int c0 = (blockIdx.x / 3 / tiles_co) * BM;
  const int split = blockIdx.y;
  const int tiles_h = (H + TH - 1) / TH;
  const int tiles_w = (W + TW - 1) / TW;
  const int total = N * tiles_h * tiles_w;   // < 2^31 (host)
  const int t_begin =
      static_cast<int>(static_cast<int64_t>(total) * split / splits);
  const int t_end =
      static_cast<int>(static_cast<int64_t>(total) * (split + 1) / splits);

  if (threadIdx.x == 0) {
    for (int i = 0; i < X_STAGES; ++i) {
      sm90::mbar_init(&xfull[i], 1);
      sm90::mbar_init(&xempty[i], CONSUMER_WARPS);
    }
    for (int i = 0; i < G_STAGES; ++i) {
      sm90::mbar_init(&gfull[i], 1);
      sm90::mbar_init(&gempty[i], TRANSPOSERS / 32);
    }
    for (int i = 0; i < 2; ++i) {
      sm90::mbar_init(&pfull[i], TRANSPOSERS);
      sm90::mbar_init(&pempty[i], CONSUMER_WARPS);
    }
    sm90::fence_barrier_init();
  }
  sm90::fence_proxy_async();   // the pad rows, for the wgmmas
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  const int lane = threadIdx.x & 31;
  if (wgi == 3) {
    sm90::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x < 416) {
      // ----------------------------------------------- TMA, one thread
      if (threadIdx.x == 384) {
        sm90::prefetch_tensormap(&xmap);
        sm90::prefetch_tensormap(&gmap);
        int w0 = t_begin % tiles_w * TW;
        int h0 = t_begin / tiles_w % tiles_h * TH;
        int img = t_begin / (tiles_w * tiles_h);
        for (int it = 0; it < t_end - t_begin; ++it) {
          const int xs = it % X_STAGES;
          sm90::mbar_wait(&xempty[xs], ((it / X_STAGES) & 1) ^ 1);
          sm90::mbar_arrive_expect_tx(&xfull[xs], X_TX);
          unsigned char* xd = smem + xs * X_TX;
          sm90::tma_load_4d(xd, &xmap, &xfull[xs], c0, w0 - 1, h0 + dy - 1,
                            img);
          sm90::tma_load_4d(xd + X_HALF, &xmap, &xfull[xs], c0 + 32, w0 - 1,
                            h0 + dy - 1, img);
          const int gs = it % G_STAGES;
          sm90::mbar_wait(&gempty[gs], ((it / G_STAGES) & 1) ^ 1);
          sm90::mbar_arrive_expect_tx(&gfull[gs], T::G_TX);
          unsigned char* gd = smem + T::G_OFF + gs * T::G_TX;
#pragma unroll
          for (int b = 0; b < T::G_BOXES; ++b)
            sm90::tma_load_4d(gd + b * G_BOX, &gmap, &gfull[gs], n0 + 32 * b,
                              w0, h0, img);
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
      // ------------------------------------- transposers, warps 13-15
      // Core matrix cm of the tile's planes (8 k8 steps j x N/8 channel
      // groups x 2 K halves, 128 bytes each, in that order) holds channels
      // n0 + 8 cg + lane / 4 at logical k = 4 kh + lane % 4 of step j,
      // i.e. pixel 16 (j / 2) + 8 (j % 2) + 2 (k % 4) + k / 4 of the tile.
      // Item i: channel quad q = i % (N/4) (channels 4q .. 4q+3) of K half
      // kh of k8 step j, (j, kh) = i / (N/4). Its four pixels (logical k =
      // 4 kh .. 4 kh + 3: pixels 2k' + kh of the step, k' = 0..3) are read
      // as 16-byte vectors of 4 channels, split, and written as 4 rows of
      // 16 bytes (one channel, the 4 pixels) of core matrix (j, q / 2, kh).
      // Eight neighbouring lanes take eight quads of one 32-channel box at
      // one pixel: distinct swizzled chunks to read, and rows of distinct
      // banks to write (the groups SBO apart).
      constexpr int Q = BN / 4, ITEMS = 16 * Q;
      const int tt = threadIdx.x - 416;
      for (int it = 0; it < t_end - t_begin; ++it) {
        const int gs = it % G_STAGES, pbuf = it & 1;
        sm90::mbar_wait(&gfull[gs], (it / G_STAGES) & 1);
        sm90::mbar_wait(&pempty[pbuf], ((it >> 1) & 1) ^ 1);
        const unsigned char* gb = smem + T::G_OFF + gs * T::G_TX;
        unsigned char* pb = smem + T::P_OFF + pbuf * T::PBUF;
#pragma unroll
        for (int r = 0; r < (ITEMS + TRANSPOSERS - 1) / TRANSPOSERS; ++r) {
          const int i = tt + r * TRANSPOSERS;
          if (i >= ITEMS) break;
          const int q = i % Q, jk = i / Q, j = jk >> 1, kh = jk & 1;
          const unsigned char* src = gb + (q >> 3) * G_BOX;
          float4 v[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            v[k] = *reinterpret_cast<const float4*>(
                src + swz(16 * (j >> 1) + 8 * (j & 1) + 2 * k + kh, q & 7));
          uint32_t hi[4][4], lo[4][4];   // [channel][pixel]
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            split_tf32(v[k].x, hi[0][k], lo[0][k]);
            split_tf32(v[k].y, hi[1][k], lo[1][k]);
            split_tf32(v[k].z, hi[2][k], lo[2][k]);
            split_tf32(v[k].w, hi[3][k], lo[3][k]);
          }
          unsigned char* dst = pb + j * T::STEP_B + (q >> 1) * T::SBO +
                               kh * 128 + (q & 1) * 64;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            *reinterpret_cast<uint4*>(dst + c * 16) =
                make_uint4(hi[c][0], hi[c][1], hi[c][2], hi[c][3]);
            *reinterpret_cast<uint4*>(dst + T::PLANE + c * 16) =
                make_uint4(lo[c][0], lo[c][1], lo[c][2], lo[c][3]);
          }
        }
        sm90::fence_proxy_async();   // the planes, for the wgmmas
        sm90::mbar_arrive(&pfull[pbuf]);
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&gempty[gs]);
      }
    }
  } else {
    // ------------------------------------------- consumers: dx = wgi
    sm90::setmaxnreg_inc<CONSUMER_REGS>();
    const int dx = wgi;
    const int warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, tq = lane & 3;
    // A = x^T: rows ci = c0 + 16 warp + g (+8: a1, a3), K = the step's
    // pixels 2 tq (a0, a1) and 2 tq + 1 (a2, a3) at the tap's shift; the
    // warp's 16 channels lie in x box warp / 2, 16-byte chunks ch0 and
    // ch0 + 2, word g % 4
    const int ch0 = (16 * (warp & 1) + g) >> 2;
    const int word = 4 * (g & 3);
    const uint32_t smem0 = smem_u32(smem);
    float acc[BN / 2], sc[2][BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = sc[0][i] = sc[1][i] = 0.f;
    for (int it = 0; it < t_end - t_begin; ++it) {
      const int xs = it % X_STAGES, pbuf = it & 1;
      sm90::mbar_wait(&xfull[xs], (it / X_STAGES) & 1);
      sm90::mbar_wait(&pfull[pbuf], (it >> 1) & 1);
      const unsigned char* xb = smem + xs * X_TX + (warp >> 1) * X_HALF;
      const uint32_t pb = smem0 + T::P_OFF + pbuf * T::PBUF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int prow = (j >> 1) * PW + 8 * (j & 1) + 2 * tq + dx;
        const float v[4] = {lds(xb, swz(prow, ch0) + word),
                            lds(xb, swz(prow, ch0 + 2) + word),
                            lds(xb, swz(prow + 1, ch0) + word),
                            lds(xb, swz(prow + 1, ch0 + 2) + word)};
        uint32_t ah[4], al[4];
        split4(v, ah, al);
        // B: the planes' step j, K-major core matrices, K halves 128 bytes
        // apart, 8-channel groups SBO
        const uint64_t bh =
            sm90::wgmma_desc(pb + j * T::STEP_B, 128, T::SBO, 0);
        const uint64_t bl =
            sm90::wgmma_desc(pb + T::PLANE + j * T::STEP_B, 128, T::SBO,
                             0);
        k8_step<BN, PINGPONG && DW_PINGPONG>(acc, sc, j, ah, al, bh, bl);
      }
      k8_drain<BN, PINGPONG && DW_PINGPONG>(acc, sc, 8);
      if (lane == 0) {
        sm90::mbar_arrive(&xempty[xs]);
        sm90::mbar_arrive(&pempty[pbuf]);
      }
    }

    // Accumulator i of tap (dy, dx): input channel c0 + 16 warp + g (+8
    // for i%4 >= 2), output channel n0 + 8 (i/4) + 2 tq + i%2.
    float* dst = out + static_cast<int64_t>(split) * 9 * Cin * Cout;
    const int tap = dy * 3 + dx;
    const bool pair = Cout % 2 == 0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ci = c0 + 16 * warp + g + 8 * half;
      if (ci >= Cin) continue;
      float* row = dst + (static_cast<int64_t>(tap) * Cin + ci) * Cout;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int co = n0 + 8 * j + 2 * tq;
        if (co >= Cout) continue;
        const float v0 = acc[4 * j + 2 * half];
        const float v1 = acc[4 * j + 2 * half + 1];
        if (pair) {   // co even, Cout even: an aligned pair in range
          *reinterpret_cast<float2*>(row + co) = make_float2(v0, v1);
        } else {
          row[co] = v0;
          if (co + 1 < Cout) row[co + 1] = v1;
        }
      }
    }
  }
}

// Pixel tiles of the split-K range.
inline long long pixel_tiles(int N, int H, int W) {
  return static_cast<long long>(N) * ((H + TH - 1) / TH) *
         ((W + TW - 1) / TW);
}

// Blocks of one split: 3 kernel rows x 64-channel Cin tiles x N tiles.
inline long long out_tiles(int Cin, int Cout) {
  const int bn = tile_n(Cout);
  return 3LL * ((Cin + BM - 1) / BM) * ((Cout + bn - 1) / bn);
}

template <int BN>
cudaError_t launch(const float* x, const float* g, float* dst, int N, int H,
                   int W, int Cin, int Cout, int xc, int gc, int splits,
                   cudaStream_t stream) {
  using T = Plan<BN>;
  CUtensorMap xmap, gmap;
  // x and g at pixel strides xc and gc (a padded copy's 4 ceil(C / 4)):
  // TMA reads their Cin and Cout channels and fills zeros past them
  const uint64_t xd[4] = {static_cast<uint64_t>(Cin),
                          static_cast<uint64_t>(W), static_cast<uint64_t>(H),
                          static_cast<uint64_t>(N)};
  const uint64_t xs[3] = {4ull * xc, 4ull * xc * W, 4ull * xc * W * H};
  const uint32_t xb[4] = {32, PW, TH, 1};
  const uint64_t gd[4] = {static_cast<uint64_t>(Cout),
                          static_cast<uint64_t>(W), static_cast<uint64_t>(H),
                          static_cast<uint64_t>(N)};
  const uint64_t gstr[3] = {4ull * gc, 4ull * gc * W, 4ull * gc * W * H};
  const uint32_t gb[4] = {32, TW, TH, 1};
  if (!sm90::encode_f32_map(&xmap, x, 4, xd, xs, xb) ||
      !sm90::encode_f32_map(&gmap, g, 4, gd, gstr, gb))
    return cudaErrorInvalidValue;
  auto kern = wgrad_f32_wgmma_kernel<BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(out_tiles(Cin, Cout)), splits);
  kern<<<grid, THREADS, T::SMEM, stream>>>(xmap, gmap, dst, N, H, W, Cin,
                                           Cout, splits);
  return cudaGetLastError();
}

cudaError_t run(const float* x, const float* g, float* dst, int N, int H,
                int W, int Cin, int Cout, int xc, int gc, int splits,
                cudaStream_t st) {
  return tile_n(Cout) == 16
             ? launch<16>(x, g, dst, N, H, W, Cin, Cout, xc, gc, splits, st)
             : launch<64>(x, g, dst, N, H, W, Cin, Cout, xc, gc, splits, st);
}

}  // namespace wgf

// ================================================================ packed

namespace pk {

constexpr int K_MAX = 192;   // 9 taps x the narrow side's channels

// 16-byte chunks that a row of ``len`` f32 elements spans at any element
// alignment
__host__ __device__ constexpr int raw_chunks(int len) {
  return (len + 2) / 4 + 1;
}

// A 16-byte cp.async of which the first ``bytes`` come from ``src``, the
// rest zero.
__device__ __forceinline__ void cp_async_n(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// ------------------------------------------------------------- forward

// A tile is 8 output rows x 16 columns, one row a consumer warp, as fw's;
// N = 64 output channels; K = 9 taps x Cin packed tap-major, k = (3 dy +
// dx) Cin + c, zero-padded to NG step sums of 32 (K = 32 at Cin 3, 192 at
// Cin 21).
constexpr int F_TH = 8, F_TW = 16;
constexpr int F_PH = F_TH + 2, F_PW = F_TW + 2;
constexpr int F_BN = 64;
constexpr int F_THREADS = 384;        // warpgroups 0, 1 consume; 2 produces
constexpr int F_CONSUMER_WARPS = 8;
constexpr int F_PRODUCERS = 128;
constexpr int F_STAGES = 4;           // raw patch stages
constexpr int F_LAG = 2;              // tiles of copies in flight
static_assert(F_STAGES > F_LAG, "a stage for the consumers");
// one k8 step of B: 8 channel groups x two 128-byte core matrices (K
// halves), K-major, no swizzle
constexpr int F_STEP_B = F_BN / 8 * 256;
// a warp's output row, staged for its TMA store: two 32-channel boxes of
// 16 pixels x 128 B, 128-byte swizzle
constexpr int F_OUT_BOX = F_TW * 128;
constexpr int F_OUT_WARP = 2 * F_OUT_BOX;

__host__ __device__ constexpr int f_groups(int cin) {
  return (9 * cin + 31) / 32;
}
// a raw stage: the tile's 10 patch rows, each the 16-byte chunks that 18 x
// Cin elements span, as they lie in x
__host__ __device__ constexpr int f_raw_stage(int cin) {
  return F_PH * raw_chunks(F_PW * cin) * 16;
}
// the zeros that a padded k reads, at either of a lane's two pixels
__host__ __device__ constexpr int f_zero(int cin) { return 32 * cin + 16; }
// shared memory: alignment slack; the output staging (1024-aligned for
// the swizzle); the resident B, hi and lo; the raw stages; the zeros; the
// affine (a, b); the A offsets' table (8 bytes a k8 step and lane column);
// two mbarriers a stage
__host__ __device__ constexpr int fwd_smem(int cin) {
  return 1024 + F_CONSUMER_WARPS * F_OUT_WARP + 2 * 4 * f_groups(cin) *
         F_STEP_B + F_STAGES * f_raw_stage(cin) + f_zero(cin) + 2 * F_BN * 4 +
         4 * f_groups(cin) * 4 * 8 + 2 * F_STAGES * 8;
}
// ops/fused_conv.py::f32_packed_fwd_plan holds the same figures
static_assert(fwd_smem(3) == 60592, "the stem's forward (Cin 3)");
static_assert(fwd_smem(21) == 195568, "VOC's dx (Cin 21)");

template <int NG>
__global__ void __launch_bounds__(F_THREADS, 1)
    conv_f32_packed_kernel(const __grid_constant__ CUtensorMap omap,
                           const float* __restrict__ x,
                           const float* __restrict__ w2,
                           const float* __restrict__ scale,
                           const float* __restrict__ shift,
                           float* __restrict__ out, int N, int H, int W,
                           int Cin, int Cout, int relu, int tma_out) {
  constexpr int KP = 32 * NG, KSTEPS = 4 * NG;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  unsigned char* bw = smem + F_CONSUMER_WARPS * F_OUT_WARP;
  unsigned char* stages = bw + 2 * KSTEPS * F_STEP_B;
  const int CPR = raw_chunks(F_PW * Cin), RSTAGE = f_raw_stage(Cin);
  unsigned char* zeros = stages + F_STAGES * RSTAGE;
  float* sa = reinterpret_cast<float*>(zeros + f_zero(Cin));
  float* sb = sa + F_BN;
  uint2* tab = reinterpret_cast<uint2*>(sb + F_BN);
  uint64_t* pfull = reinterpret_cast<uint64_t*>(tab + KSTEPS * 4);
  uint64_t* pempty = pfull + F_STAGES;
  const int K = 9 * Cin;

  const int n0 = blockIdx.y * F_BN;
  const int tiles_w = (W + F_TW - 1) / F_TW;
  const int tiles_h = (H + F_TH - 1) / F_TH;
  const int total = N * tiles_h * tiles_w;   // < 2^31 (host)
  auto origin = [&](int t, int& img, int& h0, int& w0) {
    w0 = t % tiles_w * F_TW;
    t /= tiles_w;
    h0 = t % tiles_h * F_TH;
    img = t / tiles_h;
  };
  // element 0 of patch row 0 of a tile lies at word s0 of its first raw
  // chunk, row pr's at (s0 + pr W Cin) mod 4 (32-bit arithmetic keeps the
  // residue)
  auto s_first = [&](int img, int h0, int w0) {
    return ((static_cast<uint32_t>(img) * H + h0 - 1) * W + w0 - 1) *
           static_cast<uint32_t>(Cin);
  };
  const uint32_t wc = static_cast<uint32_t>(W) * static_cast<uint32_t>(Cin);

  // B, resident: element (k, n) of w2[h][n0 + n][k] (the split weights,
  // K-major; flip applied by split_weights_kernel), zero past K and Cout,
  // at k8 step k / 8, channel group n / 8, K half (k / 4) % 2, row n % 8
  for (int i = threadIdx.x; i < 2 * KP * F_BN; i += F_THREADS) {
    const int k = i % KP, r = i / KP, n = r % F_BN, h = r / F_BN;
    const int co = n0 + n;
    const float v =
        k < K && co < Cout
            ? w2[(static_cast<int64_t>(h) * Cout + co) * K + k]
            : 0.f;
    *reinterpret_cast<float*>(bw + (h * KSTEPS + (k >> 3)) * F_STEP_B +
                              (n >> 3) * 256 + ((k >> 2) & 1) * 128 +
                              (n & 7) * 16 + (k & 3) * 4) = v;
  }
  for (int i = threadIdx.x; i < f_zero(Cin) / 4; i += F_THREADS)
    reinterpret_cast<float*>(zeros)[i] = 0.f;
  for (int j = threadIdx.x; j < F_BN; j += F_THREADS) {
    const bool in = n0 + j < Cout;
    sa[j] = in ? scale[n0 + j] : 0.f;
    sb[j] = in ? shift[n0 + j] : 0.f;
  }
  // k = 8 s + t and 8 s + t + 4 (a fragment's K columns): kernel row dy in
  // the top 16 bits (3: a padded k, read from the zeros) and the byte
  // offset of (dx, c) from a pixel's place in its patch row
  auto kent = [&](int k) {
    if (k >= K) return 3u << 16;
    const int tap = k / Cin, c = k - tap * Cin;
    return static_cast<uint32_t>(tap / 3) << 16 |
           static_cast<uint32_t>(4 * ((tap % 3) * Cin + c));
  };
  for (int i = threadIdx.x; i < KSTEPS * 4; i += F_THREADS) {
    const int k = 8 * (i >> 2) + (i & 3);
    tab[i] = make_uint2(kent(k), kent(k + 4));
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < F_STAGES; ++i) {
      sm90::mbar_init(&pfull[i], F_PRODUCERS);
      sm90::mbar_init(&pempty[i], F_CONSUMER_WARPS);
    }
    sm90::fence_barrier_init();
  }
  sm90::fence_proxy_async();   // B, for the wgmmas
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  const int lane = threadIdx.x & 31;
  if (wgi == 2) {
    // ------------------------------------------------------ producers
    // Patch row pr of tile (img, h0, w0) is input row h0 + pr - 1,
    // columns w0 - 1 .. w0 + 16: 18 x Cin elements, contiguous in NHWC,
    // spanning CPR 16-byte chunks of x. Each tile's rows are copied as
    // they lie (cp.async, F_LAG tiles in flight) into a raw stage, rows
    // outside the image and chunks outside x as zeros; once a tile's
    // copies have landed, the columns outside the image (at its left or
    // right edge) are zeroed, and the stage goes to the consumers.
    const int p = threadIdx.x - 256;
    const int64_t numel = static_cast<int64_t>(N) * H * W * Cin;
    const int first = blockIdx.x;
    const int mine = first < total ? (total - 1 - first) / gridDim.x + 1 : 0;
    for (int it = 0; it < mine + F_LAG; ++it) {
      if (it < mine) {
        const int st = it % F_STAGES;
        int img, h0, w0;
        origin(first + it * gridDim.x, img, h0, w0);
        sm90::mbar_wait(&pempty[st], ((it / F_STAGES) & 1) ^ 1);
        unsigned char* rb = stages + st * RSTAGE;
        for (int i = p; i < F_PH * CPR; i += F_PRODUCERS) {
          const int pr = i / CPR, q = i - pr * CPR;
          const int h = h0 + pr - 1;
          const int64_t g0 =
              ((((static_cast<int64_t>(img) * H + h) * W + w0 - 1) * Cin) &
               ~static_cast<int64_t>(3)) + 4 * q;
          const int bytes =
              h < 0 || h >= H || g0 < 0 || g0 >= numel
                  ? 0
                  : 4 * static_cast<int>(numel - g0 < 4 ? numel - g0 : 4);
          cp_async_n(rb + i * 16, bytes ? x + g0 : x, bytes);
        }
      }
      sm90::cp_async_commit();   // one group a tile, empty past the end
      if (it < F_LAG) continue;
      const int done = it - F_LAG, st = done % F_STAGES;
      int img, h0, w0;
      origin(first + done * gridDim.x, img, h0, w0);
      sm90::cp_async_wait<F_LAG>();   // tile ``done``'s copies, then all
      asm volatile("bar.sync 1, %0;\n" ::"n"(F_PRODUCERS) : "memory");
      if (w0 == 0 || w0 + F_TW + 1 > W) {
        float* rf = reinterpret_cast<float*>(stages + st * RSTAGE);
        const uint32_t s0 = s_first(img, h0, w0);
        for (int i = p; i < F_PH * F_PW * Cin; i += F_PRODUCERS) {
          const int pr = i / (F_PW * Cin), e = i - pr * (F_PW * Cin);
          const int w = w0 + e / Cin - 1;
          if (w < 0 || w >= W)
            rf[pr * CPR * 4 + ((s0 + pr * wc) & 3u) + e] = 0.f;
        }
      }
      sm90::mbar_arrive(&pfull[st]);
    }
  } else {
    // ------------------------------------------------------ consumers
    // A: warp ``warp`` of warpgroup wgi takes output row r = 4 wgi + warp,
    // rows g (a0, a2) and g + 8 (a1, a3) its columns; each k8 step's two
    // K columns (8 s + tq, + 4) at the table's kernel row and offset, from
    // the raw stage at that patch row's misalignment, split once and fed
    // to the three wgmma.m64n64k8 of the step, whose B is the resident
    // weights' step s.
    const int warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, tq = lane & 3;
    const int r = wgi * 4 + warp;
    const uint32_t b0 = smem_u32(bw);
    const int zb = static_cast<int>(zeros - smem);
    unsigned char* st_out = smem + r * F_OUT_WARP;
    float sc[2][F_BN / 2];
#pragma unroll
    for (int i = 0; i < F_BN / 2; ++i) sc[0][i] = sc[1][i] = 0.f;
    int it = 0;
    for (int t = blockIdx.x; t < total; t += gridDim.x, ++it) {
      const int st = it % F_STAGES;
      int img, h0, w0;
      origin(t, img, h0, w0);
      // the byte offsets of this lane's pixel (r, g) in patch rows r + dy
      const uint32_t s0 = s_first(img, h0, w0);
      int rb[3];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const int pr = r + dy;
        rb[dy] = static_cast<int>(stages - smem) + st * RSTAGE +
                 4 * (pr * CPR * 4 + static_cast<int>((s0 + pr * wc) & 3u) +
                      g * Cin);
      }
      auto at = [&](uint32_t e) {
        const uint32_t dy = e >> 16;
        return (dy == 0 ? rb[0] : dy == 1 ? rb[1] : dy == 2 ? rb[2] : zb) +
               static_cast<int>(e & 0xFFFFu);
      };
      float acc[F_BN / 2];
#pragma unroll
      for (int i = 0; i < F_BN / 2; ++i) acc[i] = 0.f;
      sm90::mbar_wait(&pfull[st], (it / F_STAGES) & 1);
      uint2 e = tab[tq];
#pragma unroll
      for (int s = 0; s < KSTEPS; ++s) {
        const int ox = at(e.x), oy = at(e.y);
        const float v[4] = {lds(smem, ox), lds(smem, ox + 32 * Cin),
                            lds(smem, oy), lds(smem, oy + 32 * Cin)};
        if (s + 1 < KSTEPS) e = tab[4 * (s + 1) + tq];   // the next step's
        uint32_t ah[4], al[4];
        split4(v, ah, al);
        const uint64_t bh = sm90::wgmma_desc(b0 + s * F_STEP_B, 128, 256, 0);
        const uint64_t bl =
            sm90::wgmma_desc(b0 + (KSTEPS + s) * F_STEP_B, 128, 256, 0);
        k8_step<F_BN, kPingpong<F_BN>>(acc, sc, s, ah, al, bh, bl);
      }
      k8_drain<F_BN, kPingpong<F_BN>>(acc, sc, KSTEPS);
      if (lane == 0) sm90::mbar_arrive(&pempty[st]);

      // Epilogue: acc * a + b, ReLU. Accumulator i: output row h0 + r,
      // column w0 + g (+8 for i%4 >= 2); channel n0 + 8*(i/4) + 2*tq + i%2.
      // Where TMA can describe the output (Cout % 4 == 0: 256-byte rows at
      // 64 channels) the warp stages its row in shared memory (two boxes of
      // 32 channels, 128-byte swizzle) and hands it to a TMA store that
      // runs while the next tile computes and clips H, W and Cout; else
      // each channel pair goes out as one 8-byte store where Cout is even.
      const int h = h0 + r;
      if (tma_out) {
        if (lane == 0) sm90::bulk_wait<0, true>();   // the row was read
        __syncwarp();
#pragma unroll
        for (int j = 0; j < F_BN / 8; ++j) {
          const int c = 8 * j + 2 * tq;
          const float a0 = sa[c], a1 = sa[c + 1], c0 = sb[c], c1 = sb[c + 1];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float v0 = acc[4 * j + 2 * half] * a0 + c0;
            float v1 = acc[4 * j + 2 * half + 1] * a1 + c1;
            if (relu) {
              v0 = fmaxf(v0, 0.f);
              v1 = fmaxf(v1, 0.f);
            }
            *reinterpret_cast<float2*>(st_out + (c >> 5) * F_OUT_BOX +
                                       swz(g + 8 * half, (c & 31) >> 2) +
                                       4 * (c & 3)) = make_float2(v0, v1);
          }
        }
        sm90::fence_proxy_async();
        __syncwarp();
        if (lane == 0) {
          if (h < H) {
            sm90::tma_store_4d(&omap, st_out, n0, w0, h, img);
            if (n0 + 32 < Cout)
              sm90::tma_store_4d(&omap, st_out + F_OUT_BOX, n0 + 32, w0, h,
                                 img);
          }
          sm90::bulk_commit();
        }
      } else {
        const bool pair = Cout % 2 == 0;
#pragma unroll
        for (int j = 0; j < F_BN / 8; ++j) {
          const int c = 8 * j + 2 * tq, co = n0 + c;
          if (co >= Cout) continue;
          const bool two = co + 1 < Cout;
          const float a0 = sa[c], a1 = sa[c + 1], c0 = sb[c], c1 = sb[c + 1];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int ww = w0 + g + 8 * half;
            if (ww >= W || h >= H) continue;
            float* o = out + ((static_cast<int64_t>(img) * H + h) * W + ww) *
                                 Cout + co;
            float v0 = acc[4 * j + 2 * half] * a0 + c0;
            float v1 = acc[4 * j + 2 * half + 1] * a1 + c1;
            if (relu) {
              v0 = fmaxf(v0, 0.f);
              v1 = fmaxf(v1, 0.f);
            }
            if (two && pair) {
              *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
            } else {
              o[0] = v0;
              if (two) o[1] = v1;
            }
          }
        }
      }
    }
    if (lane == 0) sm90::bulk_wait<0, false>();   // the stores are done
  }
}

template <int NG>
cudaError_t fwd_launch(const float* x, const float* w2, const float* a,
                       const float* b, float* out, int N, int H, int W,
                       int Cin, int Cout, int relu, cudaStream_t stream) {
  // the output's tensor map where TMA can describe it (Cout % 4 == 0)
  CUtensorMap omap = {};
  const int tma_out = Cout % 4 == 0;
  if (tma_out) {
    const uint64_t od[4] = {static_cast<uint64_t>(Cout),
                            static_cast<uint64_t>(W),
                            static_cast<uint64_t>(H),
                            static_cast<uint64_t>(N)};
    const uint64_t os[3] = {4ull * Cout, 4ull * Cout * W,
                            4ull * Cout * W * H};
    const uint32_t ob[4] = {32, F_TW, 1, 1};
    if (!sm90::encode_f32_map(&omap, out, 4, od, os, ob))
      return cudaErrorInvalidValue;
  }
  auto kern = conv_f32_packed_kernel<NG>;
  const int smem = fwd_smem(Cin);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const int64_t tiles = static_cast<int64_t>(N) * ((H + F_TH - 1) / F_TH) *
                        ((W + F_TW - 1) / F_TW);
  const int tiles_n = (Cout + F_BN - 1) / F_BN;
  if (tiles > 2147483647LL || tiles_n > 65535)
    return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(tiles < sms ? tiles : sms), tiles_n);
  kern<<<grid, F_THREADS, smem, stream>>>(omap, x, w2, a, b, out, N, H, W,
                                          Cin, Cout, relu, tma_out);
  return cudaGetLastError();
}

// The forward: the weights split once into ws (flip applied), then the
// packed kernel for the step sums K needs.
cudaError_t fwd_run(const float* x, const float* w, const float* a,
                    const float* b, float* out, float* w2, int N, int H,
                    int W, int Cin, int Cout, int relu, int flip,
                    cudaStream_t st) {
  if (reinterpret_cast<uintptr_t>(x) & 15)   // its 16-byte copies
    return cudaErrorInvalidValue;
  const cudaError_t err = split_weights(w, w2, Cin, Cin, Cout, flip, st);
  if (err != cudaSuccess) return err;
#define PK_FWD_CASE(G) \
  case G:              \
    return fwd_launch<G>(x, w2, a, b, out, N, H, W, Cin, Cout, relu, st);
  switch (f_groups(Cin)) {
    PK_FWD_CASE(1) PK_FWD_CASE(2) PK_FWD_CASE(3)
    PK_FWD_CASE(4) PK_FWD_CASE(5) PK_FWD_CASE(6)
    default:
      return cudaErrorInvalidValue;
  }
#undef PK_FWD_CASE
}

// ------------------------------------------------------------------ dW

// A pixel tile is 4 x 16 pixels, 8 k8 steps, as wgf's. The block owns 64
// channels of the wide side (M); consumer warpgroup dy owns the narrow
// side's rows (dx, c) = dx Cn + c of kernel row dy, N = 3 Cn padded to
// the tile N (16 at Cn <= 5, 24 at Cn 6-7, 64 up to 21).
constexpr int W_TH = 4, W_TW = 16;
constexpr int W_PH = W_TH + 2, W_PW = W_TW + 2;   // the narrow patch
constexpr int W_CB = W_TW / 8;                    // 8-pixel column blocks
constexpr int W_THREADS = 512;   // WGs 0-2 consume; warp 12 TMA; 13-15 build
constexpr int W_CONSUMER_WARPS = 12;
constexpr int W_BUILDERS = 96;
constexpr int W_BOX = W_TH * W_TW * 128;   // one 32-channel box of the tile
constexpr int W_X_TX = 2 * W_BOX;          // the block's 64 wide channels
constexpr int W_X_STAGES = 4, W_RAW = 4;

__host__ __device__ constexpr int w_tile_n(int cn) {
  return 3 * cn <= 16 ? 16 : 3 * cn <= 24 ? 24 : 64;
}
// one plane (hi or lo): 6 patch rows x 2 column blocks of N / 8 channel
// groups x two 128-byte core matrices (K halves)
__host__ __device__ constexpr int w_plane(int bn) {
  return W_PH * W_CB * bn * 32;
}
// a raw patch buffer: 6 rows of the 16-byte chunks that 18 x cn elements
// span
__host__ __device__ constexpr int w_raw(int cn) {
  return W_PH * raw_chunks(W_PW * cn) * 16;
}
// alignment slack, the wide stages, two plane buffers (hi and lo), the raw
// buffers and two mbarriers a stage and a buffer
__host__ __device__ constexpr int wgrad_smem(int cn) {
  return 1024 + W_X_STAGES * W_X_TX + 2 * 2 * w_plane(w_tile_n(cn)) +
         W_RAW * w_raw(cn) + 2 * (W_X_STAGES + 2) * 8;
}
// ops/conv_train.py::wgrad_f32_packed_plan holds the same figures
static_assert(w_tile_n(3) == 16 && wgrad_smem(3) == 96992,
              "the stem's dW (Cn 3)");
static_assert(w_tile_n(21) == 64 && wgrad_smem(21) == 201824,
              "VOC's head dW (Cn 21)");
static_assert(W_TH == wgf::TH && W_TW == wgf::TW,
              "the f32 dW routes walk the same pixel tiles");

template <int BN>
__global__ void __launch_bounds__(W_THREADS, 1)
    wgrad_f32_packed_kernel(const __grid_constant__ CUtensorMap wmap,
                            const float* __restrict__ nar,
                            float* __restrict__ out, int N, int H, int W,
                            int Cw, int Cn, int head, int splits) {
  constexpr int PLANE = w_plane(BN);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  unsigned char* planes = smem + W_X_STAGES * W_X_TX;
  unsigned char* raw0 = planes + 4 * PLANE;
  const int CPR = raw_chunks(W_PW * Cn);
  const int RAWB = W_PH * CPR * 16;
  uint64_t* xfull = reinterpret_cast<uint64_t*>(raw0 + W_RAW * RAWB);
  uint64_t* xempty = xfull + W_X_STAGES;
  uint64_t* pfull = xempty + W_X_STAGES;
  uint64_t* pempty = pfull + 2;

  const int n0 = blockIdx.x * 64;   // the block's wide channels
  const int split = blockIdx.y;
  const int tiles_h = (H + W_TH - 1) / W_TH;
  const int tiles_w = (W + W_TW - 1) / W_TW;
  const int total = N * tiles_h * tiles_w;   // < 2^31 (host)
  const int t_begin =
      static_cast<int>(static_cast<int64_t>(total) * split / splits);
  const int t_end =
      static_cast<int>(static_cast<int64_t>(total) * (split + 1) / splits);
  auto origin = [&](int t, int& img, int& h0, int& w0) {
    w0 = t % tiles_w * W_TW;
    h0 = t / tiles_w % tiles_h * W_TH;
    img = t / (tiles_w * tiles_h);
  };

  // row n of a plane: its dx (n = dx Cn + c), -1 past 3 Cn (zero)
  const int tid = threadIdx.x;
  // the planes' pad rows n >= 3 Cn: zero in both buffers, hi and lo
  for (int i = tid; i < 4 * W_PH * W_CB * 2 * BN; i += W_THREADS) {
    const int n = i % BN, cm = i / BN;   // core-matrix row of (pr, cb, kh)
    if (n >= 3 * Cn)
      *reinterpret_cast<uint4*>(planes + cm / (W_PH * W_CB * 2) * PLANE +
                                (cm % (W_PH * W_CB * 2) / 2 * (BN / 8) +
                                 (n >> 3)) * 256 + (cm & 1) * 128 +
                                (n & 7) * 16) = make_uint4(0, 0, 0, 0);
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < W_X_STAGES; ++i) {
      sm90::mbar_init(&xfull[i], 1);
      sm90::mbar_init(&xempty[i], W_CONSUMER_WARPS);
    }
    for (int i = 0; i < 2; ++i) {
      sm90::mbar_init(&pfull[i], W_BUILDERS);
      sm90::mbar_init(&pempty[i], W_CONSUMER_WARPS);
    }
    sm90::fence_barrier_init();
  }
  sm90::fence_proxy_async();   // the pad rows, for the wgmmas
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  const int lane = threadIdx.x & 31;
  if (wgi == 3) {
    if (threadIdx.x == 384) {
      // ------------------------------------ TMA: the wide tile, unshifted
      sm90::prefetch_tensormap(&wmap);
      for (int it = 0; it < t_end - t_begin; ++it) {
        int img, h0, w0;
        origin(t_begin + it, img, h0, w0);
        const int xs = it % W_X_STAGES;
        sm90::mbar_wait(&xempty[xs], ((it / W_X_STAGES) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&xfull[xs], W_X_TX);
        unsigned char* d = smem + xs * W_X_TX;
        sm90::tma_load_4d(d, &wmap, &xfull[xs], n0, w0, h0, img);
        sm90::tma_load_4d(d + W_BOX, &wmap, &xfull[xs], n0 + 32, w0, h0,
                          img);
      }
    } else if (threadIdx.x >= 416) {
      // ------------------------------------- builders, warps 13-15
      // Patch row pr (input row h0 + pr - 1) of the narrow tensor is 18 x
      // Cn contiguous elements (pixels w0 - 1 .. w0 + 16), spanning CPR
      // 16-byte chunks; each tile's rows are copied as they lie (cp.async,
      // three tiles ahead) into one of W_RAW buffers, skipping rows
      // outside the image and chunks outside the tensor. Then a builder
      // takes a line (patch row pr, channel c): its 18 values, zero
      // outside the image, each split once, written as plane row n = dx Cn
      // + c of each tap column dx, pixels dx .. dx + 15, in 16-byte rows of
      // four (columns 8 cb + 2 k + kh, k = 0..3: the pixel order 0, 2, 4,
      // 6, 1, 3, 5, 7 of the consumers' A) of the hi and of the lo plane:
      // every (tap, channel) row of every kernel row dy, built once, its dy
      // a patch-row offset for the consumers. The pad rows (n >= 3 Cn)
      // stay the zeros written at the start.
      const int bt = threadIdx.x - 416;
      const int64_t numel = static_cast<int64_t>(N) * H * W * Cn;
      auto row_start = [&](int img, int h, int w0) {
        return ((static_cast<int64_t>(img) * H + h) * W + w0 - 1) * Cn;
      };
      auto load_raw = [&](int t) {
        if (t < t_end) {
          int img, h0, w0;
          origin(t, img, h0, w0);
          unsigned char* rb = raw0 + (t - t_begin) % W_RAW * RAWB;
          for (int i = bt; i < W_PH * CPR; i += W_BUILDERS) {
            const int pr = i / CPR, q = i - pr * CPR;
            const int h = h0 + pr - 1;
            if (h < 0 || h >= H) continue;
            const int64_t g0 =
                (row_start(img, h, w0) & ~static_cast<int64_t>(3)) + 4 * q;
            if (g0 < 0 || g0 >= numel) continue;
            const int n4 = numel - g0 < 4 ? static_cast<int>(numel - g0) : 4;
            cp_async_n(rb + i * 16, nar + g0, 4 * n4);
          }
        }
        sm90::cp_async_commit();   // one group a tile, empty past the end
      };
      auto build = [&](int t, unsigned char* pl, const unsigned char* rb) {
        int img, h0, w0;
        origin(t, img, h0, w0);
        for (int l = bt; l < W_PH * Cn; l += W_BUILDERS) {
          const int pr = l / Cn, c = l - pr * Cn;
          const int h = h0 + pr - 1;
          const bool row = h >= 0 && h < H;
          // the row's element misalignment in the raw buffer (mod 4 of
          // row_start, in 32-bit arithmetic)
          const int s = static_cast<int>(
              ((static_cast<uint32_t>(img) * H + h) * W + w0 - 1) *
              static_cast<uint32_t>(Cn) & 3u);
          const float* rp =
              reinterpret_cast<const float*>(rb + pr * CPR * 16) + s + c;
          uint32_t hi[W_PW], lo[W_PW];
#pragma unroll
          for (int q = 0; q < W_PW; ++q) {
            const int w = w0 + q - 1;
            split_tf32(row && w >= 0 && w < W ? rp[q * Cn] : 0.f, hi[q],
                       lo[q]);
          }
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const int n = dx * Cn + c;   // the plane row of tap column dx
            unsigned char* d = pl + (pr * W_CB * (BN / 8) + (n >> 3)) * 256 +
                               (n & 7) * 16;
#pragma unroll
            for (int cb = 0; cb < W_CB; ++cb)
#pragma unroll
              for (int kh = 0; kh < 2; ++kh) {
                const int q = 8 * cb + kh + dx;   // pixels q, q+2, q+4, q+6
                unsigned char* e = d + cb * (BN / 8) * 256 + kh * 128;
                *reinterpret_cast<uint4*>(e) =
                    make_uint4(hi[q], hi[q + 2], hi[q + 4], hi[q + 6]);
                *reinterpret_cast<uint4*>(e + PLANE) =
                    make_uint4(lo[q], lo[q + 2], lo[q + 4], lo[q + 6]);
              }
          }
        }
      };
      for (int k = 0; k < W_RAW - 1; ++k) load_raw(t_begin + k);
      for (int it = 0; it < t_end - t_begin; ++it) {
        const int pbuf = it & 1;
        sm90::cp_async_wait<W_RAW - 2>();   // this tile's copies
        asm volatile("bar.sync 1, %0;\n" ::"n"(W_BUILDERS) : "memory");
        sm90::mbar_wait(&pempty[pbuf], ((it >> 1) & 1) ^ 1);
        build(t_begin + it, planes + pbuf * 2 * PLANE,
              raw0 + it % W_RAW * RAWB);
        sm90::fence_proxy_async();   // the planes, for the wgmmas
        sm90::mbar_arrive(&pfull[pbuf]);
        // into the buffer read one tile ago (every builder is past it)
        load_raw(t_begin + it + W_RAW - 1);
      }
    }
  } else {
    // ------------------------------------------- consumers: dy = wgi
    // A = the wide tile^T: rows (wide channels) n0 + 16 warp + g (+8: a1,
    // a3), K = the step's pixels 2 tq (a0, a1) and 2 tq + 1 (a2, a3), as
    // wgf reads x (here unshifted); B = the planes' k8 block at patch row
    // (tile row + dy), N = this kernel row's (dx, c) rows.
    constexpr bool PP = PINGPONG && DW_PINGPONG;   // one scratch, as wgf's
    const int dy = wgi;
    const int warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, tq = lane & 3;
    const int ch0 = (16 * (warp & 1) + g) >> 2;
    const int word = 4 * (g & 3);
    const uint32_t pl0 = smem_u32(planes);
    float acc[BN / 2], sc[2][BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = sc[0][i] = sc[1][i] = 0.f;
    for (int it = 0; it < t_end - t_begin; ++it) {
      const int xs = it % W_X_STAGES, pbuf = it & 1;
      sm90::mbar_wait(&xfull[xs], (it / W_X_STAGES) & 1);
      sm90::mbar_wait(&pfull[pbuf], (it >> 1) & 1);
      const unsigned char* xb = smem + xs * W_X_TX + (warp >> 1) * W_BOX;
      const uint32_t pb = pl0 + pbuf * 2 * PLANE;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = j >> 1, cb = j & 1;
        const int prow = i * W_TW + 8 * cb + 2 * tq;
        const float v[4] = {lds(xb, swz(prow, ch0) + word),
                            lds(xb, swz(prow, ch0 + 2) + word),
                            lds(xb, swz(prow + 1, ch0) + word),
                            lds(xb, swz(prow + 1, ch0 + 2) + word)};
        uint32_t ah[4], al[4];
        split4(v, ah, al);
        const uint32_t blk = pb + ((i + dy) * W_CB + cb) * (BN * 32);
        const uint64_t bh = sm90::wgmma_desc(blk, 128, 256, 0);
        const uint64_t bl = sm90::wgmma_desc(blk + PLANE, 128, 256, 0);
        k8_step<BN, PP>(acc, sc, j, ah, al, bh, bl);
      }
      k8_drain<BN, PP>(acc, sc, 8);
      if (lane == 0) {
        sm90::mbar_arrive(&xempty[xs]);
        sm90::mbar_arrive(&pempty[pbuf]);
      }
    }

    // Accumulator i: wide channel n0 + 16 warp + g (+8 for i%4 >= 2),
    // narrow row n = 8 (i/4) + 2 tq + i%2 = (dx, c), tap t = 3 dy + dx.
    // The stem (x narrow): dW[t][c][wide]; the head (g narrow, summed at
    // g's shift off(t) = -off(8 - t)): dW[8 - t][wide][c].
    float* dst = out + static_cast<int64_t>(split) * 9 * Cw * Cn;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int wc = n0 + 16 * warp + g + 8 * half;
      if (wc >= Cw) continue;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = 8 * j + 2 * tq + e;
          if (n >= 3 * Cn) continue;
          const int dx = n / Cn, c = n - dx * Cn, tap = 3 * dy + dx;
          const int64_t at =
              head ? (static_cast<int64_t>(8 - tap) * Cw + wc) * Cn + c
                   : (static_cast<int64_t>(tap) * Cn + c) * Cw + wc;
          dst[at] = acc[4 * j + 2 * half + e];
        }
    }
  }
}

// Blocks of one split: the wide side's 64-channel tiles (Cw its channels).
inline long long out_tiles(int Cw) { return (Cw + 63) / 64; }

template <int BN>
cudaError_t wgrad_launch(const CUtensorMap& wmap, const float* nar,
                         float* dst, int N, int H, int W, int Cw, int Cn,
                         int head, int splits, cudaStream_t stream) {
  auto kern = wgrad_f32_packed_kernel<BN>;
  const int smem = wgrad_smem(Cn);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Cw + 63) / 64, splits);
  kern<<<grid, W_THREADS, smem, stream>>>(wmap, nar, dst, N, H, W, Cw, Cn,
                                          head, splits);
  return cudaGetLastError();
}

// x-side (the stem's case): x narrow, read as it lies (its pixel stride
// xc = Cin, Cin % 4 != 0), g wide; g-side (the head's): g narrow (gc =
// Cout), x wide. The wide side by TMA at its pixel stride (a padded copy
// where its channels are no multiple of 4: both sides narrow), Cw
// channels of each pixel and zeros past them; the block's 64 wide
// channels (M) are masked at Cw where it stores.
cudaError_t wgrad_run(const float* x, const float* g, float* dst, int N,
                      int H, int W, int Cin, int Cout, int xc, int gc,
                      int splits, cudaStream_t st) {
  const int head = gc % 4 != 0;
  const float* wide = head ? x : g;
  const float* nar = head ? g : x;
  const int Cw = head ? Cin : Cout, Cn = head ? Cout : Cin;
  const uint64_t cs = static_cast<uint64_t>(head ? xc : gc);
  if (reinterpret_cast<uintptr_t>(nar) & 15)   // its 16-byte copies
    return cudaErrorInvalidValue;
  CUtensorMap wmap;
  const uint64_t d[4] = {static_cast<uint64_t>(Cw), static_cast<uint64_t>(W),
                         static_cast<uint64_t>(H), static_cast<uint64_t>(N)};
  const uint64_t s[3] = {4 * cs, 4 * cs * W, 4 * cs * W * H};
  const uint32_t box[4] = {32, W_TW, W_TH, 1};
  if (!sm90::encode_f32_map(&wmap, wide, 4, d, s, box))
    return cudaErrorInvalidValue;
  switch (w_tile_n(Cn)) {
    case 16:
      return wgrad_launch<16>(wmap, nar, dst, N, H, W, Cw, Cn, head, splits,
                              st);
    case 24:
      return wgrad_launch<24>(wmap, nar, dst, N, H, W, Cw, Cn, head, splits,
                              st);
    default:
      return wgrad_launch<64>(wmap, nar, dst, N, H, W, Cw, Cn, head, splits,
                              st);
  }
}

}  // namespace pk

// ================================================================== pair

// K5 at float32: relu(conv3x3(x, W) * A + B) for the full-resolution
// shallow convs (Cin <= 128, Cout <= 64), the f32 instance of
// pytorch_camvid_tpu/ops/pallas_conv_pair.py:229 (_conv3x3_pair_impl
// :182, which takes x's dtype and accumulates in f32). What carries over
// from the bf16 K5 (conv3x3_pair_bn_relu.cu) is its idea: vertically
// adjacent output rows share input rows, so the split A fragment of one
// patch row feeds a wgmma for every output row it reaches, one per tap
// dy. At f32 the reuse saves more than at bf16: each A element costs a
// cvt, a sub and a cvt to split, paid once for up to three rows' products
// (24 splits an output row and 32-channel chunk, where fw splits 36).
// - A block tile is TH = 4 output rows x TW = 64 columns x BN output
//   channels (all of Cout: 16, 32 or 64 by Cout); consumer warpgroup g
//   takes its pair of rows 2g, 2g + 1 (the TPU kernel's H pair), each
//   output row one m64 (warp w: columns 16w .. 16w+15). Both read one
//   6-row x 66-column x 32-channel patch stage (the halo and the pad
//   zero-filled by TMA, as everything past Cin) and one weight stage, so
//   they run in lockstep over the same stages.
// - The weights are split once per call into K-major hi and lo copies
//   (split_weights_kernel, as fw) and streamed through a ring of W_STAGES
//   stages, one stage a (32-channel chunk, tap column dx): the three taps
//   dy, hi and lo, BN rows x 128 bytes each (the 128-byte swizzle). A
//   resident copy would take 8 bytes an element, 294,912 B at 64->64,
//   over a block's 232,448. Per output pixel the ring reads half of fw's
//   weight bytes from L2 (a block tile of 256 pixels against fw's 128).
// - The products: for each stage, each of the warpgroup's four patch rows
//   r is loaded and split once (4 k8 steps, 32 A registers kept), then
//   for each of its output rows o = r - dy it reaches, the tap's four k8
//   steps go into one scratch accumulator from zero (scale-d 0), which
//   after its wait is added to row o's running accumulator with FADD: the
//   step sums of fw, one tap over one 32-channel chunk each, in the order
//   chunk, dx, r, dy, so the error is fw's (chip_smoke's f32 rule; its
//   depth is the chunk's KK = 4 k8 steps, fw's STEP_K8). One
//   scratch and the kept A fragment hold a thread to 2 x BN/2 + BN/2 + 32
//   registers (128 at BN = 64) of the 168 a thread of this 320-thread
//   block gets; the other warpgroup's wgmmas run during a scratch's wait.
// - Epilogue acc * a + b and the ReLU, f32 pairs stored at the pixel,
//   masked at H (a last tile of one pair), W and Cout.
// What bounds it: at 360x480 64->64 the split product (165 TFLOP/s of f32
// work on an H100 SXM) at 1.85 ms for b24 against 0.63 ms of bytes.
// Contract: H even, any W; Cin and Cout multiples of 4 (TMA's 16-byte
// rows), Cin <= 128, Cout <= 64; x, the split weights and out 16-byte
// aligned.
namespace k5 {

constexpr int TH = 4;                 // output rows a block tile: 2 pairs
constexpr int TW = 64;                // output columns: one m64 a row
constexpr int PR = TH + 2, PW = TW + 2;
constexpr int KC = 32;                // channels a chunk: one swizzle row
constexpr int KK = KC / 8;            // k8 steps a chunk: a step sum
constexpr int THREADS = 320;          // WGs 0, 1 consume; warps 8, 9 produce
constexpr int CONSUMER_WARPS = 8;
constexpr int MAX_CIN = 128, MAX_COUT = 64;
constexpr int PATCH_TX = PR * PW * 128;                       // 50688
constexpr int PATCH = (PATCH_TX + 1023) / 1024 * 1024;        // 51200
constexpr int P_STAGES = 2, W_STAGES = 2;

// The tile N at ``cout``: all of Cout in 16, 32 or 64 channels.
inline int tile_n(int cout) { return cout <= 16 ? 16 : cout <= 32 ? 32 : 64; }

template <int BN>
struct Plan {
  static constexpr int W_BOX = BN * 128;       // one (tap, half) box
  static constexpr int W_STAGE = 6 * W_BOX;    // the three taps dy, hi, lo
  static constexpr int BAR_OFF = P_STAGES * PATCH + W_STAGES * W_STAGE;
  static constexpr int SMEM =
      1024 + BAR_OFF + 2 * (P_STAGES + W_STAGES) * 8;
};
// ops/fused_conv_pair.py::tile_plan(cin, torch.float32, cout) holds the
// same figures
static_assert(Plan<64>::SMEM == 201792, "f32 pair plan at N 64");
static_assert(Plan<32>::SMEM == 152640, "f32 pair plan at N 32");
static_assert(Plan<16>::SMEM == 128064, "f32 pair plan at N 16");
static_assert(Plan<64>::SMEM <= 232448, "the plan fits one block");

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
    conv_pair_f32_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap wmap,
                         const float* __restrict__ scale,
                         const float* __restrict__ shift,
                         float* __restrict__ out, int N, int H, int W,
                         int Cin, int Cout, int relu) {
  using T = Plan<BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  unsigned char* patch = smem;
  unsigned char* wring = smem + P_STAGES * PATCH;
  uint64_t* pfull = reinterpret_cast<uint64_t*>(smem + T::BAR_OFF);
  uint64_t* pempty = pfull + P_STAGES;
  uint64_t* wfull = pempty + P_STAGES;
  uint64_t* wempty = wfull + W_STAGES;

  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  const int total = N * tiles_h * tiles_w;   // < 2^31 (host)
  const int nch = (Cin + KC - 1) / KC;
  // tile -> (image, first row, first column), the column tile fastest
  auto origin = [&](int t, int& img, int& h0, int& w0) {
    w0 = t % tiles_w * TW;
    t /= tiles_w;
    h0 = t % tiles_h * TH;
    img = t / tiles_h;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < P_STAGES; ++i) {
      sm90::mbar_init(&pfull[i], 1);
      sm90::mbar_init(&pempty[i], CONSUMER_WARPS);
    }
    for (int i = 0; i < W_STAGES; ++i) {
      sm90::mbar_init(&wfull[i], 1);
      sm90::mbar_init(&wempty[i], CONSUMER_WARPS);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 2) {
    // ----------------------------------------------------- producers
    if (threadIdx.x == 256) {
      sm90::prefetch_tensormap(&xmap);
      uint32_t pit = 0;
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        int img, h0, w0;
        origin(t, img, h0, w0);
        for (int c = 0; c < nch; ++c, ++pit) {
          const int ps = pit % P_STAGES;
          sm90::mbar_wait(&pempty[ps], ((pit / P_STAGES) & 1) ^ 1);
          sm90::mbar_arrive_expect_tx(&pfull[ps], PATCH_TX);
          sm90::tma_load_4d(patch + ps * PATCH, &xmap, &pfull[ps], c * KC,
                            w0 - 1, h0 - 1, img);
        }
      }
    } else if (threadIdx.x == 288) {
      sm90::prefetch_tensormap(&wmap);
      uint32_t wit = 0;
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        for (int c = 0; c < nch; ++c) {
          for (int dx = 0; dx < 3; ++dx, ++wit) {
            const int ws = wit % W_STAGES;
            sm90::mbar_wait(&wempty[ws], ((wit / W_STAGES) & 1) ^ 1);
            sm90::mbar_arrive_expect_tx(&wfull[ws], T::W_STAGE);
            unsigned char* dst = wring + ws * T::W_STAGE;
            for (int dy = 0; dy < 3; ++dy)
              for (int h = 0; h < 2; ++h)
                sm90::tma_load_4d(dst + (dy * 2 + h) * T::W_BOX, &wmap,
                                  &wfull[ws], c * KC, dy * 3 + dx, 0, h);
          }
        }
      }
    }
    return;
  }

  // ------------------------------------------------------- consumers
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const uint32_t wring0 = smem_u32(wring);
  // patch column of tap dx = 0 for this lane's A rows g (a0, a2) and g + 8
  // (a1, a3): output columns 16 warp + g (+ 8); this warpgroup's first
  // patch row: 2 wgi
  const int col0 = warp * 16 + g;
  float sc[BN / 2];   // the step sums' scratch
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
  uint32_t pit = 0, wit = 0;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    int img, h0, w0;
    origin(t, img, h0, w0);
    float acc[2][BN / 2];
#pragma unroll
    for (int o = 0; o < 2; ++o)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[o][i] = 0.f;

    for (int c = 0; c < nch; ++c, ++pit) {
      const int ps = pit % P_STAGES;
      sm90::mbar_wait(&pfull[ps], (pit / P_STAGES) & 1);
      const unsigned char* pb = patch + ps * PATCH;
#pragma unroll 1
      for (int dx = 0; dx < 3; ++dx, ++wit) {
        const int ws = wit % W_STAGES;
        sm90::mbar_wait(&wfull[ws], (wit / W_STAGES) & 1);
        const uint32_t wb = wring0 + ws * T::W_STAGE;
#pragma unroll
        for (int r = 0; r < 4; ++r) {   // this warpgroup's patch rows
          const int row = (2 * wgi + r) * PW + col0 + dx;
          uint32_t ah[KK][4], al[KK][4];
#pragma unroll
          for (int kk = 0; kk < KK; ++kk) {
            // channels 8kk + tq (a0, a1) and 8kk + tq + 4 (a2, a3)
            const float v[4] = {lds(pb, swz(row, 2 * kk) + 4 * tq),
                                lds(pb, swz(row + 8, 2 * kk) + 4 * tq),
                                lds(pb, swz(row, 2 * kk + 1) + 4 * tq),
                                lds(pb, swz(row + 8, 2 * kk + 1) + 4 * tq)};
            split4(v, ah[kk], al[kk]);
          }
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            const int o = r - dy;   // the output row of the pair it reaches
            if (o < 0 || o > 1) continue;
            sm90::wgmma_fence();   // the A registers and the scratch
#pragma unroll
            for (int kk = 0; kk < KK; ++kk) {
              const uint32_t b = wb + dy * 2 * T::W_BOX + kk * 32;
              split_products<BN>(sc, ah[kk], al[kk],
                                 sm90::wgmma_desc(b, 16, 1024, 1),
                                 sm90::wgmma_desc(b + T::W_BOX, 16, 1024, 1),
                                 kk == 0);
            }
            sm90::wgmma_commit();
            sm90::wgmma_wait<0>();
            add_into(acc[o], sc);
          }
        }
        if (lane == 0) sm90::mbar_arrive(&wempty[ws]);
      }
      if (lane == 0) sm90::mbar_arrive(&pempty[ps]);
    }

    // Epilogue. Accumulator i of row o: output row h0 + 2 wgi + o, column
    // w0 + 16 warp + g (+8 for i%4 >= 2); channel 8*(i/4) + 2*tq + i%2.
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      const int h = h0 + 2 * wgi + o;
      if (h >= H) break;   // the last tile at H % 4 == 2
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int co = 8 * j + 2 * tq;
        if (co >= Cout) continue;   // Cout % 4 == 0: co + 1 too
        const float a0 = scale[co], a1 = scale[co + 1];
        const float b0 = shift[co], b1 = shift[co + 1];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int ww = w0 + col0 + 8 * half;
          if (ww >= W) continue;
          float v0 = acc[o][4 * j + 2 * half] * a0 + b0;
          float v1 = acc[o][4 * j + 2 * half + 1] * a1 + b1;
          if (relu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          *reinterpret_cast<float2*>(
              out + ((static_cast<int64_t>(img) * H + h) * W + ww) * Cout +
              co) = make_float2(v0, v1);
        }
      }
    }
  }
}

template <int BN>
cudaError_t launch(const float* x, const float* w2, const float* a,
                   const float* b, float* out, int N, int H, int W, int Cin,
                   int Cout, int relu, cudaStream_t stream) {
  using T = Plan<BN>;
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const int64_t tiles = static_cast<int64_t>(N) * ((H + TH - 1) / TH) *
                        ((W + TW - 1) / TW);
  if (tiles > 2147483647LL) return cudaErrorInvalidConfiguration;

  CUtensorMap xmap, wmap;
  const uint64_t xd[4] = {static_cast<uint64_t>(Cin),
                          static_cast<uint64_t>(W), static_cast<uint64_t>(H),
                          static_cast<uint64_t>(N)};
  const uint64_t xs[3] = {4ull * Cin, 4ull * Cin * W, 4ull * Cin * W * H};
  const uint32_t xb[4] = {KC, PW, PR, 1};
  // the split copies [2][Cout][9][Cin] as (Cin, 9, Cout, 2), as fw's
  const uint64_t wd[4] = {static_cast<uint64_t>(Cin), 9,
                          static_cast<uint64_t>(Cout), 2};
  const uint64_t wstr[3] = {4ull * Cin, 36ull * Cin, 36ull * Cin * Cout};
  const uint32_t wbox[4] = {KC, 1, BN, 1};
  if (!sm90::encode_f32_map(&xmap, x, 4, xd, xs, xb) ||
      !sm90::encode_f32_map(&wmap, w2, 4, wd, wstr, wbox))
    return cudaErrorInvalidValue;
  auto kern = conv_pair_f32_kernel<BN>;
  if ((err = cudaFuncSetAttribute(
           kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM)) !=
      cudaSuccess)
    return err;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  kern<<<grid, THREADS, T::SMEM, stream>>>(xmap, wmap, a, b, out, N, H, W,
                                           Cin, Cout, relu);
  return cudaGetLastError();
}

cudaError_t run(const float* x, const float* w, const float* a,
                const float* b, float* out, float* w2, int N, int H, int W,
                int Cin, int Cout, int relu, cudaStream_t st) {
  const cudaError_t err = split_weights(w, w2, Cin, Cin, Cout, 0, st);
  if (err != cudaSuccess) return err;
  switch (tile_n(Cout)) {
    case 16:
      return launch<16>(x, w2, a, b, out, N, H, W, Cin, Cout, relu, st);
    case 32:
      return launch<32>(x, w2, a, b, out, N, H, W, Cin, Cout, relu, st);
    default:
      return launch<64>(x, w2, a, b, out, N, H, W, Cin, Cout, relu, st);
  }
}

}  // namespace k5

}  // namespace f32c

// ---------------------------------------------------------- C interface

namespace {

// C rounded up to a multiple of 4: the pixel stride of a padded copy.
int padded(int C) { return (C + 3) / 4 * 4; }

// Pixels (N*H*W) stay below this: the kernels index pixels and tiles in
// 32 bits, with a tile's overhang past the last pixel.
constexpr long long kMaxPixels = (1LL << 31) - 128;

}  // namespace

// The route of a (Cin, Cout) call, of the forward or (``wgrad`` != 0) the
// dW. 2 packed: the forward where Cin % 4 != 0 with 9 x Cin <= pk::K_MAX
// = 192; the dW where one side is so and the other's channels are a
// multiple of 4, or both sides are so (conv3x3_wgrad_f32_packed_side:
// the side read as it lies; the other goes as its padded copy). 1 wgmma,
// TMA over x (and g) at a pixel stride of 4 ceil(C / 4): every other call,
// a side whose channels are no multiple of 4 as the wrapper's padded copy
// (conv3x3_f32_pad_channels), e.g. the 150-class head's dx and dW.
extern "C" int conv3x3_f32_route(int Cin, int Cout, int wgrad) {
  using f32c::pk::K_MAX;
  const bool xn = Cin % 4 != 0, gn = Cout % 4 != 0;
  const bool xp = xn && 9 * Cin <= K_MAX, gp = gn && 9 * Cout <= K_MAX;
  if (!wgrad) return xp ? 2 : 1;
  return (xp && !gn) || (gp && !xn) || (xp && gp) ? 2 : 1;
}

// The side a dW on route 2 reads as it lies: 0 x (the stem's case), 1 g
// (the head's); with both sides narrow the one with fewer channels (x on
// a tie), the other padded. -1 where route 1 takes the dW.
extern "C" int conv3x3_wgrad_f32_packed_side(int Cin, int Cout) {
  if (conv3x3_f32_route(Cin, Cout, 1) != 2) return -1;
  if (Cin % 4 != 0 && Cout % 4 != 0) return Cout < Cin ? 1 : 0;
  return Cout % 4 != 0 ? 1 : 0;
}

// The forward's tile N on the wgmma route.
extern "C" int conv3x3_f32_tile_n(int Cout) { return f32c::fw::tile_n(Cout); }

// f32 elements of the forward's workspace: the split weights, [2][Cout][9]
// rows of x's pixel stride ``xc``.
extern "C" long long conv3x3_bn_relu_f32_ws_floats(int xc, int Cout) {
  return 18LL * xc * Cout;
}

// out (P, 4 ceil(C / 4)) f32 <- x (P, C) f32, zeros past C: the padded
// copy route 1 reads of a side whose channels are no multiple of 4. x at
// any 4-byte alignment, out 16-byte aligned. Returns the CUDA error of the
// launch.
extern "C" int conv3x3_f32_pad_channels(const void* x, void* out,
                                        long long P, int C, void* stream) {
  if (P <= 0 || C <= 0 || (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(f32c::pad_channels(
      static_cast<const float*>(x), static_cast<float*>(out), P, C,
      static_cast<cudaStream_t>(stream)));
}

// out (N,H,W,Cout) f32 = relu(conv3x3_pad1(x, w) * a + b): x (N,H,W,Cin)
// f32 at a pixel stride of ``xc`` elements; w (3,3,Cin,Cout) f32, or with
// ``flip`` (3,3,Cout,Cin) read as the tap-reversed transpose (K1's dx);
// a, b (Cout,) f32; ws: the workspace of conv3x3_bn_relu_f32_ws_floats(xc,
// Cout) elements, 16-byte aligned. The layout names the route: xc % 4 ==
// 0, route 1 (xc = Cin, or 4 ceil(Cin / 4) for a padded copy: TMA reads
// Cin channels of each pixel and fills zeros past them); else route 2 (xc
// = Cin, 9 x Cin <= K_MAX). x 16-byte aligned. Returns the CUDA error of
// the launches.
extern "C" int conv3x3_bn_relu_f32(const void* x, const void* w,
                                   const void* a, const void* b, void* out,
                                   void* ws, int N, int H, int W, int Cin,
                                   int Cout, int xc, int relu, int flip,
                                   void* stream) {
  using namespace f32c;
  const long long P = static_cast<long long>(N) * H * W;
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 ||
      P >= kMaxPixels || (xc != Cin && xc != padded(Cin)) ||
      (xc % 4 != 0 && 9 * Cin > pk::K_MAX) ||
      9LL * xc * Cout >= (1LL << 31) || ws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto xf = static_cast<const float*>(x);
  auto wf = static_cast<const float*>(w);
  auto af = static_cast<const float*>(a);
  auto bf = static_cast<const float*>(b);
  auto of = static_cast<float*>(out);
  auto w2 = static_cast<float*>(ws);
  if (xc % 4 == 0)
    return static_cast<int>(fw::run(xf, wf, af, bf, of, w2, N, H, W, Cin, xc,
                                     Cout, relu, flip, st));
  return static_cast<int>(pk::fwd_run(xf, wf, af, bf, of, w2, N, H, W, Cin,
                                      Cout, relu, flip, st));
}

// The f32 K5's shared bytes a block at ``Cout`` (0 outside its contract):
// its tile N and plan, which ops/fused_conv_pair.py::tile_plan holds too.
extern "C" int conv3x3_pair_f32_smem(int Cout) {
  using namespace f32c::k5;
  if (Cout < 4 || Cout > MAX_COUT || Cout % 4 != 0) return 0;
  switch (tile_n(Cout)) {
    case 16:
      return Plan<16>::SMEM;
    case 32:
      return Plan<32>::SMEM;
    default:
      return Plan<64>::SMEM;
  }
}

// out (N,H,W,Cout) f32 = relu(conv3x3_pad1(x, w) * a + b) on the f32 K5:
// x (N,H,W,Cin) f32 with H even, w (3,3,Cin,Cout) f32, a, b (Cout,) f32;
// ws: 18 * Cin * Cout f32 for the split weights. Cin, Cout multiples of 4,
// Cin <= 128, Cout <= 64; x, ws and out 16-byte aligned. Returns the CUDA
// error of the launches.
extern "C" int conv3x3_pair_bn_relu_f32(const void* x, const void* w,
                                        const void* a, const void* b,
                                        void* out, void* ws, int N, int H,
                                        int W, int Cin, int Cout, int relu,
                                        void* stream) {
  using namespace f32c;
  if (N <= 0 || H <= 0 || W <= 0 || H % 2 != 0 || Cin % 4 != 0 ||
      Cin < 4 || Cin > k5::MAX_CIN || Cout % 4 != 0 || Cout < 4 ||
      Cout > k5::MAX_COUT || ws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(ws) |
        reinterpret_cast<uintptr_t>(out)) &
       15) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  return static_cast<int>(k5::run(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(out), static_cast<float*>(ws), N, H, W, Cin, Cout,
      relu, static_cast<cudaStream_t>(stream)));
}

// The dW's split-K range: 4 x 16 pixel tiles, on both routes. The wrapper
// picks splits <= this.
extern "C" long long conv3x3_wgrad_f32_pixel_tiles(int N, int H, int W) {
  return f32c::wgf::pixel_tiles(N, H, W);
}

// Blocks per split: on the wgmma route 3 kernel rows x 64-channel Cin
// tiles x N tiles of Cout; on the packed one the wide side's 64-channel
// tiles.
extern "C" long long conv3x3_wgrad_f32_out_tiles(int Cin, int Cout) {
  const int side = conv3x3_wgrad_f32_packed_side(Cin, Cout);
  if (side < 0) return f32c::wgf::out_tiles(Cin, Cout);
  return f32c::pk::out_tiles(side ? Cin : Cout);
}

// dW (3,3,Cin,Cout) f32 <- x (N,H,W,Cin) f32 at a pixel stride of ``xc``
// elements and g (N,H,W,Cout) f32 at ``gc``, each its channels or (a
// padded copy) 4 ceil(channels / 4). The layout names the route: both
// strides multiples of 4, route 1; one side as it lies with channels % 4
// != 0 and 9 x them <= K_MAX, route 2 (the other side wide, by TMA). ws:
// f32 workspace of splits * 9 * Cin * Cout elements when splits > 1
// (unused at one split). x and g 16-byte aligned. Returns the CUDA error
// of the launches.
extern "C" int conv3x3_wgrad_f32(const void* x, const void* g, void* out,
                                 void* ws, int N, int H, int W, int Cin,
                                 int Cout, int xc, int gc, int splits,
                                 void* stream) {
  using namespace f32c;
  const long long P = static_cast<long long>(N) * H * W;
  const bool xn = xc % 4 != 0, gn = gc % 4 != 0;   // a side as it lies
  const long long range = wgf::pixel_tiles(N, H, W);
  const long long blocks = !xn && !gn ? wgf::out_tiles(Cin, Cout)
                           : pk::out_tiles(gn ? Cin : Cout);
  const long long elems = 9LL * Cin * Cout;
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 ||
      P >= kMaxPixels || (xc != Cin && xc != padded(Cin)) ||
      (gc != Cout && gc != padded(Cout)) || (xn && gn) ||
      9 * (xn ? Cin : gn ? Cout : 0) > pk::K_MAX || elems >= (1LL << 31) ||
      splits <= 0 || splits > 65535 || splits > range || blocks > 65535 ||
      (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto xf = static_cast<const float*>(x);
  auto gf = static_cast<const float*>(g);
  auto of = static_cast<float*>(out);
  float* dst = splits > 1 ? static_cast<float*>(ws) : of;
  cudaError_t e;
  if (!xn && !gn) {
    e = wgf::run(xf, gf, dst, N, H, W, Cin, Cout, xc, gc, splits, st);
  } else {
    e = pk::wgrad_run(xf, gf, dst, N, H, W, Cin, Cout, xc, gc, splits, st);
  }
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const int sum_blocks = static_cast<int>(
      (elems + 255) / 256 < 8192 ? (elems + 255) / 256 : 8192);
  sum_splits_kernel<<<sum_blocks, 256, 0, st>>>(dst, of, elems, splits);
  return static_cast<int>(cudaGetLastError());
}
