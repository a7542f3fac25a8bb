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
// Design:
// - Persistent blocks, one per SM. Each block copies the whole weight tensor
//   (9 x Cin x 64 bf16, rows padded to 72 for conflict-free ldmatrix.trans:
//   82,944 B at Cin 64, 165,888 B at Cin 128) into shared memory once with
//   cp.async, then walks output tiles tile = blockIdx.x + i * gridDim.x.
//   K4 (conv3x3_bn_relu.cu) stages the weight slice again for every 8x16
//   pixel tile; at 64->64 that is 73,728 B of weights per 23,040 B patch.
// - One output tile is two H-pairs: 4 output rows x 64 columns x all 64
//   output channels (Cout < 64: zero weights, channels masked at the store;
//   H % 4 == 2: the last tile's second pair is masked). Its input is a
//   6-row x 66-column patch (one-pixel halo, cp.async zero-fill outside the
//   image, as in K4), so each input row is read 1.5 times, not 2 as with
//   one pair per tile.
// - 8 warps: 4 column groups of 16 pixels x 2 halves of 32 output channels.
//   Each warp keeps all 4 output rows of its 16 pixels (4 x 4 m16n8 f32
//   accumulators). For each dx and 16-channel step it loads the B fragments
//   of the three taps (dy = 0, 1, 2) once, from the resident weights with
//   ldmatrix.trans, and then walks the 6 input rows: the A fragment of row
//   r (ldmatrix, straight from the patch at the tap's offset) feeds output
//   rows r-2 .. r through taps dy = 2 .. 0. That is 12 ldmatrix.x4 per 48
//   MMAs (a one-pair tile with the same warps needs 10 per 24, and more of
//   the SM's shared-memory bandwidth), and no zero blocks: the TPU kernel's
//   pair-tap matrix does 2x the MACs.
// - Shared memory at 128->64, and the choice made for it: the resident
//   weights leave 66,560 of the 232,448 B a block may use, where a whole
//   6 x 66 x (128 + 8) patch is 107,712 B. Of the ways out (a narrower tile,
//   one patch buffer, the weights streamed in two Cin halves) this kernel
//   takes none: it streams the patch, not the weights, in chunks of KC input
//   channels, through a cp.async pipeline over (tile, chunk) stages, so the
//   next tile's first chunk loads while this tile's last chunk computes.
//   Cin <= 64: KC = 32 (6 x 66 x 40 bf16 = 31,680 B) in 3 buffers;
//   Cin > 64: KC = 16 (6 x 66 x 24 bf16 = 19,008 B) in 3 buffers, 222,912 B
//   in all. The tile keeps its 64 columns at every Cin.
// - mma.sync m16n8k16 bf16 with f32 accumulators; the epilogue applies
//   acc * A + B and the ReLU, rounds to bf16, transposes each quad of lanes
//   with shuffles so that a lane holds 8 consecutive channels of one pixel,
//   and stores 16 bytes. Offsets into x and out are 64-bit.
//
// What bounds it on the H100 (989 TFLOP/s bf16, 3.35 TB/s): at 360x480,
// 64->64 does 288 FLOP per byte of input + output and is bound by bytes;
// 128->64 (384 FLOP/byte) by operations. wgmma, TMA and tuning are left for
// later work.
//
// Contract (the wrapper checks it and this file checks it again): H even,
// Cin a multiple of 16 in [16, 128], Cout a multiple of 16 in [16, 64], any
// W; x, w and out 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int TH = 4;             // output rows per tile (two pairs)
constexpr int TW = 64;            // output columns per tile
constexpr int PR = TH + 2;        // patch rows (one-row halo each side)
constexpr int PW = TW + 2;        // patch columns (one-pixel halo)
constexpr int BN = 64;            // output channels per tile (all of Cout)
constexpr int BNP = BN + 8;       // weight row stride (144 B)
constexpr int STAGES = 3;         // chunk buffers in the cp.async pipeline
constexpr int THREADS = 256;      // 8 warps: 4 column groups x 2 Cout halves
constexpr int MAX_CIN = 128;
constexpr int MAX_COUT = BN;

// Patch pixel stride KC + 8: 80 B (KC 32) or 48 B (KC 16), so the 8 rows
// of an ldmatrix hit distinct banks.
template <int KC>
__host__ __device__ constexpr int patch_elems() {
  return PR * PW * (KC + 8);
}

template <int KC>
size_t smem_bytes(int cin) {
  return (static_cast<size_t>(9) * cin * BNP +
          static_cast<size_t>(STAGES) * patch_elems<KC>()) *
         sizeof(__nv_bfloat16);
}

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

// (image, first output row, first output column) of a tile; tiles are
// ordered (image, row tile, column tile) with the column tile fastest.
struct Tile {
  int n, h0, w0;
};

__device__ __forceinline__ Tile decode(long long tile, int tiles_w,
                                       int tiles_h) {
  Tile t;
  t.w0 = static_cast<int>(tile % tiles_w) * TW;
  tile /= tiles_w;
  t.h0 = static_cast<int>(tile % tiles_h) * TH;
  t.n = static_cast<int>(tile / tiles_h);
  return t;
}

// Stage input channels [c0, c0 + KC) of the PR x PW patch of ``tile``:
// patch row r is image row h0 - 1 + r, patch column c is image column
// w0 - 1 + c; outside the image, or past Cin, zeros.
template <int KC>
__device__ __forceinline__ void stage_patch(
    __nv_bfloat16* patch, const __nv_bfloat16* __restrict__ x, long long tile,
    int c0, int H, int W, int Cin, int tiles_w, int tiles_h) {
  const Tile t = decode(tile, tiles_w, tiles_h);
  const int64_t img = static_cast<int64_t>(t.n) * H * W;
  constexpr int VPP = KC / 8;  // 16-byte vectors per patch pixel
  for (int i = threadIdx.x; i < PR * PW * VPP; i += THREADS) {
    const int pix = i / VPP, v = i % VPP;
    const int h = t.h0 - 1 + pix / PW, w = t.w0 - 1 + pix % PW;
    const int c = c0 + v * 8;
    const bool ok = h >= 0 && h < H && w >= 0 && w < W && c < Cin;
    const __nv_bfloat16* src =
        ok ? x + ((img + static_cast<int64_t>(h) * W + w) * Cin + c) : x;
    cp_async16(patch + pix * (KC + 8) + v * 8, src, ok ? 16 : 0);
  }
}

__device__ __forceinline__ uint32_t pick(const uint32_t (&v)[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &h, sizeof(u));
  return u;
}

template <int KC>
__global__ void __launch_bounds__(THREADS, 1)
    conv3x3_pair_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ w,
                        const float* __restrict__ scale,
                        const float* __restrict__ shift,
                        __nv_bfloat16* __restrict__ out, int H, int W,
                        int Cin, int Cout, int relu, long long total_tiles) {
  constexpr int KCP = KC + 8;
  constexpr int PATCH = patch_elems<KC>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* wsm = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* patches = wsm + 9 * Cin * BNP;

  const int tid = threadIdx.x;
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  const int nchunks = (Cin + KC - 1) / KC;
  const long long my_tiles =
      blockIdx.x < total_tiles
          ? (total_tiles - 1 - blockIdx.x) / gridDim.x + 1
          : 0;
  const long long total_stages = my_tiles * nchunks;

  // The resident weights: row tap * Cin + ci holds W[tap][ci][0:64] (zero
  // past Cout). Committed with the first stage's group.
  for (int i = tid; i < 9 * Cin * (BN / 8); i += THREADS) {
    const int row = i / (BN / 8), co = (i % (BN / 8)) * 8;
    const bool ok = co < Cout;
    const __nv_bfloat16* src =
        ok ? w + (static_cast<int64_t>(row) * Cout + co) : w;
    cp_async16(wsm + row * BNP + co, src, ok ? 16 : 0);
  }
  // Prologue: stages 0 .. STAGES-2 (an empty group where there is none, so
  // that the wait counts below hold).
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total_stages)
      stage_patch<KC>(
          patches + s * PATCH, x,
          blockIdx.x + static_cast<long long>(s / nchunks) * gridDim.x,
          (s % nchunks) * KC, H, W, Cin, tiles_w, tiles_h);
    cp_async_commit();
  }

  const int lane = tid & 31, warp = tid >> 5;
  const int wc = warp & 3;   // pixel columns wc*16 .. wc*16+15 of the tile
  const int wn = warp >> 2;  // output channels wn*32 .. wn*32+31
  // Per-lane ldmatrix offsets (elements). A: lane l reads patch column
  // wc*16 + (l & 15) (+ dx), channels + (l >> 4) * 8 -> a0..a3 of m16n8k16.
  // B: lane l reads weight row k = (l & 15), columns + (l >> 4) * 8 ->
  // (b0, b1) of two adjacent n8 tiles under .trans.
  const int a_lane = (wc * 16 + (lane & 15)) * KCP + (lane >> 4) * 8;
  const int b_lane = (lane & 15) * BNP + wn * 32 + (lane >> 4) * 8;
  // Epilogue: C fragment rows g / g+8 are pixel columns, columns 2t, 2t+1
  // are channels.
  const int g = lane >> 2, t4 = lane & 3;
  float sc[4][2], sh[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = wn * 32 + nt * 8 + 2 * t4 + e;
      sc[nt][e] = co < Cout ? scale[co] : 0.f;
      sh[nt][e] = co < Cout ? shift[co] : 0.f;
    }
  const uint32_t w_s = smem_u32(wsm);

  float acc[TH][4][4];
  int buf = 0;
  for (long long s = 0; s < total_stages; ++s) {
    cp_async_wait<STAGES - 2>();  // stage s (and the weights) landed
    __syncthreads();              // ... for every thread; stage s-1's
                                  // buffer is free
    {
      const long long sn = s + STAGES - 1;
      if (sn < total_stages) {
        int nb = buf + STAGES - 1;
        nb -= nb >= STAGES ? STAGES : 0;
        stage_patch<KC>(patches + nb * PATCH, x,
                        blockIdx.x + (sn / nchunks) * gridDim.x,
                        static_cast<int>(sn % nchunks) * KC, H, W, Cin,
                        tiles_w, tiles_h);
      }
      cp_async_commit();
    }

    const int chunk = static_cast<int>(s % nchunks);
    if (chunk == 0) {
#pragma unroll
      for (int o = 0; o < TH; ++o)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[o][nt][q] = 0.f;
    }
    const int c0 = chunk * KC;
    const int klen = min(KC, Cin - c0);
    const uint32_t patch_s = smem_u32(patches + buf * PATCH);

#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        if (kk >= klen) continue;
        uint32_t bt[3][2][4];  // taps (dy, dx), dy = 0..2, for 32 channels
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            ldmatrix_x4_trans(
                bt[dy][j], w_s + 2 * (b_lane +
                                      ((dy * 3 + dx) * Cin + c0 + kk) * BNP +
                                      j * 16));
#pragma unroll
        for (int r = 0; r < PR; ++r) {
          uint32_t a[4];
          ldmatrix_x4(a, patch_s + 2 * (a_lane + (r * PW + dx) * KCP + kk));
          // input row r feeds output row o through tap dy = r - o
#pragma unroll
          for (int o = r - 2; o <= r; ++o) {
            if (o < 0 || o >= TH) continue;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
              mma_bf16_16816(acc[o][nt], a, bt[r - o][nt >> 1][(nt & 1) * 2],
                             bt[r - o][nt >> 1][(nt & 1) * 2 + 1]);
          }
        }
      }
    }

    if (chunk == nchunks - 1) {
      const Tile t = decode(blockIdx.x + (s / nchunks) * gridDim.x, tiles_w,
                            tiles_h);
      const int co = wn * 32 + t4 * 8;  // this lane's 8 channels after the
                                        // quad transpose
#pragma unroll
      for (int o = 0; o < TH; ++o) {
        if (t.h0 + o >= H) continue;  // uniform across the block
        const int64_t row_base =
            (static_cast<int64_t>(t.n) * H + t.h0 + o) * W;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint32_t v[4];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            float y0 = acc[o][nt][half * 2] * sc[nt][0] + sh[nt][0];
            float y1 = acc[o][nt][half * 2 + 1] * sc[nt][1] + sh[nt][1];
            if (relu) {
              y0 = fmaxf(y0, 0.f);
              y1 = fmaxf(y1, 0.f);
            }
            v[nt] = pack_bf16x2(y0, y1);
          }
          // Quad transpose: lane t4 of the quad gathers n8 tile nt = t4
          // from the four lanes (round k reads lane (t4 + k) & 3, which
          // sends its tile (its t4 - k) & 3, i.e. the reader's t4).
          uint32_t got[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            got[k] = __shfl_sync(0xffffffffu, pick(v, (t4 - k) & 3),
                                 (lane & ~3) | ((t4 + k) & 3));
          const int col = t.w0 + wc * 16 + g + half * 8;
          if (col < W && co < Cout) {
            uint4 q;
            q.x = pick(got, (0 - t4) & 3);
            q.y = pick(got, (1 - t4) & 3);
            q.z = pick(got, (2 - t4) & 3);
            q.w = pick(got, (3 - t4) & 3);
            *reinterpret_cast<uint4*>(out + (row_base + col) * Cout + co) =
                q;
          }
        }
      }
    }
    buf = buf + 1 == STAGES ? 0 : buf + 1;
  }
  cp_async_wait<0>();
}

template <int KC>
cudaError_t launch(const void* x, const void* w, const void* a, const void* b,
                   void* out, int N, int H, int W, int Cin, int Cout,
                   int relu, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  auto kern = conv3x3_pair_kernel<KC>;
  const size_t smem = smem_bytes<KC>(Cin);
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long tiles =
      static_cast<long long>(N) * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<__nv_bfloat16*>(out), H, W,
      Cin, Cout, relu, tiles);
  return cudaGetLastError();
}

}  // namespace

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
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      Cin <= 64 ? launch<32>(x, w, a, b, out, N, H, W, Cin, Cout, relu, st)
                : launch<16>(x, w, a, b, out, N, H, W, Cin, Cout, relu, st);
  return static_cast<int>(err);
}
