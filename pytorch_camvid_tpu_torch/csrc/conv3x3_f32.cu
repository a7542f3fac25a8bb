// f32 conv3x3 (pad 1, NHWC) for Hopper (sm_90a) on split-TF32 tensor-core
// products: the float32 instances of K4 and of K1's three pieces.
//
// Replaces, at float32 (the JAX package's default compute dtype):
//   K4       pytorch_camvid_tpu/ops/pallas_conv.py:230 (_conv3x3_impl :190)
//            relu(conv3x3(x, W) * A + B), out at x's dtype        -> fwd
//   K1 fwd   the same kernel, unit affine, no ReLU (_conv3x3_fwd :70) -> fwd
//   K1 dx    the same kernel on the cotangent with the flipped weight
//            (_vjp_bwd :208)                                   -> fwd, flip
//   K1 dW    pytorch_camvid_tpu/ops/pallas_conv_train.py:172
//            (_conv3x3_dw :147), f32 (3,3,Cin,Cout) out            -> wgrad
//
// Precision. A TF32 operand keeps 10 mantissa bits, so one TF32 product
// per term is ~5e-4 relative: a different function from f32. As M4 does
// (layout_probes.cu), each f32 operand v is split into hi = tf32(v) and
// lo = tf32(v - hi) (cvt.rna), and three mma.sync.m16n8k8 products are
// summed per fragment, the small ones first: lo*hi + hi*lo + hi*hi (lo*lo
// is below f32's rounding). Each k8 step's three products are summed from
// zero and added to the f32 accumulator with FADD (``mma3``): the tensor
// core truncates its sums, and a running accumulator broke phase 14's
// error rule at 7 of 12 checks, up to 63x cuDNN's f32 error, on an H100
// (``f32_variants``); the step sums cost 5-11% more time.
//
// What bounds it. Three tensor-core products per term: 494.7 / 3 = 165
// TFLOP/s of f32 work at most on an H100 SXM, against 67 TFLOP/s for
// FFMA; bytes matter only at the narrow head and the stem.
//
// Design (simple and right first; no wgmma or TMA yet):
// - fwd: an implicit GEMM, M = pixels (N*H*W flattened), N = Cout, K =
//   9 taps x Cin (k = tap * Cin + c, so the Cin = 3 stem packs into one
//   32-deep chunk). Blocks of 128 pixels x 64 channels, 4 warps of 64 x 32;
//   32-deep K chunks staged through a 3-stage cp.async ring: 16-byte
//   copies where the channels allow (Cin % 4 == 0 and 16-byte aligned
//   bases), 4-byte copies otherwise (the stem, Cout 21); the pad-1 halo,
//   the ragged pixel tile and K past 9 * Cin are zero-filled by the copy.
//   ``flip`` (K1's dx) reads w (3,3,Cout,Cin), the forward's HWIO weight,
//   tap-reversed and transposed in place: B[k = (t, c)][n] = w[8 - t][n][c].
//   Epilogue: acc * a + b, ReLU, scalar f32 stores clipped at P and Cout.
// - wgrad: dW[t][ci][co] = sum_p x[p shifted by t][ci] * g[p][co]: M = 9 x
//   Cin rows (t, ci), N = Cout, K = pixels. Blocks of 64 x 64, 4 warps of
//   32 x 32, 32-pixel chunks through the same ring; each thread follows
//   its pixels' (h, w) by increments, so the loads need no division.
//   Split-K over pixel chunks: each split writes its own slice of an f32
//   workspace, and a second kernel sums the slices in split order, so two
//   launches on the same inputs give the same bits.
// - 64-bit element offsets throughout; pixels (N*H*W) stay below 2^31.

#include <cuda_runtime.h>
#include <stdint.h>

namespace f32c {

constexpr int THREADS = 128;   // 4 warps
constexpr int STAGES = 3;
constexpr int BK = 32;         // K of one stage

// fwd: 128 pixels x 64 channels a block
constexpr int BM = 128, BN = 64;
constexpr int AP = BK + 4;     // A [BM][AP]: fragment reads conflict-free
constexpr int BNP = BN + 8;    // B [BK][BNP] (w as it lies, N-major)
constexpr int BKP = BK + 4;    // B [BN][BKP] (flip: K-major)
constexpr int A_FLOATS = BM * AP;
constexpr int B_FLOATS = BK * BNP > BN * BKP ? BK * BNP : BN * BKP;
constexpr int STAGE_FLOATS = A_FLOATS + B_FLOATS;
constexpr int FWD_SMEM = STAGES * STAGE_FLOATS * 4;
static_assert(FWD_SMEM == 82944, "fwd shared memory plan");

// wgrad: 64 rows (tap, ci) x 64 channels co a block, 32-pixel chunks
constexpr int WM = 64, WN = 64;
constexpr int WP = 64 + 8;     // [pixel][row] and [pixel][co], pitch 72
constexpr int W_STAGE_FLOATS = 2 * BK * WP;
constexpr int WG_SMEM = STAGES * W_STAGE_FLOATS * 4 + WM * 4 * 4;
static_assert(WG_SMEM == 56320, "wgrad shared memory plan");

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

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

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a * b, from a zero accumulator.
__device__ __forceinline__ void mma_tf32_z(float (&d)[4],
                                           const uint32_t (&a)[4], uint32_t b0,
                                           uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
}

// d += the split product of one fragment pair over one k8 step: the three
// products (the small ones first) summed from zero in the tensor core, then
// added to d in f32. The tensor core truncates each sum it forms, and its
// truncation errors all lean one way, so they would grow with K in a
// running accumulator; here each is relative to one k8 step's partial sum,
// and d's additions round to nearest.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  float s[4];
  mma_tf32_z(s, al, bh0, bh1);
  mma_tf32(s, ah, bl0, bl1);
  mma_tf32(s, ah, bh0, bh1);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += s[i];
}

__device__ __forceinline__ bool inside(int v, int n) {
  return static_cast<unsigned>(v) < static_cast<unsigned>(n);
}

// ------------------------------------------------------------------ fwd

// Two blocks an SM (their shared memory holds no more): with that minimum
// ptxas gives both instances the registers they want; without it, it cut
// the flip instance to 143 registers, and dx ran 1.35-1.45x slower on an
// H100 (``f32_variants``).
template <bool FLIP>
__global__ void __launch_bounds__(THREADS, 2)
    conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ av, const float* __restrict__ bv,
                    float* __restrict__ out, int H, int W, int P, int Cin,
                    int Cout, int relu) {
  extern __shared__ __align__(16) float smem[];
  const int K = 9 * Cin;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;
  const bool a_vec = (Cin & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15)
                     == 0;
  const bool b_vec = (FLIP ? (Cin & 3) == 0 : (Cout & 3) == 0) &&
                     (reinterpret_cast<uintptr_t>(w) & 15) == 0;

  // The pixels this thread stages, pixel(j): 16-byte path rows (tid >> 3)
  // + 16 j; 4-byte path row tid. (h, w) of a pixel past P is far outside.
  auto pixel = [&](int j) {
    return m0 + (a_vec ? (tid >> 3) + 16 * j : tid);
  };
  int ph[8], pw[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int m = pixel(j);
    ph[j] = m < P ? (m / W) % H : -4;
    pw[j] = m < P ? m % W : -4;
  }

  auto load_stage = [&](int stage, int kc) {
    float* As = smem + stage * STAGE_FLOATS;
    float* Bs = As + A_FLOATS;
    const int k0 = kc * BK;
    if (a_vec) {   // 8 rows x one 4-channel group (one tap: Cin % 4 == 0)
      const int grp = tid & 7, k = k0 + 4 * grp;
      const int tap = k < K ? k / Cin : 9;
      const int c = k - tap * Cin;
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bool ok = tap < 9 && inside(ph[j] + dy, H) &&
                        inside(pw[j] + dx, W);
        const float* src =
            ok ? x + static_cast<int64_t>(pixel(j) + dy * W + dx) * Cin + c
               : x;
        cp_async16(&As[((tid >> 3) + 16 * j) * AP + 4 * grp], src, ok);
      }
    } else {       // one row x 32 single channels
      for (int kk = 0; kk < BK; ++kk) {
        const int k = k0 + kk;
        const int tap = k < K ? k / Cin : 9;
        const int c = k - tap * Cin;
        const int dy = tap / 3 - 1, dx = tap % 3 - 1;
        const bool ok = tap < 9 && inside(ph[0] + dy, H) &&
                        inside(pw[0] + dx, W);
        const float* src =
            ok ? x + static_cast<int64_t>(pixel(0) + dy * W + dx) * Cin + c
               : x;
        cp_async4(&As[tid * AP + kk], src, ok);
      }
    }
    if (!FLIP) {   // B [k][n] = w[k * Cout + n]
      if (b_vec) {
        const int grp = tid & 15, n = n0 + 4 * grp;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kr = (tid >> 4) + 8 * j, k = k0 + kr;
          const bool ok = k < K && n < Cout;
          cp_async16(&Bs[kr * BNP + 4 * grp],
                     ok ? w + static_cast<int64_t>(k) * Cout + n : w, ok);
        }
      } else {
        const int nn = tid & 63, n = n0 + nn;
#pragma unroll 4
        for (int j = 0; j < 16; ++j) {
          const int kr = (tid >> 6) + 2 * j, k = k0 + kr;
          const bool ok = k < K && n < Cout;
          cp_async4(&Bs[kr * BNP + nn],
                    ok ? w + static_cast<int64_t>(k) * Cout + n : w, ok);
        }
      }
    } else {       // B [n][k] = w[8 - tap][n][c], w (3,3,Cout,Cin)
      if (b_vec) {
        const int grp = tid & 7, k = k0 + 4 * grp;
        const int tap = k < K ? k / Cin : 9;
        const int c = k - tap * Cin;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int nr = (tid >> 3) + 16 * j, n = n0 + nr;
          const bool ok = tap < 9 && n < Cout;
          cp_async16(&Bs[nr * BKP + 4 * grp],
                     ok ? w + (static_cast<int64_t>(8 - tap) * Cout + n) * Cin
                              + c
                        : w,
                     ok);
        }
      } else {
        const int kk = tid & 31, k = k0 + kk;
        const int tap = k < K ? k / Cin : 9;
        const int c = k - tap * Cin;
#pragma unroll 4
        for (int j = 0; j < 16; ++j) {
          const int nr = (tid >> 5) + 4 * j, n = n0 + nr;
          const bool ok = tap < 9 && n < Cout;
          cp_async4(&Bs[nr * BKP + kk],
                    ok ? w + (static_cast<int64_t>(8 - tap) * Cout + n) * Cin
                             + c
                       : w,
                    ok);
        }
      }
    }
  };

  float acc[4][4][4] = {};
  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // chunk kc landed; stage (kc - 1) % STAGES is free
    const int pre = kc + STAGES - 1;
    if (pre < nk) load_stage(pre % STAGES, pre);
    cp_async_commit();
    const float* As = smem + (kc % STAGES) * STAGE_FLOATS;
    const float* Bs = As + A_FLOATS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t ah[4][4], al[4][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const float* ap = &As[(wm * 64 + mt * 16 + g) * AP + kk + t];
        split_tf32(ap[0], ah[mt][0], al[mt][0]);
        split_tf32(ap[8 * AP], ah[mt][1], al[mt][1]);
        split_tf32(ap[4], ah[mt][2], al[mt][2]);
        split_tf32(ap[8 * AP + 4], ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = wn * 32 + nt * 8 + g;
        const float v0 = FLIP ? Bs[n * BKP + kk + t] : Bs[(kk + t) * BNP + n];
        const float v1 =
            FLIP ? Bs[n * BKP + kk + t + 4] : Bs[(kk + t + 4) * BNP + n];
        split_tf32(v0, bh[nt][0], bl[nt][0]);
        split_tf32(v1, bh[nt][1], bl[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma3(acc[mt][nt], ah[mt], al[mt], bh[nt][0], bh[nt][1], bl[nt][0],
               bl[nt][1]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int c0 = n0 + wn * 32 + nt * 8 + 2 * t;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = c0 + e;
      if (c >= Cout) continue;
      const float sa = av[c], sb = bv[c];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = m0 + wm * 64 + mt * 16 + g + 8 * half;
          if (m >= P) continue;
          float v = acc[mt][nt][2 * half + e] * sa + sb;
          if (relu) v = fmaxf(v, 0.0f);
          out[static_cast<int64_t>(m) * Cout + c] = v;
        }
    }
  }
}

// ---------------------------------------------------------------- wgrad

__global__ void __launch_bounds__(THREADS)
    wgrad_f32_kernel(const float* __restrict__ x, const float* __restrict__ g,
                     float* __restrict__ dst, int H, int W, int P, int Cin,
                     int Cout, int chunks_per_split, int chunks) {
  extern __shared__ __align__(16) float smem[];
  int* rowinfo = reinterpret_cast<int*>(smem + STAGES * W_STAGE_FLOATS);
  const int M = 9 * Cin;
  const int r0 = blockIdx.x * WM, n0 = blockIdx.y * WN;
  const int c_begin =
      min(static_cast<int>(blockIdx.z) * chunks_per_split, chunks);
  const int c_end = min(c_begin + chunks_per_split, chunks);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;
  const bool a_vec = (Cin & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15)
                     == 0;
  const bool b_vec = (Cout & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(g) & 15) == 0;

  // each of the block's 64 rows: its channel, its tap's shift, valid
  if (tid < WM) {
    const int r = r0 + tid;
    const int tap = r < M ? r / Cin : 4;
    rowinfo[4 * tid + 0] = r - tap * Cin;
    rowinfo[4 * tid + 1] = tap / 3 - 1;
    rowinfo[4 * tid + 2] = tap % 3 - 1;
    rowinfo[4 * tid + 3] = r < M;
  }
  __syncthreads();

  // the chunk's first pixel, and the pixels this thread stages x at:
  // pbase + off(j), off(j) = (tid >> 4) + 8 j (16-byte path, j < 4) or
  // tid & 31 (4-byte path); their (h, w) followed by increments
  const int npix = a_vec ? 4 : 1;
  auto off = [&](int j) { return a_vec ? (tid >> 4) + 8 * j : tid & 31; };
  int pbase = c_begin * BK;
  int ph[4], pw[4];
  for (int j = 0; j < 4; ++j) {
    const int p = pbase + off(j);
    ph[j] = (p / W) % H;
    pw[j] = p % W;
  }
  // the 16-byte path's 4-row group: its channel and its tap's shift
  const int grp = tid & 15;
  const int* gi = &rowinfo[4 * (4 * grp)];
  const int a_c = gi[0], a_dy = gi[1], a_dx = gi[2], a_ok = gi[3];

  auto load_stage = [&](int stage) {
    float* As = smem + stage * W_STAGE_FLOATS;   // [pixel][row]
    float* Bs = As + BK * WP;                     // [pixel][co]
    if (a_vec) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = pbase + off(j);
        const bool ok = a_ok && p < P && inside(ph[j] + a_dy, H) &&
                        inside(pw[j] + a_dx, W);
        const float* src =
            ok ? x + static_cast<int64_t>(p + a_dy * W + a_dx) * Cin + a_c
               : x;
        cp_async16(&As[((tid >> 4) + 8 * j) * WP + 4 * grp], src, ok);
      }
    } else {
      const int pk = tid & 31;
#pragma unroll 4
      for (int j = 0; j < 16; ++j) {
        const int rr = (tid >> 5) + 4 * j;
        const int* ri = &rowinfo[4 * rr];
        const int p = pbase + pk;
        const bool ok = ri[3] && p < P && inside(ph[0] + ri[1], H) &&
                        inside(pw[0] + ri[2], W);
        const float* src =
            ok ? x + static_cast<int64_t>(p + ri[1] * W + ri[2]) * Cin + ri[0]
               : x;
        cp_async4(&As[pk * WP + rr], src, ok);
      }
    }
    if (b_vec) {
      const int n = n0 + 4 * grp;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pk = (tid >> 4) + 8 * j;
        const int p = pbase + pk;
        const bool ok = p < P && n < Cout;
        cp_async16(&Bs[pk * WP + 4 * grp],
                   ok ? g + static_cast<int64_t>(p) * Cout + n : g, ok);
      }
    } else {
      const int nn = tid & 63, n = n0 + nn;
#pragma unroll 4
      for (int j = 0; j < 16; ++j) {
        const int pk = (tid >> 6) + 2 * j;
        const int p = pbase + pk;
        const bool ok = p < P && n < Cout;
        cp_async4(&Bs[pk * WP + nn],
                  ok ? g + static_cast<int64_t>(p) * Cout + n : g, ok);
      }
    }
    // the next chunk's pixels: 32 further on
    pbase += BK;
    for (int j = 0; j < npix; ++j) {
      pw[j] += BK;
      while (pw[j] >= W) {
        pw[j] -= W;
        if (++ph[j] == H) ph[j] = 0;
      }
    }
  };

  float acc[2][4][4] = {};
  const int nk = max(c_end - c_begin, 0);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kc + STAGES - 1 < nk) load_stage((kc + STAGES - 1) % STAGES);
    cp_async_commit();
    const float* As = smem + (kc % STAGES) * W_STAGE_FLOATS;
    const float* Bs = As + BK * WP;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* ap = &As[(kk + t) * WP + wm * 32 + mt * 16 + gq];
        split_tf32(ap[0], ah[mt][0], al[mt][0]);
        split_tf32(ap[8], ah[mt][1], al[mt][1]);
        split_tf32(ap[4 * WP], ah[mt][2], al[mt][2]);
        split_tf32(ap[4 * WP + 8], ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* bp = &Bs[(kk + t) * WP + wn * 32 + nt * 8 + gq];
        split_tf32(bp[0], bh[nt][0], bl[nt][0]);
        split_tf32(bp[4 * WP], bh[nt][1], bl[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma3(acc[mt][nt], ah[mt], al[mt], bh[nt][0], bh[nt][1], bl[nt][0],
               bl[nt][1]);
    }
  }
  cp_async_wait<0>();

  // this split's partial dW: its slice of the workspace (or dW itself at
  // one split)
  float* d = dst + static_cast<int64_t>(blockIdx.z) * M * Cout;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + wm * 32 + mt * 16 + gq + 8 * half;
      if (r >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n0 + wn * 32 + nt * 8 + 2 * t + e;
          if (c >= Cout) continue;
          d[static_cast<int64_t>(r) * Cout + c] = acc[mt][nt][2 * half + e];
        }
    }
}

// out[i] = ws[0][i] + ws[1][i] + ... in split order: the same bits on
// every launch.
__global__ void sum_splits_kernel(const float* __restrict__ ws,
                                  float* __restrict__ out, int64_t n,
                                  int splits) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float s = ws[i];
    for (int k = 1; k < splits; ++k) s += ws[k * n + i];
    out[i] = s;
  }
}

}  // namespace f32c

// ---------------------------------------------------------- C interface

// out (N,H,W,Cout) f32 = relu(conv3x3_pad1(x, w) * a + b): x (N,H,W,Cin)
// f32; w (3,3,Cin,Cout) f32, or with ``flip`` (3,3,Cout,Cin) read as the
// tap-reversed transpose (K1's dx); a, b (Cout,) f32. Returns the CUDA
// error of the launch.
extern "C" int conv3x3_bn_relu_f32(const void* x, const void* w,
                                   const void* a, const void* b, void* out,
                                   int N, int H, int W, int Cin, int Cout,
                                   int relu, int flip, void* stream) {
  using namespace f32c;
  const long long P = static_cast<long long>(N) * H * W;
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 ||
      P >= (1LL << 31) - BM || 9LL * Cin >= (1LL << 31) ||
      (Cout + BN - 1) / BN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((P + BM - 1) / BM),
                  (Cout + BN - 1) / BN);
  auto st = static_cast<cudaStream_t>(stream);
  void (*kernel)(const float*, const float*, const float*, const float*,
                 float*, int, int, int, int, int, int) =
      flip ? conv_f32_kernel<true> : conv_f32_kernel<false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       FWD_SMEM);
  kernel<<<grid, THREADS, FWD_SMEM, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(out), H, W, static_cast<int>(P), Cin, Cout, relu);
  return static_cast<int>(cudaGetLastError());
}

// 32-pixel chunks of the split-K range: the wrapper picks splits <= this.
extern "C" long long conv3x3_wgrad_f32_pixel_chunks(int N, int H, int W) {
  const long long P = static_cast<long long>(N) * H * W;
  return (P + f32c::BK - 1) / f32c::BK;
}

// Output tiles (blocks per split): 64 rows of (tap, Cin) x 64 of Cout.
extern "C" long long conv3x3_wgrad_f32_out_tiles(int Cin, int Cout) {
  return ((9LL * Cin + f32c::WM - 1) / f32c::WM) *
         ((Cout + f32c::WN - 1) / f32c::WN);
}

// dW (3,3,Cin,Cout) f32 <- x (N,H,W,Cin) f32, g (N,H,W,Cout) f32. ws: f32
// workspace of splits * 9 * Cin * Cout elements when splits > 1 (unused
// at one split). Returns the CUDA error of the launches.
extern "C" int conv3x3_wgrad_f32(const void* x, const void* g, void* out,
                                 void* ws, int N, int H, int W, int Cin,
                                 int Cout, int splits, void* stream) {
  using namespace f32c;
  const long long P = static_cast<long long>(N) * H * W;
  const long long chunks = conv3x3_wgrad_f32_pixel_chunks(N, H, W);
  const long long elems = 9LL * Cin * Cout;
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 ||
      P >= (1LL << 31) - 4 * BK || elems >= (1LL << 31) || splits <= 0 ||
      splits > 65535 || splits > chunks || (Cout + WN - 1) / WN > 65535 ||
      (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto of = static_cast<float*>(out);
  float* dst = splits > 1 ? static_cast<float*>(ws) : of;
  const int per = static_cast<int>((chunks + splits - 1) / splits);
  const dim3 grid(static_cast<unsigned>((9LL * Cin + WM - 1) / WM),
                  (Cout + WN - 1) / WN, splits);
  cudaFuncSetAttribute(wgrad_f32_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
  wgrad_f32_kernel<<<grid, THREADS, WG_SMEM, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(g), dst, H, W,
      static_cast<int>(P), Cin, Cout, per, static_cast<int>(chunks));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const int blocks = static_cast<int>(
      (elems + 255) / 256 < 8192 ? (elems + 255) / 256 : 8192);
  sum_splits_kernel<<<blocks, 256, 0, st>>>(dst, of, elems, splits);
  return static_cast<int>(cudaGetLastError());
}
