// Fused x`scale` bilinear upsample + cross-entropy, forward and backward, for
// Hopper.
//
// Output pixel (y, x) = (S*i + p, S*j + q) of the upsample (align_corners =
// False, edge-clamped) is, per phase (p, q), a fixed lerp of the latent
// pixels (i-1 or i+1, i) x (j-1 or j+1, j): phi = (p + 0.5) / S - 0.5 picks
// the taps (i-1, i) with weights (-phi, 1 + phi) when negative, else (i, i+1)
// with (1 - phi, phi) (ddp_tpu/ops/pallas/upsample_ce.py:_taps). The rows are
// lerped first, then the columns, each as lo * w_lo + hi * w_hi rounded
// exactly where the plain PyTorch version rounds (__fmul_rn / __fadd_rn), so
// both compute the same upsampled logits z to the bit.
//
// Forward (replaces ddp_tpu/ops/pallas/upsample_ce.py:_fwd_kernel, reached
// through _kernel_call from fused_upsample_ce): over the output pixels whose
// label is not ignore_index, the sums of the NLL (log-sum-exp of z minus the
// label's z), of the count, and of the correct count (z_label >= max z: ties
// count, as in the TPU kernel). It also writes each output pixel's
// log-sum-exp (B*S*h*S*w f32, 2 MB at the path's shape), which the backward
// reads instead of recomputing it. Nothing upsampled is written.
//
// Bound: at B=2, h=w=128, K=150, S=4 the forward reads 19.7 MB of f32 logits
// and 4.2 MB of int64 labels and writes 2.1 MB of lse, but takes 16 x 32768 x
// 150 = 78.6 M exponentials (0.019 ms on the SFU against 0.008 ms of bytes).
// What the TPU kernel kept out of HBM, the S^2-times larger upsampled logits,
// stays out of it here too. So the SFU and instruction issue bound it: each
// (output pixel, class) must cost one exponential and a few FP32
// instructions, and nothing else may be paid per output pixel and class.
//   - tiles: a block owns TH x 8 latent pixels of one image and their
//     S*TH x S*8 output pixels, which no other block touches. TH is 16, 8 or
//     4, the largest with S * TH <= 32 (fwd_tile), fixed at compile time
//     so that the phase loops unroll; one thread per output row and latent
//     column owns that cell's S output pixels of the row, so a block has
//     S * TH * 8 <= 256 threads (256 at S = 4: 8 x 8 tiles, 512 blocks at the
//     path's shape, one wave at 4 blocks per SM). ops/upsample_ce.py:
//     fwd_geometry picks the same tile, the grid (tiles, batch) and the
//     shared bytes, and the launch checks them.
//   - staging, per chunk of 32 classes: the (TH+2) x 10 halo of logits in
//     f32, edge-clamped as the upsample clamps it, 8 loads in flight a
//     thread (lanes along the classes). A halo pixel takes 36 floats, so
//     that the 8 lanes of a quarter warp (one output row) read 8 neighbouring
//     pixels' float4s on distinct banks. Classes >= K of the last chunk are
//     staged as -1e30: their z is -1e30 and their exponential 0. The tile's
//     labels are staged once (coalesced, lanes along the output row) and its
//     lse leaves through the same shared buffer.
//   - per group of 4 classes a thread reads 6 float4s (the halo rows of its
//     row's taps at its cell's 3 columns), lerps the rows, forms its S
//     pixels' z, takes each pixel's maximum of the group, rescales its
//     running sum once (one ex2 per pixel and group) and adds ex2(z log2 e -
//     m log2 e) per class: one exponential per (output pixel, class), each
//     pixel's (max, sum) in one thread, no branch per element and no
//     cross-lane merge (~11 instructions per output pixel and class). The
//     label's z is formed again once per chunk from the staged halo, with
//     the same roundings, so z_label >= max z (the Pallas rule) compares
//     exact values; lse = m + logf(s) once per pixel.
//   - sums: per thread over its valid pixels, then shuffles, and one
//     atomicAdd per block and sum. Float atomics change the summation order
//     from run to run.
//
// Backward (replaces :_bwd_kernel, reached through _kernel_grad from the VJP
// _ce_sums_bwd): dlogits[b, i, j, :] = g * sum over the output pixels whose
// taps include (i, j) of w_row * w_col * (softmax(z) - onehot(label)) over
// valid labels. It reads the logits, the labels and the forward's lse and
// writes dlogits (46 MB, 0.014 ms at the path's shape); its floor is the same
// 78.6 M exponentials, so what bounds it on the card is instruction issue:
// every output pixel's softmax must be computed once, and the transposed
// lerps must cost a few FMAs per (output pixel, class).
//   - tiles: a block of TH + 1 warps owns TH x TW latent pixels of one image
//     and 32 classes (one per lane; the grid's y walks the class chunks, the
//     last one partial). TH = TW = 8 for S <= 5, 4 above (bwd_tile), fixed
//     at compile time so that the walk over the cells unrolls;
//     ops/upsample_ce.py:bwd_geometry picks the same tile, the grid and the
//     shared bytes, and the launch checks them. The output pixels whose taps
//     reach the tile are the
//     (S*TH + S) x (S*TW + S) region from S*i0 - ceil(S/2): the tile's cells,
//     the later phases of the cell before and the earlier phases of the cell
//     after. Their taps lie in the (TH+2) x (TW+2) latent halo.
//   - staging (opt-in dynamic shared memory, 60 KB at 8 x 8 and S = 4), with
//     8 loads in flight a thread: the halo's logits in f32, edge-clamped as
//     the upsample clamps them, and the region's lse and label. An ignored
//     pixel, and one outside the image, gets lse = +inf, so that its softmax
//     is 0 with no mask or branch, and label -1, as does a valid label
//     outside [0, K) (softmax only): the plain version's valid / in_range
//     masks.
//   - dz once: a warp owns S output rows of the region. It lerps each row at
//     the halo's columns, then walks the cells left to right (unrolled); per
//     phase it forms z, dz = exp(z - lse) - [c == label], one exponential
//     (ex2.approx of z log2 e - lse log2 e, the product staged; ~1e-6
//     relative at |z - lse| < 20) per output pixel and class (1.27x the
//     minimum at 8 x 8 for the halo, against 4x for a gather per latent
//     pixel), and adds w_lo * dz and w_hi * dz into three rolling registers
//     for the columns cj - 1, cj,
//     cj + 1. Column cj - 1 is complete after cell cj and goes to
//     dzy[row][col] in shared memory. At the image's edge the clamp sends
//     both taps to one column: the virtual columns -1 and w are folded into
//     0 and w - 1, as _lerp_T's two index_add_ calls do.
//   - rows: each latent pixel sums the 2S rows of dzy that tap it (both
//     weights on the border row), scales by g and writes its 32 classes once.
// No atomics: a block's output is its own tile, and within the block the
// column pass owns its rows and the row pass its pixels, with one barrier
// between them. The sums run in another order than the plain version's.
//
// S is a template parameter (2..8) so that the phase loops unroll and the
// tap weights are constants. C interface (loaded with ctypes): each entry
// returns cudaGetLastError() after its launch; the caller raises if it is
// not 0.

#include <math.h>

#include "dtype.cuh"

namespace {

using ddp::to_f32;

constexpr unsigned kFull = 0xffffffffu;
// classes staged at a time (backward: per block, one per lane), and the
// opt-in shared memory of one block
constexpr int kChunk = 32;
constexpr int kMaxSmem = 232448;

// the forward's tile: fwd_tile<S>() x kFwdTileW latent pixels, the height
// the largest of 16, 8, 4 with at most 32 output rows, one thread per output
// row and latent column (ops/upsample_ce.py:fwd_geometry)
constexpr int kFwdTileW = 8;
template <int S>
__host__ __device__ constexpr int fwd_tile() {
  return S * 16 <= 32 ? 16 : S * 8 <= 32 ? 8 : 4;
}
template <int S>
__host__ __device__ constexpr int fwd_threads() {
  return S * fwd_tile<S>() * kFwdTileW;
}
// floats of a staged halo pixel in the forward: its chunk of classes and 4
// more, so that neighbouring pixels' float4s fall on distinct banks
constexpr int kFwdPixel = kChunk + 4;
// blocks per SM the forward's registers leave room for (64 a thread at 256)
constexpr int kFwdBlocks = 4;
// the forward uses no opt-in shared memory
constexpr int kFwdMaxSmem = 48 * 1024;

// shared bytes of the forward at tile TH x TW (ops/upsample_ce.py:fwd_smem_bytes)
__host__ __device__ constexpr size_t fwd_smem_bytes(int scale, int th, int tw) {
  return sizeof(float) * ((size_t)(th + 2) * (tw + 2) * kFwdPixel + (size_t)scale * scale * th * tw);
}

// the backward's tile edge at scale S: 8 x 8 where three blocks' shared
// memory fits on an SM (S <= 5), else 4 x 4 (ops/upsample_ce.py:bwd_geometry)
template <int S>
__host__ __device__ constexpr int bwd_tile() {
  return S <= 5 ? 8 : 4;
}

// global loads each thread keeps in flight while a kernel stages a halo
constexpr int kInFlight = 8;

// a staged output pixel of the backward: its lse times log2(e) (+inf where
// it counts nothing, so that its softmax is 0) and its label (-1 where it
// counts nothing or has no class: it matches no lane)
struct Px {
  float lse;
  int lab;
};

// 2^x to ~2 ulp, one SFU instruction (0 for -inf and below 2^-126)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// shared bytes of the backward at tile TH x TW (ops/upsample_ce.py:bwd_smem_bytes)
size_t bwd_smem_bytes(int scale, int th, int tw) {
  return sizeof(float) * kChunk * ((size_t)(th + 2) * (tw + 2) + (size_t)scale * (th + 1) * tw) +
         sizeof(Px) * (size_t)scale * scale * (th + 1) * (tw + 1);
}

template <int S>
__device__ __forceinline__ constexpr bool minus(int p) {
  return 2 * p + 1 < S;  // phi < 0: taps (i-1, i)
}

// the tap weights (w_lo, w_hi) of phase p, computed in double and rounded
// once to f32, as the plain version's Python floats are
template <int S>
__device__ __forceinline__ void phase_weights(int p, float* wlo, float* whi) {
  const double phi = (p + 0.5) / S - 0.5;
  if (phi < 0) {
    *wlo = (float)(-phi);
    *whi = (float)(1.0 + phi);
  } else {
    *wlo = (float)(1.0 - phi);
    *whi = (float)phi;
  }
}

__device__ __forceinline__ float lerp(float lo, float wlo, float hi, float whi) {
  return __fadd_rn(__fmul_rn(lo, wlo), __fmul_rn(hi, whi));
}

template <typename T, int S>
__global__ void __launch_bounds__(fwd_threads<S>(), kFwdBlocks)
upsample_ce_fwd_kernel(const T* __restrict__ logits, const int64_t* __restrict__ labels,
                       float* __restrict__ sums, float* __restrict__ lse_out, int h, int w,
                       int k, int64_t ignore_index) {
  constexpr int TH = fwd_tile<S>(), TW = kFwdTileW;
  constexpr int kThreads = fwd_threads<S>(), kWarpsF = kThreads / 32;
  constexpr int VW = TW + 2, NV = (TH + 2) * VW;  // halo columns and pixels
  constexpr int RW = S * TW;                      // the tile's output columns
  constexpr float kLog2e = 1.4426950408889634f;
  constexpr float kPad = -1e30f;  // a class >= K: z = -1e30, exponential 0
  constexpr int kNone = -2;       // the label code of a pixel that counts nothing
  static_assert(kThreads % 32 == 0 && kThreads <= 256, "whole warps, 64 registers");
  extern __shared__ float4 smem[];
  float* s_v = reinterpret_cast<float*>(smem);                   // [NV][kFwdPixel]
  int* s_lab = reinterpret_cast<int*>(s_v + NV * kFwdPixel);     // [S * TH][RW]
  float* s_lse = reinterpret_cast<float*>(s_lab);                // the same, at the end
  __shared__ float red[3][kWarpsF];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles_w = (w + TW - 1) / TW;
  const int i0 = (int)(blockIdx.x / tiles_w) * TH, j0 = (int)(blockIdx.x % tiles_w) * TW;
  const int64_t b = blockIdx.y;
  const int hh = S * h, ww = S * w;
  const int y0 = S * i0, x0 = S * j0;

  // 1. the tile's labels, coded: the class, -1 for a valid label outside
  // [0, K) (no class matches it), kNone for an ignored pixel or one outside
  // the image; S a thread, lanes along the output row
  {
    int64_t lab[S];
#pragma unroll
    for (int u = 0; u < S; ++u) {
      const int e = threadIdx.x + u * kThreads;
      const int y = y0 + e / RW, x = x0 + e % RW;
      lab[u] = y < hh && x < ww ? labels[(b * hh + y) * (int64_t)ww + x] : ignore_index;
    }
#pragma unroll
    for (int u = 0; u < S; ++u)
      s_lab[threadIdx.x + u * kThreads] = lab[u] == ignore_index ? kNone
                                          : lab[u] >= 0 && lab[u] < k ? (int)lab[u] : -1;
  }

  // this thread's output row r of the tile and latent column lc: the halo
  // rows of its row taps (unclamped: the staging clamped them) and weights
  const int r = threadIdx.x / TW, lc = threadIdx.x % TW;
  const int p = r % S;
  float wrl, wrh;
  phase_weights<S>(p, &wrl, &wrh);
  const float* vlo = s_v + ((r / S + (minus<S>(p) ? 0 : 1)) * VW + lc) * kFwdPixel;
  const float* vhi = vlo + VW * kFwdPixel;
  float wcl[S], wch[S];
  int lab[S];
  float m[S], s[S], zl[S];  // per output pixel: max z, sum of exp(z - m), z of the label
#pragma unroll
  for (int q = 0; q < S; ++q) {
    phase_weights<S>(q, &wcl[q], &wch[q]);
    m[q] = -INFINITY;
    s[q] = 0.0f;
    zl[q] = 0.0f;  // a label outside [0, K): the Pallas kernel's all-zero one-hot
  }

  for (int c0 = 0; c0 < k; c0 += kChunk) {
    const int nc = min(kChunk, k - c0);
    // 2. stage the chunk's halo (rows i0 - 1 .. i0 + TH, columns j0 - 1 ..
    // j0 + TW, clamped to the image as the upsample's taps are), once every
    // thread is done with the previous chunk
    __syncthreads();
    for (int e0 = warp; e0 < NV; e0 += kInFlight * kWarpsF) {
      float v[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int e = e0 + u * kWarpsF;
        const int row = min(max(i0 - 1 + e / VW, 0), h - 1);
        const int col = min(max(j0 - 1 + e % VW, 0), w - 1);
        v[u] = e < NV && lane < nc
                   ? to_f32(logits[((b * h + row) * w + col) * (int64_t)k + c0 + lane])
                   : kPad;
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        if (e0 + u * kWarpsF < NV) s_v[(e0 + u * kWarpsF) * kFwdPixel + lane] = v[u];
    }
    __syncthreads();
    if (c0 == 0) {
#pragma unroll
      for (int q = 0; q < S; ++q) lab[q] = s_lab[r * RW + S * lc + q];
    }

    // 3. per group of 4 classes: the rows lerped at the cell's 3 halo
    // columns, each pixel's z, its maximum, one rescale, one exponential
    // per class
    for (int g = 0; g < nc; g += 4) {
      float zr[3][4];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float4 a = *reinterpret_cast<const float4*>(vlo + d * kFwdPixel + g);
        const float4 c = *reinterpret_cast<const float4*>(vhi + d * kFwdPixel + g);
        zr[d][0] = lerp(a.x, wrl, c.x, wrh);
        zr[d][1] = lerp(a.y, wrl, c.y, wrh);
        zr[d][2] = lerp(a.z, wrl, c.z, wrh);
        zr[d][3] = lerp(a.w, wrl, c.w, wrh);
      }
#pragma unroll
      for (int q = 0; q < S; ++q) {
        const int d = minus<S>(q) ? 0 : 1;  // the pixel's column taps: d, d + 1
        float z[4];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) z[cc] = lerp(zr[d][cc], wcl[q], zr[d + 1][cc], wch[q]);
        const float mn = fmaxf(fmaxf(m[q], fmaxf(z[0], z[1])), fmaxf(z[2], z[3]));
        const float ml = __fmul_rn(mn, kLog2e);
        const float e01 = ex2(fmaf(z[0], kLog2e, -ml)) + ex2(fmaf(z[1], kLog2e, -ml));
        const float e23 = ex2(fmaf(z[2], kLog2e, -ml)) + ex2(fmaf(z[3], kLog2e, -ml));
        // the sum so far is scaled by 2^-(m log2 e) rounded as ml is, so the
        // rescale is exactly 1 where the maximum stays (no drift over the
        // groups); m = -inf before the first group: ex2(-inf) = 0 times s = 0
        s[q] = fmaf(s[q], ex2(__fmul_rn(m[q], kLog2e) - ml), e01 + e23);
        m[q] = mn;
      }
    }
    // the label's z where the label is in this chunk, as in the loop above
#pragma unroll
    for (int q = 0; q < S; ++q) {
      const int cl = lab[q] - c0;
      if (cl >= 0 && cl < nc) {
        const int d = minus<S>(q) ? 0 : 1;
        const float* lo = vlo + d * kFwdPixel + cl;
        const float* hi = vhi + d * kFwdPixel + cl;
        zl[q] = lerp(lerp(lo[0], wrl, hi[0], wrh), wcl[q],
                     lerp(lo[kFwdPixel], wrl, hi[kFwdPixel], wrh), wch[q]);
      }
    }
  }

  // 4. each pixel's lse, through shared memory (each thread writes the
  // entries whose labels it read, so no barrier is needed before), and the
  // thread's sums over its valid pixels
  float nll = 0.0f, cnt = 0.0f, cor = 0.0f;
#pragma unroll
  for (int q = 0; q < S; ++q) {
    const float l = m[q] + logf(s[q]);
    s_lse[r * RW + S * lc + q] = l;
    if (lab[q] != kNone) {
      nll += l - zl[q];
      cnt += 1.0f;
      cor += zl[q] >= m[q] ? 1.0f : 0.0f;  // ties count, as in the Pallas kernel
    }
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < S; ++u) {
    const int e = threadIdx.x + u * kThreads;
    const int y = y0 + e / RW, x = x0 + e % RW;
    if (y < hh && x < ww) lse_out[(b * hh + y) * (int64_t)ww + x] = s_lse[e];
  }
  for (int off = 16; off > 0; off >>= 1) {
    nll += __shfl_xor_sync(kFull, nll, off);
    cnt += __shfl_xor_sync(kFull, cnt, off);
    cor += __shfl_xor_sync(kFull, cor, off);
  }
  if (lane == 0) {
    red[0][warp] = nll;
    red[1][warp] = cnt;
    red[2][warp] = cor;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    float t = 0.0f;
#pragma unroll
    for (int v = 0; v < kWarpsF; ++v) t += red[threadIdx.x][v];
    atomicAdd(&sums[threadIdx.x], t);
  }
}

template <typename T, int S>
__global__ void __launch_bounds__((bwd_tile<S>() + 1) * 32)
upsample_ce_bwd_kernel(const T* __restrict__ logits, const int64_t* __restrict__ labels,
                       const float* __restrict__ lse, const float* __restrict__ g,
                       float* __restrict__ dlogits, int h, int w, int k,
                       int64_t ignore_index) {
  constexpr int TH = bwd_tile<S>(), TW = TH;
  constexpr int kWarpsB = TH + 1;        // warp t owns region rows t, t + TH + 1, ...
  constexpr int VW = TW + 2;             // halo columns
  constexpr int NV = (TH + 2) * VW;      // halo pixels
  // the region's output pixels: the tile's cells, and the phases p >= S / 2
  // (ceil(S / 2) of them) of the cell before and p < S / 2 of the cell after
  constexpr int kBefore = S - S / 2;
  constexpr int NROWS = S * (TH + 1), NCOLS = S * (TW + 1), NPX = NROWS * NCOLS;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ float4 smem[];
  float* s_v = reinterpret_cast<float*>(smem);              // [TH + 2][VW][32]
  Px* s_px = reinterpret_cast<Px*>(s_v + NV * kChunk);      // [NROWS][NCOLS]
  float* s_dzy = reinterpret_cast<float*>(s_px + NPX);      // [NROWS][TW][32]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles_w = (w + TW - 1) / TW;
  const int i0 = (int)(blockIdx.x / tiles_w) * TH, j0 = (int)(blockIdx.x % tiles_w) * TW;
  const int c = blockIdx.y * kChunk + lane;
  const int64_t b = blockIdx.z;
  const int hh = S * h, ww = S * w;
  const int y0 = S * i0 - kBefore, x0 = S * j0 - kBefore;

  // 1. stage the halo (rows i0 - 1 .. i0 + TH, columns j0 - 1 .. j0 + TW,
  // clamped to the image as the upsample's taps are) and the region's
  // pixels, kInFlight loads at a time
  for (int e0 = warp; e0 < NV; e0 += kInFlight * kWarpsB) {
    float v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int e = e0 + u * kWarpsB;
      const int r = min(max(i0 - 1 + e / VW, 0), h - 1);
      const int col = min(max(j0 - 1 + e % VW, 0), w - 1);
      v[u] = e < NV && c < k ? to_f32(logits[((b * h + r) * w + col) * (int64_t)k + c]) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
      if (e0 + u * kWarpsB < NV) s_v[(e0 + u * kWarpsB) * kChunk + lane] = v[u];
  }
  for (int e0 = threadIdx.x; e0 < NPX; e0 += kInFlight * kWarpsB * 32) {
    int64_t lab[kInFlight];
    float l[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int e = e0 + u * kWarpsB * 32;
      const int y = y0 + e / NCOLS, x = x0 + e % NCOLS;
      lab[u] = ignore_index;  // no such output pixel
      l[u] = 0.0f;
      if (e < NPX && y >= 0 && y < hh && x >= 0 && x < ww) {
        const int64_t o = (b * hh + y) * (int64_t)ww + x;
        lab[u] = labels[o];
        l[u] = lse[o];
      }
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int e = e0 + u * kWarpsB * 32;
      if (e >= NPX) continue;
      const bool valid = lab[u] != ignore_index;
      s_px[e] = Px{valid ? l[u] * kLog2e : INFINITY,
                   valid && lab[u] >= 0 && lab[u] < k ? (int)lab[u] : -1};
    }
  }
  __syncthreads();

  float wlo[S], whi[S];
#pragma unroll
  for (int q = 0; q < S; ++q) phase_weights<S>(q, &wlo[q], &whi[q]);

  // 2. dz of every output pixel of the region, once, and the transposed
  // column lerp into dzy; a warp owns whole rows, so no two write one entry.
  // Pixels outside the image carry lse = +inf and add 0, with no branch.
#pragma unroll 1
  for (int m = 0; m < S; ++m) {
    const int r = warp + m * kWarpsB;
    const int y = y0 + r;
    if (y < 0 || y >= hh) continue;  // no such row; the row pass reads none
    const int p = y % S;
    float wrl, wrh;
    phase_weights<S>(p, &wrl, &wrh);
    // the halo row of the row's low tap, unclamped (the staging clamped it);
    // the high tap is the next halo row
    const int lo = (minus<S>(p) ? y / S - 1 : y / S) - (i0 - 1);
    const float* vlo = s_v + lo * VW * kChunk + lane;
    const float* vhi = vlo + VW * kChunk;
    const Px* px = s_px + r * NCOLS;
    float* dzy = s_dzy + r * TW * kChunk + lane;
    // the row lerped at halo columns lc - 1, lc, lc + 1 of cell lc
    float zm = 0.0f;
    float z0 = lerp(vlo[0], wrl, vhi[0], wrh);
    float zp = lerp(vlo[kChunk], wrl, vhi[kChunk], wrh);
    // partial sums of dz for the columns cj - 1 and cj (a2: cj + 1)
    float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
    for (int lc = 0; lc < VW; ++lc) {
      const int cj = j0 - 1 + lc;
      float a2 = 0.0f;
#pragma unroll
      for (int q = 0; q < S; ++q) {
        // the halo's first cell reaches the region only by its phases
        // after S / 2, its last only by those before
        if (minus<S>(q) ? lc == 0 : lc == VW - 1) continue;
        const Px o = px[S * (lc - 1) + kBefore + q];
        const float z = minus<S>(q) ? lerp(zm, wlo[q], z0, whi[q])
                                    : lerp(z0, wlo[q], zp, whi[q]);
        const float dz = ex2(fmaf(z, kLog2e, -o.lse)) - (c == o.lab ? 1.0f : 0.0f);
        if (minus<S>(q)) {
          a0 = fmaf(wlo[q], dz, a0);
          a1 = fmaf(whi[q], dz, a1);
        } else {
          a1 = fmaf(wlo[q], dz, a1);
          a2 = fmaf(whi[q], dz, a2);
        }
      }
      // the clamp at the image's edge: both taps on column 0 (w - 1)
      if (cj == 0) a1 += a0;
      if (cj == w - 1) {
        a1 += a2;
        a2 = 0.0f;
      }
      // column cj - 1 has all its terms; keep it if it is the tile's
      if (lc >= 2) dzy[(lc - 2) * kChunk] = a0;
      a0 = a1;
      a1 = a2;
      zm = z0;
      z0 = zp;
      if (lc + 2 < VW) zp = lerp(vlo[(lc + 2) * kChunk], wrl, vhi[(lc + 2) * kChunk], wrh);
    }
  }
  __syncthreads();

  // 3. the transposed row lerp: latent pixel (i, j) sums the rows of dzy that
  // tap row i, the later phases of cell i - 1, all of cell i, the earlier of
  // cell i + 1 (both weights on the border rows), and writes its classes once
  const float gs = __ldg(g);
  constexpr int kRow = TW * kChunk;
  for (int e = warp; e < TH * TW; e += kWarpsB) {
    const int ti = e / TW, tj = e % TW;
    const int i = i0 + ti, j = j0 + tj;
    if (i >= h || j >= w) continue;
    const float* col = s_dzy + (S * ti + kBefore) * kRow + tj * kChunk + lane;
    float acc = 0.0f;
#pragma unroll
    for (int p = 0; p < S; ++p) {
      const float d = col[p * kRow];
      if (minus<S>(p)) {
        acc = fmaf(whi[p], d, acc);
        if (i == 0) acc = fmaf(wlo[p], d, acc);
        if (i + 1 < h) acc = fmaf(wlo[p], col[(S + p) * kRow], acc);
      } else {
        acc = fmaf(wlo[p], d, acc);
        if (i == h - 1) acc = fmaf(whi[p], d, acc);
        if (i > 0) acc = fmaf(whi[p], col[(p - S) * kRow], acc);
      }
    }
    if (c < k) dlogits[((b * h + i) * w + j) * (int64_t)k + c] = gs * acc;
  }
}

template <typename T, int S>
cudaError_t launch_fwd(const void* logits, const int64_t* labels, float* sums, float* lse,
                       int nb, int h, int w, int k, int64_t ignore, int th, int tw, int gx,
                       int gy, int threads, int smem, cudaStream_t st) {
  constexpr int kTile = fwd_tile<S>();
  static_assert(fwd_smem_bytes(S, kTile, kFwdTileW) <= kFwdMaxSmem, "no opt-in needed");
  // the geometry must be the compiled tile's, cover the output, and give
  // the shared memory its layout needs
  const int64_t tiles = (int64_t)((h + kTile - 1) / kTile) * ((w + kFwdTileW - 1) / kFwdTileW);
  if (th != kTile || tw != kFwdTileW || gx != tiles || gy != nb || threads != fwd_threads<S>() ||
      (int64_t)smem < (int64_t)fwd_smem_bytes(S, th, tw) || smem > kFwdMaxSmem)
    return cudaErrorInvalidValue;
  upsample_ce_fwd_kernel<T, S><<<dim3((unsigned)gx, (unsigned)gy), threads, smem, st>>>(
      static_cast<const T*>(logits), labels, sums, lse, h, w, k, ignore);
  return cudaGetLastError();
}

#define DDP_SCALES(X, T) \
  X(T, 2) X(T, 3) X(T, 4) X(T, 5) X(T, 6) X(T, 7) X(T, 8)

template <typename T>
cudaError_t dispatch_fwd(int scale, const void* logits, const int64_t* labels, float* sums,
                         float* lse, int nb, int h, int w, int k, int64_t ignore, int th,
                         int tw, int gx, int gy, int threads, int smem, cudaStream_t st) {
  switch (scale) {
#define X(T_, S_)                                                                      \
  case S_:                                                                             \
    return launch_fwd<T_, S_>(logits, labels, sums, lse, nb, h, w, k, ignore, th, tw, gx, \
                              gy, threads, smem, st);
    DDP_SCALES(X, T)
#undef X
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, int S>
cudaError_t launch_bwd(const void* logits, const int64_t* labels, const float* lse,
                       const float* g, float* dlogits, int nb, int h, int w, int k,
                       int64_t ignore, int th, int tw, int gx, int gy, int gz, int smem,
                       cudaStream_t st) {
  constexpr int kTile = bwd_tile<S>();
  // the geometry must be the compiled tile's, cover the output, and give
  // the shared memory its layout needs
  const int64_t tiles = (int64_t)((h + kTile - 1) / kTile) * ((w + kTile - 1) / kTile);
  if (th != kTile || tw != kTile || gx != tiles || gy != (k + kChunk - 1) / kChunk ||
      gz != nb || (int64_t)smem < (int64_t)bwd_smem_bytes(S, th, tw) || smem > kMaxSmem)
    return cudaErrorInvalidValue;
  // above 48 KB a launch is refused unless the kernel opts in (per device)
  const cudaError_t err = cudaFuncSetAttribute(
      upsample_ce_bwd_kernel<T, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  upsample_ce_bwd_kernel<T, S><<<dim3((unsigned)gx, (unsigned)gy, (unsigned)gz),
                                 (kTile + 1) * 32, smem, st>>>(
      static_cast<const T*>(logits), labels, lse, g, dlogits, h, w, k, ignore);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bwd(int scale, const void* logits, const int64_t* labels,
                         const float* lse, const float* g, float* dlogits, int nb, int h,
                         int w, int k, int64_t ignore, int th, int tw, int gx, int gy, int gz,
                         int smem, cudaStream_t st) {
  switch (scale) {
#define X(T_, S_)                                                                      \
  case S_:                                                                             \
    return launch_bwd<T_, S_>(logits, labels, lse, g, dlogits, nb, h, w, k, ignore, th, \
                              tw, gx, gy, gz, smem, st);
    DDP_SCALES(X, T)
#undef X
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t kernel_attrs(bool fwd, int scale, cudaFuncAttributes* attrs) {
  switch (scale) {
#define X(T_, S_)                                                                   \
  case S_:                                                                          \
    return fwd ? cudaFuncGetAttributes(attrs, upsample_ce_fwd_kernel<T_, S_>)       \
               : cudaFuncGetAttributes(attrs, upsample_ce_bwd_kernel<T_, S_>);
    DDP_SCALES(X, T)
#undef X
    default:
      return cudaErrorInvalidValue;
  }
}

// out[4] = registers per thread, local (spilled) bytes per thread, static
// shared bytes and the largest block of one kernel, from cudaFuncGetAttributes
int write_attrs(bool fwd, int scale, int dtype, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = dtype == 0   ? kernel_attrs<float>(fwd, scale, &a)
                          : dtype == 1 ? kernel_attrs<__nv_bfloat16>(fwd, scale, &a)
                                       : cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = a.maxThreadsPerBlock;
  return (int)cudaSuccess;
}

}  // namespace

// logits [nb, h, w, k] (dtype 0 = float32, 1 = bfloat16), labels
// [nb, scale*h, scale*w] int64; sums float32[3] zero-filled (nll, count,
// correct); lse [nb, scale*h, scale*w] float32. scale in 2..8. The tile
// (tile_h x tile_w latent pixels: 8 wide, 16, 8 or 4 high as scale is 2, 3-4
// or above), the grid (tiles, nb), the threads (scale * tile_h * tile_w) and
// the dynamic shared bytes come from ops/upsample_ce.py:fwd_geometry.
extern "C" int ddp_upsample_ce_fwd(const void* logits, const void* labels, void* sums,
                                   void* lse, int nb, int h, int w, int k, int scale,
                                   int64_t ignore_index, int dtype, int tile_h, int tile_w,
                                   int grid_x, int grid_y, int threads, int smem_bytes,
                                   void* stream) {
  if ((int64_t)nb * h * w == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t* lab = static_cast<const int64_t*>(labels);
  float* s = static_cast<float*>(sums);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return (int)dispatch_fwd<float>(scale, logits, lab, s, l, nb, h, w, k, ignore_index,
                                    tile_h, tile_w, grid_x, grid_y, threads, smem_bytes, st);
  if (dtype == 1)
    return (int)dispatch_fwd<__nv_bfloat16>(scale, logits, lab, s, l, nb, h, w, k,
                                            ignore_index, tile_h, tile_w, grid_x, grid_y,
                                            threads, smem_bytes, st);
  return (int)cudaErrorInvalidValue;
}

// dlogits [nb, h, w, k] float32 = g[0] * d(nll sum)/d(logits); lse from the
// forward; g a float32 scalar on the device. The tile (tile_h x tile_w latent
// pixels: 8 x 8 for scales 2..5, 4 x 4 above), the grid (tiles, class
// chunks of 32, nb) and the dynamic shared bytes come from
// ops/upsample_ce.py:bwd_geometry.
extern "C" int ddp_upsample_ce_bwd(const void* logits, const void* labels, const void* lse,
                                   const void* g, void* dlogits, int nb, int h, int w, int k,
                                   int scale, int64_t ignore_index, int dtype, int tile_h,
                                   int tile_w, int grid_x, int grid_y, int grid_z,
                                   int smem_bytes, void* stream) {
  if ((int64_t)nb * h * w == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t* lab = static_cast<const int64_t*>(labels);
  const float* l = static_cast<const float*>(lse);
  const float* gg = static_cast<const float*>(g);
  float* d = static_cast<float*>(dlogits);
  if (dtype == 0)
    return (int)dispatch_bwd<float>(scale, logits, lab, l, gg, d, nb, h, w, k, ignore_index,
                                    tile_h, tile_w, grid_x, grid_y, grid_z, smem_bytes, st);
  if (dtype == 1)
    return (int)dispatch_bwd<__nv_bfloat16>(scale, logits, lab, l, gg, d, nb, h, w, k,
                                            ignore_index, tile_h, tile_w, grid_x, grid_y,
                                            grid_z, smem_bytes, st);
  return (int)cudaErrorInvalidValue;
}

// out[4] = registers per thread, local (spilled) bytes per thread, static
// shared bytes and the largest block of the forward (backward) kernel for
// this scale and dtype, from cudaFuncGetAttributes
extern "C" int ddp_upsample_ce_fwd_attrs(int scale, int dtype, int* out) {
  return write_attrs(true, scale, dtype, out);
}

extern "C" int ddp_upsample_ce_bwd_attrs(int scale, int dtype, int* out) {
  return write_attrs(false, scale, dtype, out);
}
