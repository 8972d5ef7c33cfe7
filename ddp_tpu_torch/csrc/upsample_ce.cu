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
// Backward (replaces :_bwd_kernel, reached through _kernel_grad from the VJP
// _ce_sums_bwd): dlogits[b, i, j, :] = g * sum over the output pixels whose
// taps include (i, j) of w_row * w_col * (softmax(z) - onehot(label)) over
// valid labels.
//
// Bound: at B=2, h=w=128, K=150, S=4 the forward reads 19.7 MB of f32 logits
// and 4.2 MB of int64 labels, but takes 16 x 32768 x 150 = 78.6 M exponentials;
// the backward adds 19.7 MB of dlogits. What the TPU kernel kept out of HBM,
// the S^2-times larger upsampled logits, stays out here too: one warp owns
// one latent pixel (b, i, j), its lanes stride over the K classes (coalesced
// loads of the K-vector), and the 3 x 3 neighbourhood it needs is re-read
// from L1/L2 by the neighbouring warps instead of from HBM.
//   - forward: per row phase p the warp lerps the S output pixels
//     (S*i + p, S*j + q) for every class, keeps an online max / sum of
//     exponentials per pixel in registers (one exp per element), merges the
//     lanes by shuffles, and adds its sums to the block's; one atomicAdd per
//     block and sum. Float atomics change the summation order from run to run.
//   - backward: a gather, not a scatter. The up to 2S x 2S output pixels
//     whose taps include (i, j) belong to the 3 x 3 neighbouring latent
//     cells, so neighbouring warps would collide on every dlogits entry if
//     they scattered (atomics on 4.9 M addresses); gathering, each warp writes
//     its own K-vector once with no atomics, at the price of recomputing each
//     output pixel's softmax for each of the (up to 4) latent pixels it taps:
//     about 4x the forward's exponentials. The output pixels' log-sum-exp and
//     labels are staged per warp in shared memory first.
//
// S is a template parameter (2..8) so that the per-pixel accumulators live in
// registers. C interface (loaded with ctypes): each entry returns
// cudaGetLastError() after its launch; the caller raises if it is not 0.

#include <math.h>

#include "dtype.cuh"

namespace {

using ddp::to_f32;

constexpr int kWarps = 8;  // latent pixels per block, one per warp
constexpr unsigned kFull = 0xffffffffu;

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

// the two (edge-clamped) taps of phase p of latent index i along an axis of n
template <int S>
__device__ __forceinline__ void phase_taps(int p, int i, int n, int* lo, int* hi) {
  if (minus<S>(p)) {
    *lo = max(i - 1, 0);
    *hi = i;
  } else {
    *lo = i;
    *hi = min(i + 1, n - 1);
  }
}

__device__ __forceinline__ float lerp(float lo, float wlo, float hi, float whi) {
  return __fadd_rn(__fmul_rn(lo, wlo), __fmul_rn(hi, whi));
}

// v[slot] for slot in {0, 1, 2} without a runtime-indexed (local-memory) array
__device__ __forceinline__ float pick3(const float* v, int slot) {
  return slot == 0 ? v[0] : (slot == 1 ? v[1] : v[2]);
}

// merge an online (max, sum of exp(z - max)) pair with lane ^ off's
__device__ __forceinline__ void merge_lse(float* m, float* s, int off) {
  const float m2 = __shfl_xor_sync(kFull, *m, off);
  const float s2 = __shfl_xor_sync(kFull, *s, off);
  const float mm = fmaxf(*m, m2);
  const float a = *m == -INFINITY ? 0.0f : *s * expf(*m - mm);
  const float b = m2 == -INFINITY ? 0.0f : s2 * expf(m2 - mm);
  *m = mm;
  *s = a + b;
}

template <typename T, int S>
__global__ void __launch_bounds__(kWarps * 32)
upsample_ce_fwd_kernel(const T* __restrict__ logits, const int64_t* __restrict__ labels,
                       float* __restrict__ sums, float* __restrict__ lse_out, int nb,
                       int h, int w, int k, int64_t ignore_index) {
  __shared__ float red[3][kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t pix = (int64_t)blockIdx.x * kWarps + warp;
  const int hh = S * h, ww = S * w;
  float nll = 0.0f, cnt = 0.0f, cor = 0.0f;  // lane 0's sums for this warp
  if (pix < (int64_t)nb * h * w) {
    const int j = (int)(pix % w);
    const int i = (int)((pix / w) % h);
    const int64_t b = pix / ((int64_t)w * h);
    const int jm = max(j - 1, 0), jp = min(j + 1, w - 1);
    float wclo[S], wchi[S];
#pragma unroll
    for (int q = 0; q < S; ++q) phase_weights<S>(q, &wclo[q], &wchi[q]);
    for (int p = 0; p < S; ++p) {
      int rl, rh;
      float wrl, wrh;
      phase_taps<S>(p, i, h, &rl, &rh);
      phase_weights<S>(p, &wrl, &wrh);
      const T* lo_row = logits + ((b * h + rl) * w) * (int64_t)k;
      const T* hi_row = logits + ((b * h + rh) * w) * (int64_t)k;
      const int64_t* lab_row = labels + (b * hh + (S * i + p)) * (int64_t)ww + S * j;
      int64_t lab[S];
      float m[S], s[S], zl[S];
#pragma unroll
      for (int q = 0; q < S; ++q) {
        lab[q] = __ldg(lab_row + q);
        m[q] = -INFINITY;
        s[q] = 0.0f;
        zl[q] = 0.0f;
      }
      for (int c = lane; c < k; c += 32) {
        const float zm = lerp(to_f32(lo_row[jm * k + c]), wrl, to_f32(hi_row[jm * k + c]), wrh);
        const float z0 = lerp(to_f32(lo_row[j * k + c]), wrl, to_f32(hi_row[j * k + c]), wrh);
        const float zp = lerp(to_f32(lo_row[jp * k + c]), wrl, to_f32(hi_row[jp * k + c]), wrh);
#pragma unroll
        for (int q = 0; q < S; ++q) {
          const float z = minus<S>(q) ? lerp(zm, wclo[q], z0, wchi[q])
                                      : lerp(z0, wclo[q], zp, wchi[q]);
          if (z > m[q]) {
            s[q] = s[q] * expf(m[q] - z) + 1.0f;
            m[q] = z;
          } else {
            s[q] += expf(z - m[q]);
          }
          if (c == lab[q]) zl[q] = z;
        }
      }
#pragma unroll
      for (int q = 0; q < S; ++q) {
        for (int off = 16; off > 0; off >>= 1) {
          merge_lse(&m[q], &s[q], off);
          zl[q] += __shfl_xor_sync(kFull, zl[q], off);  // one lane holds it, the rest 0
        }
        const float lse = m[q] + logf(s[q]);
        if (lane == 0) {
          lse_out[(b * hh + (S * i + p)) * (int64_t)ww + S * j + q] = lse;
          if (lab[q] != ignore_index) {
            nll += lse - zl[q];
            cnt += 1.0f;
            cor += zl[q] >= m[q] ? 1.0f : 0.0f;
          }
        }
      }
    }
  }
  if (lane == 0) {
    red[0][warp] = nll;
    red[1][warp] = cnt;
    red[2][warp] = cor;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    float t = 0.0f;
    for (int v = 0; v < kWarps; ++v) t += red[threadIdx.x][v];
    atomicAdd(&sums[threadIdx.x], t);
  }
}

template <typename T, int S>
__global__ void __launch_bounds__(kWarps * 32)
upsample_ce_bwd_kernel(const T* __restrict__ logits, const int64_t* __restrict__ labels,
                       const float* __restrict__ lse, const float* __restrict__ g,
                       float* __restrict__ dlogits, int nb, int h, int w, int k,
                       int64_t ignore_index) {
  constexpr int kCand = 3 * S;  // candidate (neighbour cell, phase) pairs per axis
  __shared__ float s_lse[kWarps][kCand * kCand];
  // label of each candidate output pixel: the class, -1 for ignore_index or no
  // such pixel, -2 for a label outside [0, k) (a valid pixel with no class)
  __shared__ int s_lab[kWarps][kCand * kCand];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t pix = (int64_t)blockIdx.x * kWarps + warp;
  if (pix >= (int64_t)nb * h * w) return;  // whole warps leave; no block barrier below
  const int j = (int)(pix % w);
  const int i = (int)((pix / w) % h);
  const int64_t b = pix / ((int64_t)w * h);
  const int hh = S * h, ww = S * w;

  // candidate a = (d + 1) * S + p on an axis: neighbour cell i + d, phase p
  for (int t = lane; t < kCand * kCand; t += 32) {
    const int a = t / kCand, c = t % kCand;
    const int ci = i + a / S - 1, cj = j + c / S - 1;
    if (ci >= 0 && ci < h && cj >= 0 && cj < w) {
      const int64_t o = (b * hh + (S * ci + a % S)) * (int64_t)ww + S * cj + c % S;
      const int64_t lab = labels[o];
      s_lse[warp][t] = lse[o];
      s_lab[warp][t] = lab == ignore_index ? -1 : (lab >= 0 && lab < k ? (int)lab : -2);
    } else {
      s_lab[warp][t] = -1;
    }
  }
  __syncwarp();

  float wlo[S], whi[S];
#pragma unroll
  for (int p = 0; p < S; ++p) phase_weights<S>(p, &wlo[p], &whi[p]);
  const float gs = __ldg(g);
  const int rows[3] = {max(i - 1, 0), i, min(i + 1, h - 1)};
  const int cols[3] = {max(j - 1, 0), j, min(j + 1, w - 1)};
  for (int c = lane; c < k; c += 32) {
    // the 3 x 3 neighbourhood; every tap of every candidate lies in it
    float v[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int cc = 0; cc < 3; ++cc)
        v[r][cc] = to_f32(logits[((b * h + rows[r]) * w + cols[cc]) * (int64_t)k + c]);
    float acc = 0.0f;
    for (int a = 0; a < kCand; ++a) {
      const int ci = i + a / S - 1, p = a % S;
      if (ci < 0 || ci >= h) continue;
      int rl, rh;
      phase_taps<S>(p, ci, h, &rl, &rh);
      const float wy = (rl == i ? wlo[p] : 0.0f) + (rh == i ? whi[p] : 0.0f);
      if (wy == 0.0f) continue;
      float zy[3];  // this output row lerped at the three latent columns
#pragma unroll
      for (int cc = 0; cc < 3; ++cc) {
        const float col[3] = {v[0][cc], v[1][cc], v[2][cc]};
        zy[cc] = lerp(pick3(col, rl - i + 1), wlo[p], pick3(col, rh - i + 1), whi[p]);
      }
      float row_acc = 0.0f;
      for (int e = 0; e < kCand; ++e) {
        const int cj = j + e / S - 1, q = e % S;
        if (cj < 0 || cj >= w) continue;
        int cl, ch;
        phase_taps<S>(q, cj, w, &cl, &ch);
        const float wx = (cl == j ? wlo[q] : 0.0f) + (ch == j ? whi[q] : 0.0f);
        if (wx == 0.0f) continue;
        const int lab = s_lab[warp][a * kCand + e];
        if (lab == -1) continue;
        const float z = lerp(pick3(zy, cl - j + 1), wlo[q], pick3(zy, ch - j + 1), whi[q]);
        const float d = expf(z - s_lse[warp][a * kCand + e]) - (c == lab ? 1.0f : 0.0f);
        row_acc += wx * d;
      }
      acc += wy * row_acc;
    }
    dlogits[((b * h + i) * w + j) * (int64_t)k + c] = gs * acc;
  }
}

template <typename T, int S>
cudaError_t launch_fwd(const void* logits, const int64_t* labels, float* sums, float* lse,
                       int nb, int h, int w, int k, int64_t ignore, cudaStream_t st) {
  const int64_t blocks = ((int64_t)nb * h * w + kWarps - 1) / kWarps;
  upsample_ce_fwd_kernel<T, S><<<(unsigned)blocks, kWarps * 32, 0, st>>>(
      static_cast<const T*>(logits), labels, sums, lse, nb, h, w, k, ignore);
  return cudaGetLastError();
}

template <typename T, int S>
cudaError_t launch_bwd(const void* logits, const int64_t* labels, const float* lse,
                       const float* g, float* dlogits, int nb, int h, int w, int k,
                       int64_t ignore, cudaStream_t st) {
  const int64_t blocks = ((int64_t)nb * h * w + kWarps - 1) / kWarps;
  upsample_ce_bwd_kernel<T, S><<<(unsigned)blocks, kWarps * 32, 0, st>>>(
      static_cast<const T*>(logits), labels, lse, g, dlogits, nb, h, w, k, ignore);
  return cudaGetLastError();
}

#define DDP_SCALES(X, T) \
  X(T, 2) X(T, 3) X(T, 4) X(T, 5) X(T, 6) X(T, 7) X(T, 8)

template <typename T>
cudaError_t dispatch_fwd(int scale, const void* logits, const int64_t* labels, float* sums,
                         float* lse, int nb, int h, int w, int k, int64_t ignore,
                         cudaStream_t st) {
  switch (scale) {
#define X(T_, S_) \
  case S_:        \
    return launch_fwd<T_, S_>(logits, labels, sums, lse, nb, h, w, k, ignore, st);
    DDP_SCALES(X, T)
#undef X
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_bwd(int scale, const void* logits, const int64_t* labels,
                         const float* lse, const float* g, float* dlogits, int nb, int h,
                         int w, int k, int64_t ignore, cudaStream_t st) {
  switch (scale) {
#define X(T_, S_) \
  case S_:        \
    return launch_bwd<T_, S_>(logits, labels, lse, g, dlogits, nb, h, w, k, ignore, st);
    DDP_SCALES(X, T)
#undef X
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// logits [nb, h, w, k] (dtype 0 = float32, 1 = bfloat16), labels
// [nb, scale*h, scale*w] int64; sums float32[3] zero-filled (nll, count,
// correct); lse [nb, scale*h, scale*w] float32. scale in 2..8.
extern "C" int ddp_upsample_ce_fwd(const void* logits, const void* labels, void* sums,
                                   void* lse, int nb, int h, int w, int k, int scale,
                                   int64_t ignore_index, int dtype, void* stream) {
  if ((int64_t)nb * h * w == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t* lab = static_cast<const int64_t*>(labels);
  float* s = static_cast<float*>(sums);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return (int)dispatch_fwd<float>(scale, logits, lab, s, l, nb, h, w, k, ignore_index, st);
  if (dtype == 1)
    return (int)dispatch_fwd<__nv_bfloat16>(scale, logits, lab, s, l, nb, h, w, k,
                                            ignore_index, st);
  return (int)cudaErrorInvalidValue;
}

// dlogits [nb, h, w, k] float32 = g[0] * d(nll sum)/d(logits); lse from the
// forward; g a float32 scalar on the device.
extern "C" int ddp_upsample_ce_bwd(const void* logits, const void* labels, const void* lse,
                                   const void* g, void* dlogits, int nb, int h, int w, int k,
                                   int scale, int64_t ignore_index, int dtype, void* stream) {
  if ((int64_t)nb * h * w == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t* lab = static_cast<const int64_t*>(labels);
  const float* l = static_cast<const float*>(lse);
  const float* gg = static_cast<const float*>(g);
  float* d = static_cast<float*>(dlogits);
  if (dtype == 0)
    return (int)dispatch_bwd<float>(scale, logits, lab, l, gg, d, nb, h, w, k, ignore_index,
                                    st);
  if (dtype == 1)
    return (int)dispatch_bwd<__nv_bfloat16>(scale, logits, lab, l, gg, d, nb, h, w, k,
                                            ignore_index, st);
  return (int)cudaErrorInvalidValue;
}
