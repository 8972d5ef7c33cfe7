// encode_map: squashed analog-bits latent of a class-index map, for Hopper.
//
//   out[n, :] = (2 * sigmoid(table[labels[n], :]) - 1) * bit_scale
//
// Replaces ddp_tpu/ops/pallas/q_sample.py:_encode_kernel (reached through
// _encode_pallas and fused_encode_map). The TPU kernel did the lookup as a
// one-hot matmul on the MXU over a table padded to 128 rows and rows padded
// to 256-row tiles; none of that carries over. On Hopper this is a plain
// gather.
//
// Bound: memory. The kernel writes N*C*sizeof(T) bytes and reads N*8 bytes of
// int64 labels plus the K*C table (151 x 256 x 4 B = 155 KB at ade20k_swin_t):
// about 34 MB per call at 2 x 512^2 (N = 32768), against ~6 flops per output
// element. Design: a coalesced gather-and-squash. The table stays resident
// in L2 (it is re-read by every row); neighbouring threads handle
// neighbouring channels of one row, each with one 16-byte load and one
// 16-byte store where C and the pointers allow it, and a grid-stride loop
// masks the ragged end. The math is f32 in exactly the plain version's form
// (1 / (1 + exp(-x)), then * 2 - 1, then * bit_scale) so that the two agree
// to the last ulp of expf.
//
// A label outside [0, K) gives a zero row, as the TPU kernel's one-hot does
// (the row is never read). The serving path never produces one: its labels
// are an argmax over K-1 classes.
//
// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch; the caller raises if it is not 0.

#include "dtype.cuh"

namespace {

using ddp::from_f32;
using ddp::Pack;
using ddp::squash;
using ddp::to_f32;

template <typename T, int VEC>
__global__ void encode_map_kernel(const int64_t* __restrict__ labels,
                                  const T* __restrict__ table,
                                  T* __restrict__ out, int64_t n, int c, int k,
                                  float bit_scale) {
  const int cv = c / VEC;  // vectors per row
  const int64_t total = n * cv;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int64_t row = i / cv;
    const int col = (int)(i - row * cv) * VEC;
    const int64_t lab = __ldg(labels + row);
    Pack<T, VEC> res;
    if (lab >= 0 && lab < k) {
      const Pack<T, VEC> src =
          *reinterpret_cast<const Pack<T, VEC>*>(table + lab * c + col);
#pragma unroll
      for (int j = 0; j < VEC; ++j) res.v[j] = from_f32<T>(squash(to_f32(src.v[j]), bit_scale));
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) res.v[j] = from_f32<T>(0.0f);
    }
    *reinterpret_cast<Pack<T, VEC>*>(out + row * c + col) = res;
  }
}

template <typename T>
cudaError_t launch(const int64_t* labels, const T* table, T* out, int64_t n,
                   int c, int k, float bit_scale, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);  // one 16-byte access per thread
  const bool vec_ok = (c % kVec == 0) &&
                      (reinterpret_cast<uintptr_t>(table) % 16 == 0) &&
                      (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const int vec = vec_ok ? kVec : 1;
  const int64_t total = n * (c / vec);
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;  // grid-stride covers the rest
  if (vec_ok) {
    encode_map_kernel<T, kVec><<<(unsigned)blocks, threads, 0, stream>>>(
        labels, table, out, n, c, k, bit_scale);
  } else {
    encode_map_kernel<T, 1><<<(unsigned)blocks, threads, 0, stream>>>(
        labels, table, out, n, c, k, bit_scale);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (table and output share it).
extern "C" int ddp_encode_map(const void* labels, const void* table, void* out,
                              int64_t n, int c, int k, float bit_scale,
                              int dtype, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* lab = static_cast<const int64_t*>(labels);
  if (dtype == 0) {
    return (int)launch<float>(lab, static_cast<const float*>(table),
                              static_cast<float*>(out), n, c, k, bit_scale, s);
  }
  if (dtype == 1) {
    return (int)launch<__nv_bfloat16>(
        lab, static_cast<const __nv_bfloat16*>(table),
        static_cast<__nv_bfloat16*>(out), n, c, k, bit_scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
