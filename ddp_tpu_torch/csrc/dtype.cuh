// Shared helpers of the port's kernels: f32 <-> storage-type conversion and
// the aligned vector used for 16-byte loads and stores.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ddp {

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// (1 / (1 + exp(-x)) * 2 - 1) * bit_scale in f32: the squash of the
// analog-bits latent, in exactly the plain PyTorch version's form.
__device__ __forceinline__ float squash(float x, float bit_scale) {
  const float s = 1.0f / (1.0f + expf(-x));
  return (s * 2.0f - 1.0f) * bit_scale;
}

}  // namespace ddp
