// Shared helpers of the port's kernels: f32 <-> storage-type conversion, the
// aligned vector used for 16-byte loads and stores, and loads and stores of
// it with a cache policy.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

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

// the unsigned type of BYTES bytes that one access of a Pack moves
template <int BYTES> struct Bits;
template <> struct Bits<2> { using type = unsigned short; };
template <> struct Bits<4> { using type = unsigned int; };
template <> struct Bits<8> { using type = uint2; };
template <> struct Bits<16> { using type = uint4; };

// through the read-only cache: data that is read again (a table)
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load_ldg(const T* p) {
  using B = typename Bits<sizeof(T) * VEC>::type;
  const B b = __ldg(reinterpret_cast<const B*>(p));
  Pack<T, VEC> r;
  memcpy(&r, &b, sizeof(B));
  return r;
}

// evict first: a stream that is read once
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load_cs(const T* p) {
  using B = typename Bits<sizeof(T) * VEC>::type;
  const B b = __ldcs(reinterpret_cast<const B*>(p));
  Pack<T, VEC> r;
  memcpy(&r, &b, sizeof(B));
  return r;
}

// evict first: an output that this kernel does not read back
template <typename T, int VEC>
__device__ __forceinline__ void store_cs(T* p, const Pack<T, VEC>& v) {
  using B = typename Bits<sizeof(T) * VEC>::type;
  B b;
  memcpy(&b, &v, sizeof(B));
  __stcs(reinterpret_cast<B*>(p), b);
}

// (1 / (1 + exp(-x)) * 2 - 1) * bit_scale in f32: the squash of the
// analog-bits latent, in exactly the plain PyTorch version's form.
__device__ __forceinline__ float squash(float x, float bit_scale) {
  const float s = 1.0f / (1.0f + expf(-x));
  return (s * 2.0f - 1.0f) * bit_scale;
}

}  // namespace ddp
