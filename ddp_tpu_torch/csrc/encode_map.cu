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
// element. Design: a coalesced gather-and-squash with no index arithmetic
// beyond adds and multiplies. A block is lanes x rows threads: the lanes
// cover one row's 16-byte vectors (64 of them at C = 256 in f32, 32 in bf16)
// and each thread takes kRows rows, a block-height apart, whose labels and
// table vectors it loads before any of its stores, so kRows loads are in
// flight per thread. The grid is fixed by the caller (the SMs times the
// blocks one SM holds) and strides over the rows. The table stays in L2
// (every row re-reads it); the output is written with evict-first stores
// (st.global.cs) so that it does not push the table out. A scalar
// instantiation takes any C and unaligned pointers; the ragged end of N is
// masked. (A variant that squashed each block's slice of the table once into
// shared memory and streamed from there was slower on the H100: the squash
// is not what bounds this kernel.) The math is f32 in exactly the plain
// version's form (1 / (1 + exp(-x)), then * 2 - 1, then * bit_scale) so that
// the two agree to the last ulp of expf.
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
using ddp::load_ldg;
using ddp::Pack;
using ddp::squash;
using ddp::store_cs;
using ddp::to_f32;

constexpr int kThreads = 256;
constexpr int kRows = 4;  // rows in flight per thread

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
encode_map_kernel(const int64_t* __restrict__ labels, const T* __restrict__ table,
                  T* __restrict__ out, int64_t n, int c, int k, float bit_scale) {
  const int cv = c / VEC;  // vectors per row
  const int64_t step = (int64_t)blockDim.y * kRows;
  for (int64_t row0 = (int64_t)blockIdx.x * step + threadIdx.y; row0 < n;
       row0 += (int64_t)gridDim.x * step) {
    int64_t lab[kRows];  // -1: outside the table, or past the end
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int64_t row = row0 + (int64_t)u * blockDim.y;
      const int64_t l = row < n ? __ldg(labels + row) : -1;
      lab[u] = (l >= 0 && l < k) ? l : -1;
    }
    for (int v = threadIdx.x; v < cv; v += blockDim.x) {
      Pack<T, VEC> src[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        if (lab[u] >= 0) src[u] = load_ldg<T, VEC>(table + lab[u] * c + v * VEC);
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int64_t row = row0 + (int64_t)u * blockDim.y;
        if (row >= n) continue;
        Pack<T, VEC> res;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          res.v[j] = from_f32<T>(lab[u] >= 0 ? squash(to_f32(src[u].v[j]), bit_scale) : 0.0f);
        }
        store_cs<T, VEC>(out + row * c + v * VEC, res);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const int64_t* labels, const T* table, T* out, int64_t n, int c,
                   int k, float bit_scale, int max_blocks, cudaStream_t stream) {
  if (c < 1 || max_blocks < 1) return cudaErrorInvalidValue;
  constexpr int kVec = 16 / sizeof(T);  // one 16-byte access per thread and row
  const bool vec_ok = (c % kVec == 0) &&
                      (reinterpret_cast<uintptr_t>(table) % 16 == 0) &&
                      (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const int cv = c / (vec_ok ? kVec : 1);
  const int lanes = cv >= kThreads ? kThreads : (cv + 31) / 32 * 32;
  const dim3 block(lanes, kThreads / lanes);
  const int64_t step = (int64_t)block.y * kRows;
  int64_t blocks = (n + step - 1) / step;
  if (blocks > max_blocks) blocks = max_blocks;  // the rows loop covers the rest
  if (vec_ok) {
    encode_map_kernel<T, kVec><<<(unsigned)blocks, block, 0, stream>>>(labels, table, out,
                                                                       n, c, k, bit_scale);
  } else {
    encode_map_kernel<T, 1><<<(unsigned)blocks, block, 0, stream>>>(labels, table, out, n,
                                                                     c, k, bit_scale);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (table and output share it). max_blocks:
// the grid's size at most (the caller passes the SMs times the blocks of
// kThreads that one SM holds).
extern "C" int ddp_encode_map(const void* labels, const void* table, void* out,
                              int64_t n, int c, int k, float bit_scale,
                              int dtype, int max_blocks, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* lab = static_cast<const int64_t*>(labels);
  if (dtype == 0) {
    return (int)launch<float>(lab, static_cast<const float*>(table),
                              static_cast<float*>(out), n, c, k, bit_scale, max_blocks, s);
  }
  if (dtype == 1) {
    return (int)launch<__nv_bfloat16>(
        lab, static_cast<const __nv_bfloat16*>(table),
        static_cast<__nv_bfloat16*>(out), n, c, k, bit_scale, max_blocks, s);
  }
  return (int)cudaErrorInvalidValue;
}
