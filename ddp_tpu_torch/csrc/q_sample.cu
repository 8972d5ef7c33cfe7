// q_sample and its table gradient (dtable): the train-step corruption of the
// ground truth, for Hopper.
//
//   q_sample: out[n, :] = alpha[n] * x0[n, :] + sigma[n] * noise[n, :],
//             x0[n, :]  = (2 * sigmoid(table[labels[n], :]) - 1) * bit_scale
//   dtable:   dtable[k, :] = sum over n with labels[n] == k of demb[n, :]
//
// Replaces ddp_tpu/ops/pallas/q_sample.py:_qsample_kernel (reached through
// _qsample_pallas and fused_q_sample) and :_dtable_kernel (reached through
// _dtable_pallas from the VJPs _encode_bwd and _qs_bwd). The TPU kernels did
// the lookup, and its transpose, as one-hot matmuls on the MXU over a table
// padded to 128 rows and rows padded to 256-row tiles, and carried the dtable
// sum across the sequential TPU grid. None of that carries over.
//
// q_sample is bound by memory: it reads noise and writes out (N*C elements
// each; 2 x 33.5 MB in f32 at 2 x 512^2, N = 32768, C = 256) and reads the
// small table, labels, alpha and sigma. Design: encode_map's coalesced gather
// (16-byte loads and stores where C and the pointers allow, a grid-stride
// loop that masks the ragged end, a scalar instantiation for any C) with two
// per-row scalars and one more stream. The arithmetic is f32 and rounds
// exactly where the plain version's separate multiplies and add do
// (__fmul_rn / __fadd_rn keep the compiler from contracting them into an FMA).
//
// dtable is bound by memory too: it reads demb (N*C f32, 33.5 MB) once and
// writes the K*C table. The TPU grid ran in order; H100 blocks run in no
// order, so the sum over rows becomes a reduction across blocks, done with
// atomics: each block owns a contiguous range of rows and a chunk of columns,
// sums its rows into a partial table in shared memory (151 x 256 x 4 B =
// 154.6 KB at ade20k_swin_t, within the 227 KB a block may opt into; wider
// tables are split into column chunks), and folds the partial table into the
// zero-filled output with one global atomicAdd per non-zero entry. ADE label
// maps are large regions of one class, so per-row global atomics would
// serialise on a few addresses; in shared memory the threads of one row group
// own distinct columns, and only the few row groups of a block meet on one
// address. The cross-block atomic order changes from run to run, so the sums
// differ from a sequential sum in the last bits (hold them with a relative
// tolerance). Labels outside [0, K) contribute nothing and are never read
// outside the table.
//
// C interface (loaded with ctypes): each entry returns cudaGetLastError()
// after its launch; the caller raises if it is not 0.

#include "dtype.cuh"

namespace {

using ddp::from_f32;
using ddp::Pack;
using ddp::squash;
using ddp::to_f32;

template <typename T, int VEC>
__global__ void q_sample_kernel(const int64_t* __restrict__ labels,
                                const T* __restrict__ table,
                                const float* __restrict__ alpha,
                                const float* __restrict__ sigma,
                                const T* __restrict__ noise, T* __restrict__ out,
                                int64_t n, int c, int k, float bit_scale) {
  const int cv = c / VEC;
  const int64_t total = n * cv;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int64_t row = i / cv;
    const int col = (int)(i - row * cv) * VEC;
    const int64_t lab = __ldg(labels + row);
    const float a = __ldg(alpha + row);
    const float s = __ldg(sigma + row);
    const Pack<T, VEC> nz = *reinterpret_cast<const Pack<T, VEC>*>(noise + row * c + col);
    Pack<T, VEC> emb;
    const bool in_table = lab >= 0 && lab < k;
    if (in_table) emb = *reinterpret_cast<const Pack<T, VEC>*>(table + lab * c + col);
    Pack<T, VEC> res;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float x0 = in_table ? squash(to_f32(emb.v[j]), bit_scale) : 0.0f;
      res.v[j] = from_f32<T>(__fadd_rn(__fmul_rn(a, x0), __fmul_rn(s, to_f32(nz.v[j]))));
    }
    *reinterpret_cast<Pack<T, VEC>*>(out + row * c + col) = res;
  }
}

template <typename T>
cudaError_t launch_q_sample(const int64_t* labels, const T* table, const float* alpha,
                            const float* sigma, const T* noise, T* out, int64_t n,
                            int c, int k, float bit_scale, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec_ok = (c % kVec == 0) &&
                      (reinterpret_cast<uintptr_t>(table) % 16 == 0) &&
                      (reinterpret_cast<uintptr_t>(noise) % 16 == 0) &&
                      (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const int vec = vec_ok ? kVec : 1;
  const int64_t total = n * (c / vec);
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;  // grid-stride covers the rest
  if (vec_ok) {
    q_sample_kernel<T, kVec><<<(unsigned)blocks, threads, 0, stream>>>(
        labels, table, alpha, sigma, noise, out, n, c, k, bit_scale);
  } else {
    q_sample_kernel<T, 1><<<(unsigned)blocks, threads, 0, stream>>>(
        labels, table, alpha, sigma, noise, out, n, c, k, bit_scale);
  }
  return cudaGetLastError();
}

// dtable: 512 threads = 4 row groups x 128 column lanes. Group g takes rows
// row0 + g, row0 + g + 4, ... of the block's range, 4 rows at a time (their
// loads are issued before their adds, to keep more bytes in flight); lane l
// takes columns c0 + l, c0 + l + 128, ... of the block's column chunk.
constexpr int kLanes = 128;
constexpr int kGroups = 4;
constexpr int kRowUnroll = 4;

__global__ void __launch_bounds__(kLanes * kGroups)
dtable_kernel(const int64_t* __restrict__ labels, const float* __restrict__ demb,
              float* __restrict__ out, int64_t n, int c, int k, int64_t rows_per_block,
              int chunk) {
  extern __shared__ float part[];  // [k, width] partial table
  const int c0 = blockIdx.y * chunk;
  const int width = min(chunk, c - c0);
  for (int i = threadIdx.x; i < k * width; i += blockDim.x) part[i] = 0.0f;
  __syncthreads();

  const int lane = threadIdx.x % kLanes;
  const int group = threadIdx.x / kLanes;
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_block;
  const int64_t r1 = min(n, r0 + rows_per_block);
  constexpr int kStep = kGroups * kRowUnroll;
  for (int64_t base = r0 + group; base < r1; base += kStep) {
    int64_t lab[kRowUnroll];
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) {
      const int64_t row = base + (int64_t)u * kGroups;
      lab[u] = row < r1 ? __ldg(labels + row) : -1;
    }
    for (int col = lane; col < width; col += kLanes) {
      float v[kRowUnroll];
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u) {
        const int64_t row = base + (int64_t)u * kGroups;
        v[u] = (lab[u] >= 0 && lab[u] < k) ? __ldg(demb + row * c + c0 + col) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u) {
        if (lab[u] >= 0 && lab[u] < k) atomicAdd(&part[lab[u] * width + col], v[u]);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < k * width; i += blockDim.x) {
    const float v = part[i];
    if (v != 0.0f) atomicAdd(&out[(int64_t)(i / width) * c + c0 + i % width], v);
  }
}

cudaError_t launch_dtable(const int64_t* labels, const float* demb, float* out, int64_t n,
                          int c, int k, cudaStream_t stream) {
  int dev = 0, sms = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  // widest column chunk whose partial table fits in shared memory
  int chunk = c;
  const int64_t per_col = (int64_t)k * sizeof(float);
  if (per_col * chunk > max_smem) chunk = (int)(max_smem / per_col);
  if (chunk < 1) return cudaErrorInvalidValue;  // K alone exceeds shared memory
  const int col_chunks = (c + chunk - 1) / chunk;
  const size_t smem = (size_t)per_col * chunk;
  err = cudaFuncSetAttribute(dtable_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  // about one resident block per SM in all: each block pays a zero fill and
  // a fold of its partial table, so fewer, longer blocks are cheaper
  int64_t row_blocks = (sms + col_chunks - 1) / col_chunks;
  const int64_t min_rows = 256;  // keep the fill and fold small beside the rows
  if (row_blocks * min_rows > n) row_blocks = (n + min_rows - 1) / min_rows;
  if (row_blocks < 1) row_blocks = 1;
  const int64_t rows_per_block = (n + row_blocks - 1) / row_blocks;
  dim3 grid((unsigned)row_blocks, (unsigned)col_chunks);
  dtable_kernel<<<grid, kLanes * kGroups, smem, stream>>>(labels, demb, out, n, c, k,
                                                          rows_per_block, chunk);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (table, noise and out share it); alpha and
// sigma are float32.
extern "C" int ddp_q_sample(const void* labels, const void* table, const void* alpha,
                            const void* sigma, const void* noise, void* out, int64_t n,
                            int c, int k, float bit_scale, int dtype, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* lab = static_cast<const int64_t*>(labels);
  const float* al = static_cast<const float*>(alpha);
  const float* si = static_cast<const float*>(sigma);
  if (dtype == 0) {
    return (int)launch_q_sample<float>(lab, static_cast<const float*>(table), al, si,
                                       static_cast<const float*>(noise),
                                       static_cast<float*>(out), n, c, k, bit_scale, s);
  }
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    return (int)launch_q_sample<bf>(lab, static_cast<const bf*>(table), al, si,
                                    static_cast<const bf*>(noise), static_cast<bf*>(out),
                                    n, c, k, bit_scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

// out must be zero-filled [k, c] float32; demb is [n, c] float32.
extern "C" int ddp_dtable(const void* labels, const void* demb, void* out, int64_t n,
                          int c, int k, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  return (int)launch_dtable(static_cast<const int64_t*>(labels),
                            static_cast<const float*>(demb), static_cast<float*>(out), n,
                            c, k, static_cast<cudaStream_t>(stream));
}
