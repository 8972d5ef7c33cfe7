// q_sample and the table gradient of its backward, for Hopper.
//
//   q_sample:      out[n, :] = alpha[n] * x0[n, :] + sigma[n] * noise[n, :],
//                  x0[n, :]  = (2 * sigmoid(table[labels[n], :]) - 1) * bit_scale
//   squash_dtable: dtable[k, :] = sum over n with labels[n] == k of
//                  g[n, :] * alpha[n] * 2 * bit_scale * s * (1 - s),
//                  s = sigmoid(table[k, :])
//   dtable:        dtable[k, :] = sum over n with labels[n] == k of demb[n, :]
//
// Replaces ddp_tpu/ops/pallas/q_sample.py:_qsample_kernel (reached through
// _qsample_pallas and fused_q_sample) and :_dtable_kernel (reached through
// _dtable_pallas from the VJPs _encode_bwd and _qs_bwd). The TPU kernels did
// the lookup, and its transpose, as one-hot matmuls on the MXU over a table
// padded to 128 rows and rows padded to 256-row tiles, and carried the dtable
// sum across the sequential TPU grid. None of that carries over.
// squash_dtable is _qs_bwd's (and _encode_bwd's, alpha = 1) table gradient
// and _dtable_kernel in one pass: the JAX package forms demb = g * alpha *
// d x0 / d emb in XLA over [N, C] before the kernel sums it; here the squash's
// derivative depends only on the table entry, so the kernel sums g * alpha by
// label and multiplies each sum by the derivative once. dtable is the same
// kernel without the derivative, the counterpart of _dtable_kernel alone.
//
// q_sample is bound by memory: it reads noise and writes out (N*C elements
// each; 2 x 33.5 MB in f32 at 2 x 512^2, N = 32768, C = 256) and reads the
// small table, labels, alpha and sigma. Design: a coalesced gather (16-byte
// loads and stores where C and the pointers allow, a grid-stride loop that
// masks the ragged end, a scalar instantiation for any C) with two per-row
// scalars and one more stream. The arithmetic is f32 and rounds exactly where
// the plain version's separate multiplies and add do (__fmul_rn / __fadd_rn
// keep the compiler from contracting them into an FMA).
//
// (squash_)dtable is bound by memory too: it reads g once (N*C, 33.5 MB in
// f32, 16.8 MB in bf16) and writes the K*C table. The TPU grid ran in order;
// H100 blocks run in no order, so the sum over rows becomes a reduction
// across blocks, done with atomics. A partial table of floats in shared
// memory would cost one shared-memory float atomicAdd per element, and on
// sm_90 that is a compare-and-swap loop (ATOMS.CAST.SPIN in the SASS), which
// took about half the time of such a kernel. So no thread adds to
// shared floats here: a block owns rows_per_block rows and kChunk columns,
// sorts its rows by label (a counting sort in shared memory with one integer
// atomic per distinct label of a warp), and its row groups walk even slices
// of the sorted rows, kRowUnroll 16-byte loads of g in flight per thread.
// Sorted, a slice is a few runs of one label each; a thread sums a run in
// registers and adds it to the zero-filled output with one float4 reduction
// (red.global.add.v4.f32), times the squash's derivative of those K-table
// entries. So the reductions per block are about the distinct labels of its
// rows plus one per group, for each 16-byte column lane, on random labels as
// on ADE's region maps, and their number does not grow with the rows. g may
// have a row stride (the training path's g is a column slice of the fusion
// conv's input gradient). The cross-block atomic order changes from run to
// run, so the sums differ from a sequential sum in the last bits (hold them
// with a relative tolerance). Labels outside [0, K) contribute nothing and
// are never read outside the table.
//
// C interface (loaded with ctypes): each entry returns cudaGetLastError()
// after its launch; the caller raises if it is not 0.

#include "dtype.cuh"

namespace {

using ddp::from_f32;
using ddp::load_cs;
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

// (squash_)dtable: a block of kThreads threads owns rows_per_block rows and
// kChunk columns. Its row groups (kChunk / VEC column lanes each: f32 g 16
// lanes of float4, bf16 g 8 lanes of 8 values, the scalar path 64 lanes)
// walk even slices of the block's rows sorted by label.
constexpr int kChunk = 64;
constexpr int kThreads = 512;
constexpr int kRowUnroll = 4;

// d x0 / d emb at the table entry x: 2 * bit_scale * s * (1 - s), s = sigmoid(x)
__device__ __forceinline__ float squash_grad(float x, float scale2) {
  const float s = 1.0f / (1.0f + expf(-x));
  return scale2 * s * (1.0f - s);
}

__device__ __forceinline__ float table_at(const void* table, bool bf16, int64_t i) {
  if (bf16) {
    const unsigned short b = __ldg(static_cast<const unsigned short*>(table) + i);
    return __bfloat162float(__ushort_as_bfloat16(b));
  }
  return __ldg(static_cast<const float*>(table) + i);
}

__device__ __forceinline__ void atomic_add4(float* p, float4 v) {
#if __CUDACC_VER_MAJOR__ > 12 || (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 4)
  atomicAdd(reinterpret_cast<float4*>(p), v);  // one vector reduction (sm_90)
#else
  atomicAdd(p, v.x);
  atomicAdd(p + 1, v.y);
  atomicAdd(p + 2, v.z);
  atomicAdd(p + 3, v.w);
#endif
}

// Add the run sum acc of label lab (none if lab < 0) to out[lab, col:col+VEC],
// times the squash's derivative of those table entries when SQUASH.
template <int VEC, bool SQUASH>
__device__ __forceinline__ void add_run(float* out, int lab, const float (&acc)[VEC], int c,
                                        int col, const void* table, bool table_bf16,
                                        float scale2, bool red4) {
  if (lab < 0) return;
  const int64_t o = (int64_t)lab * c + col;
  float w[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    w[j] = acc[j];
    if constexpr (SQUASH) w[j] *= squash_grad(table_at(table, table_bf16, o + j), scale2);
  }
  if constexpr (VEC % 4 == 0) {
    if (red4) {
#pragma unroll
      for (int j = 0; j < VEC; j += 4) {
        atomic_add4(out + o + j, make_float4(w[j], w[j + 1], w[j + 2], w[j + 3]));
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) atomicAdd(out + o + j, w[j]);
}

// row r's label, or -1 outside [0, k) or when !in
__device__ __forceinline__ int row_label(const int64_t* labels, int64_t r, bool in, int k) {
  const int64_t l = in ? __ldg(labels + r) : -1;
  return (l >= 0 && l < k) ? (int)l : -1;
}

template <typename TG, int VEC, bool SQUASH>
__global__ void __launch_bounds__(kThreads, 2)
dtable_kernel(const int64_t* __restrict__ labels, const TG* __restrict__ g, int64_t ld,
              const float* __restrict__ alpha, const void* __restrict__ table,
              bool table_bf16, float* __restrict__ out, int64_t n, int c, int k,
              float scale2, int rows_per_block, bool red4) {
  extern __shared__ int smem[];
  int* start = smem;  // [k + 1]: rows per label, then where each label's rows go
  int2* order = reinterpret_cast<int2*>(smem + ((k + 2) & ~1));  // [rows]: (row - r0, label)
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_block;
  const int rows = (int)min((int64_t)rows_per_block, n - r0);
  const int lane = threadIdx.x & 31;

  // 1. a counting sort of the block's rows by label: the counts (one shared
  // integer atomic per distinct label of a warp) ...
  for (int i = threadIdx.x; i <= k; i += kThreads) start[i] = 0;
  __syncthreads();
  for (int base = 0; base < rows; base += kThreads) {
    const int i = base + threadIdx.x;
    const int lab = row_label(labels, r0 + i, i < rows, k);
    const unsigned same = __match_any_sync(0xffffffffu, lab);
    if (lab >= 0 && lane == __ffs(same) - 1) atomicAdd(&start[lab], __popc(same));
  }
  __syncthreads();
  // ... their exclusive prefix sum, by the first warp (start[k]: all rows) ...
  if (threadIdx.x < 32) {
    int carry = 0;
    for (int b = 0; b <= k; b += 32) {
      const int i = b + lane;
      const int v = i < k ? start[i] : 0;
      int x = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      if (i <= k) start[i] = carry + x - v;
      carry += __shfl_sync(0xffffffffu, x, 31);
    }
  }
  __syncthreads();
  const int valid = start[k];
  // ... and each row placed among its label's rows
  for (int base = 0; base < rows; base += kThreads) {
    const int i = base + threadIdx.x;
    const int lab = row_label(labels, r0 + i, i < rows, k);
    const unsigned same = __match_any_sync(0xffffffffu, lab);
    const int leader = __ffs(same) - 1;
    int pos = 0;
    if (lab >= 0 && lane == leader) pos = atomicAdd(&start[lab], __popc(same));
    pos = __shfl_sync(0xffffffffu, pos, leader);
    if (lab >= 0) order[pos + __popc(same & ((1u << lane) - 1))] = make_int2(i, lab);
  }
  __syncthreads();

  // 2. each row group sums its slice of the sorted rows, run by run of one
  // label in registers, and adds each run to the output
  constexpr int kLanes = kChunk / VEC;
  constexpr int kGroups = kThreads / kLanes;
  const int col = blockIdx.y * kChunk + (threadIdx.x % kLanes) * VEC;
  if (col >= c) return;
  const int group = threadIdx.x / kLanes;
  const int slice = (valid + kGroups - 1) / kGroups;
  const int p1 = min(valid, (group + 1) * slice);
  const TG* gcol = g + r0 * ld + col;
  int run = -1;  // the label whose run acc sums; -1: none
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
  for (int p = group * slice; p < p1; p += kRowUnroll) {
    int lab[kRowUnroll];  // -1: past the slice
    float a[kRowUnroll];
    Pack<TG, VEC> v[kRowUnroll];
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) {
      if (p + u < p1) {
        const int2 e = order[p + u];
        lab[u] = e.y;
        a[u] = alpha != nullptr ? __ldg(alpha + r0 + e.x) : 1.0f;
        v[u] = load_cs<TG, VEC>(gcol + e.x * ld);
      } else {
        lab[u] = -1;
        a[u] = 0.0f;
#pragma unroll
        for (int j = 0; j < VEC; ++j) v[u].v[j] = from_f32<TG>(0.0f);
      }
    }
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) {
      if (lab[u] != run) {
        add_run<VEC, SQUASH>(out, run, acc, c, col, table, table_bf16, scale2, red4);
        run = lab[u];
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = fmaf(to_f32(v[u].v[j]), a[u], acc[j]);
    }
  }
  add_run<VEC, SQUASH>(out, run, acc, c, col, table, table_bf16, scale2, red4);
}

template <typename TG, bool SQUASH>
cudaError_t launch_dtable(const int64_t* labels, const TG* g, int64_t ld, const float* alpha,
                          const void* table, bool table_bf16, float* out, int64_t n,
                          int c, int k, float scale2, int row_blocks, int rows_per_block,
                          cudaStream_t stream) {
  if (c < 1 || k < 1 || ld < c || row_blocks < 1 || rows_per_block < 1 ||
      (int64_t)row_blocks * rows_per_block < n) {
    return cudaErrorInvalidValue;
  }
  constexpr int kVec = 16 / sizeof(TG);
  const bool vec_ok = (c % kVec == 0) && (ld % kVec == 0) &&
                      (reinterpret_cast<uintptr_t>(g) % 16 == 0);
  const bool red4 = (c % 4 == 0) && (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const size_t smem = (size_t)((k + 2) & ~1) * sizeof(int) + (size_t)rows_per_block * 8;
  const dim3 grid((unsigned)row_blocks, (unsigned)((c + kChunk - 1) / kChunk));
  if (smem > 48 * 1024) return cudaErrorInvalidValue;  // the caller keeps it below
  auto go = [&](auto kernel) {
    kernel<<<grid, kThreads, smem, stream>>>(labels, g, ld, alpha, table, table_bf16, out, n,
                                             c, k, scale2, rows_per_block, red4);
    return cudaGetLastError();
  };
  return vec_ok ? go(dtable_kernel<TG, kVec, SQUASH>) : go(dtable_kernel<TG, 1, SQUASH>);
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

// out must be zero-filled [k, c] float32; demb is [n, c] float32. The grid is
// row_blocks x ceil(c / 64) blocks of rows_per_block rows each.
extern "C" int ddp_dtable(const void* labels, const void* demb, void* out, int64_t n,
                          int c, int k, int row_blocks, int rows_per_block, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  return (int)launch_dtable<float, false>(
      static_cast<const int64_t*>(labels), static_cast<const float*>(demb), c, nullptr,
      nullptr, false, static_cast<float*>(out), n, c, k, 0.0f, row_blocks, rows_per_block,
      static_cast<cudaStream_t>(stream));
}

// out must be zero-filled [k, c] float32; g is [n, c] with row stride ld (its
// columns contiguous) and table [k, c], each float32 (dtype 0) or bfloat16
// (1); alpha is [n] float32, or null for 1. The grid is as ddp_dtable's.
extern "C" int ddp_squash_dtable(const void* labels, const void* g, int64_t ld,
                                 const void* alpha, const void* table, void* out, int64_t n,
                                 int c, int k, float bit_scale, int g_dtype, int table_dtype,
                                 int row_blocks, int rows_per_block, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (table_dtype != 0 && table_dtype != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* lab = static_cast<const int64_t*>(labels);
  const float* al = static_cast<const float*>(alpha);
  const bool tb = table_dtype == 1;
  float* o = static_cast<float*>(out);
  const float scale2 = 2.0f * bit_scale;
  if (g_dtype == 0) {
    return (int)launch_dtable<float, true>(lab, static_cast<const float*>(g), ld, al, table,
                                           tb, o, n, c, k, scale2, row_blocks,
                                           rows_per_block, s);
  }
  if (g_dtype == 1) {
    return (int)launch_dtable<__nv_bfloat16, true>(
        lab, static_cast<const __nv_bfloat16*>(g), ld, al, table, tb, o, n, c, k, scale2,
        row_blocks, rows_per_block, s);
  }
  return (int)cudaErrorInvalidValue;
}
