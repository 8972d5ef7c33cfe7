// Host-side native ops for the lidar branch: hard voxelization and
// sparse-convolution rulebook construction (a copy of the JAX package's
// ddp_tpu/native/sparse_ops.cpp; the code is the same, so the rulebooks are
// the same bit for bit).
//
// Host equivalents of the reference's CUDA kernels (studied, not copied):
//   - bev/mmdet3d/ops/voxel/src/voxelization_cuda.cu (hard voxelize:
//     quantize points, cap points-per-voxel and voxel count)
//   - bev/mmdet3d/ops/spconv rulebook ("indice pairs") construction for
//     SubMConv3d and strided SparseConv3d
//
// Design: the device side wants static shapes (a CUDA graph captures fixed
// sizes), so everything here emits fixed-capacity arrays with -1 sentinels;
// gathers on the device route -1 to a zero pad row. Rulebooks are "one
// source per (output, kernel-offset)" index maps: gather[k*V_cap + o] = input
// voxel index or -1. This is exact for sparse convolution (a given output
// cell sees at most one input cell per kernel offset).
//
// Build: ddp_tpu_torch/native/__init__.py runs
//   g++ -O3 -shared -fPIC -std=c++17 -o <_build>/libsparse_ops_<hash>.so sparse_ops.cpp
// ABI: plain C ints/floats/int32/float32 buffers (ctypes-friendly).

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct Key3 {
  int32_t x, y, z;
  bool operator==(const Key3 &o) const { return x == o.x && y == o.y && z == o.z; }
};

struct Key3Hash {
  size_t operator()(const Key3 &k) const {
    // 3-int mix (splitmix-style)
    uint64_t h = (uint64_t)(uint32_t)k.x;
    h = h * 0x9E3779B97F4A7C15ull ^ (uint64_t)(uint32_t)k.y;
    h = h * 0xC2B2AE3D27D4EB4Full ^ (uint64_t)(uint32_t)k.z;
    h ^= h >> 29;
    return (size_t)h;
  }
};

using CoordMap = std::unordered_map<Key3, int32_t, Key3Hash>;

}  // namespace

extern "C" {

// Hard voxelization.
//   points:    [n_points, n_feat] float32, first 3 feats are (x, y, z)
//   range:     [6] float32 (xmin, ymin, zmin, xmax, ymax, zmax)
//   voxel_sz:  [3] float32
//   voxels:    out [max_voxels, max_points, n_feat] float32 (zero padded)
//   coords:    out [max_voxels, 3] int32 (x, y, z cell indices)
//   num_per_voxel: out [max_voxels] int32
// Returns the number of voxels actually produced (<= max_voxels).
int32_t hard_voxelize(const float *points, int64_t n_points, int32_t n_feat,
                      const float *range, const float *voxel_sz,
                      int32_t max_points, int32_t max_voxels, float *voxels,
                      int32_t *coords, int32_t *num_per_voxel) {
  CoordMap map;
  map.reserve((size_t)max_voxels * 2);
  std::memset(num_per_voxel, 0, sizeof(int32_t) * max_voxels);
  int32_t n_voxels = 0;
  const int32_t nx = (int32_t)((range[3] - range[0]) / voxel_sz[0] + 0.5f);
  const int32_t ny = (int32_t)((range[4] - range[1]) / voxel_sz[1] + 0.5f);
  const int32_t nz = (int32_t)((range[5] - range[2]) / voxel_sz[2] + 0.5f);

  for (int64_t i = 0; i < n_points; ++i) {
    const float *p = points + i * n_feat;
    int32_t cx = (int32_t)((p[0] - range[0]) / voxel_sz[0]);
    int32_t cy = (int32_t)((p[1] - range[1]) / voxel_sz[1]);
    int32_t cz = (int32_t)((p[2] - range[2]) / voxel_sz[2]);
    if (p[0] < range[0] || p[1] < range[1] || p[2] < range[2]) continue;
    if (cx < 0 || cx >= nx || cy < 0 || cy >= ny || cz < 0 || cz >= nz) continue;
    Key3 key{cx, cy, cz};
    auto it = map.find(key);
    int32_t vid;
    if (it == map.end()) {
      if (n_voxels >= max_voxels) continue;
      vid = n_voxels++;
      map.emplace(key, vid);
      coords[vid * 3 + 0] = cx;
      coords[vid * 3 + 1] = cy;
      coords[vid * 3 + 2] = cz;
    } else {
      vid = it->second;
    }
    int32_t cnt = num_per_voxel[vid];
    if (cnt < max_points) {
      std::memcpy(voxels + ((int64_t)vid * max_points + cnt) * n_feat, p,
                  sizeof(float) * n_feat);
      num_per_voxel[vid] = cnt + 1;
    }
  }
  return n_voxels;
}

// Submanifold rulebook: output sites == input sites.
//   coords: [n_voxels, 3] int32
//   kernel: cubic kernel edge (e.g. 3) — offsets in [-(k/2), k/2]
//   gather: out [kernel^3, cap] int32, gather[k, o] = input idx at
//           coords[o] + offset_k, or -1. Rows o >= n_voxels are -1.
void build_subm_rulebook(const int32_t *coords, int32_t n_voxels, int32_t cap,
                         int32_t kernel, int32_t *gather) {
  CoordMap map;
  map.reserve((size_t)n_voxels * 2);
  for (int32_t i = 0; i < n_voxels; ++i) {
    map.emplace(Key3{coords[i * 3], coords[i * 3 + 1], coords[i * 3 + 2]}, i);
  }
  const int32_t r = kernel / 2;
  const int32_t K = kernel * kernel * kernel;
  for (int64_t i = 0; i < (int64_t)K * cap; ++i) gather[i] = -1;
  int32_t k = 0;
  for (int32_t dx = -r; dx <= r; ++dx) {
    for (int32_t dy = -r; dy <= r; ++dy) {
      for (int32_t dz = -r; dz <= r; ++dz, ++k) {
        int32_t *row = gather + (int64_t)k * cap;
        for (int32_t o = 0; o < n_voxels; ++o) {
          Key3 key{coords[o * 3] + dx, coords[o * 3 + 1] + dy,
                   coords[o * 3 + 2] + dz};
          auto it = map.find(key);
          if (it != map.end()) row[o] = it->second;
        }
      }
    }
  }
}

// Strided sparse conv rulebook (SparseConv3d, kernel k, stride s, padding p).
// Output sites: every cell o with o*s + k_off - p hitting an input site, with
// the output grid bounded by out_dim = (in_dim + 2p - k) / s + 1 per axis.
//   coords:      [n_voxels, 3] int32 input sites
//   in_shape:    [3] int32 input grid dims
//   out_coords:  out [cap, 3] int32 (valid rows first)
//   gather:      out [k^3, cap] int32 (-1 = no contribution)
// Returns number of output voxels (<= cap; overflow dropped).
int32_t build_sparse_rulebook(const int32_t *coords, int32_t n_voxels,
                              const int32_t *in_shape, int32_t kernel,
                              int32_t stride, int32_t pad, int32_t cap,
                              int32_t *out_coords, int32_t *gather) {
  int32_t out_dim[3];
  for (int i = 0; i < 3; ++i)
    out_dim[i] = (in_shape[i] + 2 * pad - kernel) / stride + 1;

  const int32_t K = kernel * kernel * kernel;
  for (int64_t i = 0; i < (int64_t)K * cap; ++i) gather[i] = -1;

  CoordMap out_map;
  out_map.reserve((size_t)n_voxels * 2);
  int32_t n_out = 0;

  // pairs: for each input voxel and each kernel offset, find the output cell
  // it contributes to: out = (in + pad - off) / stride if divisible & in range
  int32_t k = 0;
  for (int32_t dx = 0; dx < kernel; ++dx) {
    for (int32_t dy = 0; dy < kernel; ++dy) {
      for (int32_t dz = 0; dz < kernel; ++dz, ++k) {
        int32_t *row = gather + (int64_t)k * cap;
        for (int32_t i = 0; i < n_voxels; ++i) {
          int32_t ix = coords[i * 3] + pad - dx;
          int32_t iy = coords[i * 3 + 1] + pad - dy;
          int32_t iz = coords[i * 3 + 2] + pad - dz;
          if (ix < 0 || iy < 0 || iz < 0) continue;
          if (ix % stride || iy % stride || iz % stride) continue;
          int32_t ox = ix / stride, oy = iy / stride, oz = iz / stride;
          if (ox >= out_dim[0] || oy >= out_dim[1] || oz >= out_dim[2]) continue;
          Key3 key{ox, oy, oz};
          auto it = out_map.find(key);
          int32_t oid;
          if (it == out_map.end()) {
            if (n_out >= cap) continue;
            oid = n_out++;
            out_map.emplace(key, oid);
            out_coords[oid * 3 + 0] = ox;
            out_coords[oid * 3 + 1] = oy;
            out_coords[oid * 3 + 2] = oz;
          } else {
            oid = it->second;
          }
          row[oid] = i;
        }
      }
    }
  }
  return n_out;
}

// Anisotropic-kernel variant of build_sparse_rulebook (e.g. the reference's
// conv_out with kernel (1,1,3), stride (1,1,2)). kernel/stride/pad are [3].
int32_t build_sparse_rulebook_aniso(const int32_t *coords, int32_t n_voxels,
                                    const int32_t *in_shape,
                                    const int32_t *kernel,
                                    const int32_t *stride, const int32_t *pad,
                                    int32_t cap, int32_t *out_coords,
                                    int32_t *gather) {
  int32_t out_dim[3];
  for (int i = 0; i < 3; ++i)
    out_dim[i] = (in_shape[i] + 2 * pad[i] - kernel[i]) / stride[i] + 1;
  const int32_t K = kernel[0] * kernel[1] * kernel[2];
  for (int64_t i = 0; i < (int64_t)K * cap; ++i) gather[i] = -1;

  CoordMap out_map;
  out_map.reserve((size_t)n_voxels * 2);
  int32_t n_out = 0;
  int32_t k = 0;
  for (int32_t dx = 0; dx < kernel[0]; ++dx) {
    for (int32_t dy = 0; dy < kernel[1]; ++dy) {
      for (int32_t dz = 0; dz < kernel[2]; ++dz, ++k) {
        int32_t *row = gather + (int64_t)k * cap;
        for (int32_t i = 0; i < n_voxels; ++i) {
          int32_t ix = coords[i * 3] + pad[0] - dx;
          int32_t iy = coords[i * 3 + 1] + pad[1] - dy;
          int32_t iz = coords[i * 3 + 2] + pad[2] - dz;
          if (ix < 0 || iy < 0 || iz < 0) continue;
          if (ix % stride[0] || iy % stride[1] || iz % stride[2]) continue;
          int32_t ox = ix / stride[0], oy = iy / stride[1], oz = iz / stride[2];
          if (ox >= out_dim[0] || oy >= out_dim[1] || oz >= out_dim[2]) continue;
          Key3 key{ox, oy, oz};
          auto it = out_map.find(key);
          int32_t oid;
          if (it == out_map.end()) {
            if (n_out >= cap) continue;
            oid = n_out++;
            out_map.emplace(key, oid);
            out_coords[oid * 3 + 0] = ox;
            out_coords[oid * 3 + 1] = oy;
            out_coords[oid * 3 + 2] = oz;
          } else {
            oid = it->second;
          }
          row[oid] = i;
        }
      }
    }
  }
  return n_out;
}

}  // extern "C"
