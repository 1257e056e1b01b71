// K3 `raygen`: per-pixel primary rays from the inverse camera matrix.
//
// Replaces octree_tracer_tpu/render/camera.py:100 `_device_raygen`, in
// pixel order (block = 0) or in block order (block > 0: each block x block
// tile's rays contiguous, row-major within the tile, tiles row-major, the
// order of tracer._pixel_to_block that JAX's beam frames take with
// pre_permuted). Each pixel centre is inverse-projected at clip z = 1, the
// camera origin subtracted and the direction normalised: world_j =
// ((cx*M[j,0] + cy*M[j,1]) + M[j,2]) + M[j,3], the row-by-row order of the
// plain version, with every division IEEE. In block order a thread derives
// each pixel from the output index, as JAX's `_device_raygen` does
// (camera.py:117-126), so the values are the pixel order's, reordered.
//
// What bounds it on the H100: bytes written (12 per pixel, 24.9 MB at
// 1920x1080, 7.4 us at 3.35 TB/s). The arithmetic is close behind: seven IEEE
// divisions and a square root a pixel come to about as many instructions as
// the card can dispatch in that time.
//
// Design: the 16 matrix entries are kernel parameters, passed by value from
// the host, so a launch reads no device memory and needs no host-to-device
// copy. A 2-D grid of row groups and column groups with 32-bit indices; three
// lanes of each warp divide the origin's components and shuffle them to the
// rest; each thread computes four adjacent pixels of one row and writes their
// 48 bytes as three 16-byte stores when the width is a multiple of 4 (each
// group then starts on a 16-byte boundary), one float at a time otherwise.
// One thread writes the origin. What stays between it and its bound: at
// about 100 instructions a pixel (seven IEEE divisions and a square root)
// the instructions take as long to dispatch as the stores take to drain,
// and the two overlap only in part (PERF.md). The block form is a 1-D grid:
// each thread takes four consecutive outputs (one row of a tile when the
// block is a multiple of 4), computes each one's pixel and its own clip y,
// and stores the 48 bytes as three 16-byte stores (the four outputs start
// on a 16-byte boundary), one float at a time at the end of the array.
#include "common.cuh"

namespace {

struct Mat4 {
  float m[16];  // row-major
};

constexpr int kCols = 32;  // threads of a block along a row (4 pixels each)
constexpr int kRows = 8;   // rows of a block

__global__ void __launch_bounds__(kCols * kRows)
raygen_kernel(Mat4 mat, int width, int height, float* __restrict__ origin_out,
              float* __restrict__ dirs) {
  const float* m = mat.m;
  const int y = blockIdx.y * kRows + threadIdx.y;
  const int x0 = 4 * (blockIdx.x * kCols + threadIdx.x);
  // The camera origin: M @ (0, 0, 0, 1), i.e. column 3, over its w; lane j
  // of each warp (one row of the block) divides component j, the shuffles
  // share them.
  const int lane = threadIdx.x;
  const float mine = (lane == 0 ? m[3] : lane == 1 ? m[7] : m[11]) / m[15];
  float origin[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) origin[j] = __shfl_sync(0xffffffffu, mine, j);
  if (y >= height || x0 >= width) return;
  if (x0 == 0 && y == 0) {
#pragma unroll
    for (int j = 0; j < 3; ++j) origin_out[j] = origin[j];
  }
  const float cy = -(((static_cast<float>(y) + 0.5f) / static_cast<float>(height)) * 2.0f - 1.0f);
  float out[12];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float cx =
        ((static_cast<float>(x0 + p) + 0.5f) / static_cast<float>(width)) * 2.0f - 1.0f;
    float world[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      world[j] = ((cx * m[4 * j] + cy * m[4 * j + 1]) + m[4 * j + 2]) + m[4 * j + 3];
    }
    float dir[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) dir[j] = world[j] / world[3] - origin[j];
    const float norm = sqrtf((dir[0] * dir[0] + dir[1] * dir[1]) + dir[2] * dir[2]);
#pragma unroll
    for (int j = 0; j < 3; ++j) out[3 * p + j] = dir[j] / norm;
  }
  float* row = dirs + 3 * (static_cast<int64_t>(y) * width + x0);
  if ((width & 3) == 0) {
    auto* v = reinterpret_cast<float4*>(row);
    v[0] = make_float4(out[0], out[1], out[2], out[3]);
    v[1] = make_float4(out[4], out[5], out[6], out[7]);
    v[2] = make_float4(out[8], out[9], out[10], out[11]);
  } else {
    const int n = 3 * min(4, width - x0);
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      if (k < n) row[k] = out[k];
    }
  }
}

__global__ void __launch_bounds__(kCols * kRows)
raygen_block_kernel(Mat4 mat, int width, int height, int block, float* __restrict__ origin_out,
                    float* __restrict__ dirs) {
  const float* m = mat.m;
  const int n = width * height;  // 3n < 2^31 (the wrapper's check)
  const int i0 = 4 * (blockIdx.x * (kCols * kRows) + threadIdx.x);
  const int lane = threadIdx.x & 31;
  const float mine = (lane == 0 ? m[3] : lane == 1 ? m[7] : m[11]) / m[15];
  float origin[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) origin[j] = __shfl_sync(0xffffffffu, mine, j);
  if (i0 >= n) return;
  if (i0 == 0) {
#pragma unroll
    for (int j = 0; j < 3; ++j) origin_out[j] = origin[j];
  }
  // The pixel of an output: its tile, then its place in the tile. When the
  // block is a multiple of 4 the thread's four outputs are four neighbours
  // in one row of one tile, located once.
  const int lanes = block * block, wb = width / block;
  const bool one_row = (block & 3) == 0;
  int y = 0, x0 = 0;
  float cy_row = 0.0f;
  if (one_row) {
    const int tile = i0 / lanes, in = i0 % lanes;
    y = (tile / wb) * block + in / block;
    x0 = (tile % wb) * block + in % block;
    cy_row = -(((static_cast<float>(y) + 0.5f) / static_cast<float>(height)) * 2.0f - 1.0f);
  }
  float out[12];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    int x = x0 + p;
    float cy = cy_row;
    if (!one_row) {
      const int i = min(i0 + p, n - 1);
      const int tile = i / lanes, in = i % lanes;
      y = (tile / wb) * block + in / block;
      x = (tile % wb) * block + in % block;
      cy = -(((static_cast<float>(y) + 0.5f) / static_cast<float>(height)) * 2.0f - 1.0f);
    }
    const float cx = ((static_cast<float>(x) + 0.5f) / static_cast<float>(width)) * 2.0f - 1.0f;
    float world[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      world[j] = ((cx * m[4 * j] + cy * m[4 * j + 1]) + m[4 * j + 2]) + m[4 * j + 3];
    }
    float dir[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) dir[j] = world[j] / world[3] - origin[j];
    const float norm = sqrtf((dir[0] * dir[0] + dir[1] * dir[1]) + dir[2] * dir[2]);
#pragma unroll
    for (int j = 0; j < 3; ++j) out[3 * p + j] = dir[j] / norm;
  }
  float* row = dirs + 3 * static_cast<int64_t>(i0);
  if (i0 + 4 <= n) {
    auto* v = reinterpret_cast<float4*>(row);
    v[0] = make_float4(out[0], out[1], out[2], out[3]);
    v[1] = make_float4(out[4], out[5], out[6], out[7]);
    v[2] = make_float4(out[8], out[9], out[10], out[11]);
  } else {
    const int k_end = 3 * (n - i0);
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      if (k < k_end) row[k] = out[k];
    }
  }
}

}  // namespace

// m0..m15: the inverse camera matrix f32[4, 4], row-major, by value. Writes
// origin f32[3] and dirs (16-byte aligned): f32[height, width, 3] when block
// is 0, else f32[height * width, 3] in block order (block divides width and
// height). Returns cudaGetLastError().
extern "C" int ot_raygen(float m0, float m1, float m2, float m3, float m4, float m5, float m6,
                         float m7, float m8, float m9, float m10, float m11, float m12,
                         float m13, float m14, float m15, int width, int height, int block,
                         void* origin, void* dirs, void* stream) {
  if (width <= 0 || height <= 0) return 0;
  const Mat4 mat = {{m0, m1, m2, m3, m4, m5, m6, m7, m8, m9, m10, m11, m12, m13, m14, m15}};
  if (block > 0) {
    const int groups = (width * height + 3) / 4;
    const unsigned grid = static_cast<unsigned>((groups + kCols * kRows - 1) / (kCols * kRows));
    raygen_block_kernel<<<grid, kCols * kRows, 0, static_cast<cudaStream_t>(stream)>>>(
        mat, width, height, block, static_cast<float*>(origin), static_cast<float*>(dirs));
    return static_cast<int>(cudaGetLastError());
  }
  const int groups = (width + 3) / 4;
  const dim3 grid((groups + kCols - 1) / kCols, (height + kRows - 1) / kRows);
  raygen_kernel<<<grid, dim3(kCols, kRows), 0, static_cast<cudaStream_t>(stream)>>>(
      mat, width, height, static_cast<float*>(origin), static_cast<float*>(dirs));
  return static_cast<int>(cudaGetLastError());
}
