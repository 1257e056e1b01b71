// K3 `raygen`: per-pixel primary rays from the inverse camera matrix.
//
// Replaces octree_tracer_tpu/render/camera.py:100 `_device_raygen` with
// block = 0 (pixel order; the block-major order was a TPU layout). Each pixel
// centre is inverse-projected at clip z = 1, the camera origin subtracted and
// the direction normalised: world_j = ((cx*M[j,0] + cy*M[j,1]) + M[j,2]) +
// M[j,3], the row-by-row order of the plain version.
//
// What bounds it on the H100: bytes written (12 per pixel); the arithmetic is
// a few dozen flops a pixel. The simple design: one thread per pixel, the 16
// matrix entries read through the read-only cache.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(ot::kBlock)
raygen_kernel(const float* __restrict__ m, int width, int height,
              float* __restrict__ origin_out, float* __restrict__ dirs) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<int64_t>(width) * height) return;
  const int x = static_cast<int>(i % width);
  const int y = static_cast<int>(i / width);
  // The camera origin: M @ (0, 0, 0, 1), i.e. column 3, over its w.
  float origin[3];
  for (int j = 0; j < 3; ++j) origin[j] = m[4 * j + 3] / m[15];
  if (i == 0) {
    for (int j = 0; j < 3; ++j) origin_out[j] = origin[j];
  }
  const float cx = ((static_cast<float>(x) + 0.5f) / static_cast<float>(width)) * 2.0f - 1.0f;
  const float cy = -(((static_cast<float>(y) + 0.5f) / static_cast<float>(height)) * 2.0f - 1.0f);
  float world[4];
  for (int j = 0; j < 4; ++j) {
    world[j] = ((cx * m[4 * j] + cy * m[4 * j + 1]) + m[4 * j + 2]) + m[4 * j + 3];
  }
  float dir[3];
  for (int j = 0; j < 3; ++j) dir[j] = world[j] / world[3] - origin[j];
  const float norm = sqrtf((dir[0] * dir[0] + dir[1] * dir[1]) + dir[2] * dir[2]);
  for (int j = 0; j < 3; ++j) dirs[3 * i + j] = dir[j] / norm;
}

}  // namespace

// camera_inverse: f32[4, 4] row-major on the device. Writes origin f32[3] and
// dirs f32[height, width, 3]; returns cudaGetLastError().
extern "C" int ot_raygen(const void* camera_inverse, int width, int height,
                         void* origin, void* dirs, void* stream) {
  const int64_t n = static_cast<int64_t>(width) * height;
  if (n == 0) return 0;
  raygen_kernel<<<ot::blocks_for(n), ot::kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(camera_inverse), width, height,
      static_cast<float*>(origin), static_cast<float*>(dirs));
  return static_cast<int>(cudaGetLastError());
}
