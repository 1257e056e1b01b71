// Definitions shared by the port's CUDA kernels.
//
// Every kernel is built by kernels.py with --fmad=false and without
// --use_fast_math: no multiply-add is contracted, and division, sqrtf and
// powf keep their IEEE/libdevice accuracy, so each expression rounds as the
// separately-rounded JAX and PyTorch expressions it mirrors. K3 and K4 are
// elementwise and could be Triton; they are CUDA so that this single build
// governs the rounding of every kernel, and so that K4's powf calls are the
// same libdevice powf that PyTorch's CUDA pow uses.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ot {

// A node payload (word >> 4) at or above this is a leaf; equal means empty
// (octree_tracer_tpu/core/voxel.py VOXEL_OFFSET).
constexpr uint32_t kVoxelOffset = 1u << 27;

constexpr int kBlock = 256;

inline unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kBlock - 1) / kBlock);
}

// 2^e as a float for a normal power, -126 <= e <= 127, built from its
// exponent bits: exact. Out of that range the field wraps (0 at -127, -inf
// at -128), so callers keep e inside it; K1's descent halves its cell size
// level by level instead (csrc/trace.cu).
__device__ __forceinline__ float pow2(int e) { return __int_as_float((e + 127) << 23); }

// 2^e for any e <= 127, as the plain versions' `_pow2`: exact down to the
// subnormal 2^-149, 0 below.
__device__ __forceinline__ float pow2_exact(int e) {
  if (e >= -126) return pow2(e);
  return e >= -149 ? __int_as_float(1 << (e + 149)) : 0.0f;
}

}  // namespace ot
