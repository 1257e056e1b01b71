// K2 `warp_occupancy`: the warp table and the cell occupancy in one pass.
//
// Replaces octree_tracer_tpu/render/tracer.py:2859 `build_warp_table` and
// octree_tracer_tpu/render/skip.py:66 `occupancy_from_pool`. Both run the same
// descent: from the root toward each cell centre of the 2^L grid, at most L
// levels (strict '>'), stopping above leaves. The warp word is
// (node << 5) | depth of where the descent stopped; the cell is occupied
// unless the last word fetched is an empty leaf.
//
// What bounds it on the H100: bytes. Each cell makes at most L dependent
// 4-byte pool loads and writes 5 bytes; neighbouring cells share the top of
// their paths, so most loads hit L1/L2. The simple design: one thread per
// cell, no shared memory.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(ot::kBlock)
warp_occupancy_kernel(const uint32_t* __restrict__ words, int64_t n_words, int levels,
                      uint32_t* __restrict__ warp, uint8_t* __restrict__ occ) {
  const int64_t n = static_cast<int64_t>(1) << (3 * levels);
  const int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c >= n) return;
  const int side = 1 << levels;
  const int cell[3] = {static_cast<int>(c >> (2 * levels)),
                       static_cast<int>(c >> levels) & (side - 1),
                       static_cast<int>(c) & (side - 1)};
  const float cw = 2.0f / static_cast<float>(side);
  float centre[3], pos[3] = {0.0f, 0.0f, 0.0f};
  for (int k = 0; k < 3; ++k) {
    centre[k] = (static_cast<float>(cell[k]) + 0.5f) * cw - 1.0f;
  }
  int32_t node = 0, depth = 0;
  uint32_t word = 0;
  // Once a leaf is reached, JAX's remaining scan steps refetch the same
  // word, so stopping there gives the same result.
  for (int it = 0; it < levels; ++it) {
    bool pb[3];
    for (int k = 0; k < 3; ++k) pb[k] = centre[k] > pos[k];
    const int64_t idx = node + pb[0] * 4 + pb[1] * 2 + pb[2];
    word = words[idx < n_words ? idx : n_words - 1];  // clamped, as JAX's gather
    const uint32_t payload = word >> 4;
    if (payload >= ot::kVoxelOffset) break;
    const float step = ot::pow2(-(depth + 1));
    for (int k = 0; k < 3; ++k) pos[k] = pos[k] + (pb[k] ? step : -step);
    node = static_cast<int32_t>(payload);
    ++depth;
  }
  warp[c] = (static_cast<uint32_t>(node) << 5) | static_cast<uint32_t>(depth);
  occ[c] = (word >> 4) != ot::kVoxelOffset;
}

}  // namespace

// Fills warp u32[8^levels] and occ bool[8^levels]; returns cudaGetLastError().
extern "C" int ot_warp_occupancy(const void* words, int64_t n_words, int levels, void* warp,
                                 void* occ, void* stream) {
  const int64_t n = static_cast<int64_t>(1) << (3 * levels);
  warp_occupancy_kernel<<<ot::blocks_for(n), ot::kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n_words, levels, static_cast<uint32_t*>(warp),
      static_cast<uint8_t*>(occ));
  return static_cast<int>(cudaGetLastError());
}
