// K6 `propagate_visits`: one pass of the upward visit closure.
//
// Replaces the XLA fori_loop body of octree_tracer_tpu/adaptive/feedback.py:96
// `propagate_visits`: an interior slot (word != 0, payload < VOXEL_OFFSET)
// with no visits is marked 1 when any slot of its 8-child group has a visit;
// every other slot keeps its value. The group index is clipped into the pool
// and slots past its end read 0, as JAX's padded, clipped gather does.
//
// Passes are Jacobi: a launch reads one buffer and writes the other, so
// every pass is deterministic and equals the plain version pass for pass.
// The host runs one launch per pass, as many passes as the tree is deep.
// What bounds it on the H100: bytes; each slot reads its word and visit, an
// unvisited interior also one 32-byte group row of visits.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(ot::kBlock) propagate_kernel(
    const uint32_t* __restrict__ words, const int32_t* __restrict__ v_in,
    int32_t* __restrict__ v_out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t word = words[i];
  const uint32_t payload = word >> 4;
  int32_t v = v_in[i];
  if (v == 0 && word != 0u && payload < ot::kVoxelOffset) {
    const int64_t rows = (n + 7) / 8;
    const int64_t base = min(static_cast<int64_t>(payload / 8u), rows - 1) * 8;
    bool any = false;
    for (int k = 0; k < 8; ++k) {
      const int64_t c = base + k;
      any = any || (c < n && v_in[c] > 0);
    }
    if (any) v = 1;
  }
  v_out[i] = v;
}

}  // namespace

// One pass: v_out = closure step of v_in (both i32[n], distinct); words
// u32[n]. Returns cudaGetLastError().
extern "C" int ot_propagate_visits(const void* words, int64_t n, const void* v_in,
                                   void* v_out, void* stream) {
  if (n == 0) return 0;
  propagate_kernel<<<ot::blocks_for(n), ot::kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const int32_t*>(v_in),
      static_cast<int32_t*>(v_out), n);
  return static_cast<int>(cudaGetLastError());
}
