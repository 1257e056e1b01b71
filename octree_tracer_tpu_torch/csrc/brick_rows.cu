// K10 `build_bricks`: the brick table and the decorated pool.
//
// Replaces the XLA program of octree_tracer_tpu/render/bricks.py:110
// `build_bricks` (its NumPy twin `build_bricks_np`, :44): for every pool slot,
// whether it is a valid brick root (an interior node, not 0, whose children
// are leaves or have only leaf children), and its brick row: w0 (bit 0 valid,
// bit c + 1 set where child c is a leaf), the 64 occupancy bits of its 4x4x4
// fine cells (bit ccode * 8 + gcode; a coarse leaf fills its 8 bits), its
// children group and four zero words. The decorated word is the slot's word
// with bit 0 set on valid roots; other slots get a zero row.
//
// Reads follow JAX's clamps term for term (bricks.py:60-66): a group pointer
// reads row min(pointer, rows * 8 - 8) / 8 of the pool padded with zero
// words to whole rows, so garbage and hole words read what JAX reads, and a
// word past the pool's end reads 0. Word-0 slots are never decorated.
//
// What bounds it on the H100: bytes. Each slot reads its word and, where it
// is interior, its children's 32-byte row; then, child by child until it is
// known to be no brick root, each interior child's row; and it writes 36
// bytes. The design is simple, one thread a slot: rows are read as two
// 16-byte loads where the pool starts on 16 bytes (element by element in the
// last, partial row), and the brick row is written as two 16-byte stores.
#include "common.cuh"

namespace {

// Row `row` of the pool padded with zero words to whole rows.
__device__ __forceinline__ void load_row(const uint32_t* __restrict__ words, int64_t n,
                                         int64_t row, bool vec, uint32_t out[8]) {
  const int64_t base = row * 8;
  if (vec && base + 8 <= n) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(words + base));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(words + base) + 1);
    out[0] = a.x, out[1] = a.y, out[2] = a.z, out[3] = a.w;
    out[4] = b.x, out[5] = b.y, out[6] = b.z, out[7] = b.w;
  } else {
    for (int k = 0; k < 8; ++k) out[k] = base + k < n ? __ldg(words + base + k) : 0u;
  }
}

__global__ void __launch_bounds__(ot::kBlock) brick_rows_kernel(
    const uint32_t* __restrict__ words, int64_t n, bool vec, uint32_t* __restrict__ dec,
    uint4* __restrict__ rows) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t word = __ldg(words + i);
  const uint32_t payload = word >> 4;
  const int64_t last_row = (n - 1) >> 3;
  bool valid = payload < ot::kVoxelOffset && word != 0u;
  uint32_t w0 = 1u, lo = 0u, hi = 0u;
  if (valid) {
    uint32_t child[8];
    load_row(words, n, min(static_cast<int64_t>(payload >> 3), last_row), vec, child);
    // Unrolled, so the rows stay in registers; a slot stops reading at the
    // first interior child with an interior child.
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (!valid) break;
      const uint32_t cp = child[c] >> 4;
      uint32_t bits;
      if (cp >= ot::kVoxelOffset) {  // a coarse leaf fills its 8 fine cells
        w0 |= 1u << (c + 1);
        bits = cp > ot::kVoxelOffset ? 0xFFu : 0u;
      } else {
        uint32_t grand[8];
        load_row(words, n, min(static_cast<int64_t>(cp >> 3), last_row), vec, grand);
        bits = 0u;
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          const uint32_t gp = grand[g] >> 4;
          valid = valid && gp >= ot::kVoxelOffset;
          bits |= (gp > ot::kVoxelOffset ? 1u : 0u) << g;
        }
      }
      if (c < 4) {
        lo |= bits << (8 * c);
      } else {
        hi |= bits << (8 * (c - 4));
      }
    }
  }
  dec[i] = word | (valid ? 1u : 0u);
  rows[2 * i] = valid ? make_uint4(w0, lo, hi, payload) : make_uint4(0u, 0u, 0u, 0u);
  rows[2 * i + 1] = make_uint4(0u, 0u, 0u, 0u);
}

}  // namespace

// words u32[n] (vec != 0: the pointer is 16-byte aligned); dec u32[n] and
// rows u32[n, 8] (16-byte aligned) out. Returns cudaGetLastError().
extern "C" int ot_brick_rows(const void* words, int64_t n, int vec, void* dec, void* rows,
                             void* stream) {
  if (n == 0) return 0;
  brick_rows_kernel<<<ot::blocks_for(n), ot::kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n, vec != 0, static_cast<uint32_t*>(dec),
      static_cast<uint4*>(rows));
  return static_cast<int>(cudaGetLastError());
}
