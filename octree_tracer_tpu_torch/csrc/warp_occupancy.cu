// K2 `warp_occupancy`: the warp table and the cell occupancy in one pass.
//
// Replaces octree_tracer_tpu/render/tracer.py:2859 `build_warp_table` and
// octree_tracer_tpu/render/skip.py:66 `occupancy_from_pool`. Both run the same
// descent: from the root toward each cell centre of the 2^L grid, at most L
// levels (strict '>'), stopping above leaves. The warp word is
// (node << 5) | depth of where the descent stopped; the cell is occupied
// unless the last word fetched is an empty leaf. Each fetch is JAX's row
// gather: word `child` of row min(node / 8, rows - 1) of the pool padded
// with zero words to whole rows (XLA clamps the row, not the word).
//
// What bounds it on the H100: the 5 bytes a cell it writes (10.5 MB at
// L7); the pool sectors the descents read add a few percent
// (tracer.k2_bytes). The descent is integer: the child at depth d is bit
// L-1-d of the cell's coordinates. (A cell centre is an odd multiple of
// 2^-L, a node centre at depth d < L a multiple of 2^-d; both are exact in
// f32 for L <= 9 and never equal, so JAX's `centre > node_pos` is that
// bit.) The design, with no shared memory, a thread for the 2x2x4 cells of
// one level-(L-2) cell:
// - the sixteen cells share their descent down to depth L-2, which the
//   thread walks once; there the two halves' words lie side by side in one
//   row, and each half that goes on reads one 32-byte row (two 16-byte
//   loads) for its last level, the two halves' loads in flight together;
// - a warp's threads lie side by side along z, so each store of warp words
//   (16 bytes a lane) or of flags (4 bytes a lane) covers 512 or 128
//   contiguous bytes.
// What it waits on: the chain of L-1 dependent loads before a thread's
// stores, and the stores themselves (PERF.md: one fill_ of the same bytes
// takes most of K2's time).
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = ot::kBlock;

// Word `child` of row min(node / 8, last_row), 0 past the pool's end.
__device__ __forceinline__ uint32_t read_child(const uint32_t* __restrict__ words,
                                               int32_t n_words, int32_t last_row,
                                               int32_t node, int child) {
  const int32_t at = (min(node >> 3, last_row) << 3) | child;
  return at < n_words ? __ldg(words + at) : 0u;
}

// The eight cells below a node at depth L-1, from its row of children.
__device__ __forceinline__ void last_level(const uint32_t* __restrict__ words, int32_t n_words,
                                           int32_t last_row, int32_t node, int levels,
                                           uint32_t w[8], bool o[8]) {
  const int32_t base = min(node >> 3, last_row) << 3;
  uint32_t row[8];
  if (base + 8 <= n_words && (reinterpret_cast<uintptr_t>(words) & 15) == 0) {
    const uint4 lo = __ldg(reinterpret_cast<const uint4*>(words + base));
    const uint4 hi = __ldg(reinterpret_cast<const uint4*>(words + base) + 1);
    row[0] = lo.x, row[1] = lo.y, row[2] = lo.z, row[3] = lo.w;
    row[4] = hi.x, row[5] = hi.y, row[6] = hi.z, row[7] = hi.w;
  } else {
    for (int c = 0; c < 8; ++c) row[c] = base + c < n_words ? __ldg(words + base + c) : 0u;
  }
  const uint32_t stay = (static_cast<uint32_t>(node) << 5) | static_cast<uint32_t>(levels - 1);
  for (int c = 0; c < 8; ++c) {
    const uint32_t payload = row[c] >> 4;
    w[c] = payload < ot::kVoxelOffset ? (payload << 5) | static_cast<uint32_t>(levels) : stay;
    o[c] = payload != ot::kVoxelOffset;
  }
}

// levels >= 2: a thread takes the cells (2qx + i, 2qy + j, 4qz + 2h + k),
// i, j, h, k < 2; half h is the octet below the level-(L-1) cell
// (qx, qy, 2qz + h).
__global__ void __launch_bounds__(kThreads)
warp_occupancy_kernel(const uint32_t* __restrict__ words, int32_t n_words, int levels,
                      uint32_t* __restrict__ warp, uint8_t* __restrict__ occ) {
  const int lq = levels - 1, lz = levels - 2;
  const int32_t q = static_cast<int32_t>(blockIdx.x * blockDim.x + threadIdx.x);
  if (q >= (1 << (3 * lq - 1))) return;
  const int32_t qx = q >> (lq + lz), qy = (q >> lz) & ((1 << lq) - 1), qz = q & ((1 << lz) - 1);
  const int32_t last_row = (n_words - 1) >> 3;

  // Depths 0 .. L-3, along bit L-1-d of x = 2qx + i (bit L-2-d of qx), of
  // y, and of z = 4qz + 2h + k (bit L-3-d of qz).
  int32_t node = 0, depth = 0;
  uint32_t word = 0;
  bool leaf = false;
  for (; depth < lz; ++depth) {
    const int b = lz - depth;
    const int child = (((qx >> b) & 1) << 2) | (((qy >> b) & 1) << 1) | ((qz >> (b - 1)) & 1);
    word = read_child(words, n_words, last_row, node, child);
    if ((word >> 4) >= ot::kVoxelOffset) {
      leaf = true;
      break;
    }
    node = static_cast<int32_t>(word >> 4);
  }

  uint32_t w[2][8];
  bool o[2][8];
  if (leaf) {  // a leaf above depth L-2 decides all sixteen cells
    const uint32_t stay = (static_cast<uint32_t>(node) << 5) | static_cast<uint32_t>(depth);
    const bool filled = (word >> 4) != ot::kVoxelOffset;
    for (int h = 0; h < 2; ++h) {
      for (int c = 0; c < 8; ++c) w[h][c] = stay, o[h][c] = filled;
    }
  } else {  // depth L-2: the halves' words are children c0 and c0 + 1 of one row
    const int c0 = ((qx & 1) << 2) | ((qy & 1) << 1);
    const uint32_t half[2] = {read_child(words, n_words, last_row, node, c0),
                              read_child(words, n_words, last_row, node, c0 | 1)};
    const uint32_t stay = (static_cast<uint32_t>(node) << 5) | static_cast<uint32_t>(lz);
    for (int h = 0; h < 2; ++h) {
      const uint32_t payload = half[h] >> 4;
      if (payload >= ot::kVoxelOffset) {
        for (int c = 0; c < 8; ++c) w[h][c] = stay, o[h][c] = payload != ot::kVoxelOffset;
      } else {
        last_level(words, n_words, last_row, static_cast<int32_t>(payload), levels, w[h], o[h]);
      }
    }
  }

  // Cell (2qx + i, 2qy + j, 4qz + 2h + k) is child i*4 + j*2 + k of half h;
  // the four cells of one (i, j) are neighbours in the x-major table.
  for (int i = 0; i < 2; ++i) {
    for (int j = 0; j < 2; ++j) {
      const int32_t f = ((2 * qx + i) << (2 * levels)) | ((2 * qy + j) << levels) | (4 * qz);
      const int c = i * 4 + j * 2;
      *reinterpret_cast<uint4*>(warp + f) = make_uint4(w[0][c], w[0][c + 1], w[1][c], w[1][c + 1]);
      *reinterpret_cast<uint32_t*>(occ + f) =
          static_cast<uint32_t>(o[0][c]) | (static_cast<uint32_t>(o[0][c + 1]) << 8) |
          (static_cast<uint32_t>(o[1][c]) << 16) | (static_cast<uint32_t>(o[1][c + 1]) << 24);
    }
  }
}

// levels 0 and 1, one thread: the root cell (no fetch, occupied), or the
// root row's eight cells (at L1 a cell's flat index is its child index).
__global__ void warp_occupancy_top(const uint32_t* __restrict__ words, int32_t n_words,
                                   int levels, uint32_t* __restrict__ warp,
                                   uint8_t* __restrict__ occ) {
  if (levels == 0) {
    warp[0] = 0;
    occ[0] = 1;
    return;
  }
  uint32_t w[8];
  bool o[8];
  last_level(words, n_words, (n_words - 1) >> 3, 0, 1, w, o);
  for (int c = 0; c < 8; ++c) {
    warp[c] = w[c];
    occ[c] = o[c];
  }
}

}  // namespace

// Fills warp u32[8^levels] and occ bool[8^levels] (0 <= levels <= 9, both
// 16-byte aligned) from words u32[n_words], n_words >= 1; returns
// cudaGetLastError().
extern "C" int ot_warp_occupancy(const void* words, int64_t n_words, int levels, void* warp,
                                 void* occ, void* stream) {
  const auto* w = static_cast<const uint32_t*>(words);
  const int32_t nw = static_cast<int32_t>(n_words < INT_MAX ? n_words : INT_MAX);
  auto* out_warp = static_cast<uint32_t*>(warp);
  auto* out_occ = static_cast<uint8_t*>(occ);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (levels < 2) {
    warp_occupancy_top<<<1, 1, 0, s>>>(w, nw, levels, out_warp, out_occ);
  } else {
    const int64_t threads = static_cast<int64_t>(1) << (3 * (levels - 1) - 1);
    warp_occupancy_kernel<<<(threads + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        w, nw, levels, out_warp, out_occ);
  }
  return static_cast<int>(cudaGetLastError());
}
