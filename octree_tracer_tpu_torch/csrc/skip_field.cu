// K12 `skip_field`: the octant skip words of the 2^L grid from its occupancy.
//
// No JAX kernel: it replaces the JAX package's host NumPy composition,
// octree_tracer_tpu/render/skip.py:141-147 `build_skip_field`, which JAX ran
// on the host because XLA took minutes to compile the device program. For
// each cell and octant o = sx*4 + sy*2 + sz (bit set: the positive
// direction), the nibble at bits [4o, 4o+4) counts the codebook sides
// k in {1..12, 16, 24, 32} whose k-cube, anchored at the cell and extending
// in the octant's direction, holds no occupied cell (outside the grid is
// empty). It is bit for bit the NumPy build's (render/skip.py
// `build_skip_field_plain`).
//
// What bounds it on the H100: 5 bytes a cell, the occupancy byte read and the
// skip word written (skip.k12_bytes: 10.5 MB at L7, 3.1 us at 3.35 TB/s).
// The design keeps the work in bits and on chip:
// - cells are bits: bit j of word q of column (x, y) is cell z = 32q + j, so
//   one 32-bit AND tests 32 cells. A first launch packs the occupancy bytes
//   into such words once (`pack_kernel`), laid out so that neighbouring
//   columns along y are neighbouring words; E_1 is their complement;
// - the cubes grow in place, E_{k+o} = AND of E_k at the offsets o*{0,1}^3
//   (exact for o <= k), with o = 1 eleven times (E_2..E_12), then 4, 8, 8
//   (E_16, E_24, E_32): fourteen steps, each an AND along z (a funnel shift
//   of the word and its neighbour word, in registers), along y (warp
//   shuffles: a warp holds two region rows of 64 columns along y) and along
//   x (shared memory, two buffers in turn: one barrier a step); every step
//   makes a codebook side;
// - the count is kept as four bit planes: bit b of the count of nested
//   indicators is the parity of the indicators whose codebook index is a
//   multiple of 2^b, so each step XORs its E into one to four planes;
// - a block takes a 32x32 tile of columns, one output word of z, and the two
//   octants of one (sx, sy) that differ in sz, which share the tile's halo:
//   a 64x64 region of columns (the 31 columns an E_32 reaches past the tile,
//   and one spare), words q and q+1 for +z, q and q-1 for -z. Values near
//   the region's far side go wrong as the steps reach past it; no output
//   cell depends on them, since an E_k reads k-1 cells ahead at most;
// - the two octants' nibbles are byte sx*2 + sy of the skip word: each
//   output column's 8 planes become its 32 cells' bytes by four 8x8 bit
//   transposes in registers, staged in shared memory, and a warp stores a
//   column a lane a cell, so the four (sx, sy) blocks of a cell write
//   disjoint bytes of its word with no atomic, along z in 128-byte (into a
//   combined table's odd words, 256-byte) runs.
// What it waits on (PERF.md, K12): the region is four times the tile and
// the two words twice the output, so a block ANDs eight times the words it
// writes, and the exchanges along y and x go through the SM's shared-memory
// pipe; one block of 1024 threads fills an SM (56 registers, 128 KB of shared
// memory).
#include "common.cuh"

namespace {

constexpr int kTile = 32;     // output columns a side
constexpr int kRegion = 64;   // columns a side, tile and halo
constexpr int kThreads = 1024;  // 32 warps of 2 region rows of 64 columns
constexpr int kSteps = 14;
constexpr int kStage = 36;  // bytes a column of output bytes in shared memory

// Offset of each step; step s makes codebook index s + 2.
__constant__ int kOffset[kSteps] = {1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 4, 8, 8};

// One column's state: E of the output word q and its +z neighbour word
// (for sz = 1), of q and its -z neighbour word (for sz = 0).
struct Col {
  uint32_t p0, p1, m0, m1;
};

__device__ __forceinline__ uint4 as_vec(const Col& c) { return make_uint4(c.p0, c.p1, c.m0, c.m1); }

__device__ __forceinline__ void and_with(Col& c, const uint4& v) {
  c.p0 &= v.x, c.p1 &= v.y, c.m0 &= v.z, c.m1 &= v.w;
}

// y for one word of two columns lane and lane + 32 of a region row: each
// ANDs the word of the column `o` ahead, lane `from` = (lane + o) mod 32 of
// the lower half where lane + o < 32 (`low`), else of the upper half, and
// past the upper half all empty.
__device__ __forceinline__ void and_ahead(uint32_t& lo, uint32_t& hi, int from, bool low) {
  const uint32_t from_lo = __shfl_sync(0xffffffffu, lo, from);
  const uint32_t from_hi = __shfl_sync(0xffffffffu, hi, from);
  lo &= low ? from_lo : from_hi;
  hi &= low ? from_hi : ~0u;
}

// The 8x8 bit matrix with row i in byte i, transposed.
__device__ __forceinline__ uint64_t transpose8(uint64_t x) {
  uint64_t t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AAull;
  x ^= t ^ (t << 7);
  t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCCull;
  x ^= t ^ (t << 14);
  t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0ull;
  return x ^ t ^ (t << 28);
}

// 1 in each of the four bytes of `v` that is not 0.
__device__ __forceinline__ uint32_t byte_flags(uint32_t v) {
  v |= v >> 4;
  v |= v >> 2;
  v |= v >> 1;
  return v & 0x01010101u;
}

// The occupancy as bits, one thread a word: bits[(x * nz + q) * side + y]
// bit j is cell (x, y, 32q + j) of occ (bits at z >= side 0), so the
// columns of one x and word q lie side by side along y.
__global__ void __launch_bounds__(ot::kBlock)
pack_kernel(const uint8_t* __restrict__ occ, int levels, bool vec,
            uint32_t* __restrict__ bits) {
  const int side = 1 << levels;
  const int nz = side >= 32 ? side >> 5 : 1;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<int64_t>(side) * side * nz) return;
  const int y = static_cast<int>(i % side);
  const int64_t xq = i / side;
  const int q = static_cast<int>(xq % nz), x = static_cast<int>(xq / nz);
  const uint8_t* p = occ + (static_cast<int64_t>(x) * side + y) * side + 32 * q;
  uint32_t word = 0;
  if (side >= 32) {
    uint32_t v[8];
    if (vec) {
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
      const uint4 b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
      v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
      v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
    } else {
      for (int k = 0; k < 8; ++k) {
        v[k] = static_cast<uint32_t>(__ldg(p + 4 * k)) |
               (static_cast<uint32_t>(__ldg(p + 4 * k + 1)) << 8) |
               (static_cast<uint32_t>(__ldg(p + 4 * k + 2)) << 16) |
               (static_cast<uint32_t>(__ldg(p + 4 * k + 3)) << 24);
      }
    }
    // Four 0/1 bytes to four bits, the lowest byte to the lowest bit.
    for (int k = 0; k < 8; ++k) word |= ((byte_flags(v[k]) * 0x01020408u) >> 24) << (4 * k);
  } else {
    for (int z = 0; z < side; ++z) word |= static_cast<uint32_t>(__ldg(p + z) != 0) << z;
  }
  bits[i] = word;
}

// Word q of column (x, y), 0 <= x, y < side: bit j set where cell z = 32q + j
// is empty; all set where q is outside [0, nz), bits at z >= side set.
__device__ __forceinline__ uint32_t empty_word(const uint32_t* __restrict__ bits, int x, int y,
                                               int side, int nz, int q) {
  if (q < 0 || q >= nz) return ~0u;
  const uint32_t outside = side >= 32 ? 0u : ~0u << side;
  return ~__ldg(bits + (static_cast<int64_t>(x) * nz + q) * side + y) | outside;
}

// Absolute coordinate of region index r along an axis whose octant
// direction is `pos`, in the tile starting at t0.
__device__ __forceinline__ int region_coord(int t0, int r, int pos) {
  return pos ? t0 + r : t0 + kTile - 1 - r;
}

__global__ void __launch_bounds__(kThreads, 1)
skip_field_kernel(const uint32_t* __restrict__ bits, int levels, uint8_t* __restrict__ out,
                  int64_t stride) {
  extern __shared__ uint4 buf[];  // two buffers of kRegion * kRegion columns
  const int side = 1 << levels;
  const int nz = side >= 32 ? side >> 5 : 1;
  const int ntile = (side + kTile - 1) / kTile;
  const int x0 = (blockIdx.x / ntile) * kTile, y0 = (blockIdx.x % ntile) * kTile;
  const int sx = blockIdx.y >> 1, sy = blockIdx.y & 1;
  const int q = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // The thread's columns: region (rx, ry) = (2 * warp + a, lane + 32 * b),
  // column index rx * kRegion + ry in shared memory.
  Col col[2][2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int x = region_coord(x0, 2 * warp + a, sx), y = region_coord(y0, lane + 32 * b, sy);
      if (x < 0 || x >= side || y < 0 || y >= side) {
        col[a][b] = {~0u, ~0u, ~0u, ~0u};
        continue;
      }
      const uint32_t e = empty_word(bits, x, y, side, nz, q);
      col[a][b] = {e, empty_word(bits, x, y, side, nz, q + 1), e,
                   empty_word(bits, x, y, side, nz, q - 1)};
    }
  }

  // Bit planes of the counts of the output columns (warps 0-15, b = 0):
  // plane p of sz = 0 at acc[a][p], of sz = 1 at acc[a][4 + p].
  const bool owner = 2 * warp < kTile;
  uint32_t acc[2][8];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int p = 1; p < 4; ++p) acc[a][p] = acc[a][4 + p] = 0u;
    acc[a][0] = col[a][0].m0, acc[a][4] = col[a][0].p0;  // codebook index 1
  }

#pragma unroll 1
  for (int s = 0; s < kSteps; ++s) {
    const int o = kOffset[s];
    const int from = (lane + o) & 31;
    const bool low = lane + o < 32;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {  // z: in registers
        Col& c = col[a][b];
        c.p0 &= __funnelshift_r(c.p0, c.p1, o);
        c.p1 &= __funnelshift_r(c.p1, ~0u, o);
        c.m0 &= __funnelshift_l(c.m1, c.m0, o);
        c.m1 &= __funnelshift_l(~0u, c.m1, o);
      }
      // y: the column o rows ahead is lane + o of this half or the next;
      // past the region, all empty.
      Col& lo = col[a][0];
      Col& hi = col[a][1];
      and_ahead(lo.p0, hi.p0, from, low);
      and_ahead(lo.p1, hi.p1, from, low);
      and_ahead(lo.m0, hi.m0, from, low);
      and_ahead(lo.m1, hi.m1, from, low);
    }
    // x: the column o ahead belongs to another warp: through one of two
    // shared buffers in turn, so one barrier a step.
    uint4* cur = buf + (s & 1) * kRegion * kRegion;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int b = 0; b < 2; ++b) cur[(2 * warp + a) * kRegion + lane + 32 * b] = as_vec(col[a][b]);
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      if (2 * warp + a + o >= kRegion) continue;
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        and_with(col[a][b], cur[(2 * warp + a + o) * kRegion + lane + 32 * b]);
      }
    }
    const int i = s + 2;  // codebook index of this step's E
    if (owner) {
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          if (i % (1 << p) == 0) acc[a][p] ^= col[a][0].m0, acc[a][4 + p] ^= col[a][0].p0;
        }
      }
    }
  }

  // Output column t = rx * 32 + ry (rx, ry < 32): its 32 cells' bytes at
  // stage[t * kStage + j], transposed in registers from its 8 planes, 8 cells
  // at a time; then each warp stores whole columns, a lane a cell.
  __syncthreads();
  uint8_t* stage = reinterpret_cast<uint8_t*>(buf);
  if (owner) {
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      uint32_t* row = reinterpret_cast<uint32_t*>(stage + ((2 * warp + a) * kTile + lane) * kStage);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t sel = k | ((k + 4) << 4);
        const uint32_t lo = __byte_perm(__byte_perm(acc[a][0], acc[a][1], sel),
                                        __byte_perm(acc[a][2], acc[a][3], sel), 0x5410);
        const uint32_t hi = __byte_perm(__byte_perm(acc[a][4], acc[a][5], sel),
                                        __byte_perm(acc[a][6], acc[a][7], sel), 0x5410);
        const uint64_t t = transpose8((static_cast<uint64_t>(hi) << 32) | lo);
        row[2 * k] = static_cast<uint32_t>(t);
        row[2 * k + 1] = static_cast<uint32_t>(t >> 32);
      }
    }
  }
  __syncthreads();
  const int byte = sx * 2 + sy;
  const int z = q * 32 + lane;
  for (int t = warp; t < kTile * kTile; t += kThreads / 32) {
    const int x = region_coord(x0, t / kTile, sx), y = region_coord(y0, t % kTile, sy);
    if (x >= side || y >= side || z >= side) continue;
    const int64_t cell = (static_cast<int64_t>(x) * side + y) * side + z;
    out[cell * stride * 4 + byte] = stage[t * kStage + lane];
  }
}

}  // namespace

// Writes the skip word of each cell c of the 2^levels grid (0 <= levels <= 9)
// to u32 out[c * stride] from occ bool[8^levels] (x-major: cell
// (x * side + y) * side + z), through bits u32[side * side * max(side / 32,
// 1)]; vec != 0 where occ starts on 16 bytes. Two launches: the packing,
// then the field. Returns cudaGetLastError().
extern "C" int ot_skip_field(const void* occ, int levels, int vec, void* bits, void* out,
                             int64_t stride, void* stream) {
  constexpr int smem = 2 * kRegion * kRegion * static_cast<int>(sizeof(uint4));
  cudaError_t err = cudaFuncSetAttribute(skip_field_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int side = 1 << levels;
  const int nz = side >= 32 ? side >> 5 : 1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* packed = static_cast<uint32_t*>(bits);
  pack_kernel<<<ot::blocks_for(static_cast<int64_t>(side) * side * nz), ot::kBlock, 0, s>>>(
      static_cast<const uint8_t*>(occ), levels, vec != 0, packed);
  const int ntile = (side + kTile - 1) / kTile;
  const dim3 grid(ntile * ntile, 4, nz);
  skip_field_kernel<<<grid, kThreads, smem, s>>>(packed, levels, static_cast<uint8_t*>(out),
                                                 stride);
  return static_cast<int>(cudaGetLastError());
}
