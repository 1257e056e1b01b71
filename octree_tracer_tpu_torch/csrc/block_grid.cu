// K7 `block_grid`: the island SDF over a chunk's cell grid, 2-bit-packed.
//
// Replaces the XLA program of octree_tracer_tpu/gen/procedural.py:84
// `_block_grid_packed` (and :48 `_block_grid`, which it wraps). Cell (x, y, z)
// of the S^3 chunk grid (S = 2^chunk_depth) is stone (1) where the island SDF
// v at its corner is < 0, grass (3) where also v one cell above is > 0, else
// empty (0). Coordinates are f32(i) * scale + pos per axis. Output word w holds
// flat C-order cells 16w..16w+15, cell 16w + k in bits [2k, 2k + 1], the
// native dense builder's layout.
//
// Arithmetic: the SDF below repeats gen/sdf.py and gen/noise.py operation for
// operation in f32 (each constant the f32 rounding of JAX's Python constant,
// written as a hex literal; sums left to right; sign(0) = 0), built without
// FMA contraction, so it equals the plain PyTorch version on the same device
// bit for bit. Two things compute the same values by other means:
//
// - Floor-mod by 289. Every input of the noise's `% 289` is an integer-valued
//   float: the lattice corners floor(v + s), and the permutation polynomial
//   (34x + 1)x of x in [0, 577], at most 11,320,163 < 2^24, so exact in f32.
//   On such a float the remainder in int32 (truncate, `% 289`, + 289 where
//   negative) is the float remainder exactly, for |x| < 2^31; the wrapper
//   raises for a chunk whose lattice corners could reach 2^31
//   (gen/procedural.py k7_exact_range). fmodf(-0.0, 289) is -0.0 where the
//   integers give +0.0; that zero only ever meets `iz + oz` or a sum with a
//   non-negative term, which turns -0.0 into +0.0 in both.
// - The permutation and the gradient. A simplex corner's gradient is a pure
//   function of the lattice index before its last permutation, an integer in
//   [0, 577]. Each block fills two shared-memory tables over that range with
//   the noise's own f32 operations, `perm` (the permutation) and `grad` (the
//   three gradient components after the Taylor normalisation), so a corner
//   costs three table reads and five integer adds instead of 62 f32
//   operations (three permutations and a gradient).
//
// What bounds it on the H100: f32 operations. The algorithm states 1,612 a
// point (counts per function below; gen/procedural.py SDF_OPS). The tables
// leave 620 of them, and 37 of those read only x and z, so the work needs 583
// a point, 37 a column and 45 a table entry (gen/procedural.py k7_ops):
// 7.8e10 at S = 512, 1.17 ms at 67 TFLOP/s, a rate the card reaches only
// with FMAs. With no contraction one counted operation is one instruction at
// best, and the SMs dispatch 128 lane-instructions a clock (33.5e12 a second
// at 1.98 GHz), so the same work needs 2.3 ms at the dispatch rate. Each IEEE
// division (5 a point) and square root (4) is a sequence of several
// instructions, so is each int32 floor-mod (12), and each corner reads three
// table entries, so the kernel issues well over one instruction per counted
// operation. It recomputes the terms that read only x and z at every
// point: hoisting them out of the y walk measured no faster (PERF.md). The
// 32 MB of packed output is 10 us at 3.35 TB/s.
//
// Design: one thread per (x, y segment, z) column, 64 cells a segment, in
// blocks of 128 threads; it walks its segment in y, evaluating v one cell up
// and carrying it as the next cell's v, so a cell costs (seg + 1) / seg
// evaluations. z is the fastest thread index, so the
// 16 lanes of a half warp hold the 16 cells of one output word, which one OR
// reduction across the warp assembles, and the lanes of a warp mostly share
// a simplex cell, so their table reads broadcast. Grids with S < 16 (a word
// spans rows) take one thread per cell and evaluate both v values.
#include "common.cuh"

namespace {

constexpr float kCx = 0x1.555556p-3f;   // f32(1/6)
constexpr float kCy = 0x1.555556p-2f;   // f32(1/3)
constexpr float kCx2 = 0x1.555556p-2f;  // f32(2.0 * (1/6)), folded in double
constexpr float kCx3 = 0x1.0p-1f;       // f32(3.0 * (1/6))
constexpr float kNsX = 0x1.24924ap-2f;  // f32(1/7) * 2 - 0
constexpr float kNsY = -0x1.db6db6p-1f; // f32(1/7) * 0.5 - 1
constexpr float kNsZ = 0x1.24924ap-3f;  // f32(1/7) * 1 - 0
constexpr float kTaylorA = 0x1.caf7c0p+0f;  // f32(1.79284291400159)
constexpr float kTaylorB = 0x1.b51cb8p-1f;  // f32(0.85373472095314)
constexpr float k0_6 = 0x1.333334p-1f;
constexpr float k0_7 = 0x1.666666p-1f;
constexpr float k0_1 = 0x1.99999ap-4f;
constexpr float k1_6 = 0x1.99999ap+0f;
constexpr float k3_2 = 0x1.99999ap+1f;  // f32(1.6 * 2.0)
constexpr float k0_07 = 0x1.1eb852p-4f;
constexpr float k0_9 = 0x1.ccccccp-1f;
constexpr float k0_2 = 0x1.99999ap-3f;
constexpr float k0_3 = 0x1.333334p-2f;
constexpr float k2_3 = 0x1.266666p+1f;
constexpr float k0_4 = 0x1.99999ap-2f;

// Lattice indices lie in [0, 289); a permuted index plus two of them and an
// offset of 0 or 1 in [0, 577].
constexpr int kTable = 2 * 288 + 2;

struct Tables {
  float4 grad[kTable];  // gradient of the corner whose last permutation reads i
  int perm[kTable];     // ((34 i + 1) i) % 289
};

// x % 289 as JAX computes it (the truncated remainder, + 289 where negative)
// for an integer-valued float |x| < 2^31, in int32: 3 operations counted.
__device__ __forceinline__ int floor_mod289(float x) {
  const int r = __float2int_rz(x) % 289;
  return r < 0 ? r + 289 : r;
}

// The gradient of permuted index p (gen/noise.py, from j to the normalised
// (x, y, h)): 39 operations counted, run once per table entry.
__device__ float4 gradient(float p) {
  const float j = p - 49.0f * floorf(p * kNsZ * kNsZ);        // 5
  const float xq = floorf(j * kNsZ);                          // 2
  const float yq = floorf(j - 7.0f * xq);                     // 3
  const float x = xq * kNsX + kNsY;                           // 2
  const float y = yq * kNsX + kNsY;                           // 2
  const float h = 1.0f - fabsf(x) - fabsf(y);                 // 4
  const float sh = h <= 0.0f ? -1.0f : -0.0f;                 // 1
  const float ax = x + (floorf(x) * 2.0f + 1.0f) * sh;        // 5
  const float ay = y + (floorf(y) * 2.0f + 1.0f) * sh;        // 5
  const float az = h;
  const float norm = kTaylorA - kTaylorB * (ax * ax + ay * ay + az * az);  // 7
  return make_float4(ax * norm, ay * norm, az * norm, 0.0f);  // 3
}

// Fill the block's tables; every thread of the block must call it.
__device__ void fill_tables(Tables& t) {
  for (int i = threadIdx.x; i < kTable; i += blockDim.x) {
    // ((x * 34 + 1) * x) % 289 (6 operations counted): exact in f32 on
    // these integers, so exact in int32.
    const int p = (i * 34 + 1) * i % 289;
    t.perm[i] = p;
    t.grad[i] = gradient(static_cast<float>(p));
  }
  __syncthreads();
}

// simplex_noise3 (gen/noise.py): 372 operations counted, 60 before the
// corner loop, 77 per corner, 3 to sum the corners and 1 to scale.
__device__ __forceinline__ float simplex3(const Tables& tb, float vx, float vy, float vz) {
  const float s = (vx + vy + vz) * kCy;                         // 3
  const float ix = floorf(vx + s), iy = floorf(vy + s), iz = floorf(vz + s);  // 6
  const float t = (ix + iy + iz) * kCx;                         // 3
  const float x0[3] = {vx - ix + t, vy - iy + t, vz - iz + t};  // 6
  // step(x0.yzx, x0.xyz) as g, 1 - g rolled to .zxy as l (9); i1 = min(g, l)
  // and i2 = max(g, l) on {0, 1} (6) are AND and OR.
  const bool g0 = x0[0] >= x0[1], g1 = x0[1] >= x0[2], g2 = x0[2] >= x0[0];
  const int i1[3] = {g0 && !g2, g1 && !g0, g2 && !g1};
  const int i2[3] = {g0 || !g2, g1 || !g0, g2 || !g1};
  const float x1[3] = {x0[0] - static_cast<float>(i1[0]) + kCx,
                       x0[1] - static_cast<float>(i1[1]) + kCx,
                       x0[2] - static_cast<float>(i1[2]) + kCx};
  const float x2[3] = {x0[0] - static_cast<float>(i2[0]) + kCx2,
                       x0[1] - static_cast<float>(i2[1]) + kCx2,
                       x0[2] - static_cast<float>(i2[2]) + kCx2};
  const float x3[3] = {x0[0] - 1.0f + kCx3, x0[1] - 1.0f + kCx3, x0[2] - 1.0f + kCx3};  // 18
  const int jx = floor_mod289(ix), jy = floor_mod289(iy), jz = floor_mod289(iz);  // 9
  const float* corner[4] = {x0, x1, x2, x3};
  float total = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int ox = k == 0 ? 0 : k == 1 ? i1[0] : k == 2 ? i2[0] : 1;
    const int oy = k == 0 ? 0 : k == 1 ? i1[1] : k == 2 ? i2[1] : 1;
    const int oz = k == 0 ? 0 : k == 1 ? i1[2] : k == 2 ? i2[2] : 1;
    // permute(permute(permute(iz + oz) + iy + oy) + ix + ox) and its
    // gradient: 23 + 39 operations counted.
    const float4 gr = tb.grad[tb.perm[tb.perm[jz + oz] + jy + oy] + jx + ox];
    const float* c = corner[k];
    float m = fmaxf(k0_6 - (c[0] * c[0] + c[1] * c[1] + c[2] * c[2]), 0.0f);  // 7
    m = m * m;                                                  // 1
    const float term = m * m * (gr.x * c[0] + gr.y * c[1] + gr.z * c[2]);  // 7
    total = k == 0 ? term : total + term;                       // 1 (3 in all)
  }
  return 42.0f * total;                                         // 1
}

__device__ __forceinline__ float clamp01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

__device__ __forceinline__ float signf(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

// sdf_box(p, (0.7, 0.1, 0.7)): 19 operations counted, 8 of them (qx, qz,
// their max with 0 and squares) reading only x and z.
__device__ __forceinline__ float sdf_box(float px, float py, float pz) {
  const float qx = fabsf(px) - k0_7, qy = fabsf(py) - k0_1, qz = fabsf(pz) - k0_7;  // 6
  const float mx = fmaxf(qx, 0.0f), my = fmaxf(qy, 0.0f), mz = fmaxf(qz, 0.0f);    // 3
  const float outside = sqrtf(mx * mx + my * my + mz * mz);                        // 6
  const float inside = fminf(fmaxf(fmaxf(qx, qy), qz), 0.0f);                      // 3
  return outside + inside;                                                         // 1
}

// sdf_cone(p, (0.5, 0.5), 0.9): q = (0.9 * (0.5 / 0.5), 0.9 * -1); 38
// operations counted, 12 of them (w0, w0 * qx, w0 * qy, tb, b0 and b0^2)
// reading only x and z.
__device__ __forceinline__ float sdf_cone(float px, float py, float pz) {
  const float qx = k0_9 * (0.5f / 0.5f), qy = k0_9 * -1.0f;
  const float qq = qx * qx + qy * qy;
  const float w0 = sqrtf(px * px + pz * pz), w1 = py;                // 4
  const float ta = clamp01((w0 * qx + w1 * qy) / qq);                // 6
  const float a0 = w0 - qx * ta, a1 = w1 - qy * ta;                  // 4
  const float tb = clamp01(w0 / qx);                                 // 3
  const float b0 = w0 - qx * tb, b1 = w1 - qy * 1.0f;                // 4
  const float k = signf(qy);
  const float d = fminf(a0 * a0 + a1 * a1, b0 * b0 + b1 * b1);       // 7
  const float s = fmaxf(k * (w0 * qy - w1 * qx), k * (w1 - qy));     // 8
  return sqrtf(d) * signf(s);                                        // 3 (sign 1)
}

// smin(a, b, 0.2): 13 operations counted.
__device__ __forceinline__ float smin(float a, float b) {
  const float h = clamp01(0.5f + 0.5f * (a - b) / k0_2);
  return a + (b - a) * h - k0_2 * h * (1.0f - h);
}

// smoothstep(e0, e1, x) with e1 - e0 folded in double, as JAX's Python floats
// are: 8 operations counted.
__device__ __forceinline__ float smoothstep(float e0, float span, float x) {
  const float t = clamp01((x - e0) / span);
  return t * t * (3.0f - 2.0f * t);
}

// island_sdf (gen/sdf.py): 4 simplex, box, cone, smin, 2 smoothstep, and 38
// operations counted of its own, 17 of them (the noise and cone inputs along
// x and z, dist and 1.6 * dist) reading only x and z.
__device__ float island_sdf(const Tables& tb, float px, float py, float pz) {
  float v = sdf_box(px, py, pz) - k0_1;
  const float base = simplex3(tb, px * k1_6, py * k1_6, pz * k1_6)
                     + 0.5f * simplex3(tb, px * k3_2, py * k3_2, pz * k3_2);
  v = v + k0_07 * base;
  const float dist = sqrtf(px * px + pz * pz);
  const float cone = sdf_cone(px * 1.5f - 0.0f, py * -1.5f - 1.0f, pz * 1.5f - 0.0f) - k0_1;
  v = smin(v, cone);
  const float sx = k2_3, sy = k0_4, sz = k2_3;
  float spike = simplex3(tb, px * sx, py * sy, pz * sz)
                + 0.5f * simplex3(tb, px * (sx * 2.0f), py * (sy * 2.0f), pz * (sz * 2.0f));
  const float height_bias = smoothstep(0.0f, -1.5f, py) + smoothstep(0.0f, k0_2, py);
  spike = spike + k1_6 * dist + height_bias * 2.0f - 1.0f;
  return v + k0_3 * spike;
}

__device__ __forceinline__ uint32_t cell_id(float v, float v_above) {
  return v < 0.0f ? (v_above > 0.0f ? 3u : 1u) : 0u;
}

// OR of `bits` over each half warp; lanes 0 and 16 store their half's word.
__device__ __forceinline__ void store_word(uint32_t bits, uint32_t* out, int64_t word,
                                           bool active) {
  const unsigned lane = threadIdx.x & 31u;
  const uint32_t lo = __reduce_or_sync(0xffffffffu, lane < 16 ? bits : 0u);
  const uint32_t hi = __reduce_or_sync(0xffffffffu, lane >= 16 ? bits : 0u);
  if (active && (lane & 15u) == 0) out[word] = lane == 0 ? lo : hi;
}

// 64 cells a segment and blocks of 128 threads: 1-3% faster than 32 and 256
// on an H100 (PERF.md).
constexpr int kSeg = 64;
constexpr int kThreads = 128;

// S >= 16: thread = (x, y segment, z), z fastest.
__global__ void __launch_bounds__(kThreads) block_grid_kernel(
    float pos_x, float pos_y, float pos_z, float scale, int log_s, uint32_t* __restrict__ out) {
  __shared__ Tables tables;
  fill_tables(tables);
  const int s = 1 << log_s;
  const int seg = s < kSeg ? s : kSeg;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;  // < S^3 / seg <= 2^24
  const int z = t & (s - 1);
  const int rest = t >> log_s;
  const int n_seg = s / seg;
  const int y0 = (rest % n_seg) * seg;
  const int x = rest / n_seg;
  const float fx = static_cast<float>(x) * scale + pos_x;
  const float fz = static_cast<float>(z) * scale + pos_z;
  float v = island_sdf(tables, fx, static_cast<float>(y0) * scale + pos_y, fz);
  const int shift = 2 * static_cast<int>(threadIdx.x & 15u);
  const int64_t row = (static_cast<int64_t>(x) * s + y0) * s + z;
  for (int dy = 0; dy < seg; ++dy) {
    const float above = island_sdf(tables, fx, static_cast<float>(y0 + dy + 1) * scale + pos_y,
                                   fz);
    store_word(cell_id(v, above) << shift, out, (row + static_cast<int64_t>(dy) * s) >> 4, true);
    v = above;
  }
}

// S < 16: thread = flat cell; the grid is padded to whole warps.
__global__ void __launch_bounds__(kThreads) block_grid_small_kernel(
    float pos_x, float pos_y, float pos_z, float scale, int log_s, uint32_t* __restrict__ out) {
  __shared__ Tables tables;
  fill_tables(tables);
  const int s = 1 << log_s;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < s * s * s;
  uint32_t bits = 0;
  if (active) {
    const int z = i % s, y = (i / s) % s, x = i / (s * s);
    const float fx = static_cast<float>(x) * scale + pos_x;
    const float fz = static_cast<float>(z) * scale + pos_z;
    const float v = island_sdf(tables, fx, static_cast<float>(y) * scale + pos_y, fz);
    const float above = island_sdf(tables, fx, static_cast<float>(y + 1) * scale + pos_y, fz);
    bits = cell_id(v, above) << (2 * (i & 15));
  }
  store_word(bits, out, i >> 4, active);
}

unsigned blocks(int64_t threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

}  // namespace

// Packed block ids of the chunk at world corner pos with cell size `scale`,
// S = 2^log_s (log_s <= 10): out u32[ceil(S^3 / 16)]. Returns
// cudaGetLastError().
extern "C" int ot_block_grid(float pos_x, float pos_y, float pos_z, float scale, int log_s,
                             void* out, void* stream) {
  const int64_t s = int64_t(1) << log_s;
  auto* o = static_cast<uint32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (s >= 16) {
    const int64_t seg = s < kSeg ? s : kSeg;
    block_grid_kernel<<<blocks(s * (s / seg) * s), kThreads, 0, st>>>(
        pos_x, pos_y, pos_z, scale, log_s, o);
  } else {
    block_grid_small_kernel<<<blocks(s * s * s), kThreads, 0, st>>>(
        pos_x, pos_y, pos_z, scale, log_s, o);
  }
  return static_cast<int>(cudaGetLastError());
}
