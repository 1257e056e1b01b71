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
// Arithmetic: island_sdf below repeats gen/sdf.py and gen/noise.py operation
// for operation in f32 (each constant the f32 rounding of JAX's Python
// constant, written as a hex literal; sums left to right; floor-mod as fmodf
// plus 289 where negative; sign(0) = 0), built without FMA contraction, so it
// equals the plain PyTorch version on the same device bit for bit.
//
// What bounds it on the H100: f32 operations. One SDF evaluation is 1,612 of
// them (counts per function below; gen/procedural.py SDF_OPS), over
// S^2 (S + 1) grid points: 2.2e11 at S = 512, 3.2 ms at 67 TFLOP/s (a bound
// the card reaches only with FMAs, which this build does not contract); the
// 32 MB of packed output is 10 us at 3.35 TB/s.
//
// Design: one thread per (x, y segment, z) column; it walks its segment in y,
// evaluating v one cell up and carrying it as the next cell's v, so a cell
// costs (seg + 1) / seg evaluations. z is the fastest thread index, so the
// 16 lanes of a half warp hold the 16 cells of one output word, which one OR
// reduction across the warp assembles. Grids with S < 16 (a word spans rows)
// take one thread per cell and evaluate both v values.
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

// floor-mod by 289 (x % 289.0): 3 operations.
__device__ __forceinline__ float mod289(float x) {
  const float r = fmodf(x, 289.0f);
  return r < 0.0f ? r + 289.0f : r;
}

// ((x * 34 + 1) * x) % 289: 6 operations.
__device__ __forceinline__ float permute(float x) { return mod289((x * 34.0f + 1.0f) * x); }

// simplex_noise3 (gen/noise.py): 372 operations, 60 before the corner loop,
// 77 per corner, 3 to sum the corners and 1 to scale.
__device__ float simplex3(float vx, float vy, float vz) {
  const float s = (vx + vy + vz) * kCy;                         // 3
  float ix = floorf(vx + s), iy = floorf(vy + s), iz = floorf(vz + s);  // 6
  const float t = (ix + iy + iz) * kCx;                         // 3
  const float x0[3] = {vx - ix + t, vy - iy + t, vz - iz + t};  // 6
  // step(x0.yzx, x0.xyz) and 1 - step rolled to .zxy: 9
  const float g[3] = {x0[0] >= x0[1] ? 1.0f : 0.0f, x0[1] >= x0[2] ? 1.0f : 0.0f,
                      x0[2] >= x0[0] ? 1.0f : 0.0f};
  const float l[3] = {1.0f - g[2], 1.0f - g[0], 1.0f - g[1]};
  const float i1[3] = {fminf(g[0], l[0]), fminf(g[1], l[1]), fminf(g[2], l[2])};  // 3
  const float i2[3] = {fmaxf(g[0], l[0]), fmaxf(g[1], l[1]), fmaxf(g[2], l[2])};  // 3
  const float x1[3] = {x0[0] - i1[0] + kCx, x0[1] - i1[1] + kCx, x0[2] - i1[2] + kCx};
  const float x2[3] = {x0[0] - i2[0] + kCx2, x0[1] - i2[1] + kCx2, x0[2] - i2[2] + kCx2};
  const float x3[3] = {x0[0] - 1.0f + kCx3, x0[1] - 1.0f + kCx3, x0[2] - 1.0f + kCx3};  // 18
  ix = mod289(ix);
  iy = mod289(iy);
  iz = mod289(iz);                                              // 9
  const float* corner[4] = {x0, x1, x2, x3};
  float total = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float ox = k == 0 ? 0.0f : k == 1 ? i1[0] : k == 2 ? i2[0] : 1.0f;
    const float oy = k == 0 ? 0.0f : k == 1 ? i1[1] : k == 2 ? i2[1] : 1.0f;
    const float oz = k == 0 ? 0.0f : k == 1 ? i1[2] : k == 2 ? i2[2] : 1.0f;
    const float p = permute(permute(permute(iz + oz) + iy + oy) + ix + ox);  // 23
    const float j = p - 49.0f * floorf(p * kNsZ * kNsZ);        // 5
    const float xq = floorf(j * kNsZ);                          // 2
    const float yq = floorf(j - 7.0f * xq);                     // 3
    const float x = xq * kNsX + kNsY;                           // 2
    const float y = yq * kNsX + kNsY;                           // 2
    const float h = 1.0f - fabsf(x) - fabsf(y);                 // 4
    const float sh = h <= 0.0f ? -1.0f : -0.0f;                 // 1
    float ax = x + (floorf(x) * 2.0f + 1.0f) * sh;              // 5
    float ay = y + (floorf(y) * 2.0f + 1.0f) * sh;              // 5
    float az = h;
    const float norm = kTaylorA - kTaylorB * (ax * ax + ay * ay + az * az);  // 7
    ax = ax * norm;
    ay = ay * norm;
    az = az * norm;                                             // 3
    const float* c = corner[k];
    float m = fmaxf(k0_6 - (c[0] * c[0] + c[1] * c[1] + c[2] * c[2]), 0.0f);  // 7
    m = m * m;                                                  // 1
    const float term = m * m * (ax * c[0] + ay * c[1] + az * c[2]);  // 7
    total = k == 0 ? term : total + term;                       // 1 (3 in all)
  }
  return 42.0f * total;                                         // 1
}

// sdf_box(p, (0.7, 0.1, 0.7)): 19 operations.
__device__ __forceinline__ float sdf_box(float px, float py, float pz) {
  const float qx = fabsf(px) - k0_7, qy = fabsf(py) - k0_1, qz = fabsf(pz) - k0_7;  // 6
  const float mx = fmaxf(qx, 0.0f), my = fmaxf(qy, 0.0f), mz = fmaxf(qz, 0.0f);    // 3
  const float outside = sqrtf(mx * mx + my * my + mz * mz);                        // 6
  const float inside = fminf(fmaxf(fmaxf(qx, qy), qz), 0.0f);                      // 3
  return outside + inside;                                                         // 1
}

__device__ __forceinline__ float clamp01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

__device__ __forceinline__ float signf(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

// sdf_cone(p, (0.5, 0.5), 0.9): q = (0.9 * (0.5 / 0.5), 0.9 * -1); 38
// operations.
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

// smin(a, b, 0.2): 13 operations.
__device__ __forceinline__ float smin(float a, float b) {
  const float h = clamp01(0.5f + 0.5f * (a - b) / k0_2);
  return a + (b - a) * h - k0_2 * h * (1.0f - h);
}

// smoothstep(e0, e1, x) with e1 - e0 folded in double, as JAX's Python floats
// are: 8 operations.
__device__ __forceinline__ float smoothstep(float e0, float span, float x) {
  const float t = clamp01((x - e0) / span);
  return t * t * (3.0f - 2.0f * t);
}

// island_sdf (gen/sdf.py): 4 simplex, box, cone, smin, 2 smoothstep, and 38
// operations of its own.
__device__ float island_sdf(float px, float py, float pz) {
  float v = sdf_box(px, py, pz) - k0_1;
  const float base = simplex3(px * k1_6, py * k1_6, pz * k1_6)
                     + 0.5f * simplex3(px * k3_2, py * k3_2, pz * k3_2);
  v = v + k0_07 * base;
  const float dist = sqrtf(px * px + pz * pz);
  const float cone = sdf_cone(px * 1.5f - 0.0f, py * -1.5f - 1.0f, pz * 1.5f - 0.0f) - k0_1;
  v = smin(v, cone);
  const float sx = k2_3, sy = k0_4, sz = k2_3;
  float spike = simplex3(px * sx, py * sy, pz * sz)
                + 0.5f * simplex3(px * (sx * 2.0f), py * (sy * 2.0f), pz * (sz * 2.0f));
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

constexpr int kSeg = 32;

// S >= 16: thread = (x, y segment, z), z fastest.
__global__ void __launch_bounds__(ot::kBlock) block_grid_kernel(
    float pos_x, float pos_y, float pos_z, float scale, int log_s, uint32_t* __restrict__ out) {
  const int64_t s = int64_t(1) << log_s;
  const int seg = s < kSeg ? static_cast<int>(s) : kSeg;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t z = t & (s - 1);
  const int64_t rest = t >> log_s;
  const int64_t n_seg = s / seg;
  const int64_t y0 = (rest % n_seg) * seg;
  const int64_t x = rest / n_seg;
  const float fx = static_cast<float>(x) * scale + pos_x;
  const float fz = static_cast<float>(z) * scale + pos_z;
  float v = island_sdf(fx, static_cast<float>(y0) * scale + pos_y, fz);
  const int shift = 2 * static_cast<int>(threadIdx.x & 15u);
  for (int dy = 0; dy < seg; ++dy) {
    const int64_t y = y0 + dy;
    const float above = island_sdf(fx, static_cast<float>(y + 1) * scale + pos_y, fz);
    store_word(cell_id(v, above) << shift, out, ((x * s + y) * s + z) >> 4, true);
    v = above;
  }
}

// S < 16: thread = flat cell; the grid is padded to whole warps.
__global__ void __launch_bounds__(ot::kBlock) block_grid_small_kernel(
    float pos_x, float pos_y, float pos_z, float scale, int log_s, uint32_t* __restrict__ out) {
  const int64_t s = int64_t(1) << log_s;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool active = i < s * s * s;
  uint32_t bits = 0;
  if (active) {
    const int64_t z = i % s, y = (i / s) % s, x = i / (s * s);
    const float fx = static_cast<float>(x) * scale + pos_x;
    const float fz = static_cast<float>(z) * scale + pos_z;
    const float v = island_sdf(fx, static_cast<float>(y) * scale + pos_y, fz);
    const float above = island_sdf(fx, static_cast<float>(y + 1) * scale + pos_y, fz);
    bits = cell_id(v, above) << (2 * static_cast<int>(i & 15));
  }
  store_word(bits, out, i >> 4, active);
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
    block_grid_kernel<<<ot::blocks_for(s * (s / seg) * s), ot::kBlock, 0, st>>>(
        pos_x, pos_y, pos_z, scale, log_s, o);
  } else {
    block_grid_small_kernel<<<ot::blocks_for(s * s * s), ot::kBlock, 0, st>>>(
        pos_x, pos_y, pos_z, scale, log_s, o);
  }
  return static_cast<int>(cudaGetLastError());
}
