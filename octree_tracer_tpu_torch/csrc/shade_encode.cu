// K4 `shade_encode`: per-ray shading, optionally encoded to the u8 frame.
//
// Replaces octree_tracer_tpu/render/tracer.py:3132 `shade` and :3191
// `encode_u8`. Ambient 0.3 + Lambert against the sun, zeroed where the
// shadow ray hit, 0.2 grey on a miss, red on a forced hit, clip and ^gamma;
// or the show_steps view steps/64; or the show_hits view (:3153-3159),
// min(visits[max(index, 0)], 15) / 15 grey on hits and black elsewhere. The
// encode is (clip^(1/2.2) * 255) truncated to u8.
//
// What bounds it on the H100: bytes (about 30 read and 3 or 12 written per
// ray); two powf calls a channel are the only real arithmetic. The simple
// design: one thread per ray, shading and encode fused so the f32 image never
// reaches device memory when the u8 frame is asked for.
#include "common.cuh"

namespace {

struct ShadeArgs {
  const uint8_t* hit;
  const uint8_t* forced;
  const uint32_t* word;
  const float* normal;        // [n, 3]
  const int32_t* steps;
  const uint8_t* shadow_hit;  // [n] or null
  int64_t n;
  float neg_sun[3];           // -normalize(sun)
  int show_steps;
  float gamma;
  const int32_t* index;       // [n]; read only for show_hits
  const int32_t* visits;      // [pool] for the show_hits view, or null
  float* image;               // [n, 3] f32, or null when encoding
  uint8_t* image_u8;          // [n, 3] u8, or null
};

// 1/2.2 rounded once to float, as JAX's weakly typed 1.0 / 2.2 is.
constexpr float kEncodeExponent = static_cast<float>(1.0 / 2.2);

__device__ __forceinline__ float clip01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

__global__ void __launch_bounds__(ot::kBlock) shade_encode_kernel(const ShadeArgs a) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  float colour[3];
  if (a.show_steps) {
    const float g = static_cast<float>(a.steps[i]) / 64.0f;
    for (int k = 0; k < 3; ++k) colour[k] = g;
  } else if (a.visits != nullptr) {
    float g = 0.0f;
    if (a.hit[i]) {  // a forced hit has index -1 and reads slot 0, as JAX's
      const int32_t c = a.visits[max(a.index[i], 0)];
      g = static_cast<float>(min(c, 15)) / 15.0f;
    }
    for (int k = 0; k < 3; ++k) colour[k] = g;
  } else if (a.forced[i]) {
    colour[0] = 1.0f;
    colour[1] = 0.0f;
    colour[2] = 0.0f;
  } else if (a.hit[i]) {
    const float* nrm = a.normal + 3 * i;
    float diffuse = fmaxf(
        (nrm[0] * a.neg_sun[0] + nrm[1] * a.neg_sun[1]) + nrm[2] * a.neg_sun[2], 0.0f);
    if (a.shadow_hit != nullptr && a.shadow_hit[i]) diffuse = 0.0f;
    const uint32_t rgb24 = (a.word[i] >> 4) - ot::kVoxelOffset;
    const float lum = 0.3f + diffuse;
    colour[0] = lum * (static_cast<float>((rgb24 >> 16) & 0xFFu) / 255.0f);
    colour[1] = lum * (static_cast<float>((rgb24 >> 8) & 0xFFu) / 255.0f);
    colour[2] = lum * (static_cast<float>(rgb24 & 0xFFu) / 255.0f);
  } else {
    for (int k = 0; k < 3; ++k) colour[k] = 0.2f;
  }
  for (int k = 0; k < 3; ++k) {
    const float c = powf(clip01(colour[k]), a.gamma);
    if (a.image_u8 != nullptr) {
      a.image_u8[3 * i + k] =
          static_cast<uint8_t>(powf(clip01(c), kEncodeExponent) * 255.0f);
    } else {
      a.image[3 * i + k] = c;
    }
  }
}

}  // namespace

// Writes image f32[n, 3] (image_u8 null) or image_u8 u8[n, 3] (image null);
// visits non-null selects the show_hits view. Returns cudaGetLastError().
extern "C" int ot_shade_encode(const void* hit, const void* forced, const void* word,
                               const void* normal, const void* steps,
                               const void* shadow_hit, int64_t n, float neg_sun_x,
                               float neg_sun_y, float neg_sun_z, int show_steps,
                               float gamma, const void* index, const void* visits,
                               void* image, void* image_u8, void* stream) {
  if (n == 0) return 0;
  const ShadeArgs a{static_cast<const uint8_t*>(hit),
                    static_cast<const uint8_t*>(forced),
                    static_cast<const uint32_t*>(word),
                    static_cast<const float*>(normal),
                    static_cast<const int32_t*>(steps),
                    static_cast<const uint8_t*>(shadow_hit),
                    n,
                    {neg_sun_x, neg_sun_y, neg_sun_z},
                    show_steps,
                    gamma,
                    static_cast<const int32_t*>(index),
                    static_cast<const int32_t*>(visits),
                    static_cast<float*>(image),
                    static_cast<uint8_t*>(image_u8)};
  shade_encode_kernel<<<ot::blocks_for(n), ot::kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
