// K4 `shade_encode`: per-ray shading, optionally encoded to the u8 frame.
//
// Replaces octree_tracer_tpu/render/tracer.py:3132 `shade` and :3191
// `encode_u8`. Ambient 0.3 + Lambert against the sun, zeroed where the
// shadow ray hit, 0.2 grey on a miss, red on a forced hit, clip and ^gamma;
// or the show_steps view steps/64; or the show_hits view (:3153-3159),
// min(visits[clamp(index, 0, pool - 1)], 15) / 15 grey on hits and black
// elsewhere (JAX's gather clamps a slot past the pool's end, which a
// malformed pool's hit reports). The
// encode is (clip^(1/2.2) * 255) truncated to u8.
//
// What bounds it on the H100: bytes (2 a ray of masks, a lit pixel's
// shadow, word and normal sectors, 3 or 12 out; tracer.k4_bytes), and the
// powf calls, which take longer than that when every pixel makes them. So
// the kernel makes a powf call only where its value depends on the pixel:
// - a per-gamma table (encode_table_kernel, computed on the card once a
//   device and gamma, read through the L1) holds the values every sky and
//   forced pixel shares, and 255 encode thresholds: t[k] is the least f32
//   in [0, 1] that the powf encode maps to k or more. The u8 encode counts
//   the thresholds at or below a value, from a bucket of the value's
//   exponent and top mantissa bits that holds the count at the bucket's
//   start; it equals the powf encode on every f32 in [0, 1], which
//   ot_encode_check verifies exhaustively on the card;
// - one pixel a thread and no barrier, so a warp of sky pixels never waits
//   for a lit one; word, normal and shadow are read only for a lit pixel,
//   so sky regions skip their sectors; a lit pixel's three gamma powf calls
//   are independent.
// Each value is computed by the same operations as in the plain version.
//
// Block-order input (JAX's beam frame with raw_result, tracer.py:3538-3545):
// when `block` > 0 ray i is pixel _block_to_pixel(i) of a `width`-wide image
// (tiles of block x block rays, row-major or Morton within the tile), and
// the kernel writes its colour at that pixel, so the image comes out in
// pixel order with no pass of its own.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

enum Mode { kShade = 0, kSteps = 1, kHits = 2 };

// 1/2.2 rounded once to float, as JAX's weakly typed 1.0 / 2.2 is.
constexpr float kEncodeExponent = static_cast<float>(1.0 / 2.2);
constexpr uint32_t kOneBits = 0x3F800000u;  // 1.0f

// The per-gamma table (tracer.encode_table, ENCODE_TABLE_SIZE floats): 256
// thresholds; the gamma of a sky channel (0.2), of 1 and of 0, and their
// bytes; then one bucket a 64th of an octave from 2^-18 to 1, each the
// encode of its lowest value. A value below 2^-18 encodes to 0 (the first
// threshold is about 5e-6).
constexpr int kSkyF = 256, kOneF = 257, kZeroF = 258, kSkyB = 259, kOneB = 260, kZeroB = 261;
constexpr int kBucket0 = 262;
constexpr int kBucketShift = 17;              // 23 mantissa bits - 6
constexpr int kBucketBase = (127 - 18) << 6;  // the bucket of 2^-18
constexpr int kBuckets = (kOneBits >> kBucketShift) - kBucketBase + 1;

struct ShadeArgs {
  const uint8_t* hit;
  const uint8_t* forced;
  const uint32_t* word;
  const float* normal;        // [n, 3]
  const int32_t* steps;
  const uint8_t* shadow_hit;  // [n] or null
  int64_t n;
  float neg_sun[3];           // -normalize(sun)
  float gamma;
  const int32_t* index;       // [n]; read only for show_hits
  const int32_t* visits;      // [pool] for the show_hits view
  int32_t n_visits;           // pool
  const float* table;         // the table for this gamma
  void* out;                  // f32[n, 3] or u8[n, 3]
  int32_t width;              // block order (block > 0): the image's width,
  int32_t block;              // the tile's side
  int32_t morton;             // and Morton order within the tile
};

// The pixel of ray i of the block order: its tile, then its place in the
// tile, row-major or with y and x interleaved bit by bit (y_k x_k ... y_0
// x_0, tracer.py:1144-1147).
__device__ __forceinline__ int64_t pixel_of(const ShadeArgs& a, int64_t i) {
  const int64_t lanes = static_cast<int64_t>(a.block) * a.block;
  const int64_t tile = i / lanes;
  const int in = static_cast<int>(i - tile * lanes);
  const int wb = a.width / a.block;
  int y = 0, x = 0;
  if (a.morton) {
    for (int k = 0; (1 << k) < a.block; ++k) {
      x |= ((in >> (2 * k)) & 1) << k;
      y |= ((in >> (2 * k + 1)) & 1) << k;
    }
  } else {
    y = in / a.block;
    x = in - y * a.block;
  }
  return (tile / wb * a.block + y) * static_cast<int64_t>(a.width) + tile % wb * a.block + x;
}

__device__ __forceinline__ float clip01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

__device__ __forceinline__ float gamma_of(float colour, float gamma) {
  return powf(clip01(colour), gamma);
}

// The display encode as the plain version computes it.
__device__ __forceinline__ int encode_powf(float c) {
  return static_cast<uint8_t>(powf(clip01(c), kEncodeExponent) * 255.0f);
}

// The same byte from the table: the number of thresholds t[1..255] at or
// below clip01(c), counted on from the count at the start of c's bucket.
__device__ __forceinline__ uint8_t encode_search(float c, const float* t) {
  const float x = clip01(c);
  if (!(x > 0.0f)) return 0;
  const int b = static_cast<int>(__float_as_uint(x) >> kBucketShift) - kBucketBase;
  int k = b >= 0 ? static_cast<int>(__ldg(t + kBucket0 + b)) : 0;
  while (k < 255 && x >= __ldg(t + k + 1)) ++k;
  return static_cast<uint8_t>(k);
}

template <int kMode, bool kU8>
__global__ void __launch_bounds__(kThreads) shade_encode_kernel(const ShadeArgs a) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= a.n) return;
  float f[3];
  int shared = -1;  // kSkyF or kOneF: every channel's value is in the table
  if (kMode == kSteps) {
    f[0] = f[1] = f[2] = gamma_of(static_cast<float>(a.steps[i]) / 64.0f, a.gamma);
  } else if (kMode == kHits) {
    float g = 0.0f;
    if (a.hit[i]) {  // a forced hit has index -1 and reads slot 0, as JAX's
      const int32_t c = a.visits[min(max(a.index[i], 0), a.n_visits - 1)];
      g = static_cast<float>(min(c, 15)) / 15.0f;
    }
    f[0] = f[1] = f[2] = gamma_of(g, a.gamma);
  } else if (a.forced[i]) {
    shared = kOneF;  // red
  } else if (a.hit[i]) {
    const float* nrm = a.normal + 3 * i;
    float diffuse = fmaxf(
        (nrm[0] * a.neg_sun[0] + nrm[1] * a.neg_sun[1]) + nrm[2] * a.neg_sun[2], 0.0f);
    if (a.shadow_hit != nullptr && a.shadow_hit[i]) diffuse = 0.0f;
    const uint32_t rgb24 = (a.word[i] >> 4) - ot::kVoxelOffset;
    const float lum = 0.3f + diffuse;
    f[0] = gamma_of(lum * (static_cast<float>((rgb24 >> 16) & 0xFFu) / 255.0f), a.gamma);
    f[1] = gamma_of(lum * (static_cast<float>((rgb24 >> 8) & 0xFFu) / 255.0f), a.gamma);
    f[2] = gamma_of(lum * (static_cast<float>(rgb24 & 0xFFu) / 255.0f), a.gamma);
  } else {
    shared = kSkyF;
  }
  const int64_t o = a.block > 0 ? pixel_of(a, i) : i;
  if (kU8) {
    uint8_t b[3];
    if (shared == kOneF) {
      b[0] = static_cast<uint8_t>(__ldg(a.table + kOneB));
      b[1] = b[2] = static_cast<uint8_t>(__ldg(a.table + kZeroB));
    } else if (shared == kSkyF) {
      b[0] = b[1] = b[2] = static_cast<uint8_t>(__ldg(a.table + kSkyB));
    } else {
      for (int c = 0; c < 3; ++c) b[c] = encode_search(f[c], a.table);
    }
    for (int c = 0; c < 3; ++c) static_cast<uint8_t*>(a.out)[3 * o + c] = b[c];
  } else {
    if (shared == kOneF) {
      f[0] = __ldg(a.table + kOneF);
      f[1] = f[2] = __ldg(a.table + kZeroF);
    } else if (shared == kSkyF) {
      f[0] = f[1] = f[2] = __ldg(a.table + kSkyF);
    }
    for (int c = 0; c < 3; ++c) static_cast<float*>(a.out)[3 * o + c] = f[c];
  }
}

template <int kMode>
void launch_mode(const ShadeArgs& a, bool u8, unsigned grid, cudaStream_t s) {
  if (u8) {
    shade_encode_kernel<kMode, true><<<grid, kThreads, 0, s>>>(a);
  } else {
    shade_encode_kernel<kMode, false><<<grid, kThreads, 0, s>>>(a);
  }
}

// The per-gamma table. t[k], k = 1..255: the least f32 c in [0, 1] whose
// powf encode is k or more, by bisection over the bit patterns (ordered as
// the values); t[0] = 0. Exact if the encode is monotone, which
// ot_encode_check verifies. Then the shared values and their bytes, and
// the buckets.
__global__ void encode_table_kernel(float* t, float gamma) {
  const int k = threadIdx.x;
  uint32_t lo = 0u, hi = kOneBits;  // encode(1) = 255 >= k
  while (k > 0 && lo < hi) {
    const uint32_t mid = lo + (hi - lo) / 2;
    if (encode_powf(__uint_as_float(mid)) >= k) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  t[k] = k > 0 ? __uint_as_float(lo) : 0.0f;
  if (k < 3) {
    const float c = gamma_of(k == 0 ? 0.2f : k == 1 ? 1.0f : 0.0f, gamma);
    t[kSkyF + k] = c;
    t[kSkyB + k] = static_cast<float>(encode_powf(c));
  }
  for (int b = k; b < kBuckets; b += blockDim.x) {
    const uint32_t bits = static_cast<uint32_t>(b + kBucketBase) << kBucketShift;
    t[kBucket0 + b] = static_cast<float>(encode_powf(__uint_as_float(bits)));
  }
}

// Over every f32 in [0, 1] (bit patterns 0 .. 0x3F800000), kCheckRun a
// thread: counts[0] += values whose table encode differs from the powf
// encode, counts[1] += neighbours where the powf encode decreases,
// counts[2] += values compared, so the caller sees that every value was.
constexpr int kCheckRun = 16;

__global__ void __launch_bounds__(kThreads) encode_check_kernel(const float* table,
                                                               unsigned long long* counts) {
  const uint64_t b0 = (static_cast<uint64_t>(blockIdx.x) * kThreads + threadIdx.x) * kCheckRun;
  unsigned c[3] = {0u, 0u, 0u};  // differ, decrease, compared
  if (b0 <= kOneBits) {
    int prev = encode_powf(__uint_as_float(static_cast<uint32_t>(b0)));
    for (int j = 0; j <= kCheckRun && b0 + j <= kOneBits; ++j) {
      const float x = __uint_as_float(static_cast<uint32_t>(b0 + j));
      const int e = j == 0 ? prev : encode_powf(x);
      if (j < kCheckRun) {
        ++c[2];
        if (encode_search(x, table) != e) ++c[0];
      }
      if (e < prev) ++c[1];
      prev = e;
    }
  }
  __shared__ unsigned warp_c[3][kThreads / 32];
  for (int k = 0; k < 3; ++k) {
    for (int o = 16; o > 0; o >>= 1) c[k] += __shfl_xor_sync(0xffffffffu, c[k], o);
    if ((threadIdx.x & 31) == 0) warp_c[k][threadIdx.x >> 5] = c[k];
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    unsigned long long sum = 0;
    for (int w = 0; w < kThreads / 32; ++w) sum += warp_c[threadIdx.x][w];
    if (sum != 0) atomicAdd(&counts[threadIdx.x], sum);
  }
}

}  // namespace

// Writes out as f32[n, 3] or (u8 != 0) u8[n, 3]. mode 0 shades, 1 is the
// show_steps view, 2 the show_hits view (index and visits of n_visits >= 1
// entries). table: from
// ot_encode_table for this gamma. block > 0: the rays are in the block order
// of a width-wide image (block divides width and n / width; morton != 0 for
// the Morton order within a tile), and out is written in pixel order.
// Returns cudaGetLastError().
extern "C" int ot_shade_encode(const void* hit, const void* forced, const void* word,
                               const void* normal, const void* steps,
                               const void* shadow_hit, int64_t n, float neg_sun_x,
                               float neg_sun_y, float neg_sun_z, int mode, float gamma,
                               const void* index, const void* visits, int64_t n_visits,
                               const void* table, void* out, int u8, int width, int block,
                               int morton, void* stream) {
  if (n == 0) return 0;
  const ShadeArgs a{static_cast<const uint8_t*>(hit),
                    static_cast<const uint8_t*>(forced),
                    static_cast<const uint32_t*>(word),
                    static_cast<const float*>(normal),
                    static_cast<const int32_t*>(steps),
                    static_cast<const uint8_t*>(shadow_hit),
                    n,
                    {neg_sun_x, neg_sun_y, neg_sun_z},
                    gamma,
                    static_cast<const int32_t*>(index),
                    static_cast<const int32_t*>(visits),
                    static_cast<int32_t>(n_visits < INT_MAX ? n_visits : INT_MAX),
                    static_cast<const float*>(table),
                    out,
                    width,
                    block,
                    morton};
  const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kSteps) {
    launch_mode<kSteps>(a, u8 != 0, grid, s);
  } else if (mode == kHits) {
    launch_mode<kHits>(a, u8 != 0, grid, s);
  } else {
    launch_mode<kShade>(a, u8 != 0, grid, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// table: tracer.ENCODE_TABLE_SIZE floats, for gamma (one block). Returns
// cudaGetLastError().
extern "C" int ot_encode_table(void* table, float gamma, void* stream) {
  encode_table_kernel<<<1, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(table), gamma);
  return static_cast<int>(cudaGetLastError());
}

// counts u64[3], zeroed by the caller: values where the table encode
// differs from the powf encode, neighbours where the powf encode
// decreases, and values compared, over every f32 in [0, 1] (0x3F800001
// when the grid covers them all). Returns cudaGetLastError().
extern "C" int ot_encode_check(const void* table, void* counts, void* stream) {
  const uint64_t values = static_cast<uint64_t>(kOneBits) + 1;
  const uint64_t threads = (values + kCheckRun - 1) / kCheckRun;
  encode_check_kernel<<<static_cast<unsigned>((threads + kThreads - 1) / kThreads), kThreads,
                        0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<unsigned long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}
