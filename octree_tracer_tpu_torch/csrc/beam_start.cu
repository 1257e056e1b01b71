// K11 `beam_start`: the beam pre-pass's per-tile descent and per-ray starts.
//
// Replaces octree_tracer_tpu/render/tracer.py:2987 `beam_start`. For each
// block x block tile of an h x w image it takes the entry points of the
// tile's four corner rays (top-left, bottom-left, top-right, bottom-right
// pixels), walks the dyadic cell centres while all four take the same
// child, for at most max_depth levels (the common spatial path; 0 unless
// all four rays enter the root cube), then descends the pool along corner
// 0's path to at most that depth, stopping above leaves, and records each
// interior slot it descends through (beam_visit_idx, padded with the pool's
// length). Every ray then starts at its tile's node when its own entry
// point lies in the node's cell under the descent's boundary rule ((lo, hi]
// for the strict '>' descent, [lo, hi) for '>='), else at the root; a
// descent from any ancestor of the ray's first leaf finds what the root
// descent finds (the tests hold K1 with these starts to K1 without them).
//
// The pool is read as JAX's element gather reads it: slot min(idx, pool - 1).
// Powers of two are exact (ot::pow2_exact), as the plain version's `_pow2`.
//
// What bounds it on the H100: bytes. Each ray's direction read (12 B) and
// its start written (20 B), 4 B a tile and level of beam_visit_idx, and the
// pool rows the tiles' descents read: at 1920x1080, block 16, about 67 MB,
// 0.020 ms at 3.35 TB/s. The tile's walk is a chain of dependent loads
// (at most max_depth of them), but there are only h*w / block^2 tiles.
//
// Design: two launches in order on the stream. The first takes one thread a
// tile: the four corners' entries, the walk and the descent, with the tile's
// state (node, centre, depth) written to a scratch row of 5 words. The
// second takes one thread a ray: its entry point, the containment test
// against its tile's row (read through the L1: 256 threads of a row of
// pixels share w / block rows) and its start.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kEpsDir = 1e-6f;

struct BeamArgs {
  const uint32_t* words;
  int32_t n_words;
  const float* origin;  // f32[3]
  const float* dirs;    // f32[h, w, 3]
  int32_t h, w, block, wb, n_tiles, max_depth;
  int32_t* tile_state;  // [n_tiles, 5]: node, centre bits x3, depth
  int32_t* visit_idx;   // [n_tiles, max_depth]
  int32_t* start_index; // [h * w]
  float* start_pos;     // [h * w, 3]
  int32_t* start_depth; // [h * w]
};

// JAX `_init_state`'s entry point of the ray from `o` along pixel `i`'s
// direction (tracer.py:253-258): the origin inside the root cube, else the
// slab entry, which is 0 (the origin) on a miss. Returns whether it entered.
__device__ __forceinline__ bool entry_point(const BeamArgs& a, int32_t i, float e[3]) {
  float o[3], d[3], mn[3], mx[3];
  bool inside = true;
  for (int k = 0; k < 3; ++k) {
    o[k] = __ldg(a.origin + k);
    d[k] = __ldg(a.dirs + 3 * static_cast<int64_t>(i) + k);
    d[k] = d[k] == 0.0f ? kEpsDir : d[k];
    inside = inside && o[k] >= -1.0f && o[k] < 1.0f;
    const float t1 = (-1.0f - o[k]) / d[k];
    const float t2 = (1.0f - o[k]) / d[k];
    mn[k] = fminf(t1, t2);
    mx[k] = fmaxf(t1, t2);
  }
  const float v7 = fmaxf(fmaxf(mn[0], mn[1]), mn[2]);
  const float v8 = fminf(fminf(mx[0], mx[1]), mx[2]);
  const float dist = (v8 < 0.0f || v7 > v8) ? 0.0f : v7;
  for (int k = 0; k < 3; ++k) e[k] = inside ? o[k] : o[k] + d[k] * dist;
  return inside || dist != 0.0f;
}

template <bool STRICT>
__device__ __forceinline__ bool above(float p, float c) {
  return STRICT ? p > c : p >= c;
}

template <bool STRICT>
__global__ void __launch_bounds__(kThreads) beam_tile_kernel(const BeamArgs a) {
  const int32_t t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= a.n_tiles) return;
  const int32_t b = a.block;
  const int32_t y0 = (t / a.wb) * b, x0 = (t % a.wb) * b;
  // Corners in JAX's order: (y0, x0), (y0 + b - 1, x0), (y0, x0 + b - 1),
  // (y0 + b - 1, x0 + b - 1); corner 0's path is the one descended.
  const int32_t px[4] = {y0 * a.w + x0, (y0 + b - 1) * a.w + x0, y0 * a.w + x0 + b - 1,
                         (y0 + b - 1) * a.w + x0 + b - 1};
  float c[4][3];
  bool all_entered = true;
  for (int q = 0; q < 4; ++q) all_entered = entry_point(a, px[q], c[q]) && all_entered;

  // The common spatial path.
  float centre[3] = {0.0f, 0.0f, 0.0f};
  int32_t sdepth = 0;
  for (int it = 0; it < a.max_depth; ++it) {
    bool same = true;
    for (int q = 1; q < 4; ++q) {
      for (int k = 0; k < 3; ++k) {
        same = same && above<STRICT>(c[q][k], centre[k]) == above<STRICT>(c[0][k], centre[k]);
      }
    }
    if (!same) break;
    const float s = ot::pow2_exact(-(sdepth + 1));
    for (int k = 0; k < 3; ++k) centre[k] += above<STRICT>(c[0][k], centre[k]) ? s : -s;
    ++sdepth;
  }
  if (!all_entered) sdepth = 0;

  // The pool descent along corner 0's path, above leaves, to sdepth.
  int32_t node = 0, depth = 0;
  float pos[3] = {0.0f, 0.0f, 0.0f};
  int32_t* visits = a.visit_idx + static_cast<int64_t>(t) * a.max_depth;
  int it = 0;
  for (; it < a.max_depth && depth < sdepth; ++it) {
    bool pb[3];
    for (int k = 0; k < 3; ++k) pb[k] = above<STRICT>(c[0][k], pos[k]);
    const int32_t idx = node + (pb[0] * 4 + pb[1] * 2 + pb[2]);
    const uint32_t payload = __ldg(a.words + min(idx, a.n_words - 1)) >> 4;
    if (payload >= ot::kVoxelOffset) break;  // a leaf: the descent stops above it
    const float s = ot::pow2_exact(-(depth + 1));
    for (int k = 0; k < 3; ++k) pos[k] += pb[k] ? s : -s;
    node = static_cast<int32_t>(payload);
    ++depth;
    visits[it] = idx;
  }
  for (; it < a.max_depth; ++it) visits[it] = a.n_words;
  int32_t* row = a.tile_state + 5 * static_cast<int64_t>(t);
  row[0] = node;
  for (int k = 0; k < 3; ++k) row[1 + k] = __float_as_int(pos[k]);
  row[4] = depth;
}

template <bool STRICT>
__global__ void __launch_bounds__(kThreads) beam_ray_kernel(const BeamArgs a) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<int64_t>(a.h) * a.w) return;
  const int32_t y = static_cast<int32_t>(i / a.w), x = static_cast<int32_t>(i % a.w);
  const int32_t* row = a.tile_state + 5 * static_cast<int64_t>((y / a.block) * a.wb + x / a.block);
  const int32_t depth = __ldg(row + 4);
  float e[3], cp[3];
  entry_point(a, static_cast<int32_t>(i), e);
  const float half = ot::pow2_exact(-depth);
  bool ok = depth > 0;
  for (int k = 0; k < 3; ++k) {
    cp[k] = __int_as_float(__ldg(row + 1 + k));
    ok = ok && (STRICT ? (e[k] > cp[k] - half && e[k] <= cp[k] + half)
                       : (e[k] >= cp[k] - half && e[k] < cp[k] + half));
  }
  a.start_index[i] = ok ? __ldg(row) : 0;
  a.start_depth[i] = ok ? depth : 0;
  for (int k = 0; k < 3; ++k) a.start_pos[3 * i + k] = ok ? cp[k] : 0.0f;
}

template <bool STRICT>
void launch(const BeamArgs& a, cudaStream_t s) {
  if (a.n_tiles > 0) {
    beam_tile_kernel<STRICT><<<ot::blocks_for(a.n_tiles), kThreads, 0, s>>>(a);
  }
  beam_ray_kernel<STRICT><<<ot::blocks_for(static_cast<int64_t>(a.h) * a.w), kThreads, 0, s>>>(a);
}

}  // namespace

// words u32[n_words] (n_words >= 1), origin f32[3] and dirs f32[h, w, 3] on
// the card; block divides h and w; writes tile_state int32[tiles, 5] (a
// scratch), visit_idx int32[tiles, max_depth], start_index int32[h * w],
// start_pos f32[h * w, 3] and start_depth int32[h * w], tiles = (h / block)
// * (w / block). Returns cudaGetLastError().
extern "C" int ot_beam_start(const void* words, int64_t n_words, const void* origin,
                             const void* dirs, int h, int w, int block, int max_depth,
                             int strict, void* tile_state, void* visit_idx,
                             void* start_index, void* start_pos, void* start_depth,
                             void* stream) {
  if (static_cast<int64_t>(h) * w == 0) return 0;
  BeamArgs a{};
  a.words = static_cast<const uint32_t*>(words);
  a.n_words = static_cast<int32_t>(n_words < INT32_MAX ? n_words : INT32_MAX);
  a.origin = static_cast<const float*>(origin);
  a.dirs = static_cast<const float*>(dirs);
  a.h = h;
  a.w = w;
  a.block = block;
  a.wb = w / block;
  a.n_tiles = (h / block) * a.wb;
  a.max_depth = max_depth;
  a.tile_state = static_cast<int32_t*>(tile_state);
  a.visit_idx = static_cast<int32_t*>(visit_idx);
  a.start_index = static_cast<int32_t*>(start_index);
  a.start_pos = static_cast<float*>(start_pos);
  a.start_depth = static_cast<int32_t*>(start_depth);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (strict != 0) {
    launch<true>(a, s);
  } else {
    launch<false>(a, s);
  }
  return static_cast<int>(cudaGetLastError());
}
