// K1 `trace`: stackless per-ray octree traversal.
//
// Replaces the XLA while-loop program of octree_tracer_tpu/render/tracer.py:135
// `trace` with `_init_state` (:239), `_make_body` (:372), `_warp_lookup`
// (:2916), `_ray_box_dist` (:117), `_in_bounds` (:99) and `_finish` (:342),
// and the brick DDA of `_brick_substeps` (:832) and `_refetch_words` (:318),
// without paging, pack9 or fuse_sibling, in both restart forms.
// Each loop trip of a ray is one `_make_body` iteration for that ray: descend
// one level through the group row, or take a t_max boundary step (2e-6 nudge)
// and restart at the parent, at the warp-table cell or at the root; with a
// combined table the step may cross a whole stored empty cube. A ray still
// active after max_iters trips stays unresolved, as the JAX loop leaves it.
// The root form (ROOT, JAX parent_restart=False, tracer.py:603-613) never
// restarts at the parent: after every boundary step the ray descends again
// from the warp cell's stored node, or from the root, as the reference's full
// re-descent does (src/shader.wgsl:213-245), so its visit counts have the
// reference counter's magnitudes. ROOT is a template parameter: the parent
// form keeps its code and registers, and the root form carries no parent test.
//
// Start forms (START, JAX `trace(start=...)`, `_init_state` :239-290): the
// first descent of each primary ray begins at the caller's node, centre and
// depth (`beam_start`'s tile ancestors), in place of the table's lookup;
// with a combined table the first step skips nothing, as in JAX. They are a
// kernel of their own, `trace_start_kernel`, so the forms without a start
// keep their code and registers, and only they read the 20 bytes a ray.
//
// Seed forms (JAX `trace_staged` and `render_frame` without `warp_in_body`,
// tracer.py:1745-1777): the warp table (either kind) gives each ray's first
// descent its start, as the table forms' lookup does, and no later step
// reads it: restarts go to the parent or the root, and nothing skips. A
// kernel of their own, `trace_seed_kernel`, primary and shadow mode, on the
// body without a table.
//
// Brick mode (BRICKS, JAX `trace(bricks=...)`, render/bricks.py; only without
// a table, which JAX forbids beside bricks): a descent into a decorated node
// (bit 0 of the word) switches the ray to an arithmetic DDA over the node's
// 4x4x4 brick from its next trip on. A trip in brick mode reads the first 16
// bytes of the node's brick row (w0, the 64 occupancy bits and the children
// group) and takes up to brick_k sub-steps, each one reference step at the
// actual leaf: the two-level point location by the descent's comparisons; a
// filled coarse leaf is a hit, a filled fine cell descends into the interior
// child's brick, an empty cell takes the t_max step from its own cell. A step
// out of the brick's cell resumes from the brick root's parent cell when that
// holds the position, else from the root, whatever the restart form
// (tracer.py:1017-1046). In brick mode `node` is the brick root's slot, `cp`
// and `depth` its cell and `inv1` its half side 2^-depth. The DDA never reads
// the leaf word: `word` is read at `index` after the loop, for hits that are
// not forced (tracer.py:318-340). As JAX reads one table of pool rows and then
// brick rows, a node row past the pool's end reads a brick row (the last one
// at most), and a brick row past the table's end the last one. Each lane's
// load of a trip, the brick row's first 16 bytes or the descent's word, is
// issued at the top of the trip, before the lanes part into the two bodies,
// so a warp whose lanes split waits on one load latency. One 16-byte load
// for both modes (JAX's one row a trip, a descent lane taking the half of
// its row that holds its word) measured 8-20% slower (PERF.md §6). A split
// warp still runs both bodies in turn, and a brick trip's sub-steps, each
// with three IEEE divisions, are the longer of the two.
//
// What bounds it on the H100: every trip is one dependent 4-byte load from
// the pool (the child word of the 32-byte group row), and every boundary step
// with a table one more from the table. On the deep10 scene the pool and the
// level-7 combined table fit in the H100's L2 together, so the kernel waits on
// L2 latency of dependent loads, and on warps whose rays need far more trips
// than their neighbours'. The design, one thread per ray with the whole state
// in registers and no shared memory:
// - Coherent warps. For an image (width > 0) a warp traces a tile of 8x4
//   neighbouring pixels, whose rays cross the same nodes and finish together
//   more often than a 32x1 strip's; any other batch is taken in linear order.
//   Results are written at each ray's own index.
// - One warp a tile, in a grid of all tiles. Persistent warps that take
//   tiles from a counter (Aila and Laine, HPG 2009) measured about 5% slower on
//   the deep10 frame's primary pass (PERF.md): the block scheduler already
//   refills an SM as its blocks end, and rays here end within 100 steps.
// - A shadow mode of the same kernel builds each shadow ray from the primary
//   result in its prologue (origin hit_pos + normal * 2.5e-6, direction
//   -normalize(sun), active on hits facing the sun under `cull`) and writes
//   only `hit`: 1 byte a ray instead of the primary's 42.
// - The primary pass may pass one origin for every ray (stride 0).
// - int32 index arithmetic; powers of two are built from exponent bits and
//   applied by multiplication, which is exact.
//
// Rounding: every expression keeps tracer.py's association term by term,
// including the skip-plane association of tracer.py:554-561
// (clo + cw - B*cw), which can differ by an ulp from the plain march's.
// Every division by a ray direction stays a true IEEE division (a reciprocal
// multiply moves knife-edge rays), and the build keeps --fmad=false.
//
// Visits (`_visit_mark`, tracer.py:355-369, marked at :524-526): every trip
// marks slot node + child in an int32[pool] array, as a count or as a stored
// 1 (flags; every writer stores the same value, so the race is benign). That
// is the slot it reads in a well-formed pool; a slot past the pool's end is
// not marked, as JAX's scatter drops it.
// Counts are warp-aggregated: the lanes marking one slot in the same trip
// find each other with __match_any_sync and one of them adds their number,
// so the first descents of a tile, which share the root group, take one
// atomic instead of 32. Counting is a template parameter, so frames that do
// not count keep the unmarked kernel's registers. A brick sub-step marks
// children group + ccode (tracer.py:943-948), dropped past the pool's end.
// The root form's counting and flag forms re-descend from the root after
// every step: on the deep10 1080p primaries 9.3M marks at each of depths
// 0, 1 and 2, on 8, 64 and 512 slots, whose atomics queue on a few L2
// addresses (4.2x the unmarked pass). A block adds those up in shared
// memory and each entry to the array once (`top_mark`); every other mark
// stays warp-aggregated. A per-lane cache of the last slot at each depth
// measured slower: its flushes come apart across a warp's lanes (PERF.md
// §6).
// A counting form's skip jump also marks the empty leaf that covers each table
// cell the jumped segment crosses (`mark_jump`), as a root descent there reads
// it, so that K6's closure leaves a root descent's interior zero-set: a jump
// that marks nothing (JAX's) leaves the interiors only it crosses unread, and
// the Session lists them to collapse. It also counts the boundary steps the
// descent takes there, and its cube shrinks near the step cap, so that the
// counted frame forces the rays a root descent forces: a jump counted as one
// step (JAX's, and the uncounted forms') carries grazing rays past the cap.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kTileW = 8, kTileH = 4;  // one warp's image tile
constexpr int kWarps = ot::kBlock / 32;

struct TraceArgs {
  const uint32_t* words;
  int32_t n_words;            // node indices are < 2^27 + 8, so int32 holds it
  const float* origins;       // [n, 3], or one point when origin_stride == 0
  int32_t origin_stride;      // 3, or 0
  const float* dirs;          // [n, 3] (primary)
  const uint8_t* active_init; // [n] or null (primary)
  const uint8_t* prim_hit;    // [n] (shadow)
  const float* prim_pos;      // [n, 3] (shadow)
  const float* prim_normal;   // [n, 3] (shadow)
  float sun[3];               // -normalize(sun) (shadow)
  bool cull;                  // (shadow)
  int32_t n;
  int32_t width;              // image width, 0 for linear order
  int32_t tiles_x;            // tiles across the image
  int32_t n_tiles;
  const uint32_t* table;      // [8^L] warp words or [2*8^L] (warp, skip) pairs
  int levels;
  int max_steps;
  int max_iters;
  uint8_t* hit;
  uint8_t* forced;            // outputs below: primary only
  int32_t* index;
  float* hit_pos;             // [n, 3]
  float* normal;              // [n, 3]
  int32_t* steps;
  int32_t* depth;
  uint32_t* word;
  int32_t* visits;            // [n_words] or null
  const uint32_t* bricks;     // [n_words, 8] brick rows (brick mode)
  int brick_k;                // sub-steps a brick trip
  const int32_t* start_index; // [n] (start forms): where the first descent
  const float* start_pos;     // [n, 3] begins, its cell's centre
  const int32_t* start_depth; // [n] and its depth
  int seed;                   // (seed forms) 1 = warp words, 2 = combined pairs
};

struct Resume {
  int32_t index;
  float c[3];
  int32_t depth;
  bool valid;
  uint32_t skip;
};

// floor((p + 1) * side/2) clamped into the grid, as a float.
__device__ __forceinline__ float cell_f(float p, float half_side, float last) {
  return fminf(fmaxf(floorf((p + 1.0f) * half_side), 0.0f), last);
}

// tracer.py:2916 `_warp_lookup`: the resume state of the table cell holding
// p, valid only where p lies inside the stored node's cell under the descent's
// boundary rule ((lo, hi] for strict '>', [lo, hi) for '>=').
template <bool STRICT, bool COMBINED>
__device__ __forceinline__ Resume warp_lookup(const uint32_t* __restrict__ table,
                                              int levels, float half_side,
                                              float last, const float p[3]) {
  int cell[3];
  for (int k = 0; k < 3; ++k) cell[k] = static_cast<int>(cell_f(p[k], half_side, last));
  const int32_t flat = (((cell[0] << levels) + cell[1]) << levels) + cell[2];
  const int32_t lane = COMBINED ? 2 * flat : flat;
  const uint32_t packed = __ldg(table + lane);
  const int32_t w_index = static_cast<int32_t>(packed >> 5);
  const int32_t w_depth = static_cast<int32_t>(packed & 31u);
  const int shift = max(levels - w_depth, 0);
  const float half = ot::pow2(-w_depth);  // 1 / scale, exact
  Resume r;
  bool in_cell = true;
  for (int k = 0; k < 3; ++k) {
    const float anc = static_cast<float>(cell[k] >> shift);
    r.c[k] = (anc * 2.0f + 1.0f) * half - 1.0f;  // / scale, exact
    in_cell = in_cell && (STRICT ? (p[k] > r.c[k] - half && p[k] <= r.c[k] + half)
                                 : (p[k] >= r.c[k] - half && p[k] < r.c[k] + half));
  }
  r.valid = in_cell && w_depth > 0;
  r.index = r.valid ? w_index : 0;
  r.depth = r.valid ? w_depth : 0;
  for (int k = 0; k < 3; ++k) r.c[k] = r.valid ? r.c[k] : 0.0f;
  r.skip = COMBINED ? __ldg(table + lane + 1) : 0u;
  return r;
}

// Side of the empty cube stored for this ray's octant: nibble codebook
// 0..12 identity, 13/14/15 -> 16/24/32 (render/skip.py decode_skip).
__device__ __forceinline__ int32_t decode_skip(uint32_t skip_word, int oct) {
  const int32_t nib = static_cast<int32_t>((skip_word >> (4u * oct)) & 15u);
  return nib <= 12 ? nib : (nib - 11) * 8;
}

// The ray a lane takes in a tile, or -1 past the batch's (or image's) edge.
__device__ __forceinline__ int32_t ray_of(const TraceArgs& a, int32_t tile, int lane) {
  if (a.width == 0) {
    const int32_t i = tile * 32 + lane;
    return i < a.n ? i : -1;
  }
  const int32_t ty = tile / a.tiles_x;
  const int32_t x = (tile - ty * a.tiles_x) * kTileW + (lane % kTileW);
  const int32_t i = (ty * kTileH + lane / kTileW) * a.width + x;
  return (x < a.width && i < a.n) ? i : -1;
}

// One visit mark at `slot` (counts or flags), dropped past the pool's end.
template <int VISITS>
__device__ __forceinline__ void mark(int32_t* visits, int32_t slot, int32_t n_words) {
  if (VISITS != 0 && static_cast<uint32_t>(slot) < static_cast<uint32_t>(n_words)) {
    if (VISITS == 1) {
      const unsigned peers = __match_any_sync(__activemask(), slot);
      if ((threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(visits + slot, __popc(peers));
    } else {
      visits[slot] = 1;
    }
  }
}

// The covering slot of level-L cell c (centre cc) of a combined table, as
// render/tracer.py `_cell_slots`: from a stored node (depth > 0), its child
// toward the centre; from a word of depth 0, the slot that K2's descent
// toward the centre reads last. In an empty cell both are its empty leaf.
__device__ __forceinline__ int32_t cell_slot(const uint32_t* __restrict__ table,
                                             const uint32_t* __restrict__ words,
                                             int32_t n_words, int levels, const int c[3],
                                             const float cc[3]) {
  const int32_t flat = (((c[0] << levels) + c[1]) << levels) + c[2];
  const uint32_t packed = __ldg(table + 2 * flat);
  const int32_t w_depth = static_cast<int32_t>(packed & 31u);
  if (w_depth > 0) {
    const int shift = max(levels - w_depth, 0);
    const float half = ot::pow2(-w_depth);
    int child = 0;
    for (int k = 0; k < 3; ++k) {
      const float anc = static_cast<float>(c[k] >> shift);
      child = child * 2 + (cc[k] > (anc * 2.0f + 1.0f) * half - 1.0f);
    }
    return static_cast<int32_t>(packed >> 5) + child;
  }
  const int32_t last_row = (n_words - 1) >> 3;
  int32_t node = 0, slot = 0;
  float np[3] = {0.0f, 0.0f, 0.0f};
  for (int it = 0; it < levels; ++it) {
    bool pb[3];
    for (int k = 0; k < 3; ++k) pb[k] = cc[k] > np[k];
    const int child = pb[0] * 4 + pb[1] * 2 + pb[2];
    slot = node + child;
    const int32_t at = (min(node >> 3, last_row) << 3) | child;
    const uint32_t payload = (at < n_words ? __ldg(words + at) : 0u) >> 4;
    if (payload >= ot::kVoxelOffset) break;
    node = static_cast<int32_t>(payload);
    const float h = ot::pow2(-(it + 1));
    for (int k = 0; k < 3; ++k) np[k] = np[k] + (pb[k] ? h : -h);
  }
  return slot;
}

// A counted skip jump's marks and steps (render/tracer.py `_jump_slots`): a
// root descent through the jumped segment reads, in every cell it crosses,
// the empty leaf that covers the cell (a cube holds no node below level L)
// and its ancestors, and takes one boundary step out of each such leaf. The
// walk starts at the cell that holds v under the descent's boundary rule
// (the cube's anchor, v's cell by its floor, may miss it on a face), steps
// from cell to cell by each cell's exit planes, (plane - p) / d as the
// jump's own planes, every tied axis at once, until it leaves the cube of
// `skw` cells anchored at v's floor cell (a step at or past the jump's exit
// t, `exit_t`: the cube's planes are cells' planes) or the grid, and marks
// the covering slot of each cell entered outside the leaf it jumps from
// (slot `leaf_slot`, centre lc, half side lh); K6's closure marks the
// ancestors.
// Returns the steps the jump stands for: each cell entered whose covering
// slot differs from the one before (the leaf's at the start), the first cell
// past the cube included (outside the grid is no slot). Only the counting
// forms with a combined table take it (four blocks an SM, below).
template <bool STRICT, int VISITS>
__device__ __forceinline__ int32_t mark_jump(const uint32_t* __restrict__ table,
                                             const uint32_t* __restrict__ words,
                                             int32_t n_words, int levels, int32_t* visits,
                                             const float p[3], const float d[3],
                                             const float rs[3], const float v[3], int32_t skw,
                                             float exit_t, const float lc[3], float lh,
                                             int32_t leaf_slot) {
  const int side = 1 << levels;
  const float half_side = static_cast<float>(side) * 0.5f;
  const float last = static_cast<float>(side - 1);
  const float cw = 2.0f / static_cast<float>(side);
  int c[3];
  for (int k = 0; k < 3; ++k) {
    const float cf = cell_f(v[k], half_side, last);
    const float low = cf * cw - 1.0f;  // exact
    const bool below = STRICT ? v[k] <= low : v[k] < low;
    const bool above = STRICT ? v[k] > low + cw : v[k] >= low + cw;
    c[k] = static_cast<int>(cf) + (above && cf < last) - (below && cf > 0.0f);
  }
  int32_t prev = leaf_slot, n = 0;
  for (int it = 0; it < 3 * skw; ++it) {
    float tt[3];
    for (int k = 0; k < 3; ++k) {
      const float clo = static_cast<float>(c[k]) * cw - 1.0f;
      tt[k] = ((rs[k] > 0.0f ? clo + cw : clo) - p[k]) / d[k];
    }
    const float tm = fminf(fminf(tt[0], tt[1]), tt[2]);
    bool in_grid = true, in_leaf = true;
    float cc[3];
    for (int k = 0; k < 3; ++k) {
      if (tt[k] <= tm) c[k] += rs[k] > 0.0f ? 1 : -1;
      in_grid = in_grid && static_cast<unsigned>(c[k]) < static_cast<unsigned>(side);
      cc[k] = (static_cast<float>(c[k]) + 0.5f) * cw - 1.0f;
      in_leaf = in_leaf && cc[k] > lc[k] - lh && cc[k] < lc[k] + lh;
    }
    const bool in_cube = in_grid && tm < exit_t;
    const int32_t slot = in_cube && in_leaf ? prev
                         : in_grid           ? cell_slot(table, words, n_words, levels, c, cc)
                                             : -1;
    n += slot != prev;
    if (!in_cube) break;
    if (!in_leaf) mark<VISITS>(visits, slot, n_words);
    prev = slot;
  }
  return n;
}

// The root form's counting and flag forms: every re-descent from the root
// marks a slot at depths 0, 1 and 2, so these few slots take most of the
// frame's marks. Each block adds them up in shared memory instead, in
// entries named by the descent's path (its children at depths 0-2: 8 + 64
// + 512 entries), and adds each entry to the array once, at its end. The
// path names the slot (slot = node + child, the node read from the pool
// along the same path), so every lane that marks an entry marks one slot.
// The forms that use them: the root form's counting and flag forms, but
// for the shadow mode with a table, whose rays start in cells the table
// holds and so almost never re-descend from the root (14 marks at depth 0
// of 11M on deep10; PERF.md §6).
constexpr int kTopEntries = 8 + 64 + 512;

template <int TABLE, int VISITS, bool SHADOW, bool ROOT>
constexpr bool kTopMarks = ROOT && VISITS != 0 && (TABLE == 0 || !SHADOW);

struct TopMarks {
  int32_t* count;  // [kTopEntries] marks (counts) or 0/1 (flags)
  int32_t* slot;   // [kTopEntries] the entry's slot
};

// A mark at depth < 3 of a descent from the root with path `path` (the
// children at the depths above, c0 * 8 + c1), warp-aggregated as `mark`;
// dropped past the pool's end.
template <int VISITS>
__device__ __forceinline__ void top_mark(const TopMarks& top, int depth, int32_t path,
                                         int child, int32_t slot, int32_t n_words) {
  if (static_cast<uint32_t>(slot) >= static_cast<uint32_t>(n_words)) return;
  const int entry = depth == 0 ? child : depth == 1 ? 8 + path * 8 + child
                                                    : 72 + path * 8 + child;
  if (VISITS == 1) {
    const unsigned peers = __match_any_sync(__activemask(), entry);
    if ((threadIdx.x & 31) == __ffs(peers) - 1) {
      atomicAdd(top.count + entry, __popc(peers));
      top.slot[entry] = slot;
    }
  } else {
    top.count[entry] = 1;
    top.slot[entry] = slot;
  }
}

// TABLE: 0 = no table, 1 = warp words, 2 = combined warp+skip pairs.
// VISITS: 0 = none, 1 = counts, 2 = 0/1 flags. SHADOW: the shadow mode.
// ROOT: the root-restart form. BRICKS: brick mode (TABLE 0 only). START:
// 0, or where the first descent starts: 1 at the caller's per-ray node
// (primary only), 2 at the table's cell (`a.seed`; TABLE 0, no bricks).
// `top`: the block's marks at the top of the tree (the root form's counting
// and flag forms).
template <bool STRICT, int TABLE, int VISITS, bool SHADOW, bool ROOT, bool BRICKS, int START>
__device__ __forceinline__ void trace_ray(const TraceArgs& a, int32_t i, const TopMarks& top) {
  constexpr bool kCombined = TABLE == 2;
  float o[3], d[3];
  if (SHADOW) {
    // shadow_rays: from hit_pos + normal * 2.5e-6 toward -normalize(sun).
    bool on = a.prim_hit[i] != 0;
    float nrm[3];
    for (int k = 0; k < 3; ++k) nrm[k] = on ? a.prim_normal[3 * i + k] : 0.0f;
    if (a.cull) on = on && (nrm[0] * a.sun[0] + nrm[1] * a.sun[1]) + nrm[2] * a.sun[2] > 0.0f;
    if (!on) {
      a.hit[i] = 0;
      return;
    }
    for (int k = 0; k < 3; ++k) {
      o[k] = a.prim_pos[3 * i + k] + nrm[k] * 2.5e-6f;
      d[k] = a.sun[k];
    }
  } else {
    const int32_t o_off = i * a.origin_stride;
    for (int k = 0; k < 3; ++k) {
      o[k] = a.origins[o_off + k];
      d[k] = a.dirs[3 * i + k];
    }
  }

  // What a ray that never resolves reports (not entered, masked off, or still
  // active after max_iters trips).
  bool hit = false, forced = false;
  int32_t index = -1, out_steps = 0, out_depth = 0;
  uint32_t out_word = 0;
  float hp[3] = {0.0f, 0.0f, 0.0f}, hn[3] = {0.0f, 0.0f, 0.0f};

  float mn[3], mx[3];
  bool inside = true;
  for (int k = 0; k < 3; ++k) {
    d[k] = d[k] == 0.0f ? 1e-6f : d[k];
    inside = inside && o[k] >= -1.0f && o[k] < 1.0f;
    const float t1 = (-1.0f - o[k]) / d[k];
    const float t2 = (1.0f - o[k]) / d[k];
    mn[k] = fminf(t1, t2);
    mx[k] = fmaxf(t1, t2);
  }
  const float v7 = fmaxf(fmaxf(mn[0], mn[1]), mn[2]);
  const float v8 = fminf(fminf(mx[0], mx[1]), mx[2]);
  const float dist = (v8 < 0.0f || v7 > v8) ? 0.0f : v7;
  bool active = inside || dist != 0.0f;
  if (!SHADOW && a.active_init != nullptr) active = active && a.active_init[i] != 0;

  if (active) {
    // Per-ray invariants of the loop.
    const float half_side = static_cast<float>(1 << a.levels) * 0.5f;
    const float last = static_cast<float>((1 << a.levels) - 1);
    const float cw = 2.0f / static_cast<float>(1 << a.levels);
    const uint32_t* __restrict__ words = a.words;
    const int32_t n_words = a.n_words;
    const int32_t last_row = (n_words - 1) >> 3;
    // p: the entry position, which is also the origin of every boundary step.
    float p[3], v[3], nrm[3], rs[3], cp[3] = {0.0f, 0.0f, 0.0f};
    for (int k = 0; k < 3; ++k) {
      p[k] = inside ? o[k] : o[k] + d[k] * dist;
      v[k] = p[k];
      nrm[k] = truncf(p[k] * 1.000001f);
      rs[k] = d[k] > 0.0f ? 1.0f : -1.0f;
    }
    const int oct = (d[0] > 0.0f) * 4 + (d[1] > 0.0f) * 2 + (d[2] > 0.0f);
    int32_t node = 0, depth = 0, steps = 0, skw = 0;
    if (START == 1) {
      // JAX's `start` (tracer.py:263-288): it wins over the table's lookup,
      // and the skip side starts at 0 until the first restart's lookup.
      node = a.start_index[i];
      depth = a.start_depth[i];
      for (int k = 0; k < 3; ++k) cp[k] = a.start_pos[3 * i + k];
    } else if (START == 2) {
      // JAX's `_init_state` lookup (tracer.py:263-282), the table's only
      // read: the body below has none.
      const Resume w = a.seed == 2
                           ? warp_lookup<STRICT, true>(a.table, a.levels, half_side, last, p)
                           : warp_lookup<STRICT, false>(a.table, a.levels, half_side, last, p);
      node = w.index;
      depth = w.depth;
      for (int k = 0; k < 3; ++k) cp[k] = w.c[k];
    } else if (TABLE != 0) {
      const Resume w = warp_lookup<STRICT, kCombined>(a.table, a.levels, half_side, last, p);
      node = w.index;
      depth = w.depth;
      for (int k = 0; k < 3; ++k) cp[k] = w.c[k];
      if (kCombined) skw = decode_skip(w.skip, oct);
    }
    // inv1 = 2^-(depth + 1), the child's half side: set from the bits where
    // the descent starts (at most 32 levels down) and halved at each level,
    // which is exact into the subnormals and rounds 2^-150 to 0, as the
    // plain version's `_pow2`. A pool whose pointers cycle can send a
    // descent past 126 levels, where the exponent bits alone would wrap.
    // A caller's start may lie at any depth: its half side is built exactly
    // into the subnormals.
    float inv1 = START == 1 ? ot::pow2_exact(-(depth + 1)) : ot::pow2(-(depth + 1));
    bool bmode = false;
    // The root form's top-of-tree marks (kTopMarks): the depth where the
    // current descent started, and its path (children at depths 0 and 1).
    // A start at depth 0 names its entries by the path only from the root
    // node; from any other node its first descent marks as below depth 2.
    constexpr bool kTop = kTopMarks<TABLE, VISITS, SHADOW, ROOT>;
    int32_t depth0 = START == 1 && node != 0 ? -1 : depth, path = 0;

    for (int it = 0; it < a.max_iters; ++it) {
      bool pb[3];
      for (int k = 0; k < 3; ++k) pb[k] = STRICT ? v[k] > cp[k] : v[k] >= cp[k];
      const int child = pb[0] * 4 + pb[1] * 2 + pb[2];
      // Brick forms: each lane's one load of the trip is issued here,
      // before the lanes part into brick trips and descents, so a warp
      // whose lanes split waits on one load latency, not two in turn (JAX
      // reads one row a trip either way, tracer.py:471-474). A brick lane
      // loads the first 16 bytes of its brick row (w0-w3, all the DDA
      // reads; unsigned: a slot from a garbage table's w3 reads a row
      // inside), a descent lane the word `child` of its row by JAX's row
      // gather (below).
      uint4 row = make_uint4(0u, 0u, 0u, 0u);
      uint32_t row_word = 0u;
      if (BRICKS) {
        const uint32_t unode = static_cast<uint32_t>(node);
        const uint32_t last_brick = static_cast<uint32_t>(n_words - 1);
        if (bmode) {
          row = __ldg(reinterpret_cast<const uint4*>(a.bricks) +
                      2 * static_cast<int64_t>(min(unode, last_brick)));
        } else if ((unode >> 3) > static_cast<uint32_t>(last_row)) {
          const uint32_t brow = min((unode >> 3) - last_row - 1, last_brick);
          row_word = __ldg(a.bricks + 8 * static_cast<int64_t>(brow) + child);
        } else {
          const int32_t at = (node & ~7) | child;
          row_word = at < n_words ? __ldg(words + at) : 0u;
        }
      }
      if (BRICKS && bmode) {
        // One brick trip: the root's row, then up to brick_k sub-steps.
        const uint4 br = row;
        const float h = inv1, q1 = h * 0.5f, q2 = h * 0.25f;
        bool done = false;
        for (int sub = 0; sub < a.brick_k; ++sub) {
          bool b1[3], b2[3];
          float m1[3], m2[3];
          for (int k = 0; k < 3; ++k) {
            b1[k] = STRICT ? v[k] > cp[k] : v[k] >= cp[k];
            m1[k] = cp[k] + (b1[k] ? q1 : -q1);
            b2[k] = STRICT ? v[k] > m1[k] : v[k] >= m1[k];
            m2[k] = m1[k] + (b2[k] ? q2 : -q2);
          }
          const int ccode = b1[0] * 4 + b1[1] * 2 + b1[2];
          const int bit = ccode * 8 + b2[0] * 4 + b2[1] * 2 + b2[2];
          const bool occ = (((bit < 32 ? br.y : br.z) >> (bit & 31)) & 1u) != 0u;
          const bool cl = ((br.x >> (ccode + 1)) & 1u) != 0u;
          const int32_t tgt = static_cast<int32_t>(br.w) + ccode;
          mark<VISITS>(a.visits, tgt, n_words);
          if (occ && cl) {  // a filled coarse leaf: hit
            hit = true;
            index = tgt;
            out_steps = steps;
            out_depth = depth + 1;
            for (int k = 0; k < 3; ++k) {
              hp[k] = v[k];
              hn[k] = nrm[k];
            }
            done = true;
            break;
          }
          if (occ) {  // a filled fine cell: on in the interior child's brick
            node = tgt;
            depth += 1;
            inv1 = q1;
            for (int k = 0; k < 3; ++k) cp[k] = m1[k];
            break;
          }
          // An empty cell: the boundary step from the actual cell.
          const float half = cl ? q1 : q2;
          float t[3];
          for (int k = 0; k < 3; ++k) {
            t[k] = (((cl ? m1[k] : m2[k]) - p[k]) + rs[k] * half) / d[k];
          }
          const bool face[3] = {t[0] <= fminf(t[1], t[2]), t[1] <= fminf(t[2], t[0]),
                                t[2] <= fminf(t[0], t[1])};
          const float tc = fminf(fminf(t[0], t[1]), t[2]);
          float nn[3], q[3];
          bool inb = true;
          for (int k = 0; k < 3; ++k) {
            nn[k] = (face[k] ? 1.0f : 0.0f) * -rs[k];
            q[k] = (p[k] + d[k] * tc) - nn[k] * 2e-6f;
            inb = inb && q[k] >= -1.0f && q[k] < 1.0f;
          }
          if (!inb) {  // left the root cube: a miss with zero pos and normal
            out_steps = steps;
            out_depth = depth + (cl ? 1 : 2);
            done = true;
            break;
          }
          if (steps + 1 > a.max_steps) {  // the step cap forces a hit
            hit = true;
            forced = true;
            out_steps = steps + 1;
            out_depth = a.max_steps;
            for (int k = 0; k < 3; ++k) {
              hp[k] = q[k];
              hn[k] = nn[k];
            }
            done = true;
            break;
          }
          bool inc = true;
          for (int k = 0; k < 3; ++k) {
            v[k] = q[k];
            nrm[k] = nn[k];
            inc = inc && (STRICT ? (q[k] > cp[k] - h && q[k] <= cp[k] + h)
                                 : (q[k] >= cp[k] - h && q[k] < cp[k] + h));
          }
          steps += 1;
          if (!inc) {
            // Out of the brick's cell: its parent's cell (the centre is exact
            // on dyadic centres) when that holds the position, else the root.
            const float h2 = h * 2.0f;
            float pc[3];
            bool inp = true;
            for (int k = 0; k < 3; ++k) {
              pc[k] = cp[k] - (((node >> (2 - k)) & 1) != 0 ? h : -h);
              inp = inp && (STRICT ? (q[k] > pc[k] - h2 && q[k] <= pc[k] + h2)
                                   : (q[k] >= pc[k] - h2 && q[k] < pc[k] + h2));
            }
            bmode = false;
            if (inp) {  // inv1 stays h = 2^-(depth + 1) of the parent
              node &= ~7;
              depth -= 1;
              for (int k = 0; k < 3; ++k) cp[k] = pc[k];
            } else {
              node = 0;
              depth = 0;
              inv1 = ot::pow2(-1);
              for (int k = 0; k < 3; ++k) cp[k] = 0.0f;
            }
            depth0 = depth;
            break;
          }
        }
        if (done) break;
        continue;
      }
      const int32_t depth1 = depth + 1;
      float np[3];
      for (int k = 0; k < 3; ++k) np[k] = cp[k] + (pb[k] ? inv1 : -inv1);
      const int32_t idx = node + child;
      // Out-of-pool marks drop, as JAX's.
      if (kTop && depth0 == 0 && depth < 3) {
        top_mark<VISITS>(top, depth, path, child, idx, n_words);
        path = depth == 0 ? child : path * 8 + child;
      } else {
        mark<VISITS>(a.visits, idx, n_words);
      }
      // JAX's row gather: word `child` of row min(node / 8, rows - 1) of the
      // pool padded with zero words to whole rows (XLA clamps the row, not
      // the word). In a well-formed pool this is word idx. In brick mode the
      // rows past the pool's are the brick table's, and the word came with
      // the trip's load.
      uint32_t word;
      if (BRICKS) {
        word = row_word;
      } else {
        const int32_t at = (min(node >> 3, last_row) << 3) | child;
        word = at < n_words ? __ldg(words + at) : 0u;
      }
      const uint32_t payload = word >> 4;

      if (payload < ot::kVoxelOffset) {  // interior: descend
        if (BRICKS && (word & 1u) != 0u) {  // a brick root: brick mode next trip
          node = idx;
          depth = depth1;
          bmode = true;
          for (int k = 0; k < 3; ++k) cp[k] = np[k];
          continue;
        }
        node = static_cast<int32_t>(payload);
        depth = depth1;
        inv1 *= 0.5f;
        for (int k = 0; k < 3; ++k) cp[k] = np[k];
        continue;
      }
      if (payload > ot::kVoxelOffset) {  // filled leaf: hit
        hit = true;
        index = idx;
        out_word = word;
        out_steps = steps;
        out_depth = depth1;
        for (int k = 0; k < 3; ++k) {
          hp[k] = v[k];
          hn[k] = nrm[k];
        }
        break;
      }

      // Empty leaf: boundary step to the leaf's exit (or the skip cube's);
      // `taken`: the steps it stands for, one but for a counted jump's.
      float t[3];
      for (int k = 0; k < 3; ++k) t[k] = ((np[k] - p[k]) + rs[k] * inv1) / d[k];
      int32_t taken = 1;
      // A counted jump stands for a root descent's steps across it, at most
      // 3 * side - 2: its cube shrinks near the step cap, so that the cap
      // falls where the descent's does.
      const int32_t side_j = VISITS != 0 ? min(skw, (a.max_steps - steps + 2) / 3) : skw;
      if (kCombined && side_j > 0) {
        const float skb = static_cast<float>(side_j);
        float st[3];
        for (int k = 0; k < 3; ++k) {
          const float clo = cell_f(v[k], half_side, last) * cw - 1.0f;
          const float plane = rs[k] > 0.0f ? clo + skb * cw : (clo + cw) - skb * cw;
          st[k] = (plane - p[k]) / d[k];
        }
        const float exit_t = fminf(fminf(st[0], st[1]), st[2]);
        if (exit_t > fminf(fminf(t[0], t[1]), t[2])) {
          for (int k = 0; k < 3; ++k) t[k] = st[k];
          if constexpr (VISITS != 0) {
            taken = mark_jump<STRICT, VISITS>(a.table, words, n_words, a.levels, a.visits, p, d,
                                              rs, v, side_j, exit_t, np, inv1, idx);
          }
        }
      }
      const bool face[3] = {t[0] <= fminf(t[1], t[2]), t[1] <= fminf(t[2], t[0]),
                            t[2] <= fminf(t[0], t[1])};
      const float tc = fminf(fminf(t[0], t[1]), t[2]);
      float nn[3], nv[3];
      bool inb = true;
      for (int k = 0; k < 3; ++k) {
        nn[k] = (face[k] ? 1.0f : 0.0f) * -rs[k];
        nv[k] = (p[k] + d[k] * tc) - nn[k] * 2e-6f;
        inb = inb && nv[k] >= -1.0f && nv[k] < 1.0f;
      }
      const int32_t steps_new = steps + taken;
      if (!inb) {  // left the root cube: a miss with zero pos and normal
        out_steps = steps_new - 1;
        out_depth = depth1;
        break;
      }
      if (steps_new > a.max_steps) {  // the step cap forces a hit
        hit = true;
        forced = true;
        out_steps = steps_new;
        out_depth = a.max_steps;
        for (int k = 0; k < 3; ++k) {
          hp[k] = nv[k];
          hn[k] = nn[k];
        }
        break;
      }

      // Restart: at the parent when the stepped position stays in the
      // leaf's parent cell (never in the root form), else at the warp
      // cell's stored node, else at the root. With a combined table the skip
      // side is refreshed at every step.
      bool in_parent = !ROOT;
      if (!ROOT) {
        const float vs = 2.0f * inv1;
        for (int k = 0; k < 3; ++k) {
          in_parent = in_parent && (STRICT ? (nv[k] > cp[k] - vs && nv[k] <= cp[k] + vs)
                                           : (nv[k] >= cp[k] - vs && nv[k] < cp[k] + vs));
        }
      }
      for (int k = 0; k < 3; ++k) {
        v[k] = nv[k];
        nrm[k] = nn[k];
      }
      steps = steps_new;
      if (in_parent && !kCombined) continue;  // node, cp and depth stay
      Resume w;
      w.valid = false;
      if (TABLE != 0) {
        w = warp_lookup<STRICT, kCombined>(a.table, a.levels, half_side, last, nv);
        if (kCombined) skw = decode_skip(w.skip, oct);
      }
      if (in_parent) continue;
      node = w.valid ? w.index : 0;
      depth = w.valid ? w.depth : 0;
      depth0 = depth;
      inv1 = ot::pow2(-(depth + 1));
      for (int k = 0; k < 3; ++k) cp[k] = w.valid ? w.c[k] : 0.0f;
    }
  }

  a.hit[i] = hit;
  if (SHADOW) return;
  if (BRICKS) {  // `_refetch_words`: the word at max(index, 0), by the row clamp
    const int32_t slot = max(index, 0);
    const int32_t at = (min(slot >> 3, (a.n_words - 1) >> 3) << 3) | (slot & 7);
    out_word = hit && !forced && at < a.n_words ? __ldg(a.words + at) : 0u;
  }
  a.forced[i] = forced;
  a.index[i] = index;
  a.steps[i] = out_steps;
  a.depth[i] = out_depth;
  a.word[i] = out_word;
  for (int k = 0; k < 3; ++k) {
    a.hit_pos[3 * i + k] = hp[k];
    a.normal[3 * i + k] = hn[k];
  }
}

// One warp a tile, in a grid of all tiles (the kernels below).
template <bool STRICT, int TABLE, int VISITS, bool SHADOW, bool ROOT, bool BRICKS, int START>
__device__ __forceinline__ void trace_block(const TraceArgs& a) {
  const int lane = threadIdx.x & 31;
  const int32_t tile = blockIdx.x * kWarps + threadIdx.x / 32;
  if constexpr (!kTopMarks<TABLE, VISITS, SHADOW, ROOT>) {
    if (tile >= a.n_tiles) return;
    const int32_t i = ray_of(a, tile, lane);
    if (i >= 0) trace_ray<STRICT, TABLE, VISITS, SHADOW, ROOT, BRICKS, START>(a, i, TopMarks{});
  } else {
    __shared__ int32_t count[kTopEntries], slot[kTopEntries];
    for (int e = threadIdx.x; e < kTopEntries; e += ot::kBlock) count[e] = 0;
    __syncthreads();
    if (tile < a.n_tiles) {
      const int32_t i = ray_of(a, tile, lane);
      if (i >= 0) {
        trace_ray<STRICT, TABLE, VISITS, SHADOW, ROOT, BRICKS, START>(a, i, {count, slot});
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kTopEntries; e += ot::kBlock) {
      if (count[e] == 0) continue;
      if (VISITS == 1) {
        atomicAdd(a.visits + slot[e], count[e]);
      } else {
        a.visits[slot[e]] = 1;
      }
    }
  }
}

// Five resident blocks an SM (40 warps) hold the primary instantiations to
// 48 registers, where they otherwise take 51 and fit four (PERF.md §6). The
// brick forms, whose trip holds the brick's state beside the ray's, fit
// four (64 registers), and so do the counting forms with a combined table,
// whose jumps walk the cells they cross (`mark_jump`): at 48 registers they
// spill 36-136 bytes, inline or called out of line; at 64, 57-63 and none.
template <int TABLE, int VISITS, bool BRICKS>
constexpr int kBlocksPerSm = BRICKS || (TABLE == 2 && VISITS != 0) ? 4 : 5;

template <bool STRICT, int TABLE, int VISITS, bool SHADOW, bool ROOT, bool BRICKS>
__global__ void __launch_bounds__(ot::kBlock, (kBlocksPerSm<TABLE, VISITS, BRICKS>))
    trace_kernel(const TraceArgs a) {
  trace_block<STRICT, TABLE, VISITS, SHADOW, ROOT, BRICKS, 0>(a);
}

// The start forms (JAX `trace(start=...)`), a kernel of their own so that
// the forms above keep their code: primary only, under the same bounds.
template <bool STRICT, int TABLE, int VISITS, bool ROOT, bool BRICKS>
__global__ void __launch_bounds__(ot::kBlock, (kBlocksPerSm<TABLE, VISITS, BRICKS>))
    trace_start_kernel(const TraceArgs a) {
  trace_block<STRICT, TABLE, VISITS, false, ROOT, BRICKS, 1>(a);
}

// The seed forms (a table for first descents only), likewise.
template <bool STRICT, int VISITS, bool SHADOW, bool ROOT>
__global__ void __launch_bounds__(ot::kBlock, 5) trace_seed_kernel(const TraceArgs a) {
  trace_block<STRICT, 0, VISITS, SHADOW, ROOT, false, 2>(a);
}

template <bool STRICT, int TABLE, int VISITS, bool SHADOW, bool ROOT, bool BRICKS = false>
void launch_kernel(const TraceArgs& a, cudaStream_t s) {
  const unsigned grid = (a.n_tiles + kWarps - 1) / kWarps;
  if constexpr (!SHADOW) {
    if (a.start_index != nullptr) {
      trace_start_kernel<STRICT, TABLE, VISITS, ROOT, BRICKS><<<grid, ot::kBlock, 0, s>>>(a);
      return;
    }
  }
  if constexpr (TABLE == 0 && !BRICKS) {
    if (a.seed != 0) {
      trace_seed_kernel<STRICT, VISITS, SHADOW, ROOT><<<grid, ot::kBlock, 0, s>>>(a);
      return;
    }
  }
  trace_kernel<STRICT, TABLE, VISITS, SHADOW, ROOT, BRICKS><<<grid, ot::kBlock, 0, s>>>(a);
}

// Brick mode (a.bricks set) is instantiated without a table only.
template <bool STRICT, int VISITS, bool SHADOW, bool ROOT>
void launch_table(const TraceArgs& a, int table_mode, cudaStream_t s) {
  if (a.bricks != nullptr) {
    launch_kernel<STRICT, 0, VISITS, SHADOW, ROOT, true>(a, s);
    return;
  }
  switch (table_mode) {
    case 0: launch_kernel<STRICT, 0, VISITS, SHADOW, ROOT>(a, s); break;
    case 1: launch_kernel<STRICT, 1, VISITS, SHADOW, ROOT>(a, s); break;
    default: launch_kernel<STRICT, 2, VISITS, SHADOW, ROOT>(a, s); break;
  }
}

// The shadow mode takes visit modes 0 and 1 only.
template <bool SHADOW, bool ROOT>
void launch_visits(const TraceArgs& a, int strict, int table_mode, int visit_mode,
                   cudaStream_t s) {
  switch (visit_mode * 2 + (strict != 0)) {
    case 0: launch_table<false, 0, SHADOW, ROOT>(a, table_mode, s); break;
    case 1: launch_table<true, 0, SHADOW, ROOT>(a, table_mode, s); break;
    case 2: launch_table<false, 1, SHADOW, ROOT>(a, table_mode, s); break;
    case 3: launch_table<true, 1, SHADOW, ROOT>(a, table_mode, s); break;
    case 4: launch_table<false, 2, false, ROOT>(a, table_mode, s); break;
    default: launch_table<true, 2, false, ROOT>(a, table_mode, s); break;
  }
}

// Every (strict, table, visits) combination has both restart forms.
template <bool SHADOW>
void launch(const TraceArgs& a, int strict, int root, int table_mode, int visit_mode,
            cudaStream_t s) {
  if (root != 0) {
    launch_visits<SHADOW, true>(a, strict, table_mode, visit_mode, s);
  } else {
    launch_visits<SHADOW, false>(a, strict, table_mode, visit_mode, s);
  }
}

// The batch's tiles: 8x4 pixel tiles of an image of `width` columns, or
// 32-ray runs in linear order when width is 0.
void set_tiles(TraceArgs& a) {
  if (a.width > 0) {
    a.tiles_x = (a.width + kTileW - 1) / kTileW;
    a.n_tiles = a.tiles_x * ((a.n / a.width + kTileH - 1) / kTileH);
  } else {
    a.tiles_x = 0;
    a.n_tiles = (a.n + 31) / 32;
  }
}

// in_body == 0 with a table: the table sets first descents only, so the
// body is the one without a table (a caller's start wins over it).
void set_seed(TraceArgs& a, int& table_mode, int in_body) {
  if (in_body != 0 || table_mode == 0) return;
  if (a.start_index == nullptr) a.seed = table_mode;
  table_mode = 0;
}

int32_t clamp_words(int64_t n_words) {
  return static_cast<int32_t>(n_words < INT_MAX ? n_words : INT_MAX);
}

}  // namespace

// Primary pass. origins f32[n, 3] (origin_stride 3) or one f32[3] point
// (origin_stride 0); width > 0 traces the batch as an image of that many
// columns in 8x4 tiles (n a multiple of width); table_mode: 0 = no table,
// 1 = warp table, 2 = combined warp+skip table; root != 0 restarts at the
// warp cell or the root after every boundary step (parent_restart=False);
// visit_mode: 0 = no visits (visits null), 1 = counts, 2 = 0/1 flags into
// visits int32[n_words]; bricks (u32[n_words, 8], 16-byte aligned, with
// table_mode 0) or null: brick mode, brick_k sub-steps a brick trip;
// start_index int32[n], start_pos f32[n, 3] and start_depth int32[n], or
// all null: where each ray's first descent begins (the start forms);
// in_body == 0 with a table: the table sets first descents only (a start
// given wins over it), the seed forms;
// n < 2^31 / 3. Returns cudaGetLastError() after the launch.
extern "C" int ot_trace(const void* words, int64_t n_words, const void* origins,
                        int origin_stride, const void* dirs, const void* active_init,
                        int64_t n, int width, const void* table, int table_mode,
                        int levels, int strict, int root, int max_steps, int max_iters,
                        void* hit, void* forced, void* index, void* hit_pos,
                        void* normal, void* steps, void* depth, void* word, void* visits,
                        int visit_mode, const void* bricks, int brick_k,
                        const void* start_index, const void* start_pos,
                        const void* start_depth, int in_body, void* stream) {
  if (n == 0) return 0;
  TraceArgs a{};
  a.words = static_cast<const uint32_t*>(words);
  a.n_words = clamp_words(n_words);
  a.origins = static_cast<const float*>(origins);
  a.origin_stride = origin_stride;
  a.dirs = static_cast<const float*>(dirs);
  a.active_init = static_cast<const uint8_t*>(active_init);
  a.n = static_cast<int32_t>(n);
  a.width = width;
  a.table = static_cast<const uint32_t*>(table);
  a.levels = levels;
  a.max_steps = max_steps;
  a.max_iters = max_iters;
  a.hit = static_cast<uint8_t*>(hit);
  a.forced = static_cast<uint8_t*>(forced);
  a.index = static_cast<int32_t*>(index);
  a.hit_pos = static_cast<float*>(hit_pos);
  a.normal = static_cast<float*>(normal);
  a.steps = static_cast<int32_t*>(steps);
  a.depth = static_cast<int32_t*>(depth);
  a.word = static_cast<uint32_t*>(word);
  a.visits = static_cast<int32_t*>(visits);
  a.bricks = static_cast<const uint32_t*>(bricks);
  a.brick_k = brick_k;
  a.start_index = static_cast<const int32_t*>(start_index);
  a.start_pos = static_cast<const float*>(start_pos);
  a.start_depth = static_cast<const int32_t*>(start_depth);
  set_tiles(a);
  set_seed(a, table_mode, in_body);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  launch<false>(a, strict, root, table_mode, visit_mode, s);
  return static_cast<int>(cudaGetLastError());
}

// Shadow pass over a primary result (prim_hit u8[n], prim_pos and
// prim_normal f32[n, 3]) toward neg_sun = -normalize(sun): writes only
// hit_out u8[n]; `cull` skips hits whose normal faces away from the sun;
// visits (int32[n_words] or null) gets counts. Other arguments (in_body
// too) as ot_trace.
extern "C" int ot_trace_shadow(const void* words, int64_t n_words, const void* prim_hit,
                               const void* prim_pos, const void* prim_normal, float sx,
                               float sy, float sz, int cull, int64_t n, int width,
                               const void* table, int table_mode, int levels, int strict,
                               int root, int max_steps, int max_iters, void* hit_out,
                               void* visits, const void* bricks, int brick_k,
                               int in_body, void* stream) {
  if (n == 0) return 0;
  TraceArgs a{};
  a.words = static_cast<const uint32_t*>(words);
  a.n_words = clamp_words(n_words);
  a.prim_hit = static_cast<const uint8_t*>(prim_hit);
  a.prim_pos = static_cast<const float*>(prim_pos);
  a.prim_normal = static_cast<const float*>(prim_normal);
  a.sun[0] = sx;
  a.sun[1] = sy;
  a.sun[2] = sz;
  a.cull = cull != 0;
  a.n = static_cast<int32_t>(n);
  a.width = width;
  a.table = static_cast<const uint32_t*>(table);
  a.levels = levels;
  a.max_steps = max_steps;
  a.max_iters = max_iters;
  a.hit = static_cast<uint8_t*>(hit_out);
  a.visits = static_cast<int32_t*>(visits);
  a.bricks = static_cast<const uint32_t*>(bricks);
  a.brick_k = brick_k;
  set_tiles(a);
  set_seed(a, table_mode, in_body);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  launch<true>(a, strict, root, table_mode, visits != nullptr ? 1 : 0, s);
  return static_cast<int>(cudaGetLastError());
}
