// K1 `trace`: stackless per-ray octree traversal.
//
// Replaces the XLA while-loop program of octree_tracer_tpu/render/tracer.py:135
// `trace` with `_init_state` (:239), `_make_body` (:372), `_warp_lookup`
// (:2916), `_ray_box_dist` (:117), `_in_bounds` (:99) and `_finish` (:342), in
// its parent_restart=True form without bricks, paging, pack9 or fuse_sibling.
// Each loop trip of a ray is one `_make_body` iteration for that ray: descend
// one level through the group row, or take a t_max boundary step (2e-6 nudge)
// and restart at the parent, at the warp-table cell or at the root; with a
// combined table the step may cross a whole stored empty cube. A ray still
// active after max_iters trips stays unresolved, as the JAX loop leaves it.
//
// What bounds it on the H100: every trip is one dependent 4-byte load from
// the pool (the child word of the 32-byte group row), and every boundary step
// with a table one more from the table. On the deep10 scene the pool and the
// level-7 combined table fit in the H100's L2 together, so the kernel waits on
// L2 latency of dependent loads, not on DRAM bandwidth. The simple design:
// one thread per ray, the whole state in registers, no shared memory; warps
// diverge as their rays finish. Warp-coherent beams, persistent threads and
// L2 residency control are later work.
//
// Rounding: every expression keeps tracer.py's association term by term,
// including the skip-plane association of tracer.py:554-561
// (clo + cw - B*cw), which can differ by an ulp from the plain march's.
//
// Visits (`_visit_mark`, tracer.py:355-369, marked at :524-526): every trip
// marks the slot it reads in an int32[pool] array, as an atomicAdd count or
// as a stored 1 (flags; every writer stores the same value, so the race is
// benign). Counting is a template parameter, so frames that do not count
// keep the unmarked kernel's registers. Each ray's first descent marks the
// root group, so in count mode about a million atomics of a 1080p frame
// land on the same 8 addresses; warp-aggregated atomics are later work.
#include "common.cuh"

namespace {

struct TraceArgs {
  const uint32_t* words;
  int64_t n_words;
  const float* origins;       // [n, 3]
  const float* dirs;          // [n, 3]
  const uint8_t* active_init; // [n] or null
  int64_t n;
  const uint32_t* table;      // [8^L] warp words or [2*8^L] (warp, skip) pairs
  int levels;
  int max_steps;
  int max_iters;
  uint8_t* hit;
  uint8_t* forced;
  int32_t* index;
  float* hit_pos;             // [n, 3]
  float* normal;              // [n, 3]
  int32_t* steps;
  int32_t* depth;
  uint32_t* word;
  int32_t* visits;            // [n_words] or null
};

struct Resume {
  int32_t index;
  float c[3];
  int32_t depth;
  bool valid;
  uint32_t skip;
};

__device__ __forceinline__ int cell_of(float p, int side) {
  const float c = floorf((p + 1.0f) * (static_cast<float>(side) * 0.5f));
  return static_cast<int>(fminf(fmaxf(c, 0.0f), static_cast<float>(side - 1)));
}

// tracer.py:2916 `_warp_lookup`: the resume state of the table cell holding
// p, valid only where p lies inside the stored node's cell under the descent's
// boundary rule ((lo, hi] for strict '>', [lo, hi) for '>=').
template <bool STRICT, bool COMBINED>
__device__ __forceinline__ Resume warp_lookup(const uint32_t* __restrict__ table,
                                              int levels, const float p[3]) {
  const int side = 1 << levels;
  int cell[3];
  for (int k = 0; k < 3; ++k) cell[k] = cell_of(p[k], side);
  const int64_t flat =
      (static_cast<int64_t>(cell[0]) * side + cell[1]) * side + cell[2];
  const int64_t lane = COMBINED ? 2 * flat : flat;
  const uint32_t packed = table[lane];
  const int32_t w_index = static_cast<int32_t>(packed >> 5);
  const int32_t w_depth = static_cast<int32_t>(packed & 31u);
  const int shift = max(levels - w_depth, 0);
  const float scale = ot::pow2(w_depth);
  const float half = 1.0f / scale;
  Resume r;
  bool in_cell = true;
  for (int k = 0; k < 3; ++k) {
    const float anc = static_cast<float>(cell[k] >> shift);
    r.c[k] = (anc * 2.0f + 1.0f) / scale - 1.0f;
    in_cell = in_cell && (STRICT ? (p[k] > r.c[k] - half && p[k] <= r.c[k] + half)
                                 : (p[k] >= r.c[k] - half && p[k] < r.c[k] + half));
  }
  r.valid = in_cell && w_depth > 0;
  r.index = r.valid ? w_index : 0;
  r.depth = r.valid ? w_depth : 0;
  for (int k = 0; k < 3; ++k) r.c[k] = r.valid ? r.c[k] : 0.0f;
  r.skip = COMBINED ? table[lane + 1] : 0u;
  return r;
}

// Side of the empty cube stored for this ray's octant: nibble codebook
// 0..12 identity, 13/14/15 -> 16/24/32 (render/skip.py decode_skip).
__device__ __forceinline__ int32_t decode_skip(uint32_t skip_word, int oct) {
  const int32_t nib = static_cast<int32_t>((skip_word >> (4u * oct)) & 15u);
  return nib <= 12 ? nib : (nib - 11) * 8;
}

// TABLE: 0 = no table, 1 = warp words, 2 = combined warp+skip pairs.
// VISITS: 0 = none, 1 = counts, 2 = 0/1 flags.
template <bool STRICT, int TABLE, int VISITS>
__global__ void __launch_bounds__(ot::kBlock) trace_kernel(const TraceArgs a) {
  constexpr bool kCombined = TABLE == 2;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= a.n) return;

  // What a ray that never resolves reports (not entered, masked off, or still
  // active after max_iters trips).
  bool hit = false, forced = false;
  int32_t index = -1, out_steps = 0, out_depth = 0;
  uint32_t out_word = 0;
  float hp[3] = {0.0f, 0.0f, 0.0f}, hn[3] = {0.0f, 0.0f, 0.0f};

  float o[3], d[3], mn[3], mx[3];
  bool inside = true;
  for (int k = 0; k < 3; ++k) {
    o[k] = a.origins[3 * i + k];
    const float dk = a.dirs[3 * i + k];
    d[k] = dk == 0.0f ? 1e-6f : dk;
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
  if (a.active_init != nullptr) active = active && a.active_init[i] != 0;

  if (active) {
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
    if (TABLE != 0) {
      const Resume w = warp_lookup<STRICT, kCombined>(a.table, a.levels, p);
      node = w.index;
      depth = w.depth;
      for (int k = 0; k < 3; ++k) cp[k] = w.c[k];
      if (kCombined) skw = decode_skip(w.skip, oct);
    }

    for (int it = 0; it < a.max_iters; ++it) {
      const int32_t depth1 = depth + 1;
      bool pb[3];
      for (int k = 0; k < 3; ++k) pb[k] = STRICT ? v[k] > cp[k] : v[k] >= cp[k];
      const int child = pb[0] * 4 + pb[1] * 2 + pb[2];
      const float inv1 = ot::pow2(-depth1);
      float np[3];
      for (int k = 0; k < 3; ++k) np[k] = cp[k] + (pb[k] ? inv1 : -inv1);
      const int32_t idx = node + child;
      if (VISITS != 0 && idx < a.n_words) {  // out-of-pool marks drop, as JAX's
        if (VISITS == 1) {
          atomicAdd(a.visits + idx, 1);
        } else {
          a.visits[idx] = 1;
        }
      }
      // A malformed pool reads its last word, as JAX's clamped gather does.
      const uint32_t word = a.words[idx < a.n_words ? idx : a.n_words - 1];
      const uint32_t payload = word >> 4;

      if (payload < ot::kVoxelOffset) {  // interior: descend
        node = static_cast<int32_t>(payload);
        depth = depth1;
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

      // Empty leaf: boundary step to the leaf's exit (or the skip cube's).
      float t[3];
      for (int k = 0; k < 3; ++k) t[k] = ((np[k] - p[k]) + rs[k] * inv1) / d[k];
      if (kCombined && skw > 0) {
        const int side = 1 << a.levels;
        const float cw = 2.0f / static_cast<float>(side);
        const float skb = static_cast<float>(skw);
        float st[3];
        for (int k = 0; k < 3; ++k) {
          const float ci = fminf(
              fmaxf(floorf((v[k] + 1.0f) * (static_cast<float>(side) * 0.5f)), 0.0f),
              static_cast<float>(side - 1));
          const float clo = ci * cw - 1.0f;
          const float plane = rs[k] > 0.0f ? clo + skb * cw : (clo + cw) - skb * cw;
          st[k] = (plane - p[k]) / d[k];
        }
        if (fminf(fminf(st[0], st[1]), st[2]) > fminf(fminf(t[0], t[1]), t[2])) {
          for (int k = 0; k < 3; ++k) t[k] = st[k];
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
      if (!inb) {  // left the root cube: a miss with zero pos and normal
        out_steps = steps;
        out_depth = depth1;
        break;
      }
      const int32_t steps_new = steps + 1;
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
      // leaf's parent cell, else at the warp cell's stored node, else at the
      // root. With a combined table the skip side is refreshed at every step.
      const float vs = 2.0f * inv1;
      bool in_parent = true;
      for (int k = 0; k < 3; ++k) {
        in_parent = in_parent && (STRICT ? (nv[k] > cp[k] - vs && nv[k] <= cp[k] + vs)
                                         : (nv[k] >= cp[k] - vs && nv[k] < cp[k] + vs));
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
        w = warp_lookup<STRICT, kCombined>(a.table, a.levels, nv);
        if (kCombined) skw = decode_skip(w.skip, oct);
      }
      if (in_parent) continue;
      node = w.valid ? w.index : 0;
      depth = w.valid ? w.depth : 0;
      for (int k = 0; k < 3; ++k) cp[k] = w.valid ? w.c[k] : 0.0f;
    }
  }

  a.hit[i] = hit;
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

template <bool STRICT, int VISITS>
void launch_visits(const TraceArgs& a, int table_mode, cudaStream_t s) {
  const unsigned grid = ot::blocks_for(a.n);
  switch (table_mode) {
    case 0: trace_kernel<STRICT, 0, VISITS><<<grid, ot::kBlock, 0, s>>>(a); break;
    case 1: trace_kernel<STRICT, 1, VISITS><<<grid, ot::kBlock, 0, s>>>(a); break;
    default: trace_kernel<STRICT, 2, VISITS><<<grid, ot::kBlock, 0, s>>>(a); break;
  }
}

template <bool STRICT>
void launch_strict(const TraceArgs& a, int table_mode, int visit_mode, cudaStream_t s) {
  switch (visit_mode) {
    case 0: launch_visits<STRICT, 0>(a, table_mode, s); break;
    case 1: launch_visits<STRICT, 1>(a, table_mode, s); break;
    default: launch_visits<STRICT, 2>(a, table_mode, s); break;
  }
}

}  // namespace

// table_mode: 0 = no table, 1 = warp table, 2 = combined warp+skip table.
// visit_mode: 0 = no visits (visits null), 1 = counts, 2 = 0/1 flags into
// visits int32[n_words]. Returns cudaGetLastError() after the launch.
extern "C" int ot_trace(const void* words, int64_t n_words, const void* origins,
                        const void* dirs,
                        const void* active_init, int64_t n, const void* table,
                        int table_mode, int levels, int strict, int max_steps,
                        int max_iters, void* hit, void* forced, void* index,
                        void* hit_pos, void* normal, void* steps, void* depth,
                        void* word, void* visits, int visit_mode, void* stream) {
  if (n == 0) return 0;
  const TraceArgs a{static_cast<const uint32_t*>(words),
                    n_words,
                    static_cast<const float*>(origins),
                    static_cast<const float*>(dirs),
                    static_cast<const uint8_t*>(active_init),
                    n,
                    static_cast<const uint32_t*>(table),
                    levels,
                    max_steps,
                    max_iters,
                    static_cast<uint8_t*>(hit),
                    static_cast<uint8_t*>(forced),
                    static_cast<int32_t*>(index),
                    static_cast<float*>(hit_pos),
                    static_cast<float*>(normal),
                    static_cast<int32_t*>(steps),
                    static_cast<int32_t*>(depth),
                    static_cast<uint32_t*>(word),
                    static_cast<int32_t*>(visits)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (strict) {
    launch_strict<true>(a, table_mode, visit_mode, s);
  } else {
    launch_strict<false>(a, table_mode, visit_mode, s);
  }
  return static_cast<int>(cudaGetLastError());
}
